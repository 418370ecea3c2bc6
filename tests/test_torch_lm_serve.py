"""The port's serving engine (``repro_torch.serve.engine``) held to the
reference's on the CPU.

* ``prefill`` (padded to ``S_max``) on the first half of a sequence and
  teacher-forced ``decode_step``s over the rest, for the reference test's
  five architectures (``tests/test_models.py``) and phi-3-vision's
  patches frontend, with the reference's bfloat16 parameters: every
  prefill and decode logit within 0.15 of the reference's prefill and
  decode, with the MoE routing check of ``test_torch_lm`` (a routing
  difference only at a near tie; compared before it).
* ``greedy_generate`` in float32 (the reference's compute dtype patched
  to float32 for the test): the same tokens as the reference's.  In
  bfloat16 a top logit nearly tied with the next may go either way on
  rounding, as with random weights it often does.
* Every entry point runs on the card unless told otherwise.
"""
import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.models.layers as JL  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from test_torch_lm import (Routing, arrays, assert_close_before,  # noqa
                           batch, bf16_configs, configs, to_jax, to_torch)

DECODE_ARCHS = ["yi-6b", "deepseek-v2-lite-16b", "mamba2-130m",
                "jamba-v0.1-52b", "whisper-small", "phi-3-vision-4.2b"]


def call_rows(cfg, B, half):
    """Call c's tokens' (rows, positions): the prefill's MoE calls first
    (B × half tokens), then each decode step's (B tokens at one
    position)."""
    n_moe = sum(f == "moe" for f in cfg.layer_ffn())

    def where(c):
        if c < n_moe:
            t = np.arange(B * half)
            return t // half, t % half
        return np.arange(B), np.full(B, half + (c - n_moe) // n_moe)
    return where


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_and_decode_match_reference(arch, monkeypatch):
    jcfg, cfg = bf16_configs(arch)
    params = JLM.init_params(jax.random.PRNGKey(42), jcfg)
    tparams = lm_params_from_arrays(cfg, arrays(params), device="cpu")
    B, S, S_max = 2, 8, 16
    if cfg.frontend == "patches":
        S = 2 * cfg.n_patches             # the prefill holds every patch
    half = S // 2
    full = batch(cfg, B, S, seed=1)
    pre = dict(full, tokens=full["tokens"][:, :half])
    route = Routing(monkeypatch)
    want_p, wcache = jax.jit(lambda p, b: JE.prefill(
        p, jcfg, b, pad_to=S_max))(params, to_jax(pre))
    got_p, gcache = engine.prefill(tparams, cfg, to_torch(pre),
                                   pad_to=S_max, device="cpu")
    assert got_p.shape == (B, half, cfg.vocab)
    dec = jax.jit(lambda p, t, c, pos: JLM.decode_step(p, jcfg, t, c, pos))
    step = engine.make_decode_step(cfg, device="cpu")
    want_d, got_d = [], []
    for t in range(half, S):
        tok = full["tokens"][:, t:t + 1]
        lg, wcache = dec(params, jnp.asarray(tok), wcache, jnp.int32(t))
        want_d.append(np.asarray(lg[:, 0], np.float32))
        lg, gcache = step(tparams, torch.from_numpy(tok), gcache, t)
        got_d.append(lg[:, 0].float().numpy())
    first = route.first_differences(cfg.top_k, call_rows(cfg, B, half))
    n = assert_close_before(got_p.float(), want_p, first)
    n += assert_close_before(np.stack(got_d, 1), np.stack(want_d, 1), first,
                             pos0=half)
    assert n >= B * S // 2, f"compared {n} of {B * S} positions"


@pytest.mark.parametrize("arch", ["yi-6b", "deepseek-v2-lite-16b",
                                  "mamba2-130m", "jamba-v0.1-52b"])
def test_greedy_generate_matches_reference(arch, monkeypatch):
    monkeypatch.setattr(JL, "PDT", jnp.float32)
    jcfg, cfg = configs(arch)
    params = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32),
        JLM.init_params(jax.random.PRNGKey(3), jcfg))
    tparams = lm_params_from_arrays(cfg, arrays(params), device="cpu")
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 6)).astype(np.int32)
    want = JE.greedy_generate(params, jcfg, jnp.asarray(prompt), 6, 12)
    got = engine.greedy_generate(tparams, cfg, prompt, 6, 12, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_decode_writes_its_caches_in_place():
    _, cfg = configs("yi-6b")
    params = lm.init_params(lm.generator(0, "cpu"), cfg)
    caches = lm.init_caches(cfg, 2, 8, device="cpu")
    k = caches[0]["p0"]["k"]
    assert k.shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.hd)
    tok = torch.zeros((2, 1), dtype=torch.long)
    _, out = lm.decode_step(params, cfg, tok, caches, 3)
    assert out[0]["p0"]["k"] is k
    written = (k != 0).flatten(3).any(-1)          # (layers, B, S)
    assert written[:, :, 3].all() and not written[:, :, [0, 1, 2, 4]].any()


def test_entry_points_run_on_the_card_unless_asked():
    _, cfg = configs("yi-6b")
    params = lm.init_params(lm.generator(0, "cpu"), cfg)
    prompt = np.zeros((1, 4), np.int32)
    if torch.cuda.is_available():
        with pytest.raises(ValueError):          # no quiet copy to the card
            engine.greedy_generate(params, cfg, prompt, 2, 8)
        return
    for call in (lambda: lm.generator(0),
                 lambda: lm.init_caches(cfg, 1, 8),
                 lambda: lm_params_from_arrays(cfg, {}),
                 lambda: engine.prefill(params, cfg, {"tokens": prompt}),
                 lambda: engine.make_decode_step(cfg),
                 lambda: engine.greedy_generate(params, cfg, prompt, 2, 8)):
        with pytest.raises(RuntimeError):
            call()
