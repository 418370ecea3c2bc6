"""The port's LM layers (``repro_torch.models.layers`` / ``mamba2``) held
to the reference's on the CPU.

The same seeded numpy inputs and the reference's own initial parameters,
cast to float32 on both sides, go through each reference function and
its port.  Tolerance: 2e-5 absolute and relative, a few hundred float32
ulps at these magnitudes: the two frameworks sum the same products in
another order, and nothing else differs.
"""
import dataclasses
import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba2 as M  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def f32_params(tree):
    """A reference parameter tree as float32 on both sides: (jax, torch)."""
    jt = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), tree)
    tt = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), jt)
    return jt, tt


def both(a):
    """One numpy array to (jax, torch)."""
    a = np.asarray(a)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def configs(arch, **kw):
    return (dataclasses.replace(jax_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------- attend
@pytest.mark.parametrize("case", ["causal", "kv_len", "chunked_ragged"])
def test_attend_matches_reference(case):
    rng = np.random.default_rng(0)
    B, H, Hkv, hd = 2, 4, 2, 32
    Sq, Sk = (1, 24) if case == "kv_len" else (40, 40)
    q, tq = both(randn(rng, B, Sq, H, hd))
    k, tk = both(randn(rng, B, Sk, Hkv, hd))
    v, tv = both(randn(rng, B, Sk, Hkv, hd))
    if case == "kv_len":
        kw = dict(causal=False, kv_len=13)
        want = JL._attend(q, k, v, causal=False, kv_len=jnp.int32(13))
    else:
        kw = dict(causal=True, q_chunk=16 if case == "chunked_ragged"
                  else 1024)
        want = JL._attend(q, k, v, **kw)
    got = L._attend(tq, tk, tv, **kw)
    close(got, want)
    if case == "kv_len":
        # masked positions have no weight: the cache past kv_len is unread
        tk2, tv2 = tk.clone(), tv.clone()
        tk2[:, 13:], tv2[:, 13:] = 1e3, -1e3
        close(L._attend(tq, tk2, tv2, **kw), want)
    if case == "chunked_ragged":
        # 40 = 2 chunks of 16 + a ragged 8: same as one chunk
        close(got, L._attend(tq, tk, tv, causal=True).numpy())


# ---------------------------------------------------------------- GQA / MLA
def test_gqa_prefill_and_decode_match_reference():
    jcfg, cfg = configs("yi-6b")
    jp, tp = f32_params(JL.attn_init(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(1)
    B, S, S_max = 2, 12, 16
    x, tx = both(randn(rng, B, S, cfg.d_model, scale=0.5))
    want, (wk, wv) = JL.attn_apply(jp, x, jcfg, return_kv=True)
    got, (gk, gv) = L.attn_apply(tp, tx, cfg, return_kv=True)
    close(got, want)
    close(gk, wk)
    close(gv, wv)
    ck, tck = both(randn(rng, B, S_max, cfg.n_kv_heads, cfg.hd))
    cv, tcv = both(randn(rng, B, S_max, cfg.n_kv_heads, cfg.hd))
    xt, txt = both(randn(rng, B, 1, cfg.d_model, scale=0.5))
    want, wck, wcv = JL.attn_decode(jp, xt, ck, cv, jnp.int32(9), jcfg)
    got, gck, gcv = L.attn_decode(tp, txt, tck, tcv, 9, cfg)
    close(got, want)
    close(gck, wck)
    close(gcv, wcv)
    # cross attention over an encoder output of another length
    e, te = both(randn(rng, B, 20, cfg.d_model, scale=0.5))
    close(L.cross_attn_apply(tp, tx, te, cfg),
          JL.cross_attn_apply(jp, x, e, jcfg))


def test_mla_prefill_and_decode_match_reference():
    jcfg, cfg = configs("deepseek-v2-lite-16b")
    jp, tp = f32_params(JL.mla_init(jax.random.PRNGKey(2), jcfg))
    rng = np.random.default_rng(2)
    B, S, S_max = 2, 10, 16
    x, tx = both(randn(rng, B, S, cfg.d_model, scale=0.5))
    close(L.mla_apply(tp, tx, cfg), JL.mla_apply(jp, x, jcfg))
    cc, tcc = both(randn(rng, B, S_max, cfg.kv_lora))
    ckr, tckr = both(randn(rng, B, S_max, cfg.rope_head_dim))
    xt, txt = both(randn(rng, B, 1, cfg.d_model, scale=0.5))
    want, wc, wkr = JL.mla_decode(jp, xt, cc, ckr, jnp.int32(7), jcfg)
    got, gc, gkr = L.mla_decode(tp, txt, tcc, tckr, 7, cfg)
    close(got, want)
    close(gc, wc)
    close(gkr, wkr)


def test_norm_rope_swiglu_match_reference():
    rng = np.random.default_rng(3)
    x, tx = both(randn(rng, 2, 6, 3, 16, scale=2.0))
    scale, tscale = both(randn(rng, 16))
    close(L.rmsnorm({"scale": tscale}, tx, 1e-5),
          JL.rmsnorm({"scale": scale}, x, 1e-5))
    pos, tpos = both(np.arange(5, 11))
    cos, sin = JL.rope_tables(pos, 16, 1e4)
    tcos, tsin = L.rope_tables(tpos, 16, 1e4)
    close(tcos, cos)
    close(tsin, sin)
    close(L.apply_rope(tx, tcos, tsin), JL.apply_rope(x, cos, sin))
    jp, tp = f32_params(JL.swiglu_init(jax.random.PRNGKey(3), 16, 24))
    close(L.swiglu_apply(tp, tx), JL.swiglu_apply(jp, x))


# ---------------------------------------------------------------- MoE
@pytest.mark.parametrize("arch,cf,drops", [
    ("arctic-480b", 64.0, False),
    ("arctic-480b", 1.0, True),
    ("deepseek-v2-lite-16b", 1.0, True),     # with a shared expert
])
def test_moe_matches_reference(arch, cf, drops):
    jcfg, cfg = configs(arch, capacity_factor=cf)
    jp, tp = f32_params(JL.moe_init(jax.random.PRNGKey(4), jcfg))
    rng = np.random.default_rng(4)
    B, S = 2, 24
    x, tx = both(randn(rng, B, S, cfg.d_model))
    want, waux = JL.moe_apply(jp, x, jcfg)
    got, gaux = L.moe_apply(tp, tx, cfg)
    close(got, want)
    close(gaux, waux)
    # the case does (or does not) drop tokens at capacity
    T, E, K = B * S, cfg.n_experts, cfg.top_k
    C = max(8, int(T * K / E * cfg.capacity_factor))
    logits = tx.reshape(T, -1) @ tp["router"]
    load = np.bincount(torch.topk(logits, K).indices.reshape(-1).numpy(),
                       minlength=E)
    assert (load.max() > C) == drops, (load, C)


def test_moe_top_k_ties_go_to_the_lower_expert():
    """A zero router: every token ties over all experts, and top-k must
    take the lowest indices, as lax.top_k does."""
    jcfg, cfg = configs("arctic-480b", capacity_factor=64.0,
                        n_shared_experts=0)
    jp, tp = f32_params(JL.moe_init(jax.random.PRNGKey(5), jcfg))
    router = np.zeros_like(np.asarray(jp["router"]))
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router.copy()))
    rng = np.random.default_rng(5)
    x, tx = both(randn(rng, 1, 8, cfg.d_model))
    want, _ = JL.moe_apply(jp, x, jcfg)
    got, _ = L.moe_apply(tp, tx, cfg)
    close(got, want)
    # experts 0 and 1 only: zeroing the others changes nothing
    tp2 = dict(tp, w2=tp["w2"].clone())
    tp2["w2"][cfg.top_k:] = 0
    close(L.moe_apply(tp2, tx, cfg)[0], want)


# ---------------------------------------------------------------- Mamba-2
def test_ssd_chunked_matches_reference():
    rng = np.random.default_rng(6)
    B, S, H, P, N = 2, 32, 4, 8, 16
    x, tx = both(randn(rng, B, S, H, P))
    dt, tdt = both(np.abs(randn(rng, B, S, H, scale=0.5)))
    a, ta = both(randn(rng, H, scale=0.5))
    b, tb = both(randn(rng, B, S, N))
    c, tc = both(randn(rng, B, S, N))
    want_y, want_s = JM.ssd_chunked(x, dt, a, b, c, 8)
    got_y, got_s = M.ssd_chunked(tx, tdt, ta, tb, tc, 8)
    close(got_y, want_y)
    close(got_s, want_s)
    # the chunk size does not change the result
    close(M.ssd_chunked(tx, tdt, ta, tb, tc, 32)[0], want_y)


def test_mamba_apply_and_decode_match_reference():
    jcfg, cfg = configs("mamba2-130m")
    jp, tp = f32_params(JM.mamba_init(jax.random.PRNGKey(7), jcfg))
    # A_log and D away from their init (0, 1), so both reach the output
    rng = np.random.default_rng(7)
    inner, H, P, N = M.ssm_dims(cfg)
    for k, v in (("A_log", randn(rng, H, scale=0.5)),
                 ("D", randn(rng, H))):
        jp[k], tp[k] = both(v)
    B, S = 2, 12
    x, tx = both(randn(rng, B, S, cfg.d_model, scale=0.3))
    want, (ws, wc) = JM.mamba_apply(jp, x, jcfg, return_state=True)
    got, (gs, gc) = M.mamba_apply(tp, tx, cfg, return_state=True)
    close(got, want)
    close(gs, ws)
    close(gc, wc)
    st, tst = both(randn(rng, B, H, N, P, scale=0.3))
    cv, tcv = both(randn(rng, B, cfg.ssm_conv - 1, inner + 2 * N))
    xt, txt = both(randn(rng, B, 1, cfg.d_model, scale=0.3))
    want, ws, wc = JM.mamba_decode(jp, xt, st, cv, jcfg)
    got, gs, gc = M.mamba_decode(tp, txt, tst, tcv, cfg)
    close(got, want)
    close(gs, ws)
    close(gc, wc)
