"""The port's whole LM (``repro_torch.models.lm``) held to the reference
on the CPU, parameters carried across by ``convert.lm_params_from_arrays``.

* The layer grouping equals the reference's for every architecture.
* ``forward`` of every ``reduced()`` architecture with the reference's
  bfloat16 parameters (handed over as raw bits, exact): the logits within
  0.15 absolute and relative, the reference test's own bfloat16 tolerance
  (``tests/test_models.py``); the two frameworks round bfloat16
  intermediates at other places, and the largest difference seen is
  about 0.1.  A MoE router may then pick another expert where two
  experts' probabilities nearly tie (its bfloat16 logits differ by an
  ulp), which changes that token's output and, through attention, every
  later position of its row.  So for the MoE architectures both sides'
  router probabilities are recorded call by call: each token routed
  differently with no earlier difference at or before its position in
  its row must be such a near tie in the reference (its k-th and k+1-th
  probabilities within ``NEAR_TIE``), and the logits are compared at
  every position before its row's first difference (the MoE
  architectures run at ``capacity_factor`` 8, so no token is dropped and
  a difference stays in its row).
* ``forward`` of every ``reduced()`` architecture in float32 (both sides'
  parameters cast, and the reference's compute dtype ``layers.PDT``
  patched to float32 for the test): every logit within 1e-4, at the
  default capacity factor, drops included.
"""
import dataclasses
import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.models.layers as JL  # noqa: E402
from repro.configs.base import ARCH_IDS  # noqa: E402
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
import repro_torch.models.layers as L  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.models import lm  # noqa: E402

BF16_TOL = 0.15
F32_TOL = 1e-4
#: the largest gap between a token's k-th and (k+1)-th router
#: probabilities at which bfloat16 rounding may swap the two experts
NEAR_TIE = 2.0 ** -8
MOE_CF = 8.0


def arrays(tree):
    """A reference tree as numpy, bfloat16 leaves as raw uint16 bits."""
    def leaf(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    return jax.tree_util.tree_map(leaf, tree)


def configs(arch, **kw):
    return (dataclasses.replace(jax_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def bf16_configs(arch):
    """Reduced configs, MoE ones at ``MOE_CF`` (no drops)."""
    moe = get_config(arch).moe
    return configs(arch, **({"capacity_factor": MOE_CF} if moe else {}))


def batch(cfg, B, S, seed):
    """Seeded tokens and frontend inputs (rounded to bfloat16, so both
    sides see the same values), as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}

    def bf16(*shape):
        a = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
        return np.asarray(a.astype(jnp.float32))
    if cfg.enc_dec:
        out["frames"] = bf16(B, cfg.enc_len, cfg.d_model)
    if cfg.frontend == "patches":
        out["patches"] = bf16(B, cfg.n_patches, cfg.d_model)
    return out


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


# ---------------------------------------------------------------- routing
class Routing:
    """Each MoE call's router probabilities, (T, E) float32, on both
    sides, in call order (the reference's through an ordered debug
    callback, so that it works under ``jit``)."""

    def __init__(self, monkeypatch):
        self.ref, self.port = [], []
        ref_moe, port_moe = JL.moe_apply, L.moe_apply

        def ref(p, x, cfg):
            logits = x.reshape(-1, x.shape[-1]) @ p["router"]
            probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
            jax.debug.callback(lambda a: self.ref.append(np.asarray(a)),
                               probs, ordered=True)
            return ref_moe(p, x, cfg)

        def port(p, x, cfg):
            logits = x.reshape(-1, x.shape[-1]) @ p["router"]
            self.port.append(torch.softmax(logits.float(), -1).numpy())
            return port_moe(p, x, cfg)
        monkeypatch.setattr(JL, "moe_apply", ref)
        monkeypatch.setattr(L, "moe_apply", port)

    def first_differences(self, K, where):
        """Per row, the first position whose routing differs (rows
        without one: a position past the end).  ``where(c)`` gives call
        c's tokens' (rows, positions).  Asserts that every difference not
        preceded, in its row, by one at or before its position is a near
        tie in the reference."""
        assert len(self.ref) == len(self.port)
        first = {}
        for c, (pr, pp) in enumerate(zip(self.ref, self.port)):
            rows, pos = where(c)
            top_r = np.sort(np.argsort(-pr, kind="stable")[:, :K], axis=1)
            top_p = np.sort(np.argsort(-pp, kind="stable")[:, :K], axis=1)
            srt = -np.sort(-pr, axis=1)
            gap = srt[:, K - 1] - srt[:, K]
            seen = dict(first)
            for t in np.nonzero((top_r != top_p).any(1))[0]:
                b, s = int(rows[t]), int(pos[t])
                if s < seen.get(b, np.inf):
                    assert gap[t] <= NEAR_TIE, (
                        f"call {c}, row {b}, position {s}: routing differs "
                        f"with a gap of {gap[t]} between expert {K} and "
                        f"{K + 1}")
                first[b] = min(first.get(b, np.inf), s)
        return first


def assert_close_before(got, want, first, tol=BF16_TOL, pos0=0):
    """``got`` and ``want`` (B, S, V) within ``tol`` at every position
    ``pos0 + s`` before its row's first routing difference; returns how
    many positions were compared."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    n = 0
    for b in range(got.shape[0]):
        s_end = int(min(got.shape[1], max(first.get(b, np.inf) - pos0, 0)))
        np.testing.assert_allclose(got[b, :s_end], want[b, :s_end],
                                   rtol=tol, atol=tol,
                                   err_msg=f"row {b}")
        n += s_end
    return n


def forward_rows(B, S):
    """Token t of a (B, S) call is row t // S, position t % S."""
    t = np.arange(B * S)
    return lambda c: (t // S, t % S)


# ---------------------------------------------------------------- tests
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_layer_grouping_equals_reference(arch):
    jcfg, cfg = jax_config(arch), get_config(arch)
    assert lm.layer_descs(cfg) == JLM.layer_descs(jcfg)
    assert lm.group_descs(lm.layer_descs(cfg)) == \
        JLM.group_descs(JLM.layer_descs(jcfg))
    red_j, red_t = jcfg.reduced(), cfg.reduced()
    assert lm.group_descs(lm.layer_descs(red_t)) == \
        JLM.group_descs(JLM.layer_descs(red_j))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_bf16_matches_reference(arch, monkeypatch):
    jcfg, cfg = bf16_configs(arch)
    params = JLM.init_params(jax.random.PRNGKey(42), jcfg)
    tparams = lm_params_from_arrays(cfg, arrays(params), device="cpu")
    assert tparams["embed"].dtype == torch.bfloat16
    route = Routing(monkeypatch)
    B, S = 2, 16
    b = batch(cfg, B, S, seed=1)
    want, waux = jax.jit(lambda p, x: JLM.forward(p, jcfg, x))(
        params, to_jax(b))
    got, gaux = lm.forward(tparams, cfg, to_torch(b))
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, cfg.vocab)
    first = route.first_differences(cfg.top_k, forward_rows(B, S))
    n = assert_close_before(got.float(), want, first)
    assert n >= B * S // 2, f"compared {n} of {B * S} positions"
    if not first:
        np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-2)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_f32_matches_reference(arch, monkeypatch):
    monkeypatch.setattr(JL, "PDT", jnp.float32)
    jcfg, cfg = configs(arch)
    params = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32),
        JLM.init_params(jax.random.PRNGKey(7), jcfg))
    tparams = lm_params_from_arrays(cfg, arrays(params), device="cpu")
    assert tparams["embed"].dtype == torch.float32
    b = batch(cfg, 2, 16, seed=2)
    want, waux = jax.jit(lambda p, x: JLM.forward(p, jcfg, x))(
        params, to_jax(b))
    got, gaux = lm.forward(tparams, cfg, to_torch(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=F32_TOL,
                               atol=F32_TOL)


def test_converter_checks_the_groups_and_keeps_the_bits():
    jcfg, cfg = configs("jamba-v0.1-52b")
    params = JLM.init_params(jax.random.PRNGKey(0), jcfg)
    tree = arrays(params)
    tparams = lm_params_from_arrays(cfg, tree, device="cpu")
    # every leaf's bits and dtype, bfloat16 and float32 alike
    for got, want in zip(jax.tree_util.tree_leaves(tparams),
                         jax.tree_util.tree_leaves(params)):
        want = np.asarray(want)
        assert str(got.dtype).endswith(want.dtype.name)
        bits = got.view(torch.int16) if got.dtype == torch.bfloat16 else got
        ref = want.view(np.int16) if want.dtype.name == "bfloat16" else want
        assert np.array_equal(bits.numpy(), ref)
    # a numpy bfloat16 leaf is taken as its bits too
    t2 = lm_params_from_arrays(
        cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    assert torch.equal(t2["embed"], tparams["embed"])
    with pytest.raises(ValueError):
        lm_params_from_arrays(cfg, dict(tree, groups=tree["groups"][:1]),
                              device="cpu")
    with pytest.raises(ValueError):
        lm_params_from_arrays(get_config("yi-6b").reduced(), tree,
                              device="cpu")
