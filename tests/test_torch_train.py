"""The port's training step (``repro_torch.train.step``,
``repro_torch.optim.adamw``, remat in ``repro_torch.models.lm``) held to
the reference on the CPU.

* ``loss_fn`` and its gradients equal the reference's
  ``jax.value_and_grad`` in float32 (the reference's ``layers.PDT``
  patched to float32, the same float32 parameters on both sides; the
  checkpoint tests carry the reference's own bfloat16 ones) on one
  architecture
  of each mixer and FFN kind: loss, xent, aux and zloss within
  ``LOSS_RTOL`` relative, each gradient leaf within ``GRAD_TOL`` of that
  leaf's norm.  The parameters after an update are not compared
  elementwise: where a gradient is near zero, Adam's ``m / sqrt(v)``
  flips sign on its last bit, which moves an entry by ``2 lr``.
* ``adamw.update`` fed the same gradients on both sides.  Not bit-exact:
  XLA's CPU backend contracts ``b1 * m + (1 - b1) * g`` (and the second
  moment's update) into fused multiply-adds, which PyTorch's elementwise
  ops do not, so one rounding differs.  The gradients are multiples of
  1/4 with small squares, so every order of summing them is exact and
  the global norm and the clip scale are equal bit for bit; master, m
  and v then agree within ``ADAM_TOL`` of each leaf's largest magnitude,
  the bfloat16 parameters within one bfloat16 rounding.
* a 3-step run from the same parameters gives the reference's losses
  within ``LOSS_RTOL_3``;
* every ``reduced()`` architecture trains one step in the port (finite
  loss, changed parameters), AdamW minimises a quadratic;
* remat "full", "dots" and off give bit-identical gradients on the CPU,
  and no remat runs without grad;
* where the SSD's masked decay overflows, the reference's gradient is
  NaN and the port's finite (a deliberate deviation).
"""
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
from repro.optim import adamw as JA  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as S  # noqa: E402

#: loss terms: float32 sums in another order (about 1e-7 seen)
LOSS_RTOL = 1e-5
#: a gradient leaf's largest difference over its norm (about 3e-6 seen)
GRAD_TOL = 1e-4
#: AdamW state against the reference's, over the leaf's largest
#: magnitude: one float32 rounding (about 3e-8 seen)
ADAM_TOL = 1e-6
#: a 3-step run's losses, relative
LOSS_RTOL_3 = 1e-4
#: one of each mixer and FFN kind: attention and dense, MLA and MoE,
#: SSM, hybrid, encoder-decoder (the encoder's remat)
KINDS = ["yi-6b", "deepseek-v2-lite-16b", "mamba2-130m", "jamba-v0.1-52b",
         "whisper-small"]


def f32_params(cfg, seed):
    """Seeded float32 parameters of the reference's tree, on both sides
    (drawn by the port's ``init_params``: the reference's eager init
    takes seconds a model on the CPU)."""
    tp = tree.map(torch.Tensor.float,
                  lm.init_params(lm.generator(seed, "cpu"), cfg))
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tp), tp


def make_batch(cfg, B, S_, seed, masked=True):
    """Seeded tokens, labels (some masked, -1) and frontend inputs."""
    rng = np.random.default_rng(seed)
    lo = -1 if masked else 0
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S_)).astype(np.int32),
           "labels": rng.integers(lo, cfg.vocab, (B, S_)).astype(np.int32)}
    if cfg.enc_dec:
        out["frames"] = rng.standard_normal(
            (B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "patches":
        out["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# ---------------------------------------------------------------- loss
@pytest.mark.parametrize("arch", KINDS)
def test_loss_and_grads_match_reference(arch, monkeypatch):
    monkeypatch.setattr(JL, "PDT", jnp.float32)
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp, tp = f32_params(cfg, seed=3)
    b = make_batch(cfg, 2, 16, seed=0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, x: JS.loss_fn(p, jcfg, x), has_aux=True))(jp, to_jax(b))
    (tl, tm), tg = S.value_and_grad(tp, cfg, to_torch(b))
    assert rel(tl, jl) <= LOSS_RTOL
    for k in ("xent", "aux", "zloss"):
        assert tm[k].dtype == torch.float32 and tm[k].shape == ()
        assert abs(float(tm[k]) - float(jm[k])) <= \
            LOSS_RTOL * max(abs(float(jm[k])), 1e-6), k
    got, want = tree.leaves(tg), jax.tree_util.tree_leaves(jg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=GRAD_TOL * max(float(np.linalg.norm(w)), 1e-12))


def test_three_steps_match_reference_losses(monkeypatch):
    monkeypatch.setattr(JL, "PDT", jnp.float32)
    arch = "mamba2-130m"
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp, tp = f32_params(cfg, seed=5)
    ocfg = dict(lr=1e-3, warmup=2)
    jstep = jax.jit(JS.make_train_step(jcfg, JA.AdamWConfig(**ocfg)))
    tstep = S.make_train_step(cfg, adamw.AdamWConfig(**ocfg))
    jo, to = JA.init(jp), adamw.init(tp)
    for i in range(3):
        b = make_batch(cfg, 2, 16, seed=10 + i)
        jp, jo, jm = jstep(jp, jo, to_jax(b))
        tp, to, tm = tstep(tp, to, to_torch(b))
        for k in ("loss", "xent", "grad_norm"):
            assert rel(tm[k], jm[k]) <= LOSS_RTOL_3, (i, k)
    assert int(to.count) == 3 and to.count.dtype == torch.int32


# ---------------------------------------------------------------- AdamW
SHAPES = {"w": (48, 32), "blk": {"b": (7,), "k": (3, 5, 4)}}


def quarters(rng, shapes):
    """Multiples of 1/4 in [-8, 8] of ``SHAPES``' structure: each square
    and any sum of them exact in float32, so both sides' global norms are
    equal bit for bit."""
    return {k: quarters(rng, v) if isinstance(v, dict) else
            (rng.integers(-32, 33, v) / 4).astype(np.float32)
            for k, v in shapes.items()}


@pytest.mark.parametrize("dtype,clip,warmup", [
    ("bfloat16", 1.0, 5),       # clipped (norm ~ 200), in warm-up to step 5
    ("float32", 1e6, 1)])       # no clip, no warm-up
def test_adamw_update_matches_reference(dtype, clip, warmup):
    rng = np.random.default_rng(0)
    tdt = getattr(torch, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    p0 = quarters(rng, SHAPES)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), p0)
    tp = tree.map(lambda a: torch.from_numpy(a).to(tdt), p0)
    kw = dict(lr=3e-3, warmup=warmup, clip_norm=clip)
    jupd = jax.jit(lambda g, s, p: JA.update(g, s, p, JA.AdamWConfig(**kw)))
    js, ts = JA.init(jp), adamw.init(tp)
    clipped = []
    for _ in range(8):
        g = quarters(rng, SHAPES)
        jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), g)
        tg = tree.map(lambda a: torch.from_numpy(a).to(tdt), g)
        jp, js, jn = jupd(jg, js, jp)
        tp, ts, tn = adamw.update(tg, ts, tp, adamw.AdamWConfig(**kw))
        assert float(tn) == float(jn)
        clipped.append(float(jn) > clip)
        assert int(ts.count) == int(js.count)
        for mine, ref in ((ts.master, js.master), (ts.m, js.m),
                          (ts.v, js.v)):
            for a, b in zip(tree.leaves(mine), jax.tree_util.tree_leaves(ref)):
                b = np.asarray(b)
                assert a.dtype == torch.float32
                np.testing.assert_allclose(
                    a.numpy(), b, rtol=0,
                    atol=ADAM_TOL * max(float(np.abs(b).max()), 1e-30))
        for a, b in zip(tree.leaves(tp), jax.tree_util.tree_leaves(jp)):
            b = np.asarray(b.astype(jnp.float32))
            assert a.dtype == tdt
            np.testing.assert_allclose(a.float().numpy(), b, rtol=2 ** -8,
                                       atol=0)
    assert all(clipped) == (clip < 1e6)


def test_adamw_optimizes_quadratic():
    params = {"w": torch.tensor([3.0, -2.0], dtype=torch.bfloat16)}
    opt = adamw.init(params)
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup=1)

    def loss(p):
        return torch.sum(p["w"].float() ** 2)
    for _ in range(100):
        w = params["w"].detach().requires_grad_()
        g = torch.autograd.grad(loss({"w": w}), w)[0]
        params, opt, gn = adamw.update({"w": g}, opt, params, cfg)
    assert float(loss(params)) < 0.05
    # master stays float32 while params are bfloat16
    assert opt.master["w"].dtype == torch.float32
    assert params["w"].dtype == torch.bfloat16


# ---------------------------------------------------------------- smoke
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_smoke_train_step(arch):
    """Reduced config: one train step, finite loss, parameters changed."""
    cfg = get_config(arch).reduced()
    params = lm.init_params(lm.generator(42, "cpu"), cfg)
    opt = adamw.init(params)
    b = to_torch(make_batch(cfg, 2, 16, seed=0, masked=False))
    for k in ("frames", "patches"):
        if k in b:
            b[k] = b[k].to(torch.bfloat16)
    step = S.make_train_step(cfg, adamw.AdamWConfig(lr=1e-3))
    params2, opt2, m = step(params, opt, b)
    assert set(m) == {"loss", "xent", "aux", "zloss", "grad_norm"}
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    l0, l1 = tree.leaves(params)[0], tree.leaves(params2)[0]
    assert l1.dtype == l0.dtype and not torch.equal(l0, l1)
    assert int(opt2.count) == 1


# ---------------------------------------------------------------- remat
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-small"])
def test_remat_policies_give_identical_gradients(arch, monkeypatch):
    """A repeated group of a two-layer super-block (jamba) and the
    encoder layers (whisper): every policy's gradients equal remat off's
    bit for bit; with remat on, the checkpointed blocks run twice (the
    recompute); without grad, once, with the same forward."""
    cfg = get_config(arch).reduced()
    params = lm.init_params(lm.generator(0, "cpu"), cfg)
    b = to_torch(make_batch(cfg, 2, 16, seed=1, masked=False))
    if "frames" in b:
        b["frames"] = b["frames"].to(torch.bfloat16)
    calls = []
    block = lm._block_apply

    def counted(*a, **k):
        calls.append(1)
        return block(*a, **k)
    monkeypatch.setattr(lm, "_block_apply", counted)
    groups = lm.group_descs(lm.layer_descs(cfg))
    n_layers = sum(c * len(blk) for c, blk in groups) + cfg.n_enc_layers
    n_remat = sum(c * len(blk) for c, blk in groups if c > 1) + \
        cfg.n_enc_layers
    assert n_remat > 0
    out = {}
    for pol in ("none", "full", "dots"):
        monkeypatch.setattr(lm, "REMAT_POLICY", pol)
        calls.clear()
        out[pol] = S.value_and_grad(params, cfg, b)
        assert len(calls) == n_layers + (0 if pol == "none" else n_remat)
        with torch.no_grad():
            calls.clear()
            fwd, _ = lm.forward(params, cfg, b)
            assert len(calls) == n_layers
        out[pol + "_fwd"] = fwd
    for pol in ("full", "dots"):
        assert torch.equal(out[pol][0][0], out["none"][0][0])
        assert torch.equal(out[pol + "_fwd"], out["none_fwd"])
        for g, w in zip(tree.leaves(out[pol][1]),
                        tree.leaves(out["none"][1])):
            assert torch.equal(g, w)


def test_ssd_gradient_finite_where_the_reference_is_nan(monkeypatch):
    """Above the diagonal of an SSD chunk the decay's exponent is
    positive; where it overflows (here A = -exp(2) over a 32-token
    chunk), the reference's ``where(ltri, exp(diff), 0)`` has a NaN
    gradient (0 * inf), the port masks before the exp: the same loss, a
    finite gradient that equals the reference's wherever the reference's
    is finite."""
    monkeypatch.setattr(JL, "PDT", jnp.float32)
    arch = "mamba2-130m"
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    tp = lm.init_params(lm.generator(3, "cpu"), cfg)
    tp = tree.map(torch.Tensor.float, tp)
    tp["groups"][0]["p0"]["ssm"]["A_log"].fill_(2.0)
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    b = make_batch(cfg, 2, 32, seed=4)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, x: JS.loss_fn(p, jcfg, x), has_aux=True))(jp, to_jax(b))
    (tl, _), tg = S.value_and_grad(tp, cfg, to_torch(b))
    assert rel(tl, jl) <= LOSS_RTOL
    jn = float(JA.global_norm(jg))
    assert np.isnan(jn)
    assert np.isfinite(float(adamw.global_norm(tg)))
    for g, w in zip(tree.leaves(tg), jax.tree_util.tree_leaves(jg)):
        w = np.asarray(w)
        if np.isfinite(w).all():
            np.testing.assert_allclose(
                g.numpy(), w, rtol=0,
                atol=GRAD_TOL * max(float(np.linalg.norm(w)), 1e-12))
