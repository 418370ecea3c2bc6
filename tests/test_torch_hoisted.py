"""The port's hoisted FM path and its oracle against the reference, on the CPU.

The hoisted pass loop (``core.fm.fm_refine_multi``: per pass, the gains
then one ``fm_move_loop``), the fused plain pass loop and the independent
per-lane oracle (``kernels.ref.fm_fused_ref``) must all give the bits of
the reference's hoisted path, fused kernel and oracle: one another across
the whole sweep, and the reference's on a few of its shapes (each is a
compile of the reference's own).  Exact equality is the stated tolerance:
every float sum is over integer-valued float32 weights and the noise is
drawn by the same threefry sequence.  Also here: the executor's mode
switches and the ordering under ``REPRO_FM_MODE=hoisted``.
"""
import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import fm as jfm  # noqa: E402
from repro.core.nd import nested_dissection as jax_nd  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.kernels.fm_fused import fm_fused_multi as jax_fused  # noqa: E402
from repro.kernels.fm_fused import fm_noise as jax_noise  # noqa: E402
from repro.kernels.ref import fm_fused_ref as jax_oracle  # noqa: E402
from repro_torch.convert import graph_from_arrays, key_from_array  # noqa: E402
from repro_torch.core import fm, nd  # noqa: E402
from repro_torch.kernels import band_batch, fm_fused, ops, ref  # noqa: E402

N, D = 32, 4


def _rand_lanes(seed, L, locks, budgets):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, N, (L, N, D)).astype(np.int32)
    nbr[rng.random((L, N, D)) < 0.4] = -1           # ragged rows
    vwgt = rng.integers(1, 4, (L, N)).astype(np.int32)
    part = rng.integers(0, 3, (L, N)).astype(np.int8)
    if locks:
        locked = rng.random((L, N)) < rng.uniform(0.0, 0.3, (L, 1))
    else:
        locked = np.zeros((L, N), bool)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed + 1), L))
    eps = np.full(L, 0.1, np.float32)
    if budgets == "mixed":                          # adaptive, 0 included
        mm = rng.integers(0, 2 * N, L).astype(np.int32)
        mm[0] = 0
    else:
        mm = np.full(L, N, np.int32)
    n_pert = np.full(L, 8, np.int32)
    return nbr, vwgt, part, locked, keys, eps, mm, n_pert


def _port_all(args, passes, pos_only):
    """The port's hoisted path (both gain modes), fused plain and oracle."""
    nbr, vwgt, part, locked, keys, eps, mm, n_pert = args
    L = nbr.shape[0]
    t = dict(nbr=torch.from_numpy(nbr),
             lane_work=torch.arange(L, dtype=torch.int32),
             vwgt=torch.from_numpy(vwgt), parts=torch.from_numpy(part),
             locked=torch.from_numpy(locked), keys=key_from_array(keys),
             eps_frac=torch.from_numpy(eps), max_moves=torch.from_numpy(mm),
             n_pert=torch.from_numpy(n_pert))
    out = {f"hoisted/{g}": fm.fm_refine_multi(**t, passes=passes,
                                              pos_only=pos_only, gain_mode=g)
           for g in ("jnp", "pallas")}
    out["fused"] = fm_fused.fm_fused_multi(**t, passes=passes,
                                           pos_only=pos_only)
    out["oracle"] = ops.fm_refine_batch(**t, passes=passes,
                                        pos_only=pos_only, mode="oracle",
                                        device="cpu")
    return {k: [x.numpy() for x in v] for k, v in out.items()}


def _assert_same(got, want, what):
    for name, x, y in zip(("parts", "sep_w", "imb"), got, want):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype, f"{what}: {name} dtype {x.dtype} {y.dtype}"
        assert np.array_equal(x, y), \
            f"{what}: {name} differs ({(x != y).sum()} mismatches)"


@pytest.mark.parametrize("pos_only", [False, True])
@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("budgets", ["uniform", "mixed"])
@pytest.mark.parametrize("locks", [False, True])
@pytest.mark.parametrize("L", [1, 3, 8])
def test_hoisted_and_oracle_equal_reference(L, locks, budgets, passes,
                                            pos_only):
    args = _rand_lanes(100 * L + 10 * passes + locks, L, locks, budgets)
    before = (band_batch.gain_launches, fm_fused.move_loop_launches)
    got = _port_all(args, passes, pos_only)
    tag = f"L={L} locks={locks} {budgets} passes={passes} pos={pos_only}"
    # across the whole sweep every port path gives the fused plain
    # version's bits; test_torch_fm.py holds that version to the
    # reference's fused kernel and oracle across the same sweep
    for gname, g in got.items():
        _assert_same(g, got["fused"], f"{tag}: port {gname} vs port fused")
    if L == 3 and locks and budgets == "mixed" and passes == 3:
        # the reference's own paths, on a few shapes: each shape of its
        # hoisted loop is a compile of its own
        j = [jnp.asarray(a) for a in args]
        want = {"reference hoisted": jfm.fm_refine_multi(
            *j, passes=passes, pos_only=pos_only, gain_mode="jnp")}
        if not pos_only:
            want["reference fused"] = jax_fused(*j, passes=passes,
                                                pos_only=pos_only,
                                                interpret=True)
            eps_abs = j[5] * j[1].astype(jnp.float32).sum(axis=1)
            want["reference oracle"] = jax_oracle(
                j[0], j[1], j[2], j[3], jax_noise(j[4], N, passes),
                eps_abs, j[6], j[7], passes=passes, pos_only=pos_only)
        for gname, g in got.items():
            for wname, w in want.items():
                _assert_same(g, w, f"{tag}: port {gname} vs {wname}")
    # CPU tensors never launch
    assert (band_batch.gain_launches, fm_fused.move_loop_launches) == before


@pytest.mark.parametrize("passes,pos_only", [(3, False), (1, True)])
@pytest.mark.parametrize("L", [3, 8])
def test_hoisted_with_extents_equals_reference(L, passes, pos_only):
    """Given the tiles' row extents, which its gain and move-loop kernels
    read on the card, the hoisted path still gives the reference's bits."""
    args = _rand_lanes(500 + 10 * L + passes, L, True, "mixed")
    nbr, vwgt, part, locked, keys, eps, mm, n_pert = args
    got = fm.fm_refine_multi(
        torch.from_numpy(nbr), torch.arange(L, dtype=torch.int32),
        torch.from_numpy(vwgt), torch.from_numpy(part),
        torch.from_numpy(locked), key_from_array(keys),
        torch.from_numpy(eps), torch.from_numpy(mm),
        torch.from_numpy(n_pert), passes=passes, pos_only=pos_only,
        gain_mode="pallas", extents=band_batch.row_extents(nbr))
    j = [jnp.asarray(a) for a in args]
    want = jfm.fm_refine_multi(*j, passes=passes, pos_only=pos_only,
                               gain_mode="jnp")
    _assert_same([x.numpy() for x in got], want, "hoisted with extents")
    eps_abs = j[5] * j[1].astype(jnp.float32).sum(axis=1)
    oracle = jax_oracle(j[0], j[1], j[2], j[3], jax_noise(j[4], N, passes),
                        eps_abs, j[6], j[7], passes=passes,
                        pos_only=pos_only)
    _assert_same([x.numpy() for x in got], oracle, "vs reference oracle")


def test_move_loop_carries_bimb_and_leaves_inputs():
    """One pass of ``fm_move_loop`` keeps the carried best imbalance when
    no move beats it, returns dummy lanes unchanged and writes nothing
    back into its inputs."""
    nbr, vwgt, part, locked, keys, eps, mm, n_pert = \
        _rand_lanes(7, 3, True, "mixed")
    t = [torch.from_numpy(a) for a in (nbr, vwgt, part, locked)]
    lw = torch.arange(3, dtype=torch.int32)
    vw = t[1].float()
    p0, p1 = band_batch.sep_gain_multi(t[0], lw, vw, t[2])
    bws = torch.full((3,), -1.0)                # nothing can beat these
    bimb = torch.tensor([0.5, 1.5, 2.5])
    inputs = [x.clone() for x in (t[2], p0, p1, bws, bimb)]
    part_out, bws_out, bimb_out = fm_fused.fm_move_loop(
        t[0], lw, vw, t[2], t[3], p0, p1, key_from_array(keys), 0,
        torch.from_numpy(n_pert),
        torch.from_numpy(eps) * vw.sum(1), torch.from_numpy(mm), bws, bimb)
    assert torch.equal(part_out, t[2])
    assert torch.equal(bws_out, bws) and torch.equal(bimb_out, bimb)
    for x, y in zip(inputs, (t[2], p0, p1, bws, bimb)):
        assert torch.equal(x, y)


# ------------------------------------------------------------------ #
# the executor: modes, switches, and the ordering
# ------------------------------------------------------------------ #
def _work(mod, n=30, d=4, seed=5, **kw):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n, (n, d)).astype(np.int32)
    nbr[rng.random((n, d)) < 0.3] = -1
    kw.setdefault("vwgt", np.ones(n, np.int64))
    kw.setdefault("part", rng.integers(0, 3, n).astype(np.int8))
    kw.setdefault("locked", np.zeros(n, bool))
    return mod.FMWork(nbr=nbr, seed=seed, **kw)


def _same_results(a, b, what):
    for i, (x, y) in enumerate(zip(a, b)):
        assert np.array_equal(x[0], y[0]), f"{what} work {i}: part"
        assert x[1] == y[1] and x[2] == y[2], f"{what} work {i}: sep/imb"


@pytest.mark.parametrize("mode", ["fused", "hoisted", "oracle"])
def test_mixed_budget_bucket_matches_singletons(mode):
    specs = [(1, 5), (2, 40), (3, None), (4, 4096), (6, 0)]
    works = [_work(fm, seed=s, max_moves=m) for s, m in specs]
    assert len({w.bucket_key() for w in works}) == 1
    batched = fm.execute_fm_works(works, device="cpu", mode=mode)
    singles = [fm.execute_fm_works([w], device="cpu", mode=mode)[0]
               for w in works]
    _same_results(batched, singles, f"{mode}: batched vs singleton")


def test_executor_modes_agree_with_reference(monkeypatch):
    specs = [dict(seed=7, max_moves=9), dict(seed=8, max_moves=64, k_inst=3),
             dict(seed=10, pos_only=True, n_pert=0)]
    works = [_work(fm, **s) for s in specs]
    want = jfm.execute_fm_works([_work(jfm, **s) for s in specs],
                                mode="hoisted", gain_mode="jnp")
    for mode in ("fused", "hoisted", "oracle"):
        _same_results(fm.execute_fm_works(works, device="cpu", mode=mode),
                      want, f"port {mode} vs reference hoisted")

    def no_fused(*_, **__):
        raise AssertionError("the fused path ran")
    # an explicit gain mode without a mode takes the hoisted path
    monkeypatch.setattr(ops, "fm_fused_multi", no_fused)
    for gain in ("jnp", "pallas"):
        _same_results(fm.execute_fm_works(works, device="cpu",
                                          gain_mode=gain),
                      want, f"gain_mode={gain}")


def test_mode_and_gain_switches(monkeypatch):
    works = [_work(fm, seed=7, max_moves=9)]
    monkeypatch.setenv("REPRO_FM_MODE", "hoisted")
    assert ops.fm_mode_default() == "hoisted"
    monkeypatch.setenv("REPRO_FM_MODE", "auto")
    assert ops.fm_mode_default() == "fused"
    monkeypatch.setenv("REPRO_FM_MODE", "bogus")
    with pytest.raises(ValueError):
        fm.execute_fm_works(works, device="cpu")
    with pytest.raises(ValueError):
        fm.execute_fm_works(works, device="cpu", mode="bogus")
    monkeypatch.setenv("REPRO_FM_GAIN", "auto")
    assert fm.gain_mode_default("cpu") == "jnp"
    monkeypatch.setenv("REPRO_FM_GAIN", "pallas")
    assert fm.gain_mode_default("cpu") == "pallas"
    monkeypatch.setenv("REPRO_FM_GAIN", "bogus")
    with pytest.raises(ValueError):
        fm.execute_fm_works(works, device="cpu", mode="hoisted")


def test_nested_dissection_hoisted_equals_reference(monkeypatch):
    jg = jgen.grid2d(16, 16)
    g = graph_from_arrays(jg.xadj, jg.adjncy, jg.vwgt, jg.adjwgt)
    want = jax_nd(jg, seed=0, nproc=4)

    def no_fused(*_, **__):
        raise AssertionError("the fused path ran")
    monkeypatch.setattr(ops, "fm_fused_multi", no_fused)
    monkeypatch.setenv("REPRO_FM_MODE", "hoisted")
    got = nd.nested_dissection(g, seed=0, nproc=4, device="cpu")
    assert np.array_equal(got, want)


def test_oracle_runs_where_its_inputs_lie():
    args = _rand_lanes(3, 2, True, "uniform")
    nbr, vwgt, part, locked, keys, eps, mm, n_pert = args
    noise = fm_fused.fm_noise(key_from_array(keys), N, 2)
    vw = torch.from_numpy(vwgt).float()
    out = ref.fm_fused_ref(torch.from_numpy(nbr), vw,
                           torch.from_numpy(part), torch.from_numpy(locked),
                           noise, torch.from_numpy(eps) * vw.sum(1),
                           torch.from_numpy(mm), torch.from_numpy(n_pert),
                           passes=2)
    assert out[0].dtype == torch.int8 and out[0].shape == (2, N)
    assert all(x.device.type == "cpu" for x in out)
