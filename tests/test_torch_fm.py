"""The port's fused FM against the reference, bit for bit, on the CPU.

``fm_fused_plain`` (what the wrapper runs on CPU tensors) must equal the
reference's Pallas kernel in interpret mode and its independent jnp
oracle, across lane counts, locks, mixed move budgets (0 included),
passes and ``pos_only``.  Exact equality is the stated tolerance: every
float sum is over integer-valued float32 weights and the noise is drawn
by the same threefry sequence, so any reduction order gives the same
bits.
"""
import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import fm as jfm  # noqa: E402
from repro.kernels.fm_fused import fm_fused_multi as jax_fm_fused  # noqa: E402
from repro.kernels.fm_fused import fm_noise as jax_fm_noise  # noqa: E402
from repro.kernels.ref import fm_fused_ref  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.convert import key_from_array  # noqa: E402
from repro_torch.core import fm  # noqa: E402
from repro_torch.kernels import band_batch, fm_fused  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from orderbench import record  # noqa: E402
from orderbench.reference import pack as ref_pack  # noqa: E402

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


def _port(args, passes, pos_only, extents=False):
    nbr, vwgt, part, locked, keys, eps, mm, n_pert = args
    L = nbr.shape[0]
    out = fm_fused.fm_fused_multi(
        torch.from_numpy(nbr), torch.arange(L, dtype=torch.int32),
        torch.from_numpy(vwgt), torch.from_numpy(part),
        torch.from_numpy(locked), key_from_array(keys),
        torch.from_numpy(eps), torch.from_numpy(mm),
        torch.from_numpy(n_pert), passes=passes, pos_only=pos_only,
        extents=band_batch.row_extents(nbr) if extents else None)
    return [x.numpy() for x in out]


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
def test_fm_plain_matches_pallas_and_oracle(L, locks, budgets, passes,
                                            pos_only):
    args = _rand_lanes(100 * L + 10 * passes + locks, L, locks, budgets)
    jargs = [jnp.asarray(a) for a in args]
    fused = jax_fm_fused(*jargs, passes=passes, pos_only=pos_only,
                         interpret=True)
    nbr, vwgt, part, locked, keys, eps, mm, n_pert = jargs
    noise = jax_fm_noise(keys, N, passes)
    eps_abs = eps * vwgt.astype(jnp.float32).sum(axis=1)
    oracle = fm_fused_ref(nbr, vwgt, part, locked, noise, eps_abs, mm,
                          n_pert, passes=passes, pos_only=pos_only)
    got = _port(args, passes, pos_only)
    tag = f"L={L} locks={locks} {budgets} passes={passes} pos={pos_only}"
    _assert_same(got, fused, tag + " vs pallas")
    _assert_same(got, oracle, tag + " vs oracle")
    assert fm_fused.launches == 0            # CPU tensors never launch


@pytest.mark.parametrize("passes,pos_only", [(1, True), (3, False)])
@pytest.mark.parametrize("L", [1, 8])
def test_fm_with_extents_matches_pallas_and_oracle(L, passes, pos_only):
    """Given the tiles' row extents, as the executor now always passes
    them, the fused path still equals the reference's kernel and oracle."""
    args = _rand_lanes(1000 + 10 * L + passes, L, True, "mixed")
    jargs = [jnp.asarray(a) for a in args]
    fused = jax_fm_fused(*jargs, passes=passes, pos_only=pos_only,
                         interpret=True)
    nbr, vwgt, part, locked, keys, eps, mm, n_pert = jargs
    eps_abs = eps * vwgt.astype(jnp.float32).sum(axis=1)
    oracle = fm_fused_ref(nbr, vwgt, part, locked,
                          jax_fm_noise(keys, N, passes), eps_abs, mm, n_pert,
                          passes=passes, pos_only=pos_only)
    got = _port(args, passes, pos_only, extents=True)
    _assert_same(got, fused, "with extents vs pallas")
    _assert_same(got, oracle, "with extents vs oracle")


@pytest.mark.parametrize("L,passes,n", [(8, 3, 64), (3, 1, 5), (1, 2, 33)])
def test_fm_noise_on_cpu_keys_equals_reference(L, passes, n):
    """CPU keys take the plain version, which is the reference's draw."""
    jkeys = jax.random.split(jax.random.PRNGKey(L * n + passes), L)
    want = np.asarray(jax_fm_noise(jkeys, n, passes))
    keys = key_from_array(np.asarray(jkeys))
    got = fm_fused.fm_noise(keys, n, passes)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(fm_fused.fm_noise_plain(keys, n, passes).numpy(),
                          want)


def test_pack_fm_bucket_extents_equal_row_extents():
    works = [_work(fm, seed=1, k_inst=4, d=5), _work(fm, seed=2, k_inst=2)]
    host, _ = fm.pack_fm_bucket(works)
    want = band_batch.row_extents(host["nbr"])
    assert host["extents"].group == want.group
    assert torch.equal(host["extents"].row_len, want.row_len)
    assert host["extents"].row_len.shape == host["nbr"].shape[:2]


@pytest.mark.parametrize("mode", ["fused", "hoisted"])
def test_fm_refine_batch_needs_extents(mode):
    """Both kernel paths read the row extents, so ``fm_refine_batch``
    takes them from its caller and does not build them itself."""
    from repro_torch.kernels import ops
    works = [_work(fm, seed=1, k_inst=2)]
    host, _ = fm.pack_fm_bucket(works)
    extents = host.pop("extents")
    with pytest.raises(ValueError, match="extents"):
        ops.fm_refine_batch(**host, passes=1, mode=mode, device="cpu")
    got = ops.fm_refine_batch(**host, passes=1, mode=mode, device="cpu",
                              extents=extents)
    assert got[0].shape == host["parts"].shape


@pytest.mark.parametrize("entry", ["fused", "move_loop", "gain", "refine"])
@pytest.mark.parametrize("bad", ["lane_work", "row_len"])
def test_out_of_range_spans_raise_on_the_host(entry, bad):
    """The span checks left the card's wrappers (no host sync a call) but
    still hold on host tensors: the plain paths and ``fm_refine_batch``."""
    args = _rand_lanes(3, 2, False, "uniform")
    nbr, vwgt, part, locked, keys, eps, mm, n_pert = (
        torch.from_numpy(np.array(a)) for a in args)
    lane_work = torch.arange(2, dtype=torch.int32)
    extents = band_batch.row_extents(args[0])
    if bad == "lane_work":
        lane_work = torch.tensor([0, 2], dtype=torch.int32)   # 2 tiles
    else:
        row_len = extents.row_len.clone()
        row_len[1, 3] = D + 1                                 # past d
        extents = band_batch.RowExtents(row_len, extents.group)
    vw = vwgt.float()
    with pytest.raises(ValueError, match=bad):
        if entry == "fused":
            fm_fused.fm_fused_multi(nbr, lane_work, vwgt, part, locked,
                                    key_from_array(args[4]), eps, mm, n_pert,
                                    extents=extents)
        elif entry == "move_loop":
            fm_fused.fm_move_loop(
                nbr, lane_work, vw, part, locked, vw, vw,
                key_from_array(args[4]), 0, n_pert, eps, mm, vw[:, 0],
                vw[:, 0], extents=extents)
        elif entry == "gain":
            band_batch.sep_gain_multi(nbr, lane_work, vw, part,
                                      extents=extents)
        else:
            fm.fm_refine_multi(nbr, lane_work, vwgt, part, locked,
                               key_from_array(args[4]), eps, mm, n_pert,
                               extents=extents)


def test_shared_tiles_equal_per_lane_tiles():
    """Lanes naming one tile through lane_work equal lanes with copies."""
    args = _rand_lanes(5, 4, True, "mixed")
    nbr = args[0].copy()
    nbr[1], nbr[3] = nbr[0], nbr[2]
    per_lane = _port((nbr,) + args[1:], 3, False)
    nbr_t, vwgt, part, locked, keys, eps, mm, n_pert = (
        torch.from_numpy(nbr[[0, 2]]),) + tuple(
        torch.from_numpy(a) for a in args[1:4]) + (key_from_array(args[4]),) \
        + tuple(torch.from_numpy(a) for a in args[5:])
    shared = fm_fused.fm_fused_multi(
        nbr_t, torch.tensor([0, 0, 1, 1], dtype=torch.int32), vwgt, part,
        locked, keys, eps, mm, n_pert, passes=3)
    _assert_same([x.numpy() for x in shared], per_lane, "shared tiles")


def test_fm_wrapper_checks_inputs():
    args = _rand_lanes(1, 2, False, "uniform")
    nbr, vwgt, part, locked, keys, eps, mm, n_pert = (
        torch.from_numpy(np.array(a)) for a in args)
    lane_work = torch.arange(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        fm_fused.fm_fused_multi(nbr, lane_work, vwgt, part.long(), locked,
                                keys.long(), eps, mm, n_pert)
    with pytest.raises(ValueError):
        fm_fused.fm_fused_kernel(nbr, lane_work, vwgt.float(), part, locked,
                                 keys.long(), eps, mm, n_pert, passes=3)


# ------------------------------------------------------------------ #
# the executor: works, buckets, lanes
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


def test_mixed_budget_bucket_matches_singletons():
    specs = [(1, 5), (2, 40), (3, None), (4, 4096), (6, 0)]
    works = [_work(fm, seed=s, max_moves=m) for s, m in specs]
    assert len({w.bucket_key() for w in works}) == 1
    batched = fm.execute_fm_works(works, device="cpu")
    singles = [fm.execute_fm_works([w], device="cpu")[0] for w in works]
    _same_results(batched, singles, "batched vs singleton")


def test_execute_fm_works_matches_reference_executor():
    specs = [dict(seed=7, max_moves=9), dict(seed=8, max_moves=64, k_inst=3),
             dict(seed=9, n=70, d=6, passes=1),
             dict(seed=10, pos_only=True, n_pert=0),
             dict(seed=11, n=40, parts_init=np.random.default_rng(1).integers(
                 0, 3, (3, 40)).astype(np.int8), k_inst=5)]
    got = fm.execute_fm_works([_work(fm, **s) for s in specs], device="cpu")
    want = jfm.execute_fm_works([_work(jfm, **s) for s in specs],
                                mode="fused")
    _same_results(got, want, "port vs reference")
    part, sep_w, imb = fm.refine_parts(
        **{k: getattr(_work(fm, seed=3), k) for k in
           ("nbr", "vwgt", "part", "locked", "seed")}, k_inst=4,
        device="cpu")
    assert fm.separator_is_valid(_work(fm, seed=3).nbr, part) == \
        jfm.separator_is_valid(_work(fm, seed=3).nbr, part)


def test_pack_pads_lanes_with_zero_budget_copies():
    works = [_work(fm, seed=1, k_inst=4), _work(fm, seed=2, k_inst=2)]
    host, counts = fm.pack_fm_bucket(works)
    assert counts == [4, 2]
    assert host["nbr"].shape == (2, 64, 8)           # one tile per work
    assert host["lane_work"].tolist() == [0, 0, 0, 0, 1, 1, 0, 0]
    assert host["max_moves"][6:].tolist() == [0, 0]
    assert np.array_equal(host["keys"][6].numpy(), host["keys"][0].numpy())


def test_mixed_bucket_packs_the_keys_and_the_benchmarks_packing():
    """Works of ``k_inst`` 2, 5 (8 lanes) and 16 in one bucket, 26 real
    lanes: each work's keys are its own ``split(PRNGKey(seed), k)`` rows,
    the 6 padding lanes copies of lane 0, and the whole call equals the
    benchmark's independent packing of the same works."""
    works = [dataclasses.replace(_work(fm, seed=i, k_inst=k), seed=s)
             for i, (s, k) in enumerate([(2 ** 32 + 11, 2), (-4, 5),
                                         (2 ** 40 + 3, 16)])]
    host, counts = fm.pack_fm_bucket(works)
    assert counts == [2, 8, 16]
    want = torch.cat([prng.split(prng.PRNGKey(w.seed), k)
                      for w, k in zip(works, counts)])
    keys = host["keys"]
    assert keys.dtype == torch.int64 and keys.shape == (32, 2)
    assert torch.equal(keys[:26], want)
    assert torch.equal(keys[26:], keys[:1].expand(6, 2))
    ref = ref_pack.pack([record._work(w) for w in works])
    for f in ref_pack.FIELDS:
        got = host[f].numpy()
        assert got.shape == ref[f].shape, f
        if f == "eps_frac":
            assert np.array_equal(got, ref[f]), f
        else:
            assert np.array_equal(got.astype(np.int64),
                                  ref[f].astype(np.int64)), f
    w = dataclasses.replace(_work(fm, seed=6, n=40), seed=2 ** 33 + 5)
    args = {k: getattr(w, k) for k in ("nbr", "vwgt", "part", "locked",
                                        "seed")}
    got = fm.refine_parts(**args, k_inst=5, device="cpu")
    _same_results([got], [jfm.refine_parts(**args, k_inst=5)],
                  "refine_parts vs reference")


def test_bucket_key_budget_and_lane_count_helpers():
    for kw in [dict(max_moves=5), dict(max_moves=10_000), dict(),
               dict(passes=1), dict(pos_only=True), dict(n=130)]:
        a, b = _work(fm, **kw), _work(jfm, **kw)
        assert a.bucket_key() == b.bucket_key()
        assert a.effective_max_moves() == b.effective_max_moves()
    big = fm.FMWork(nbr=-np.ones((5000, 2), np.int32),
                    vwgt=np.ones(5000, np.int64),
                    part=np.full(5000, 2, np.int8),
                    locked=np.zeros(5000, bool), seed=0, max_moves=9999)
    assert big.effective_max_moves() == 4096
    for args in [(1, 16, True), (8, 16, True), (40, 16, True), (8, 16, False),
                 (8, 16, True, True)]:
        assert fm.fm_lane_count(*args) == jfm.fm_lane_count(*args)
