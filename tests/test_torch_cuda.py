"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: on a host without an NVIDIA card every test here skips
(the kernels have no CPU mode).  On the card, run

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Exact equality is the stated tolerance for the FM, BFS, gain and matching
kernels, as in
the CPU parity tests (integer-valued float32 sums); the ELL kernels are
held to the reference tests' tolerances (1e-5 float32 SpMV, 5e-2
bfloat16, 1e-4 diffusion), at sizes that are no multiple of any block,
and the bfloat16 SpMV's rounding of each product is checked exactly.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core import fm
from repro_torch.core.nd import nested_dissection
from repro_torch.graphs.generators import grid3d, rgg2d
from repro_torch.core.coarsen import match_graph
from repro_torch.kernels import band_batch, diffusion, ell_spmv, fm_fused, ops
from repro_torch.kernels import matching

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _lanes(seed, L, n, d):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n, (L, n, d)).astype(np.int32)
    nbr[rng.random((L, n, d)) < 0.4] = -1
    vwgt = rng.integers(1, 4, (L, n)).astype(np.float32)
    part = rng.integers(0, 3, (L, n)).astype(np.int8)
    locked = rng.random((L, n)) < 0.2
    mm = rng.integers(0, min(2 * n, 200), L).astype(np.int32)
    return nbr, vwgt, part, locked, mm


def _planned_launches(plan, steps: int) -> int:
    """Launches of one call in the design ``band_batch.lane_plan`` gives:
    one on the cluster design, ``steps`` + 1 on the grid design."""
    return 1 if plan[0] == "cluster" else steps + 1


@pytest.mark.parametrize("width", [0, 1, 3, 7])
@pytest.mark.parametrize("L,n,d", [(1, 64, 8), (8, 256, 16), (3, 100, 40),
                                   (2, 2048, 8), (1, 5000, 16),
                                   (3, 9000, 2), (1, 32768, 8),
                                   (2, 2 ** 17, 8), (1, 40000, 8),
                                   (2, 256, 1024)])
def test_bfs_kernel_equals_plain(card, L, n, d, width):
    nbr, _, part, _, _ = _lanes(L + n, L, n, d)
    nbr_c = torch.from_numpy(nbr).to(card)
    src = torch.from_numpy((part == 2).astype(np.int32)).to(card)
    before = band_batch.launches
    got = band_batch.bfs_multi(nbr_c, src, width)
    assert band_batch.launches == before + _planned_launches(
        band_batch.lane_plan(n, d), width)
    assert torch.equal(got, band_batch.bfs_multi_plain(nbr_c, src, width))


def _fm_args(card, nbr, vwgt, part, locked, mm, passes, seed):
    """The fused kernel's inputs on the card, one tile a lane, and the
    tiles' extents; the kernel draws its noise from the keys."""
    L, n, _ = nbr.shape
    t = [torch.from_numpy(a).to(card) for a in (nbr, vwgt, part, locked, mm)]
    keys = prng.split(prng.PRNGKey(seed, card), L)
    vw = t[1]
    args = (t[0], torch.arange(L, dtype=torch.int32, device=card), vw, t[2],
            t[3], keys, torch.full((L,), 0.1, device=card) * vw.sum(1), t[4],
            torch.full((L,), 8, dtype=torch.int32, device=card))
    return args, band_batch.row_extents(nbr).to(card)


def _move_loop_args(card, nbr, vwgt, part, locked, mm, seed, p=0):
    """Pass p's move-loop inputs on the card, the gains from the plain
    version, and the tiles' extents."""
    L, n, _ = nbr.shape
    t = [torch.from_numpy(a).to(card) for a in (nbr, vwgt, part, locked, mm)]
    lw = torch.arange(L, dtype=torch.int32, device=card)
    vw = t[1]
    p0, p1 = band_batch.sep_gain_multi_plain(t[0], lw, vw, t[2])
    keys = prng.split(prng.PRNGKey(seed, card), L)
    ws = (vw * (t[2] == 2)).sum(1)
    bimb = ((vw * (t[2] == 0)).sum(1) - (vw * (t[2] == 1)).sum(1)).abs()
    args = (t[0], lw, vw, t[2], t[3], p0, p1, keys, p,
            torch.full((L,), 8, dtype=torch.int32, device=card),
            torch.full((L,), 0.1, device=card) * vw.sum(1), t[4], ws, bimb)
    return args, band_batch.row_extents(nbr).to(card)


@pytest.mark.parametrize("passes,pos_only", [(3, False), (1, True)])
@pytest.mark.parametrize("L,n,d", [(3, 64, 8), (8, 256, 16), (2, 32768, 8)])
def test_fm_kernel_equals_plain(card, L, n, d, passes, pos_only):
    args, extents = _fm_args(card, *_lanes(7 * L + n, L, n, d), passes, L)
    want = fm_fused.fm_fused_plain(*args, passes=passes, pos_only=pos_only)
    got = fm_fused.fm_fused_kernel(*args, passes=passes, pos_only=pos_only,
                                   extents=extents)
    for a, b in zip(got[:3], want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):     # the kernel reads the row extents
        fm_fused.fm_fused_kernel(*args, passes=passes)


def _anchor_bucket(seed, L, n, d):
    """Band-like lanes: rows of a few ids, two anchor rows of about 0.9 d
    ids, locked, as the band of a separator has."""
    rng = np.random.default_rng(seed)
    nbr = -np.ones((L, n, d), np.int32)
    nbr[:, :, :6] = rng.integers(0, n, (L, n, 6))
    nbr[:, :2, :int(0.9 * d)] = rng.integers(0, n, (L, 2, int(0.9 * d)))
    nbr[rng.random((L, n, d)) < 0.1] = -1
    vwgt = rng.integers(1, 4, (L, n)).astype(np.float32)
    vwgt[:, :2] = n // 4
    part = rng.integers(0, 3, (L, n)).astype(np.int8)
    part[:, 0], part[:, 1] = 0, 1
    locked = rng.random((L, n)) < 0.05
    locked[:, :2] = True
    mm = np.full(L, 2 * int((part == 2).sum(1).max()) + 16, np.int32)
    return nbr, vwgt, part, locked, np.minimum(mm, min(n, 4096))


def _capped_bucket(seed, L, n, d):
    """Lanes whose separator is most of the graph: a budget of 4096 moves,
    the executor's cap, is used up, so the move journal runs long."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n, (L, n, d)).astype(np.int32)
    nbr[rng.random((L, n, d)) < 0.3] = -1
    vwgt = rng.integers(1, 3, (L, n)).astype(np.float32)
    part = np.where(rng.random((L, n)) < 0.7, 2,
                    rng.integers(0, 2, (L, n))).astype(np.int8)
    return nbr, vwgt, part, np.zeros((L, n), bool), \
        np.full(L, 4096, np.int32)


@pytest.mark.parametrize("bucket", ["anchor", "capped"])
def test_fm_kernels_equal_plain_at_anchor_and_capped_buckets(card, bucket):
    if bucket == "anchor":
        lanes, passes = _anchor_bucket(11, 3, 2048, 1024), 3
    else:
        lanes, passes = _capped_bucket(12, 2, 8192, 8), 1
    args, extents = _fm_args(card, *lanes, passes, 5)
    got = fm_fused.fm_fused_kernel(*args, passes=passes, extents=extents)
    want = fm_fused.fm_fused_plain(*args, passes=passes)
    for a, b in zip(got[:3], want):
        assert torch.equal(a, b)
    if bucket == "capped":                      # every lane used its budget
        assert got[3][:, 0].tolist() == [4096] * 2
    args, extents = _move_loop_args(card, *lanes, 6)
    got = fm_fused.fm_move_loop_kernel(*args, extents=extents)
    for a, b in zip(got[:3], fm_fused.fm_move_loop_plain(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("L,n,d,passes", [
    (3, 100, 8, 3),         # hot state and noise pairs in shared memory
    (4, 4096, 16, 2),       # the same, near the pairs' limit
    (2, 8192, 1024, 3),     # the band bucket's shape: the pairs in scratch
    (2, 32768, 8, 3)])      # all of the state in scratch
def test_fm_kernels_draw_the_plain_noise(card, L, n, d, passes):
    """Both FM kernels, drawing their noise in place, equal their plain
    versions, which draw with ``fm_noise_plain``, at every pass."""
    lanes = _lanes(3 * L + n + d, L, n, d)
    for seed in (0, 7, 2 ** 31 - 1):
        args, extents = _fm_args(card, *lanes, passes, seed)
        got = fm_fused.fm_fused_kernel(*args, passes=passes, extents=extents)
        for a, b in zip(got[:3], fm_fused.fm_fused_plain(*args,
                                                         passes=passes)):
            assert torch.equal(a, b)
        for p in range(passes):
            args, extents = _move_loop_args(card, *lanes, seed, p)
            got = fm_fused.fm_move_loop_kernel(*args, extents=extents)
            for a, b in zip(got[:3], fm_fused.fm_move_loop_plain(*args)):
                assert torch.equal(a, b)


def test_fm_noise_refuses_card_keys(card):
    """On the card the kernels draw the noise: ``fm_noise`` makes no noise
    tensor there and runs no plain torch."""
    keys = prng.split(prng.PRNGKey(3, card), 4)
    with pytest.raises(ValueError):
        fm_fused.fm_noise(keys, 64, 3)


def _no_plain_noise(*_, **__):
    raise AssertionError("a noise tensor was drawn on the card path")


def test_nested_dissection_card_equals_cpu(card, monkeypatch):
    for g in (grid3d(7, 7, 7), rgg2d(400, seed=2)):
        band_batch.launches = fm_fused.launches = matching.launches = 0
        with monkeypatch.context() as m:
            m.setattr(fm_fused, "fm_noise_plain", _no_plain_noise)
            p_card = nested_dissection(g, seed=1, nproc=4, device=card)
        assert band_batch.launches > 0 and fm_fused.launches > 0
        assert matching.launches > 0
        assert np.array_equal(p_card, nested_dissection(g, seed=1, nproc=4,
                                                        device="cpu"))


@pytest.mark.parametrize("L,W,n,d", [(1, 1, 64, 8), (8, 2, 256, 16),
                                     (3, 3, 100, 40), (5, 2, 1000, 1)])
def test_gain_kernel_equals_plain(card, L, W, n, d):
    rng = np.random.default_rng(L + n + d)
    nbr = rng.integers(0, n, (W, n, d)).astype(np.int32)
    nbr[rng.random((W, n, d)) < 0.4] = -1
    t = [torch.from_numpy(a).to(card) for a in (
        nbr, rng.integers(0, W, L).astype(np.int32),
        rng.integers(0, 4, (L, n)).astype(np.float32),
        rng.integers(0, 4, (L, n)).astype(np.int8))]
    before = band_batch.gain_launches
    got = band_batch.sep_gain_multi(
        *t, extents=band_batch.row_extents(nbr).to(card))
    assert band_batch.gain_launches == before + 1
    for a, b in zip(got, band_batch.sep_gain_multi_plain(*t)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):     # the kernel reads the row extents
        band_batch.sep_gain_multi(*t)


@pytest.mark.parametrize("pos_only", [False, True])
@pytest.mark.parametrize("L,n,d", [(3, 64, 8), (8, 256, 16), (2, 1000, 40)])
def test_move_loop_kernel_equals_plain(card, L, n, d, pos_only):
    args, extents = _move_loop_args(card, *_lanes(5 * L + n, L, n, d), L)
    before = fm_fused.move_loop_launches
    got = fm_fused.fm_move_loop(*args, pos_only=pos_only, extents=extents)
    assert fm_fused.move_loop_launches == before + 1
    want = fm_fused.fm_move_loop_plain(*args, pos_only=pos_only)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_hoisted_pass_loop_equals_fused(card):
    L, n, d = 8, 256, 16
    nbr, vwgt, part, locked, mm = _lanes(3, L, n, d)
    mm[6:] = 0                                          # dummy lanes
    t = dict(nbr=torch.from_numpy(nbr[:2]).to(card),
             lane_work=torch.tensor([0, 0, 0, 1, 1, 1, 0, 0],
                                    dtype=torch.int32, device=card),
             vwgt=torch.from_numpy(vwgt).to(card),
             parts=torch.from_numpy(part).to(card),
             locked=torch.from_numpy(locked).to(card),
             keys=prng.split(prng.PRNGKey(4, card), L),
             eps_frac=torch.full((L,), 0.1, device=card),
             max_moves=torch.from_numpy(mm).to(card),
             n_pert=torch.full((L,), 8, dtype=torch.int32, device=card))
    extents = band_batch.row_extents(nbr[:2]).to(card)
    fused = fm_fused.fm_fused_multi(**t, passes=3, extents=extents)
    got = fm.fm_refine_multi(**t, passes=3, gain_mode="pallas",
                             extents=extents)
    for a, b in zip(got, fused):
        assert torch.equal(a, b)
    # the plain gains and the oracle have no kernel: on the card they raise
    # rather than run plain torch there
    with pytest.raises(ValueError):
        fm.fm_refine_multi(**t, passes=3, gain_mode="jnp")
    with pytest.raises(ValueError):
        ops.fm_refine_batch(**t, passes=3, mode="oracle", device=card)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 5e-2)])
@pytest.mark.parametrize("n,d", [(1000, 1), (4097, 8), (300, 33), (4099, 4),
                                 (100003, 16), (333, 12), (5001, 5)])
def test_spmv_kernel_equals_plain(card, n, d, dtype, tol):
    """Both paths of the kernel, at ragged n: the vector path (d of 4, 8,
    12, 16 in float32; 8, 16 in bfloat16) and the group path (the rest)."""
    rng = np.random.default_rng(n + d)
    nbr = rng.integers(0, n, (n, d)).astype(np.int32)
    nbr[rng.random((n, d)) < 0.3] = -1
    dt = getattr(torch, dtype)
    nbr_c = torch.from_numpy(nbr).to(card)
    val = torch.from_numpy(rng.standard_normal((n, d))).to(card, dt)
    x = torch.from_numpy(rng.standard_normal(n)).to(card, dt)
    before = ell_spmv.launches
    got = ops.spmv(nbr_c, val, x)
    assert ell_spmv.launches == before + 1 and got.dtype == dt
    want = ell_spmv.ell_spmv_plain(nbr_c, val, x)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_spmv_kernel_rounds_each_bfloat16_product(card):
    """The rows of ``test_spmv_bfloat16_rounds_each_product`` through the
    kernel: exact sum 2^-14, sum of the rounded products 0."""
    nbr = torch.tensor([[0, 1, -1]] * 2, dtype=torch.int32, device=card)
    val = torch.tensor([[1.0 + 2 ** -7, -1.0, 5.0]] * 2,
                       dtype=torch.bfloat16, device=card)
    x = torch.tensor([1.0 + 2 ** -7, 1.0 + 2 ** -6], dtype=torch.bfloat16,
                     device=card)
    assert ell_spmv.ell_spmv_kernel(nbr, val, x).tolist() == [0.0, 0.0]
    exact = ell_spmv.ell_spmv_kernel(nbr, val.float(), x.float())
    assert exact.tolist() == [2 ** -14] * 2


@pytest.mark.parametrize("n,d", [
    (1000, 4), (4097, 8), (333, 12), (100003, 16),    # the vector path
    (4097, 3), (5001, 5), (300, 33), (4097, 9)])      # the group path
def test_diffusion_kernel_equals_plain(card, n, d):
    rng = np.random.default_rng(n * d)
    nbr = rng.integers(0, n, (n, d)).astype(np.int32)
    nbr[rng.random((n, d)) < 0.3] = -1
    val = np.abs(rng.standard_normal((n, d))).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    x[::7] = 0.0                                        # sign(0) = 0
    inj = np.zeros(n, np.float32)
    inj[:3], inj[-3:] = 0.5, -0.5
    t = [torch.from_numpy(a).to(card) for a in (nbr, val, x, inj)]
    before = diffusion.launches
    got = ops.diffuse(*t, steps=3)
    assert diffusion.launches == before + 3
    want = t[2]
    for _ in range(3):
        want = diffusion.diffusion_step_plain(t[0], t[1], want, t[3])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_diffusion_group_path_for_unaligned_arrays(card):
    """Ids and values that do not start on 16 bytes take the group path."""
    rng = np.random.default_rng(5)
    n, d = 2049, 8
    nbr = torch.from_numpy(rng.integers(-1, n, (n + 1, d)).astype(
        np.int32)).to(card)[1:]                     # offset by one row ...
    val = torch.from_numpy(np.abs(rng.standard_normal(n * d + 1)).astype(
        np.float32)).to(card)[1:].view(n, d)        # ... and by 4 bytes
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(card)
    inj = torch.zeros(n, device=card)
    inj[:3], inj[-3:] = 0.5, -0.5
    got, want = x, x
    for _ in range(3):
        got = diffusion.diffusion_step_kernel(nbr, val, got, inj)
        want = diffusion.diffusion_step_plain(nbr, val, want, inj)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_nested_dissection_hoisted_card_equals_cpu(card, monkeypatch):
    g = grid3d(7, 7, 7)
    want = nested_dissection(g, seed=1, nproc=4, device="cpu")
    monkeypatch.setenv("REPRO_FM_MODE", "hoisted")
    monkeypatch.setattr(fm_fused, "fm_noise_plain", _no_plain_noise)
    band_batch.gain_launches = fm_fused.move_loop_launches = 0
    fm_fused.launches = 0
    got = nested_dissection(g, seed=1, nproc=4, device=card)
    assert band_batch.gain_launches > 0 and fm_fused.move_loop_launches > 0
    assert fm_fused.launches == 0
    assert np.array_equal(got, want)


def _match_bucket(seed, L, n, d, weights="small"):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n, (L, n, d)).astype(np.int32)
    nbr[rng.random((L, n, d)) < 0.4] = -1
    if weights == "small":
        w = rng.integers(1, 4, (L, n, d))
    elif weights == "tied":
        w = np.full((L, n, d), 2 ** 24)
    else:
        w = rng.integers(-2 ** 31, 2 ** 31, (L, n, d))
    return nbr, np.where(nbr >= 0, w, 0).astype(np.int32)


@pytest.mark.parametrize("rounds", [0, 1, 8])
@pytest.mark.parametrize("L,n,d,weights", [
    (1, 64, 8, "small"), (4, 128, 8, "small"), (3, 64, 32, "small"),
    (2, 256, 16, "small"), (3, 128, 8, "tied"), (3, 128, 8, "int32"),
    (2, 3000, 16, "tied"), (1, 32768, 8, "small"), (3, 8192, 32, "int32"),
    (3, 9000, 2, "small"), (1, 16384, 1, "small"), (2, 2 ** 17, 8, "small"),
    (1, 40000, 8, "small"), (2, 256, 1024, "small")])
def test_matching_kernel_equals_plain(card, L, n, d, weights, rounds):
    nbr, wgt = (torch.from_numpy(a).to(card)
                for a in _match_bucket(L * n + d, L, n, d, weights))
    keys = prng.split(prng.PRNGKey(L + d, card), L)
    before = matching.launches
    got = matching.heavy_edge_matching_multi(nbr, wgt, keys, rounds=rounds)
    assert matching.launches == before + _planned_launches(
        band_batch.lane_plan(n, d), 2 * rounds)
    want = matching.heavy_edge_matching_multi_plain(nbr, wgt, keys, rounds)
    assert torch.equal(got, want)


def test_match_graph_card_equals_cpu(card):
    for g in (grid3d(9, 8, 7), rgg2d(500, seed=3)):
        for seed in (0, 5):
            before = matching.launches
            got = match_graph(g, seed, device=card)
            assert matching.launches > before
            assert np.array_equal(got, match_graph(g, seed, device="cpu"))


@pytest.mark.parametrize("L,W,n,d", [(1, 1, 64, 8), (8, 2, 256, 16),
                                     (3, 3, 100, 40), (4, 2, 300, 1024)])
def test_gain_kernel_with_row_len_equals_plain(card, L, W, n, d):
    rng = np.random.default_rng(L + n + d)
    nbr = rng.integers(0, n, (W, n, d)).astype(np.int32)
    ends = rng.integers(0, min(d, 12) + 1, (W, n))
    ends[:, ::97] = d                                   # anchor-like rows
    nbr[np.arange(d)[None, None, :] >= ends[..., None]] = -1
    nbr[rng.random((W, n, d)) < 0.3] = -1               # -1 inside extents
    t = [torch.from_numpy(a).to(card) for a in (
        nbr, rng.integers(0, W, L).astype(np.int32),
        rng.integers(0, 4, (L, n)).astype(np.float32),
        rng.integers(0, 4, (L, n)).astype(np.int8))]
    extents = band_batch.row_extents(nbr)
    before = band_batch.gain_launches
    got = band_batch.sep_gain_multi(*t, extents=extents.to(card))
    assert band_batch.gain_launches == before + 1
    for a, b in zip(got, band_batch.sep_gain_multi_plain(*t)):
        assert torch.equal(a, b)
    # every group width takes each row to its extent
    for group in (1, 4, 32):
        got = band_batch.sep_gain_multi(
            *t, extents=band_batch.RowExtents(extents.row_len.to(card), group))
        for a, b in zip(got, band_batch.sep_gain_multi_plain(*t)):
            assert torch.equal(a, b)


def test_spmv_group_path_for_unaligned_arrays(card):
    """Arrays that do not start on 16 bytes take the group path."""
    rng = np.random.default_rng(2)
    n, d = 2049, 8
    nbr = torch.from_numpy(rng.integers(-1, n, (n + 1, d)).astype(
        np.int32)).to(card)[1:]                     # offset by one row ...
    val = torch.from_numpy(rng.standard_normal(n * d + 1).astype(
        np.float32)).to(card)[1:].view(n, d)        # ... and by 4 bytes
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(card)
    torch.testing.assert_close(ell_spmv.ell_spmv_kernel(nbr, val, x),
                               ell_spmv.ell_spmv_plain(nbr, val, x),
                               rtol=1e-5, atol=1e-5)


def test_kernels_read_a_bad_lane_work_as_an_empty_tile(card):
    """The wrappers do not read ``lane_work`` back to check it: a lane that
    names no tile reads none (no pulled weight, no neighbour)."""
    L, n, d = 2, 256, 8
    nbr, vwgt, part, locked, mm = _lanes(9, L, n, d)
    args, extents = _fm_args(card, nbr, vwgt, part, locked, mm, 1, 3)
    bad = torch.tensor([0, 5], dtype=torch.int32, device=card)
    p0, p1 = band_batch.sep_gain_multi(args[0], bad, args[2], args[3],
                                       extents=extents)
    assert not p0[1].any() and not p1[1].any()
    empty = torch.full_like(args[0][:1], -1)
    want = fm_fused.fm_fused_plain(torch.cat([args[0][:1], empty]),
                                   torch.tensor([0, 1], dtype=torch.int32,
                                                device=card),
                                   *args[2:], passes=1)
    got = fm_fused.fm_fused_kernel(args[0], bad, *args[2:], passes=1,
                                   extents=extents)
    torch.cuda.synchronize()
    for a, b in zip(got[:3], want):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ #
# the service slice: many lanes a call, lanes of many requests
# ------------------------------------------------------------------ #
#: multi-lane buckets of the service's waves on the card (``chip_smoke.py``
#: phases 7-8): two grid3d(30³) roots together, the widest matching and
#: BFS buckets, and a wider-row bucket of many lanes
SERVICE_BUCKETS = [(2, 32768, 8), (58, 256, 8), (52, 256, 8),
                   (43, 256, 16), (2, 16384, 16)]


def _force_design(monkeypatch, design):
    """Make both kernels take ``design`` whatever the lanes' size."""
    def plan(n, d):
        if design == "grid":
            return "grid", None
        return "cluster", band_batch.cluster_size(n, d)
    monkeypatch.setattr(band_batch, "lane_plan", plan)
    monkeypatch.setattr(matching, "lane_plan", plan)


@pytest.mark.parametrize("design", ["cluster", "grid"])
@pytest.mark.parametrize("L,n,d", SERVICE_BUCKETS)
def test_multi_lane_matching_and_bfs_lanes_equal_singletons(
        card, monkeypatch, design, L, n, d):
    """Each lane of an L-lane call equals the same lane alone, bit for
    bit, and the call equals the plain version, in both designs."""
    _force_design(monkeypatch, design)
    nbr, wgt = (torch.from_numpy(a).to(card)
                for a in _match_bucket(L * n + d, L, n, d, "small"))
    keys = prng.split(prng.PRNGKey(L + d, card), L)
    got = matching.heavy_edge_matching_multi(nbr, wgt, keys, rounds=8)
    assert torch.equal(got, matching.heavy_edge_matching_multi_plain(
        nbr, wgt, keys, 8))
    src = (torch.rand((L, n), generator=torch.Generator().manual_seed(L))
           < 0.02).to(torch.int32).to(card)
    dist = band_batch.bfs_multi(nbr, src, 3)
    assert torch.equal(dist, band_batch.bfs_multi_plain(nbr, src, 3))
    for j in range(L):
        one = slice(j, j + 1)
        assert torch.equal(matching.heavy_edge_matching_multi(
            nbr[one], wgt[one], keys[one], rounds=8)[0], got[j])
        assert torch.equal(band_batch.bfs_multi(nbr[one], src[one], 3)[0],
                           dist[j])


def test_fm_bucket_of_many_works_lanes_equal_singletons(card):
    """FM works of different graphs, budgets and lane counts in one
    bucket (padded with dummy lanes): each work's lanes equal its own
    call's, on the card."""
    from repro_torch.core.initsep import grow_part
    from repro_torch.graphs.generators import grid2d
    works = []
    for k, g in enumerate([grid2d(11, 11), grid2d(10, 12), grid2d(12, 9),
                           grid2d(9, 13)]):
        nbr, _ = g.to_ell()
        works.append(fm.FMWork(nbr=nbr, vwgt=g.vwgt, part=grow_part(g, k),
                               locked=np.zeros(g.n, bool), seed=k,
                               k_inst=2 + 2 * k, max_moves=[None, 7][k % 2]))
    assert len({w.bucket_key() for w in works}) == 1

    def call(ws):
        host, counts = fm.pack_fm_bucket(ws)
        t = {k: v.to(card) for k, v in host.items()}
        return fm_fused.fm_fused_multi(**t, passes=3), counts
    group, counts = call(works)
    assert group[0].shape[0] % 8 == 0 and group[0].shape[0] > sum(counts)
    off = 0
    for w, k in zip(works, counts):
        one, _ = call([w])
        for a, b in zip(group, one):
            assert torch.equal(a[off:off + k], b[:k])
        off += k
    for w, (part, sep_w, imb) in zip(works, fm.execute_fm_works(works,
                                                                 card)):
        alone = fm.execute_fm_works([w], card)[0]
        assert np.array_equal(part, alone[0])
        assert (sep_w, imb) == alone[1:]


def _service_graphs():
    from repro_torch.graphs import generators as G
    return [G.grid2d(12, 12), G.grid3d(6, 6, 6), G.circuit(300, seed=3),
            G.rgg2d(250, seed=2), G.grid3d(5, 5, 6), G.grid2d(11, 14)]


def test_order_batch_on_card_equals_looped(card):
    from repro_torch.service import OrderingService, order_batch
    graphs = _service_graphs()
    seeds = list(range(len(graphs)))
    before = matching.launches
    perms = order_batch(graphs, seeds, 4, device=card)
    assert matching.launches > before
    refs = [nested_dissection(g, s, 4, device=card)
            for g, s in zip(graphs, seeds)]
    for p, r in zip(perms, refs):
        assert np.array_equal(p, r)
    svc = OrderingService()                 # the card by default
    assert svc.device.type == "cuda"
    rids = [svc.submit(g, seed=s, nproc=4) for g, s in zip(graphs, seeds)]
    svc.drain()
    for rid, r in zip(rids, refs):
        assert np.array_equal(svc.poll(rid).perm, r)


def test_persistent_fm_fault_on_card_degrades_then_isolates(
        card, monkeypatch):
    """On the card the FM ladder is fused → hoisted: a persistent fault
    at both rungs degrades the group to hoisted, then isolates it and
    excises the tree, which re-runs cold; no FM call runs the oracle or
    leaves the card, and the result is the fault-free one."""
    from repro_torch.graphs.generators import grid2d
    from repro_torch.service import OrderingService, faults
    g = grid2d(12, 12)
    ref = nested_dissection(g, 3, 2, device=card)
    calls = []
    real = ops.fm_refine_batch

    def recorded(*args, mode=None, device=None, **kw):
        calls.append((mode, torch.device(device).type))
        return real(*args, mode=mode, device=device, **kw)
    monkeypatch.setattr(ops, "fm_refine_batch", recorded)
    plan = faults.FaultPlan(seed=1, specs=[
        faults.FaultSpec(site="fm", kind="persistent", at=(0, 1, 2))])
    with faults.fault_injection(plan) as inj:
        svc = OrderingService(device=card)
        assert svc._router.recovery.modes == ("fused", "hoisted")
        rid = svc.submit(g, seed=3, nproc=2)
        res = svc.drain()[rid]
    assert inj.injected == 3
    assert res.status == "ok" and np.array_equal(res.perm, ref)
    assert svc._router.recovery.isolations >= 1
    modes = {m for m, _ in calls}
    assert "hoisted" in modes and modes <= {"fused", "hoisted"}
    assert {dev for _, dev in calls} == {"cuda"}


def test_service_drain_thread_on_card(card):
    """A worker thread drains the card's service (its kernels on that
    thread's current stream) while the caller submits and reads stats:
    every request resolves to the looped ordering."""
    import threading
    from repro_torch.graphs.generators import grid2d
    from repro_torch.service import OrderingService
    svc = OrderingService(device=card)
    graphs = [grid2d(10, 12), grid2d(11, 11), grid2d(9, 13)]
    stop, errors, rids = threading.Event(), [], []

    def drainer():
        try:
            while not stop.is_set() or svc.queue_depth():
                svc.drain()
        except Exception as e:          # surface worker crashes
            errors.append(e)

    worker = threading.Thread(target=drainer)
    worker.start()
    try:
        for k in range(12):
            rids.append((svc.submit(graphs[k % 3], seed=k), k))
            svc.stats()
    finally:
        stop.set()
        worker.join(timeout=300)
    assert not worker.is_alive() and errors == []
    for rid, k in rids:
        want = nested_dissection(graphs[k % 3], k, 1, device=card)
        assert np.array_equal(svc.poll(rid).perm, want)


# ------------------------------------------------------------------ #
# the distributed plane (csrc/dgraph.cu): rows 7-10, kernel == plain
# ------------------------------------------------------------------ #
def _dlanes(dgs, ghosts=0):
    """The stacked arrays of ``dgs``, the ghost table padded with -1 (as
    a bucket pads it) to at least ``ghosts`` slots."""
    from repro_torch.core import dgraph as D

    def st(field):
        return torch.from_numpy(np.stack([np.asarray(getattr(d, field),
                                                     np.int32)
                                          for d in dgs]))
    t = {f: st(f) for f in ("nbr_gst", "ewgt_gst", "ghost_gid", "vtxdist",
                            "n_loc")}
    gg = t["ghost_gid"]
    if ghosts > gg.shape[2]:
        pad = torch.full((*gg.shape[:2], ghosts - gg.shape[2]), -1,
                         dtype=torch.int32)
        t["ghost_gid"] = torch.cat([gg, pad], dim=2)
    return t, D


def _device_ghosts(P, C):
    """Ghost slots a lane of P parts needs for a CTA's share of the ghost
    table alone (2^16 slots of 4 bytes) to outgrow the 225 KB of shared
    memory a CTA of C may take: the cluster kernels then keep their state
    in device memory."""
    return -(-C * 2 ** 16 // P)


def _device_rows(t, C):
    """``t`` (no ghost ids) with each part's rows padded past ``n_loc``
    (ids -1, as a bucket pads them) until a CTA's share of the BFS's two
    distance buffers outgrows shared memory at C CTAs."""
    L, P, nlm, d = t["nbr_gst"].shape
    pad = -(-C * 2 ** 15 // P) - nlm
    out = dict(t)
    for f, fill in (("nbr_gst", -1), ("ewgt_gst", 0)):
        out[f] = torch.cat([t[f], torch.full((L, P, pad, d), fill,
                                             dtype=torch.int32)], dim=2)
    return out


def _dcase(name):
    """A case's stacked arrays: ``wide`` is ``stack3`` with its ghost
    table padded until the plan's one CTA keeps its state in device
    memory."""
    dgs = _dgraphs(name)
    return _dlanes(dgs, _device_ghosts(dgs[0].nparts, 1)
                   if name == "wide" else 0)


@functools.lru_cache(maxsize=None)
def _dgraphs(name):
    """The cases' DGraph stacks.  In ``dgraph_ops.plan``: ``stack3`` and
    ``folded`` one CTA a lane, ``grid3d_16`` two, ``root30`` (the root
    bucket of the distributed ordering's main path, 2^18 slots) 16, each
    part spanning two CTAs' rows, and ``grid3d_40`` and ``grid3d_100``
    (the relaxation's and the halo's largest bucket) the grid design."""
    from repro_torch.core import dgraph as D
    from repro_torch.graphs.generators import grid2d
    sides = {"grid3d_16": 16, "root30": 30, "grid3d_40": 40,
             "grid3d_100": 100}
    if name in sides:
        side = sides[name]
        return (D.distribute(grid3d(side, side, side), 8),)
    if name in ("stack3", "wide"):
        return (D.distribute(grid2d(13, 11), 4), D.distribute(grid2d(12, 12),
                                                              4),
                D.distribute(grid2d(10, 14), 4))
    g20 = D.distribute(grid2d(20, 20), 8)      # empty trailing parts
    return (D.dgraph_fold(D.dgraph_induced(g20, D.shard_gids(g20) < 150)[0]),)


DCASES = ("grid3d_16", "stack3", "folded", "root30", "grid3d_40", "wide")
#: each case's design in dgraph_ops.plan, and where the cluster kernels
#: keep their state there (dgraph_ops.state_place)
DPLANS = {"grid3d_16": ("cluster", 2, "distributed"),
          "stack3": ("cluster", 1, "shared"),
          "folded": ("cluster", 1, "shared"),
          "root30": ("cluster", 16, "distributed"),
          "grid3d_40": ("grid", None, "grid"),
          "wide": ("cluster", 1, "device")}


def _plan_of(t):
    from repro_torch.kernels import dgraph_ops as K
    return K.plan(*t["nbr_gst"].shape[1:])


def test_distributed_cases_reach_each_design(card):
    from repro_torch.kernels import dgraph_ops as K
    for name in DCASES:
        t, _ = _dcase(name)
        assert _plan_of(t) == DPLANS[name][:2], name
        L, P, nlm, _ = t["nbr_gst"].shape
        on = [t[f].to(card) for f in ("nbr_gst", "ewgt_gst", "ghost_gid",
                                      "vtxdist", "n_loc")]
        src = torch.zeros((L, P, nlm), dtype=torch.int32, device=card)
        K.dbfs(on[0], src, *on[2:4], 1)
        assert K.state_place == DPLANS[name][2], name
        K.dmatch(*on, torch.zeros(L, dtype=torch.int32, device=card), 1)
        assert K.state_place == DPLANS[name][2], name


@pytest.mark.parametrize("name", DCASES)
def test_halo_and_relax_kernels_equal_plain(card, name):
    from repro_torch.kernels import dgraph_ops as K
    t, _ = _dcase(name)
    L, P, nlm, d = t["nbr_gst"].shape
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 99, (L, P, nlm)).astype(np.int32))
    slots = K.lane_slots(t["ghost_gid"], t["vtxdist"], nlm)
    want = K.halo_plain(x, slots)
    before = K.halo_launches
    got = K.halo(x.to(card), list(slots.to(card)))
    assert K.halo_launches == before + 1
    assert torch.equal(got.cpu(), want)
    ext = want.reshape(L * P, -1)
    nbr = t["nbr_gst"].reshape(L * P, nlm, d)
    before = K.relax_launches
    got = K.ell_relax(nbr.to(card), ext.to(card), 2 ** 30)
    assert K.relax_launches == before + 1
    assert torch.equal(got.cpu(), K.ell_relax_plain(nbr, ext, 2 ** 30))


@pytest.mark.parametrize("width", [0, 1, 3])
@pytest.mark.parametrize("name", DCASES)
def test_distributed_bfs_kernel_equals_plain(card, name, width):
    from repro_torch.kernels import dgraph_ops as K
    t, _ = _dcase(name)
    L, P, nlm, _ = t["nbr_gst"].shape
    rng = np.random.default_rng(width)
    src = torch.from_numpy((rng.random((L, P, nlm)) < 0.05).astype(np.int32))
    want = K.dbfs_plain(t["nbr_gst"], src, t["ghost_gid"], t["vtxdist"],
                        width)
    own, steps = K.dbfs_counts(_plan_of(t)[0], width)
    before = (K.dbfs_launches, K.relax_launches)
    got = K.dbfs(t["nbr_gst"].to(card), src.to(card),
                 t["ghost_gid"].to(card), t["vtxdist"].to(card), width)
    assert (K.dbfs_launches, K.relax_launches) == (before[0] + own,
                                                   before[1] + steps)
    assert torch.equal(got.cpu(), want)
    for j in range(L):                  # each lane == its singleton call
        one = K.dbfs(t["nbr_gst"][j:j + 1].to(card), src[j:j + 1].to(card),
                     t["ghost_gid"][j:j + 1].to(card),
                     t["vtxdist"][j:j + 1].to(card), width)
        assert torch.equal(one[0].cpu(), want[j])


@pytest.mark.parametrize("rounds", [0, 1, 8])
@pytest.mark.parametrize("name", DCASES)
def test_distributed_matching_kernel_equals_plain(card, name, rounds):
    from repro_torch.kernels import dgraph_ops as K
    dgs = _dgraphs(name)
    t, D = _dcase(name)
    L, _, nlm, _ = t["nbr_gst"].shape
    seeds = torch.arange(11, 11 + L, dtype=torch.int32)
    args = [t[f] for f in ("nbr_gst", "ewgt_gst", "ghost_gid", "vtxdist",
                           "n_loc")] + [seeds]
    design = _plan_of(t)[0]
    # dense, the lossless cap, and caps that drop proposals (at root30 a
    # part's rows span two CTAs)
    lossless = D._match_proposal_cap(dgs, nlm)
    for cap in (0, lossless, 3, max(1, lossless // 4)):
        want = K.dmatch_plain(*args, rounds, cap)
        before = K.dmatch_launches
        got = K.dmatch(*(a.to(card) for a in args), rounds, cap)
        assert K.dmatch_launches == before + K.dmatch_count(design, rounds,
                                                            cap)
        assert torch.equal(got.cpu(), want), cap
        for j in range(L):
            one = K.dmatch(*(a[j:j + 1].to(card) for a in args), rounds,
                           cap)
            assert torch.equal(one[0].cpu(), want[j])


@pytest.mark.parametrize("name", ["root30", "stack3", "grid3d_16"])
def test_both_designs_equal_through_their_entries(card, name):
    """The cluster design (the plan's C, and other cluster sizes) and the
    grid design give the same output, the plain version's, at the same
    shape: at root30 the 2^18 slots where ``lane_plan`` switches.  Each
    cluster size also runs with the ghost table padded until its state
    no longer fits in shared memory, and keeps it in device memory."""
    from repro_torch.kernels import dgraph_ops as K
    dgs = _dgraphs(name)
    P, nlm = dgs[0].nparts, dgs[0].n_loc_max
    layouts = [("grid", None, 0)] + [
        ("cluster", C, ghosts) for C in (1, 2, 16)
        for ghosts in (0, _device_ghosts(P, C))]
    lossless = _dlanes(dgs)[1]._match_proposal_cap(dgs, nlm)
    rng = np.random.default_rng(3)
    L = len(dgs)
    src = torch.from_numpy((rng.random((L, P, nlm)) < 0.02).astype(np.int32))
    seeds = torch.arange(5, 5 + L, dtype=torch.int32)
    for design, C, ghosts in layouts:
        t, _ = _dlanes(dgs, ghosts)
        on = {k: v.to(card) for k, v in t.items()}
        for width in (0, 1, 3):
            want = K.dbfs_plain(t["nbr_gst"], src, t["ghost_gid"],
                                t["vtxdist"], width)
            got = K.dbfs_kernel(on["nbr_gst"], src.to(card), on["ghost_gid"],
                                on["vtxdist"], width, design, C)
            assert torch.equal(got.cpu(), want), (design, C, ghosts, width)
        if ghosts:
            assert K.state_place == "device"
        args = [t[f] for f in ("nbr_gst", "ewgt_gst", "ghost_gid",
                               "vtxdist", "n_loc")] + [seeds]
        for cap in (0, lossless, max(1, lossless // 4)):
            got = K.dmatch_kernel(*(a.to(card) for a in args), 8, cap,
                                  design, C)
            assert torch.equal(got.cpu(), K.dmatch_plain(*args, 8, cap)), \
                (design, C, ghosts, cap)
            if ghosts:
                assert K.state_place == "device"


def test_distributed_nd_card_equals_cpu(card):
    from repro_torch.core import dgraph as D
    from repro_torch.core.dnd import DNDConfig, \
        distributed_nested_dissection
    from repro_torch.graphs.generators import grid2d
    dg = D.distribute(grid2d(28, 28), 8)
    cfg = DNDConfig(centralize_threshold=256, band_central_threshold=128)
    want = distributed_nested_dissection(dg, 0, cfg, device="cpu")
    for frontier in (True, False):
        got = distributed_nested_dissection(
            dg, 0, dataclasses.replace(cfg, frontier=frontier))
        assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["root30", "grid3d_16"])
def test_cluster_designs_repeat_exactly(card, name):
    """Twenty calls of each cluster placement at the plan's C (the CTAs'
    shared memory, and with the ghost table padded, device memory), each
    equal to the plain version: the phases' barriers leave no race
    between CTAs."""
    from repro_torch.kernels import dgraph_ops as K
    dgs = _dgraphs(name)
    P, nlm, d = dgs[0].nbr_gst.shape
    C = K.plan(P, nlm, d)[1]
    L = len(dgs)
    src = (torch.arange(L * P * nlm).reshape(L, P, nlm) % 37 == 0).int()
    seeds = torch.tensor([9] * L, dtype=torch.int32)
    for ghosts, place in ((0, "distributed"),
                          (_device_ghosts(P, C), "device")):
        t, D = _dlanes(dgs, ghosts)
        on = {k: v.to(card) for k, v in t.items()}
        args = [t[f] for f in ("nbr_gst", "ewgt_gst", "ghost_gid",
                               "vtxdist", "n_loc")] + [seeds]
        cap = max(1, D._match_proposal_cap(dgs, nlm) // 4)
        bfs = K.dbfs_plain(t["nbr_gst"], src, t["ghost_gid"], t["vtxdist"], 3)
        for c in (0, cap):
            want = K.dmatch_plain(*args, 8, c)
            for _ in range(20):
                got = K.dmatch_kernel(*(a.to(card) for a in args), 8, c,
                                      "cluster", C)
                assert torch.equal(got.cpu(), want), (place, c)
                assert K.state_place == place
        for _ in range(20):
            got = K.dbfs_kernel(on["nbr_gst"], src.to(card), on["ghost_gid"],
                                on["vtxdist"], 3, "cluster", C)
            assert torch.equal(got.cpu(), bfs), place
            assert K.state_place == place


#: (design, C, where the state lies): the device placement is reached by
#: padding the ghost table (or, without ghosts, the rows) past what fits
LAYOUTS = [("cluster", 1, "shared"), ("cluster", 2, "distributed"),
           ("cluster", 2, "device"), ("grid", None, "grid")]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_distributed_kernels_read_outside_ids_as_padding(card, layout):
    from repro_torch.kernels import dgraph_ops as K
    design, C, place = layout
    dgs = _dgraphs("stack3")
    t, _ = _dlanes(dgs, _device_ghosts(dgs[0].nparts, C)
                   if place == "device" else 0)
    L, P, nlm, d = t["nbr_gst"].shape
    W = nlm + t["ghost_gid"].shape[2]
    nb = t["nbr_gst"].clone()
    nb[..., -1] = torch.where(nb[..., -1] < 0, W + 7, nb[..., -1])
    src = (torch.arange(L * P * nlm).reshape(L, P, nlm) % 11 == 0).int()
    seeds = torch.arange(L, dtype=torch.int32)
    rest = [t[f] for f in ("ewgt_gst", "ghost_gid", "vtxdist", "n_loc")]
    for matching in (False, True):
        a = nb.to(card)
        if matching:
            got = K.dmatch_kernel(a, *(r.to(card) for r in rest),
                                  seeds.to(card), 8, 0, design, C)
            want = K.dmatch_plain(nb, *rest, seeds, 8)
        else:
            got = K.dbfs_kernel(a, src.to(card), t["ghost_gid"].to(card),
                                t["vtxdist"].to(card), 3, design, C)
            want = K.dbfs_plain(nb, src, t["ghost_gid"], t["vtxdist"], 3)
        assert torch.equal(got.cpu(), want)
        assert K.state_place == place


@pytest.mark.parametrize("layout", LAYOUTS)
def test_distributed_kernels_without_ghost_slots(card, layout):
    """G == 0 (an empty ghost table, whose pointer may be null): every
    kernel still equals its plain version; the BFS keeps its sources at
    0 and stays inside each part."""
    from repro_torch.kernels import dgraph_ops as K
    design, C, place = layout
    t, _ = _dlanes(_dgraphs("stack3"))
    nlm = t["nbr_gst"].shape[2]
    t["nbr_gst"] = torch.where(t["nbr_gst"] < nlm, t["nbr_gst"], -1)
    if place == "device":
        t = _device_rows(t, C)
    L, P, nlm, d = t["nbr_gst"].shape
    nb = t["nbr_gst"]
    gg = t["ghost_gid"][..., :0].contiguous()
    vd, nl = t["vtxdist"], t["n_loc"]
    src = (torch.arange(L * P * nlm).reshape(L, P, nlm) % 11 == 0).int()
    for width in (1, 3):
        got = K.dbfs_kernel(nb.to(card), src.to(card), gg.to(card),
                            vd.to(card), width, design, C)
        want = K.dbfs_plain(nb, src, gg, vd, width)
        assert torch.equal(got.cpu(), want)
        assert K.state_place == place
        assert (want[src != 0] == 0).all()
    x = torch.arange(L * P * nlm, dtype=torch.int32).reshape(L, P, nlm)
    slots = K.lane_slots(gg, vd, nlm)
    assert torch.equal(K.halo(x.to(card), list(slots.to(card))).cpu(),
                       K.halo_plain(x, slots))
    seeds = torch.arange(L, dtype=torch.int32)
    args = (nb, t["ewgt_gst"], gg, vd, nl, seeds)
    for cap in (0, 3):
        got = K.dmatch_kernel(*(a.to(card) for a in args), 8, cap, design, C)
        assert torch.equal(got.cpu(), K.dmatch_plain(*args, 8, cap))
        assert K.state_place == place


@pytest.mark.parametrize("layout", LAYOUTS)
def test_distributed_kernels_with_far_ghosts(card, layout):
    """Ghost gids past the last part (grid2d(16, 16) over 4 full parts):
    their owner slot is clipped to a real row with another gid, whose
    role byte does not hold the ghost's coin; both kernels still equal
    their plain versions."""
    from repro_torch.core import dgraph as D
    from repro_torch.graphs.generators import grid2d
    from repro_torch.kernels import dgraph_ops as K
    design, C, place = layout
    t, _ = _dlanes((D.distribute(grid2d(16, 16), 4),),
                   _device_ghosts(4, C) if place == "device" else 0)
    gg = t["ghost_gid"].clone()
    pick = (gg >= 0) & (torch.arange(gg.numel()).reshape(gg.shape) % 2 == 0)
    gg[pick] = int(t["vtxdist"][0, -1]) + 3
    L, P, nlm, d = t["nbr_gst"].shape
    src = (torch.arange(L * P * nlm).reshape(L, P, nlm) % 13 == 0).int()
    want = K.dbfs_plain(t["nbr_gst"], src, gg, t["vtxdist"], 3)
    got = K.dbfs_kernel(t["nbr_gst"].to(card), src.to(card), gg.to(card),
                        t["vtxdist"].to(card), 3, design, C)
    assert torch.equal(got.cpu(), want)
    assert K.state_place == place
    for seed in range(4):
        args = (t["nbr_gst"], t["ewgt_gst"], gg, t["vtxdist"], t["n_loc"],
                torch.tensor([seed], dtype=torch.int32))
        for cap in (0, 5):
            got = K.dmatch_kernel(*(a.to(card) for a in args), 8, cap,
                                  design, C)
            assert torch.equal(got.cpu(), K.dmatch_plain(*args, 8, cap)), \
                (seed, cap)
            assert K.state_place == place


# ------------------------------------------------------------------ #
# rows 7-8 redesigned: the halo on resident slot tables, the relaxation
# on 16-byte id loads
# ------------------------------------------------------------------ #
def _random_slots(rng, L, P, nlm, G):
    """Random ghost slot tables (L, P, G): lane-local slots, a fifth -1."""
    slots = rng.integers(0, P * nlm, (L, P, G)).astype(np.int32)
    slots[rng.random((L, P, G)) < 0.2] = -1
    return torch.from_numpy(slots)


#: (L, P, nlm, G) of the halo's synthetic cases: the waves' two buckets
#: (16-byte path), nlm or G no multiple of 4 (one word a thread), no
#: ghosts, and 12 lanes (past the 8 of the small parameter block)
HALO_SHAPES = [(4, 2, 128, 64), (4, 2, 256, 128), (2, 3, 37, 13),
               (1, 2, 64, 6), (3, 4, 16, 0), (12, 4, 64, 32)]


@pytest.mark.parametrize("L,P,nlm,G", HALO_SHAPES)
def test_halo_kernel_equals_plain_on_slot_tables(card, L, P, nlm, G):
    """Each lane's own table (not a stacked one), exactly the plain
    version; then with every table one word off 16 bytes (the one-word
    path) and with one table shared by every lane."""
    from repro_torch.kernels import dgraph_ops as K
    rng = np.random.default_rng(L * 1000 + nlm + G)
    x = torch.from_numpy(rng.integers(-99, 99, (L, P, nlm)).astype(np.int32))
    slots = _random_slots(rng, L, P, nlm, G)
    want = K.halo_plain(x, slots)
    before = K.halo_launches
    got = K.halo(x.to(card), [s.to(card) for s in slots])
    assert K.halo_launches == before + 1
    assert torch.equal(got.cpu(), want)
    off = []
    for s in slots:                      # each table 4 bytes off 16
        buf = torch.empty(P * G + 1, dtype=torch.int32, device=card)
        buf[1:] = s.reshape(-1).to(card)
        off.append(buf[1:].view(P, G))
    assert torch.equal(K.halo(x.to(card), off).cpu(), want)
    shared = [slots[0].to(card)] * L
    assert torch.equal(K.halo(x.to(card), shared).cpu(),
                       K.halo_plain(x, slots[:1].expand(L, P, G)))


@pytest.mark.parametrize("name", ["root30", "grid3d_100"])
def test_halo_exchange_at_the_path_buckets(card, name):
    """The distributed ordering's root bucket and grid3d(100³) over 8
    parts through ``halo_exchange_stacked`` on the card: int32 and
    float32 payloads bit for bit the host oracle, one launch a call, the
    slot table resolved once for the DGraph and kept on the card."""
    from repro_torch.core import dgraph as D
    from repro_torch.kernels import dgraph_ops as K
    dg = _dgraphs(name)[0]
    rng = np.random.default_rng(len(name))
    x = rng.integers(0, 1 << 20, (dg.nparts, dg.n_loc_max)).astype(np.int32)
    before = (K.halo_launches, D.slot_resolutions)
    got = D.halo_exchange_fn(dg)(x)
    assert np.array_equal(got, D.halo_reference(dg, x))
    assert D.ghost_slots(dg, torch.device("cuda")).is_cuda
    xf = (x - (1 << 19)).astype(np.float32) / 7
    xf[0, :3] = (np.nan, -0.0, np.inf)
    gotf = D.halo_exchange_fn(dg)(xf)
    assert gotf.dtype == np.float32
    assert np.array_equal(gotf.view(np.int32),
                          D.halo_reference(dg, xf).view(np.int32))
    assert K.halo_launches == before[0] + 2
    assert D.slot_resolutions - before[1] <= 1
    D.halo_exchange_fn(dg)(x)
    assert D.slot_resolutions - before[1] <= 1


def _same_bucket_dgraphs():
    """Twelve lanes of one bucket (4 parts of grid2d graphs), of three
    distinct DGraphs and two fresh copies, so some lanes share one."""
    from repro_torch.core import dgraph as D
    from repro_torch.graphs.generators import grid2d
    dgs = [D.distribute(grid2d(a, b), 4)
           for a, b in ((13, 11), (12, 12), (10, 14), (12, 12), (11, 13))]
    assert len({D.dgraph_bucket(d) for d in dgs}) == 1
    return [dgs[k % len(dgs)] for k in range(12)]


def test_halo_lanes_of_many_dgraphs_equal_singletons(card):
    """Lanes of different DGraphs (and repeats) in one call, past the
    small parameter block: each lane equals its singleton call and the
    host oracle; a table a distinct DGraph."""
    from repro_torch.core import dgraph as D
    from repro_torch.kernels import dgraph_ops as K
    dgs = _same_bucket_dgraphs()
    rng = np.random.default_rng(12)
    xs = [rng.integers(0, 999, (d.nparts, d.n_loc_max)).astype(np.int32)
          for d in dgs]
    before = (K.halo_launches, D.slot_resolutions)
    got = D.halo_exchange_stacked(dgs, xs)
    assert K.halo_launches == before[0] + 1
    assert D.slot_resolutions == before[1] + len({id(d) for d in dgs})
    for dg, x, lane in zip(dgs, xs, got):
        assert np.array_equal(lane, D.halo_exchange_fn(dg)(x))
        assert np.array_equal(lane, D.halo_reference(dg, x))
    assert D.slot_resolutions == before[1] + len({id(d) for d in dgs})


def _relax_inputs(rng, L, n, d, m):
    nbr = rng.integers(-1, m + 3, (L, n, d)).astype(np.int32)
    ext = rng.integers(0, 50, (L, m)).astype(np.int32)
    return torch.from_numpy(nbr), torch.from_numpy(ext)


@pytest.mark.parametrize("L,n,d,m", [(3, 1000, 8, 1300), (3, 1000, 5, 1300),
                                     (2, 333, 32, 500), (4, 129, 4, 129),
                                     (1, 700, 12, 900)])
def test_relax_kernel_vector_and_scalar_paths(card, L, n, d, m):
    """The plain form on its 16-byte path (d % 4 == 0), on its scalar
    path (d = 5, and d = 8 with the ids one word off 16 bytes); ids past
    the vector and -1 read as padding."""
    from repro_torch.kernels import dgraph_ops as K
    nbr, ext = _relax_inputs(np.random.default_rng(n + d), L, n, d, m)
    want = K.ell_relax_plain(nbr, ext, 2 ** 30)
    assert torch.equal(K.ell_relax(nbr.to(card), ext.to(card),
                                   2 ** 30).cpu(), want)
    buf = torch.empty(nbr.numel() + 1, dtype=torch.int32, device=card)
    buf[1:] = nbr.reshape(-1).to(card)
    assert torch.equal(K.ell_relax(buf[1:].view(L, n, d), ext.to(card),
                                   2 ** 30).cpu(), want)


def _dist_random(rng, L, P, nlm, d, G):
    """Random lanes for the distributed kernels: ranges with an empty
    part, ghost ids over every lane's vertices (and past them, and -1),
    ids over the rows, the ghosts and past them."""
    vd = np.zeros((L, P + 1), np.int32)
    for l in range(L):
        sizes = rng.integers(nlm // 2, nlm + 1, P)
        sizes[1] = 0
        vd[l, 1:] = np.cumsum(sizes)
    gg = rng.integers(-1, int(vd[:, -1].max()) + 5, (L, P, G)).astype(np.int32)
    nbr = rng.integers(-1, nlm + G + 3, (L, P, nlm, d)).astype(np.int32)
    src = (rng.random((L, P, nlm)) < 0.05).astype(np.int32)
    return [torch.from_numpy(a) for a in (nbr, src, gg, vd)]


@pytest.mark.parametrize("d", [8, 5])
def test_relax_distributed_form_through_the_grid_bfs(card, d):
    """The grid BFS's steps (``dbfs_init`` writing the int32 lane-local
    slot table, ``ell_relax`` in its distributed form a step) at d = 8
    (16-byte path) and d = 5 (scalar path), many lanes: the plain
    version exactly, 1 + width launches."""
    from repro_torch.kernels import dgraph_ops as K
    nbr, src, gg, vd = _dist_random(np.random.default_rng(d), 5, 3, 40, d, 16)
    for width in (1, 3):
        before = (K.dbfs_launches, K.relax_launches)
        got = K.dbfs_kernel(nbr.to(card), src.to(card), gg.to(card),
                            vd.to(card), width, "grid")
        assert (K.dbfs_launches, K.relax_launches) == (before[0] + 1,
                                                       before[1] + width)
        assert torch.equal(got.cpu(), K.dbfs_plain(nbr, src, gg, vd, width))


def test_grid_bfs_at_grid3d_100(card):
    """The grid BFS at grid3d(100³) over 8 parts, the plan's design
    there, width 3: the plain version exactly, 3 relaxation launches."""
    from repro_torch.kernels import dgraph_ops as K
    t, _ = _dlanes(_dgraphs("grid3d_100"))
    assert _plan_of(t) == ("grid", None)
    L, P, nlm, _ = t["nbr_gst"].shape
    src = (torch.arange(L * P * nlm).reshape(L, P, nlm) % 101 == 0).int()
    before = K.relax_launches
    got = K.dbfs(t["nbr_gst"].to(card), src.to(card),
                 t["ghost_gid"].to(card), t["vtxdist"].to(card), 3)
    assert K.relax_launches == before + 3
    assert torch.equal(got.cpu(), K.dbfs_plain(t["nbr_gst"], src,
                                               t["ghost_gid"], t["vtxdist"],
                                               3))


def test_halo_results_outlive_the_staging_buffer(card):
    """A call's result is an array of its own: later calls, which reuse
    the thread's pinned staging buffer and grow it, leave it as it was."""
    from repro_torch.core import dgraph as D
    dgs = _same_bucket_dgraphs()
    rng = np.random.default_rng(4)
    xs = [rng.integers(0, 999, (d.nparts, d.n_loc_max)).astype(np.int32)
          for d in dgs]
    first = D.halo_exchange_fn(dgs[0])(xs[0])
    kept = first.copy()
    D.halo_exchange_stacked(dgs, xs)
    assert D._HALO_STAGE.buf.is_pinned()
    D.halo_exchange_fn(dgs[1])(xs[1])
    assert np.array_equal(first, kept)
    assert np.array_equal(first, D.halo_reference(dgs[0], xs[0]))


def _card_group(card, size, nparts):
    """A group of ``size`` members: the host's first cards where it has as
    many, else the one card repeated (the same code path, the rows crossing
    inside the card)."""
    from repro_torch.core import dgraph as D
    if torch.cuda.device_count() >= size:
        return D.make_parts_group(size, nparts)
    return D.make_parts_group([card] * size, nparts)


@pytest.mark.parametrize("size", [2, 3])
@pytest.mark.parametrize("name", ["grid3d_16", "folded", "stack3",
                                  "grid3d_40"])
def test_group_collectives_equal_one_card(card, name, size):
    """The halo, the BFS (width 3) and the matching (dense and at a cap
    that drops proposals) with their parts on a group: the one-card
    call's results exactly, each member's kernels launched as
    ``planned_launches`` gives the group's records."""
    from repro_torch.core import dgraph as D
    from repro_torch.kernels import dgraph_ops as K
    dgs = list(_dgraphs(name))
    P, nlm = dgs[0].nbr_gst.shape[:2]
    group = _card_group(card, size, P)
    rng = np.random.default_rng(size)
    xs = [rng.integers(0, 999, (P, nlm)).astype(np.int32) for _ in dgs]
    srcs = [(rng.random((P, nlm)) < 0.05).astype(np.int32) for _ in dgs]
    seeds = [5 + k for k in range(len(dgs))]
    want = (D.halo_exchange_stacked(dgs, xs),
            D.distributed_bfs_stacked(dgs, srcs, 3),
            D.distributed_matching_stacked(dgs, seeds))
    counts = ("halo_launches", "dbfs_launches", "relax_launches",
              "dmatch_launches")
    before = {c: getattr(K, c) for c in counts}
    with D.instrument() as ins:
        got = (D.halo_exchange_stacked(dgs, xs, group=group),
               D.distributed_bfs_stacked(dgs, srcs, 3, group=group),
               D.distributed_matching_stacked(dgs, seeds, group=group))
    for a, b in zip(got, want):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    planned = K.planned_launches(ins.launches)
    assert {c: getattr(K, c) - before[c] for c in counts} == {
        c: planned[c] for c in counts}
    assert all(r["group"] == size and r["xbytes"] > 0 for r in ins.launches)
    # the compacted gather at a cap that drops proposals
    args = [torch.from_numpy(np.stack([np.asarray(getattr(d, f), np.int32)
                                       for d in dgs]))
            for f in ("nbr_gst", "ewgt_gst", "ghost_gid", "vtxdist", "n_loc")]
    sd = torch.tensor(seeds, dtype=torch.int32)
    got = D._dmatch_group(group, group.layout(P), dgs, seeds, 8, 3, [])
    assert np.array_equal(got, K.dmatch_plain(*args, sd, 8, 3).numpy())
