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
