"""The port's FM gain recompute against the reference, exactly, on the CPU.

``sep_gain_multi_plain`` (what ``sep_gain_multi`` runs on CPU tensors)
must equal the reference's Pallas kernel in interpret mode and its jnp
oracle bit for bit: every sum is over integer-valued float32 weights, so
any order of the adds gives the same value.  The sweep covers ragged rows,
duplicate ids (a duplicate counts once per slot) and padding states, and
lanes that share a tile through ``lane_work``.
"""
import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.band_batch import sep_gain_multi as jax_gain  # noqa: E402
from repro.kernels.ref import sep_gain_multi_ref  # noqa: E402
from repro_torch.kernels import band_batch  # noqa: E402


def _lanes(seed, L, n, d):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n, (L, n, d)).astype(np.int32)
    nbr[rng.random((L, n, d)) < 0.35] = -1              # ragged rows
    nbr[:, ::3, 1] = nbr[:, ::3, 0]                     # duplicate ids
    nbr[:, -n // 8:] = -1                               # padding rows
    vwgt = rng.integers(1, 5, (L, n)).astype(np.float32)
    vwgt[:, -n // 8:] = 0.0
    part = rng.integers(0, 3, (L, n)).astype(np.int8)
    part[:, -n // 8:] = 3
    return nbr, vwgt, part


def _plain(nbr, vwgt, part, lane_work=None):
    L = vwgt.shape[0]
    if lane_work is None:
        lane_work = np.arange(L)
    return [t.numpy() for t in band_batch.sep_gain_multi(
        torch.from_numpy(nbr), torch.from_numpy(lane_work.astype(np.int32)),
        torch.from_numpy(vwgt), torch.from_numpy(part))]


@pytest.mark.parametrize("d", [8, 40])
@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("L", [1, 3, 8])
def test_gain_plain_equals_pallas_and_oracle(L, n, d):
    nbr, vwgt, part = _lanes(97 * L + n + d, L, n, d)
    got = _plain(nbr, vwgt, part)
    j = (jnp.asarray(nbr), jnp.asarray(vwgt), jnp.asarray(part, jnp.int32))
    for name, want in (("pallas", jax_gain(*j, interpret=True)),
                       ("oracle", sep_gain_multi_ref(*j))):
        for side, x, y in zip((0, 1), got, want):
            y = np.asarray(y)
            assert x.dtype == y.dtype == np.float32
            assert np.array_equal(x, y), \
                f"L={L} n={n} d={d} pulled{side} vs {name}: " \
                f"{(x != y).sum()} mismatches"
    assert band_batch.gain_launches == 0        # CPU tensors never launch


def test_shared_tiles_equal_per_lane_tiles():
    """Lanes naming one tile through lane_work equal lanes with copies."""
    nbr, vwgt, part = _lanes(3, 5, 64, 8)
    lane_work = np.array([1, 0, 1, 2, 0])
    tiles = nbr[:3]
    per_lane = _plain(tiles[lane_work], vwgt, part)
    shared = _plain(tiles, vwgt, part, lane_work)
    for x, y in zip(shared, per_lane):
        assert np.array_equal(x, y)


def test_sep_gain_batch_equals_reference_entry():
    """The reference's entry against ``sep_gain_multi``, which the port's
    hoisted path calls directly."""
    nbr, vwgt, part = _lanes(11, 3, 100, 6)     # n no multiple of a block
    got = _plain(nbr, vwgt, part)
    want = jops.sep_gain_batch(nbr, vwgt, part.astype(np.int32),
                               block_rows=100, interpret=True)
    for x, y in zip(got, want):
        assert np.array_equal(x, np.asarray(y))


def test_gain_wrapper_checks_inputs():
    nbr, vwgt, part = (torch.from_numpy(a) for a in _lanes(1, 2, 64, 8))
    lane_work = torch.arange(2, dtype=torch.int32)
    with pytest.raises(ValueError):             # part must be int8
        band_batch.sep_gain_multi(nbr, lane_work, vwgt, part.long())
    with pytest.raises(ValueError):             # vwgt must be float32
        band_batch.sep_gain_multi(nbr, lane_work, vwgt.double(), part)
    with pytest.raises(ValueError):             # the kernel takes the card
        band_batch.sep_gain_multi_kernel(nbr, lane_work, vwgt, part,
                                         band_batch.row_extents(nbr))
    with pytest.raises(ValueError):             # lane_work names a tile
        band_batch.sep_gain_multi(nbr, lane_work.long(), vwgt, part)


def _extent_lanes(seed, L, n, d):
    """Lanes whose rows end early, with -1 slots inside each extent, one
    full-width row and empty rows."""
    nbr, vwgt, part = _lanes(seed, L, n, d)
    rng = np.random.default_rng(seed)
    ends = rng.integers(0, d + 1, (L, n))
    ends[:, 0] = d                                      # a full-width row
    nbr[np.arange(d)[None, None, :] >= ends[..., None]] = -1
    return nbr, vwgt, part


@pytest.mark.parametrize("L,n,d", [(1, 64, 8), (3, 256, 40), (8, 64, 3)])
def test_gain_with_row_len_equals_without_and_reference(L, n, d):
    nbr, vwgt, part = _extent_lanes(5 * L + d, L, n, d)
    extents = band_batch.row_extents(nbr)
    row_len = extents.row_len.numpy()
    assert row_len[:, 0].max() <= d and (row_len[:, -n // 8:] == 0).all()
    inside = np.arange(d)[None, None, :] < row_len[..., None]
    assert ((nbr < 0) & inside).any()                   # -1 inside extents
    assert (nbr[~inside] < 0).all()                     # only -1 past them
    full = row_len[row_len > 0]
    assert extents.group == band_batch.extent_group(full.mean())
    lane_work = np.arange(L).astype(np.int32)
    t = [torch.from_numpy(a) for a in (nbr, lane_work, vwgt, part)]
    got = band_batch.sep_gain_multi(*t, extents=extents)
    without = band_batch.sep_gain_multi(*t)
    want = jax_gain(jnp.asarray(nbr), jnp.asarray(vwgt),
                    jnp.asarray(part, jnp.int32), interpret=True)
    for x, y, z in zip(got, without, want):
        assert torch.equal(x, y)
        assert np.array_equal(x.numpy(), np.asarray(z))


def test_shared_tiles_with_row_len_equal_per_lane_tiles():
    nbr, vwgt, part = _extent_lanes(9, 5, 64, 16)
    lane_work = np.array([2, 0, 2, 1, 0], np.int32)
    tiles = nbr[:3]
    got = band_batch.sep_gain_multi(
        torch.from_numpy(tiles), torch.from_numpy(lane_work),
        torch.from_numpy(vwgt), torch.from_numpy(part),
        extents=band_batch.row_extents(tiles))
    for x, y in zip(got, _plain(tiles[lane_work], vwgt, part)):
        assert np.array_equal(x.numpy(), y)


def test_gain_wrapper_checks_row_len():
    nbr, vwgt, part = (torch.from_numpy(a) for a in _lanes(2, 2, 64, 8))
    lane_work = torch.arange(2, dtype=torch.int32)
    ok = torch.full((2, 64), 8, dtype=torch.int32)
    band_batch.sep_gain_multi(nbr, lane_work, vwgt, part,
                              extents=band_batch.RowExtents(ok, 8))
    for bad in (ok[:1],                                 # shape: (W, n)
                ok.long(),                              # dtype: int32
                torch.empty((2, 64), dtype=torch.int32, device="meta"),
                torch.full((2, 64), 9, dtype=torch.int32),   # past d
                torch.full((2, 64), -1, dtype=torch.int32)):  # below 0
        with pytest.raises(ValueError):
            band_batch.sep_gain_multi(nbr, lane_work, vwgt, part,
                                      extents=band_batch.RowExtents(bad, 8))
    for group in (0, 3, 64):                            # a power of two <= 32
        with pytest.raises(ValueError):
            band_batch.sep_gain_multi(nbr, lane_work, vwgt, part,
                                      extents=band_batch.RowExtents(ok, group))
    with pytest.raises(ValueError):                     # not a RowExtents
        band_batch.sep_gain_multi(nbr, lane_work, vwgt, part, extents=ok)
    with pytest.raises(ValueError):             # the kernel takes the card
        band_batch.sep_gain_multi_kernel(nbr, lane_work, vwgt, part,
                                         band_batch.RowExtents(ok, 8))
    with pytest.raises(ValueError):             # ... and needs the extents
        band_batch.sep_gain_multi_kernel(nbr, lane_work, vwgt, part)


def test_hoisted_path_with_row_len_equals_without(monkeypatch):
    """``fm_refine_batch``'s hoisted path passes the bucket's extents
    (made by ``pack_fm_bucket``) to every gain launch; it gives the bits
    of the hoisted pass loop without them and of the fused path."""
    from repro_torch.core import fm
    from repro_torch.kernels import ops
    rng = np.random.default_rng(4)
    n, d = 100, 12
    nbr = rng.integers(0, n, (n, d)).astype(np.int32)
    ends = rng.integers(0, d + 1, n)
    nbr[np.arange(d)[None, :] >= ends[:, None]] = -1
    nbr[rng.random((n, d)) < 0.2] = -1
    works = [fm.FMWork(nbr=nbr, vwgt=rng.integers(1, 4, n),
                       part=rng.integers(0, 3, n).astype(np.int8),
                       locked=rng.random(n) < 0.1, seed=s, k_inst=k)
             for s, k in ((1, 4), (2, 2))]
    host, _ = fm.pack_fm_bucket(works)
    seen = []
    real = band_batch.sep_gain_multi

    def spy(*args, **kw):
        seen.append(args[4] if len(args) > 4 else kw.get("extents"))
        return real(*args, **kw)

    monkeypatch.setattr(fm, "sep_gain_multi", spy)
    with_len = ops.fm_refine_batch(**host, passes=3, mode="hoisted",
                                   gain_mode="pallas", device="cpu")
    monkeypatch.undo()
    assert len(seen) == 3
    want = band_batch.row_extents(host["nbr"])
    for e in seen:
        assert e.group == want.group and torch.equal(e.row_len, want.row_len)
    without = fm.fm_refine_multi(
        **{k: v for k, v in host.items() if k != "extents"}, passes=3,
        gain_mode="pallas")
    fused = ops.fm_refine_batch(**host, passes=3, mode="fused", device="cpu")
    for a, b, c in zip(with_len, without, fused):
        assert torch.equal(a, b) and torch.equal(a, c)
