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
        band_batch.sep_gain_multi_kernel(nbr, lane_work, vwgt, part)
    with pytest.raises(ValueError):             # lane_work names a tile
        band_batch.sep_gain_multi(nbr, lane_work.long(), vwgt, part)
