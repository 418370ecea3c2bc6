"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: on a host without an NVIDIA card every test here skips
(the kernels have no CPU mode).  On the card, run

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Exact equality is the stated tolerance, as in the CPU parity tests.
"""
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core.nd import nested_dissection
from repro_torch.graphs.generators import grid3d, rgg2d
from repro_torch.kernels import band_batch, fm_fused

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


@pytest.mark.parametrize("L,n,d", [(1, 64, 8), (8, 256, 16), (3, 100, 40)])
def test_bfs_kernel_equals_plain(card, L, n, d):
    nbr, _, part, _, _ = _lanes(L + n, L, n, d)
    nbr_c = torch.from_numpy(nbr).to(card)
    src = torch.from_numpy((part == 2).astype(np.int32)).to(card)
    before = band_batch.launches
    got = band_batch.bfs_multi(nbr_c, src, 3)
    assert band_batch.launches == before + 4     # bfs_init + 3 relaxations
    assert torch.equal(got, band_batch.bfs_multi_plain(nbr_c, src, 3))


@pytest.mark.parametrize("passes,pos_only", [(3, False), (1, True)])
@pytest.mark.parametrize("L,n,d", [(3, 64, 8), (8, 256, 16), (2, 32768, 8)])
def test_fm_kernel_equals_plain(card, L, n, d, passes, pos_only):
    nbr, vwgt, part, locked, mm = _lanes(7 * L + n, L, n, d)
    t = [torch.from_numpy(a).to(card) for a in (nbr, vwgt, part, locked, mm)]
    keys = prng.split(prng.PRNGKey(L, card), L)
    vw = t[1]
    args = (t[0], torch.arange(L, dtype=torch.int32, device=card), vw, t[2],
            t[3], fm_fused.fm_noise(keys, n, passes),
            torch.full((L,), 0.1, device=card) * vw.sum(1), t[4],
            torch.full((L,), 8, dtype=torch.int32, device=card))
    got = fm_fused.fm_fused_kernel(*args, passes=passes, pos_only=pos_only)
    want = fm_fused.fm_fused_plain(*args, passes=passes, pos_only=pos_only)
    for a, b in zip(got[:3], want):
        assert torch.equal(a, b)


def test_nested_dissection_card_equals_cpu(card):
    for g in (grid3d(7, 7, 7), rgg2d(400, seed=2)):
        band_batch.launches = fm_fused.launches = 0
        p_card = nested_dissection(g, seed=1, nproc=4, device=card)
        assert band_batch.launches > 0 and fm_fused.launches > 0
        assert np.array_equal(p_card, nested_dissection(g, seed=1, nproc=4,
                                                        device="cpu"))
