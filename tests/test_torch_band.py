"""The port's band stage against the reference, on the CPU.

``bfs_multi_plain`` (what the wrapper runs on CPU tensors) must equal the
reference's Pallas kernel in interpret mode and its fused-XLA path, and
the extracted band problem (graph, part, locked, old ids) must be the
reference's, array for array.  Exact equality: distances are integers.
"""
import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import band as jband  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.kernels.band_batch import bfs_multi as jax_bfs_multi  # noqa: E402
from repro_torch.convert import graph_from_arrays  # noqa: E402
from repro_torch.core import band  # noqa: E402
from repro_torch.kernels import band_batch  # noqa: E402


def _rand_ell(seed, L, n, d, p_src=0.05):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n, (L, n, d)).astype(np.int32)
    nbr[rng.random((L, n, d)) < 0.5] = -1          # ragged, not left-justified
    src = (rng.random((L, n)) < p_src).astype(np.int32)
    return nbr, src


@pytest.mark.parametrize("L,n,d,width", [(1, 64, 8, 3), (3, 128, 8, 1),
                                         (4, 64, 16, 3), (2, 256, 8, 5),
                                         (2, 128, 8, 0), (3, 64, 16, 7)])
def test_bfs_plain_matches_pallas_and_xla(L, n, d, width):
    nbr, src = _rand_ell(L * 31 + n, L, n, d)
    want = np.asarray(jax_bfs_multi(jnp.asarray(nbr), jnp.asarray(src),
                                    width, interpret=True))
    xla = np.asarray(jband.bfs_distance_multi(jnp.asarray(nbr),
                                              jnp.asarray(src), width))
    assert np.array_equal(want, xla)
    got = band_batch.bfs_multi(torch.from_numpy(nbr), torch.from_numpy(src),
                               width)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert band_batch.launches == 0          # CPU tensors never launch


@pytest.mark.parametrize("d", [1, 2, 4, 8, 16, 32, 64, 1024])
def test_lane_plan_picks_by_size(d):
    """One CTA for the small lanes, more as the slots grow, never above 16
    nor above what the slots need; the grid design above the threshold."""
    cap = band_batch.CLUSTER_MAX_SLOTS
    sizes = []
    for n in [1, 64, 100, 512, 2048, 3000] + [2 ** k for k in range(12, 21)]:
        design, C = band_batch.lane_plan(n, d)
        if n * d > cap:
            assert (design, C) == ("grid", None)
            continue
        assert design == "cluster" and 1 <= C <= band_batch.CLUSTER_MAX
        assert C == band_batch.cluster_size(n, d)
        assert C == 1 or (C - 1) * band_batch.CTA_SLOTS < n * d
        assert C == band_batch.CLUSTER_MAX or \
            C * band_batch.CTA_SLOTS >= n * d
        sizes.append(C)
    assert sizes == sorted(sizes) and sizes[0] == 1
    assert band_batch.lane_plan(cap // d, d) == ("cluster", 16)
    assert band_batch.lane_plan(cap // d + 1, d) == ("grid", None)


def test_bfs_wrapper_checks_inputs():
    nbr, src = _rand_ell(0, 1, 64, 8)
    with pytest.raises(TypeError):
        band_batch.bfs_multi(torch.from_numpy(nbr).long(),
                             torch.from_numpy(src), 3)
    with pytest.raises(ValueError):
        band_batch.bfs_multi(torch.from_numpy(nbr),
                             torch.from_numpy(src[:, :10]), 3)
    with pytest.raises(ValueError):
        band_batch.bfs_multi_kernel(torch.from_numpy(nbr),
                                    torch.from_numpy(src), 3)


def _graphs():
    return [("grid2d", jgen.grid2d(20, 15)), ("grid3d", jgen.grid3d(8, 7, 6)),
            ("rgg2d", jgen.rgg2d(300, seed=2))]


@pytest.mark.parametrize("gi", [0, 1, 2])
def test_execute_bfs_and_extract_band_match_reference(gi):
    name, jg = _graphs()[gi]
    g = graph_from_arrays(jg.xadj, jg.adjncy, jg.vwgt, jg.adjwgt)
    rng = np.random.default_rng(gi)
    # a separator-like source set: one random coordinate slab
    part = np.where(rng.random(g.n) < 0.5, 0, 1).astype(np.int8)
    part[np.arange(g.n) % 11 == 3] = 2
    nbr, _ = g.to_ell()
    works = [band.BFSWork(nbr=nbr, src=part == 2, width=3),
             band.BFSWork(nbr=nbr, src=part == 0, width=2)]
    got = band.execute_bfs_works(works, device="cpu")
    want = jband.execute_bfs_works(
        [jband.BFSWork(nbr=w.nbr, src=w.src, width=w.width) for w in works],
        mode="jnp")
    for a, b in zip(got, want):
        assert np.array_equal(a, b), name
    bg, bpart, locked, old = band.extract_band(g, part, width=3,
                                               dist=got[0])
    jbg, jbpart, jlocked, jold = jband.extract_band(jg, part, width=3,
                                                    dist=want[0])
    for a, b in [(bg.xadj, jbg.xadj), (bg.adjncy, jbg.adjncy),
                 (bg.vwgt, jbg.vwgt), (bg.adjwgt, jbg.adjwgt),
                 (bpart, jbpart), (locked, jlocked), (old, jold)]:
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    # without a precomputed sweep, extract_band runs it on the device
    bg2, bpart2, _, _ = band.extract_band(g, part, width=3, device="cpu")
    assert np.array_equal(bg2.adjncy, bg.adjncy)
    assert np.array_equal(bpart2, bpart)
    refined = bpart.copy()
    refined[:5] = 2
    assert np.array_equal(band.project_band(part, refined, old),
                          jband.project_band(part, refined, jold))
