"""The port's matching and coarsening against the reference, on the CPU.

Every lane of the batched matching must equal the reference's matching
for the same key, and the whole multilevel hierarchy (graphs, maps,
instance counts) must be the reference's.  Exact equality: matchings are
integer ids, and the random draws are bit-identical.
"""
import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import coarsen as jcoarsen  # noqa: E402
from repro.core.matching import heavy_edge_matching_multi as jax_hem  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch.convert import graph_from_arrays, key_from_array  # noqa: E402
from repro_torch.core import coarsen, matching  # noqa: E402


def _port_graph(jg):
    return graph_from_arrays(jg.xadj, jg.adjncy, jg.vwgt, jg.adjwgt)


@pytest.mark.parametrize("L,n,d", [(1, 64, 8), (4, 128, 8), (3, 64, 16)])
def test_matching_lanes_equal_reference(L, n, d):
    rng = np.random.default_rng(L * n + d)
    nbr = rng.integers(0, n, (L, n, d)).astype(np.int32)
    nbr[rng.random((L, n, d)) < 0.4] = -1
    wgt = np.where(nbr >= 0, rng.integers(1, 4, (L, n, d)), 0).astype(
        np.int32)
    jkeys = jax.random.split(jax.random.PRNGKey(L + d), L)
    want = np.asarray(jax_hem(jnp.asarray(nbr), jnp.asarray(wgt), jkeys))
    got = matching.heavy_edge_matching_multi(
        torch.from_numpy(nbr), torch.from_numpy(wgt),
        key_from_array(np.asarray(jkeys)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,make", [
    ("grid2d", lambda: jgen.grid2d(17, 13)),
    ("grid3d", lambda: jgen.grid3d(7, 6, 5)),
    ("circuit", lambda: jgen.circuit(300, seed=3)),
])
def test_match_graph_and_works_equal_reference(name, make):
    jg = make()
    g = _port_graph(jg)
    for seed in (0, 7):
        m = coarsen.match_graph(g, seed, device="cpu")
        assert np.array_equal(m, jcoarsen.match_graph(jg, seed)), name
        assert matching.validate_matching(m)
    works = [coarsen.match_work_for(g, s) for s in (1, 2, 3)]
    got = coarsen.execute_match_works(works, device="cpu")
    want = jcoarsen.execute_match_works(
        [jcoarsen.MatchWork(nbr=w.nbr, wgt=w.wgt, seed=w.seed) for w in works])
    for a, b in zip(got, want):
        assert np.array_equal(a, b), name


@pytest.mark.parametrize("nproc", [1, 4])
def test_coarsen_multilevel_equals_reference(nproc):
    jg = jgen.grid3d(9, 8, 7)
    g = _port_graph(jg)
    got = coarsen.coarsen_multilevel(g, seed=3, nproc=nproc, device="cpu")
    want = jcoarsen.coarsen_multilevel(jg, seed=3, nproc=nproc)
    assert len(got.levels) == len(want.levels) > 2
    for a, b in zip(got.levels, want.levels):
        assert a.n_instances == b.n_instances
        assert (a.cmap is None) == (b.cmap is None)
        if a.cmap is not None:
            assert np.array_equal(a.cmap, b.cmap)
        for f in ("xadj", "adjncy", "vwgt", "adjwgt"):
            assert np.array_equal(getattr(a.graph, f), getattr(b.graph, f))


def test_validate_matching_detects_non_involution():
    assert matching.validate_matching(np.array([1, 0, 2]))
    assert not matching.validate_matching(np.array([1, 2, 0]))
