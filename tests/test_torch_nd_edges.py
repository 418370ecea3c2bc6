"""The port's ordering against the reference on the reference's edge cases.

Each case runs the port on the CPU (its plain kernel versions, the FM
noise drawn by ``fm_noise_plain``) and the reference, and holds the
port to the reference's exact result: exact equality is the stated
tolerance, as in ``test_torch_nd.py``.  The cases are the ones the
reference's own tests order, which the port's other tests do not reach:
circuit-like and cage-like graphs at nproc 8, nproc 32, a disconnected
graph (``tests/test_ordering_core.py``), and the band anchors of
``tests/test_ordering_edges.py``, whose bands then go through FM
refinement.
"""
import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro.core import band as jband  # noqa: E402
from repro.core.fm import refine_parts as jax_refine  # noqa: E402
from repro.core.graph import Graph as JGraph  # noqa: E402
from repro.core.nd import nested_dissection as jax_nd  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch.convert import graph_from_arrays  # noqa: E402
from repro_torch.core import band, nd  # noqa: E402
from repro_torch.core.fm import refine_parts  # noqa: E402
from repro_torch.core.graph import Graph  # noqa: E402


def _port_graph(jg):
    return graph_from_arrays(jg.xadj, jg.adjncy, jg.vwgt, jg.adjwgt)


def _assert_same_ordering(jg, seed, nproc):
    got = nd.nested_dissection(_port_graph(jg), seed=seed, nproc=nproc,
                               device="cpu")
    want = jax_nd(jg, seed=seed, nproc=nproc)
    assert np.array_equal(np.sort(got), np.arange(jg.n))
    assert np.array_equal(got, want), f"seed={seed} nproc={nproc}"


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name,args", [("circuit", (2000, 5)),
                                       ("cage_like", (1500, 2))])
def test_irregular_graphs_at_nproc_8_equal_reference(name, args, seed):
    _assert_same_ordering(getattr(jgen, name)(*args), seed, 8)


def test_grid3d_at_nproc_32_equals_reference():
    _assert_same_ordering(jgen.grid3d(8, 8, 8), 5, 32)


def test_disconnected_graph_equals_reference():
    """Two disjoint copies of grid2d(7, 7), as the reference's test builds
    them."""
    a = jgen.grid2d(7, 7)
    src = np.repeat(np.arange(a.n), a.degrees())
    e1 = np.stack([src, a.adjncy], 1)
    edges = np.concatenate([e1, e1 + a.n])
    jg = JGraph.from_edges(2 * a.n, edges)
    g = Graph.from_edges(2 * a.n, edges)
    for f in ("xadj", "adjncy", "vwgt", "adjwgt"):
        assert np.array_equal(getattr(g, f), getattr(jg, f))
    _assert_same_ordering(jg, 0, 1)


def _column_sep(nx, ny, col):
    """Vertical separator at x == col on an nx×ny grid."""
    part = np.zeros(nx * ny, np.int8)
    xs = np.arange(nx * ny).reshape(nx, ny)
    part[xs[col + 1:].ravel()] = 1
    part[xs[col].ravel()] = 2
    return part


def _last_row_sep(nx, ny):
    """No side-1 vertex at all: the last row is the separator."""
    part = np.zeros(nx * ny, np.int8)
    part[-ny:] = 2
    return part


@pytest.mark.parametrize("shape,width,make_part", [
    ((20, 8), 2, lambda: _column_sep(20, 8, 9)),      # anchor weights
    ((12, 6), 3, lambda: _column_sep(12, 6, 10)),     # one side empty
    ((8, 8), 2, lambda: _last_row_sep(8, 8)),         # isolated anchor
])
def test_band_anchors_and_their_refinement_equal_reference(shape, width,
                                                           make_part):
    """``extract_band`` gives the reference's band, anchors and locks, and
    FM refinement of that band (the path whose noise the kernels draw)
    gives the reference's refined part, projected back the same way."""
    jg = jgen.grid2d(*shape)
    g = _port_graph(jg)
    part = make_part()
    got = band.extract_band(g, part, width=width, device="cpu")
    want = jband.extract_band(jg, part, width=width)
    for f in ("xadj", "adjncy", "vwgt", "adjwgt"):
        assert np.array_equal(getattr(got[0], f), getattr(want[0], f)), f
    for x, y in zip(got[1:], want[1:]):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    bgraph, bpart, locked, old = got
    nbr, _ = bgraph.to_ell()
    for seed in (0, 7):
        mine = refine_parts(nbr, bgraph.vwgt, bpart, locked, seed,
                            device="cpu")
        ref = jax_refine(nbr, want[0].vwgt, want[1], want[2], seed)
        assert np.array_equal(mine[0], np.asarray(ref[0]))
        assert (mine[1], mine[2]) == (float(ref[1]), float(ref[2]))
        assert np.array_equal(band.project_band(part, mine[0], old),
                              jband.project_band(part, np.asarray(ref[0]),
                                                 want[3]))
