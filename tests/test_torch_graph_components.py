"""The port's connected components against the reference's.

``Graph.components`` numbers each component by its smallest vertex; the
ids seed each component's ordering (``nd.component_seed``) and order the
component children, so the port must give the reference's ids element
for element, and the ordering of a graph that falls apart below its
root must be the reference's permutation.
"""
import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro.core.graph import Graph as JGraph  # noqa: E402
from repro.core.nd import nested_dissection as jax_nd  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch.convert import graph_from_arrays  # noqa: E402
from repro_torch.core import nd  # noqa: E402
from repro_torch.core.graph import Graph  # noqa: E402


def _port_graph(jg):
    return graph_from_arrays(jg.xadj, jg.adjncy, jg.vwgt, jg.adjwgt)


def _edges(jg):
    return np.stack([np.repeat(np.arange(jg.n), jg.degrees()), jg.adjncy], 1)


def _holey_grid():
    """grid3d(12³) less its middle plane and 30% of the other vertices."""
    g = jgen.grid3d(12, 12, 12)
    keep = np.random.default_rng(30).random(g.n) >= 0.3
    keep.reshape(12, 12, 12)[6] = False
    return g.induced_subgraph(keep)[0]


def _isolated():
    """grid2d(5, 5) spread over 32 ids: vertex 0, the last and five
    between them have no edge."""
    a = jgen.grid2d(5, 5)
    ids = np.sort(np.random.default_rng(4).choice(np.arange(1, 31), a.n,
                                                  replace=False))
    return JGraph.from_edges(32, ids[_edges(a)])


def _circuit_cut():
    """circuit(800) less two of its BFS levels from vertex 0: a
    separator, as ND removes one."""
    g = jgen.circuit(800, 3)
    dist = np.full(g.n, -1)
    dist[0], frontier, d = 0, [0], 0
    while len(frontier):
        d += 1
        nbrs = np.unique(np.concatenate([g.neighbors(v) for v in frontier]))
        frontier = nbrs[dist[nbrs] < 0]
        dist[frontier] = d
    mid = dist.max() // 2
    return g.induced_subgraph((dist != mid) & (dist != mid + 1))[0]


CASES = {
    "grid3d-12": lambda: jgen.grid3d(12, 12, 12),
    "grid3d-12-holey": _holey_grid,
    "isolated": _isolated,
    "circuit-800-cut": _circuit_cut,
    "one-vertex": lambda: JGraph.from_edges(1, np.zeros((0, 2), np.int64)),
    "empty": lambda: JGraph.from_edges(0, np.zeros((0, 2), np.int64)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_components_equal_reference(name):
    jg = CASES[name]()
    want = jg.components()
    got = _port_graph(jg).components()
    assert got.dtype == np.int64 and got.shape == (jg.n,)
    assert np.array_equal(got, want)
    if name in ("grid3d-12-holey", "isolated", "circuit-800-cut"):
        assert want.max() > 0, "the case should have several components"


def _star_of_grids(arms=4, side=5):
    """``arms`` copies of grid3d(side³), each joined by one edge to a hub:
    the root's separator is the hub, and each side holds two copies."""
    a = jgen.grid3d(side, side, side)
    hub = arms * a.n
    edges = [_edges(a) + i * a.n for i in range(arms)]
    edges.append(np.array([[i * a.n, hub] for i in range(arms)]))
    return JGraph.from_edges(hub + 1, np.concatenate(edges))


@pytest.mark.parametrize("nproc", [1, 8])
def test_nd_over_inner_components_equals_reference(nproc, monkeypatch):
    jg = _star_of_grids()
    split = []
    components = Graph.components

    def counted(self):
        comp = components(self)
        if self.n < jg.n and self.n and comp.max() > 0:
            split.append(self.n)
        return comp

    monkeypatch.setattr(Graph, "components", counted)
    got = nd.nested_dissection(_port_graph(jg), seed=0, nproc=nproc,
                               device="cpu")
    assert split, "no inner node fell into components"
    want = jax_nd(jg, seed=0, nproc=nproc)
    assert np.array_equal(np.sort(got), np.arange(jg.n))
    assert np.array_equal(got, want)
