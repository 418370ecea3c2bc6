"""Deterministic test-graph generators, analogs of the paper's Table 1 suite.

The UF collection is not available offline, so we generate graphs from the
same application families:

* ``grid2d`` / ``grid3d``  — FE-mesh analogs (paper: altr4, audikw1, bmw32,
  conesphere1m, coupole8000 are 2D/3D meshes).  3D grids have the
  O(n^{2/3}) separators the band-refinement argument relies on.
* ``rgg2d``                — random geometric graph (unstructured mesh analog).
* ``circuit``              — low average degree, long chains + random fanout
  (paper: qimonda07, avg degree 6.8 circuit graph).
* ``knn3d``                — high, regular degree (paper: thread, deg 149).
* ``cage_like``            — expander-ish DNA-electrophoresis analog (cage15).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph


def grid2d(nx: int, ny: int) -> Graph:
    """5-point stencil nx×ny grid."""
    idx = np.arange(nx * ny).reshape(nx, ny)
    e = []
    e.append(np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1))
    e.append(np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1))
    return Graph.from_edges(nx * ny, np.concatenate(e))


def grid3d(nx: int, ny: int, nz: int, stencil: int = 7) -> Graph:
    """7-point (or 27-point) stencil 3D grid — FE mesh analog."""
    idx = np.arange(nx * ny * nz).reshape(nx, ny, nz)
    e = []
    e.append(np.stack([idx[:-1].ravel(), idx[1:].ravel()], 1))
    e.append(np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1))
    e.append(np.stack([idx[:, :, :-1].ravel(), idx[:, :, 1:].ravel()], 1))
    if stencil == 27:
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    if (dx, dy, dz) <= (0, 0, 0):
                        continue
                    sa = idx[max(0, -dx):nx - max(0, dx),
                             max(0, -dy):ny - max(0, dy),
                             max(0, -dz):nz - max(0, dz)]
                    sb = idx[max(0, dx):nx - max(0, -dx),
                             max(0, dy):ny - max(0, -dy),
                             max(0, dz):nz - max(0, -dz)]
                    e.append(np.stack([sa.ravel(), sb.ravel()], 1))
    return Graph.from_edges(nx * ny * nz, np.concatenate(e))


def rgg2d(n: int, seed: int = 0, deg_target: float = 8.0) -> Graph:
    """Random geometric graph on the unit square via cell binning."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    r = np.sqrt(deg_target / (np.pi * n))
    nc = max(1, int(1.0 / r))
    cell = (np.minimum((pts / (1.0 / nc)).astype(np.int64), nc - 1))
    cid = cell[:, 0] * nc + cell[:, 1]
    order = np.argsort(cid, kind="stable")
    starts = np.searchsorted(cid[order], np.arange(nc * nc))
    ends = np.searchsorted(cid[order], np.arange(nc * nc), side="right")
    edges = []
    for cx in range(nc):
        for cy in range(nc):
            mine = order[starts[cx * nc + cy]:ends[cx * nc + cy]]
            if not len(mine):
                continue
            cand = [mine]
            for dx, dy in ((0, 1), (1, -1), (1, 0), (1, 1)):
                ox, oy = cx + dx, cy + dy
                if 0 <= ox < nc and 0 <= oy < nc:
                    cand.append(order[starts[ox * nc + oy]:ends[ox * nc + oy]])
            others = np.concatenate(cand)
            d2 = ((pts[mine, None, :] - pts[None, others, :]) ** 2).sum(-1)
            ii, jj = np.nonzero(d2 <= r * r)
            a, b = mine[ii], others[jj]
            keep = a < b
            if keep.any():
                edges.append(np.stack([a[keep], b[keep]], 1))
    if not edges:
        edges = [np.zeros((0, 2), dtype=np.int64)]
    g = Graph.from_edges(n, np.concatenate(edges))
    return _connect(g, pts_order=np.argsort(pts[:, 0], kind="stable"))


def circuit(n: int, seed: int = 0, fanout: float = 2.4) -> Graph:
    """Circuit-simulation analog: chain + random low-degree fanout."""
    rng = np.random.default_rng(seed)
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    k = int(n * fanout)
    src = rng.integers(0, n, k)
    # mostly-local wiring with a few long nets
    span = np.where(rng.random(k) < 0.9,
                    rng.integers(1, 50, k), rng.integers(1, n, k))
    dst = (src + span) % n
    return Graph.from_edges(n, np.concatenate([chain, np.stack([src, dst], 1)]))


def knn3d(n: int, k: int = 24, seed: int = 0) -> Graph:
    """k-nearest-neighbor graph in 3D — high-degree 'thread' analog."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 3))
    # brute-force in blocks (n expected ≤ ~20k)
    edges = []
    B = 512
    for s in range(0, n, B):
        blk = pts[s:s + B]
        d2 = ((blk[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        nn = np.argpartition(d2, k + 1, axis=1)[:, :k + 1]
        src = np.repeat(np.arange(s, s + len(blk)), k + 1)
        edges.append(np.stack([src, nn.ravel()], 1))
    return Graph.from_edges(n, np.concatenate(edges))


def cage_like(n: int, seed: int = 0, deg: int = 8) -> Graph:
    """Expander-ish analog of cage15 (DNA electrophoresis): local 3D grid
    plus random matchings (long-range)."""
    side = max(2, round(n ** (1 / 3)))
    g = grid3d(side, side, side)
    nn = g.n
    rng = np.random.default_rng(seed)
    extra = []
    for _ in range(deg // 4):
        perm = rng.permutation(nn)
        extra.append(perm[:(nn // 2) * 2].reshape(-1, 2))
    edges = np.concatenate(extra)
    both = np.concatenate([np.stack([np.repeat(np.arange(nn), np.diff(g.xadj)),
                                     g.adjncy], 1), edges])
    return Graph.from_edges(nn, both)


def _connect(g: Graph, pts_order: np.ndarray) -> Graph:
    """Stitch components with a spatial chain so generators return one CC."""
    comp = g.components()
    if comp.max() == 0:
        return g
    seen = {}
    extra = []
    prev = None
    for v in pts_order:
        c = comp[v]
        if c not in seen:
            seen[c] = v
            if prev is not None:
                extra.append((prev, v))
            prev = v
    src = np.repeat(np.arange(g.n), g.degrees())
    all_edges = np.concatenate(
        [np.stack([src, g.adjncy], 1), np.array(extra, dtype=np.int64)])
    return Graph.from_edges(g.n, all_edges)


#: paper-analog suite used by the benchmarks (name -> constructor)
SUITE = {
    "altr4-like":    lambda: grid3d(30, 30, 30),              # 27k, 3D mesh
    "bmw32-like":    lambda: grid3d(61, 61, 61, stencil=7),   # 227k, 3D mesh
    "audikw1-like":  lambda: grid3d(21, 21, 21, stencil=27),  # 9.2k, deg~26
    "conesphere-like": lambda: rgg2d(100_000, seed=3),
    "qimonda-like":  lambda: circuit(120_000, seed=7),
    "thread-like":   lambda: knn3d(8_000, k=48, seed=1),
    "cage-like":     lambda: cage_like(40_000, seed=5),
}
