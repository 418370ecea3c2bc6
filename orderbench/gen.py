"""The benchmark's graphs, made from a seed: the test-graph families of the
paper's Table 1 (as the repository's generators build them, the random
geometric graph by a k-d tree), and the stream of distinct
sparsity patterns a traffic mix draws.

A graph is a ``CSR`` of host arrays: symmetric rows (both arc directions),
unit vertex weights, and edge weights that count parallel edges once
merged.  The harness hands the program its own ``Graph`` made from these
arrays, and the reference reads the same arrays.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np

FAMILIES = ("grid2d", "grid3d", "circuit", "rgg2d", "cage_like")


@dataclasses.dataclass(frozen=True)
class CSR:
    xadj: np.ndarray        # (n + 1,) int64
    adjncy: np.ndarray      # (2m,) int32
    vwgt: np.ndarray        # (n,) int64
    adjwgt: np.ndarray      # (2m,) int64

    @property
    def n(self) -> int:
        return len(self.xadj) - 1

    @property
    def m(self) -> int:
        return len(self.adjncy) // 2


def from_edges(n: int, edges: np.ndarray) -> CSR:
    """Undirected edges (k, 2), loops dropped, parallel edges merged into
    one edge whose weight counts them; rows sorted by neighbour."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    edges = edges[edges[:, 0] != edges[:, 1]]
    lo, hi = edges.min(axis=1), edges.max(axis=1)
    key, cnt = np.unique(lo * n + hi, return_counts=True)
    lo, hi = key // n, key % n
    src = np.concatenate([lo, hi])
    dst = np.concatenate([hi, lo])
    w = np.concatenate([cnt, cnt]).astype(np.int64)
    order = np.lexsort((dst, src))
    src, dst, w = src[order], dst[order], w[order]
    xadj = np.zeros(n + 1, dtype=np.int64)
    np.add.at(xadj, src + 1, 1)
    return CSR(np.cumsum(xadj), dst.astype(np.int32),
               np.ones(n, dtype=np.int64), w)


def _edges(g: CSR) -> np.ndarray:
    src = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.xadj))
    return np.stack([src, g.adjncy.astype(np.int64)], 1)


def grid2d(nx: int, ny: int) -> CSR:
    """5-point stencil on an nx × ny grid."""
    idx = np.arange(nx * ny).reshape(nx, ny)
    return from_edges(nx * ny, np.concatenate([
        np.stack([idx[:-1].ravel(), idx[1:].ravel()], 1),
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1)]))


def grid3d(nx: int, ny: int, nz: int) -> CSR:
    """7-point stencil on an nx × ny × nz grid (Scotch's gmk_m3 mesh)."""
    idx = np.arange(nx * ny * nz).reshape(nx, ny, nz)
    return from_edges(nx * ny * nz, np.concatenate([
        np.stack([idx[:-1].ravel(), idx[1:].ravel()], 1),
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
        np.stack([idx[:, :, :-1].ravel(), idx[:, :, 1:].ravel()], 1)]))


def circuit(n: int, seed: int, fanout: float = 2.4) -> CSR:
    """A chain with random low-degree fanout, mostly local (qimonda07)."""
    rng = np.random.default_rng(seed)
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    k = int(n * fanout)
    src = rng.integers(0, n, k)
    span = np.where(rng.random(k) < 0.9, rng.integers(1, 50, k),
                    rng.integers(1, n, k))
    return from_edges(n, np.concatenate(
        [chain, np.stack([src, (src + span) % n], 1)]))


def rgg2d(n: int, seed: int, deg_target: float = 8.0) -> CSR:
    """A random geometric graph on the unit square (an unstructured
    mesh): points within r of each other, r set for a mean degree of
    ``deg_target``; its components chained by x-order into one."""
    from scipy.spatial import cKDTree
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    r = math.sqrt(deg_target / (math.pi * n))
    pairs = cKDTree(pts).query_pairs(r, output_type="ndarray")
    g = from_edges(n, pairs.reshape(-1, 2))
    return _connect(g, np.argsort(pts[:, 0], kind="stable"))


def _connect(g: CSR, order: np.ndarray) -> CSR:
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    a = csr_matrix((np.ones(len(g.adjncy)), g.adjncy, g.xadj),
                   shape=(g.n, g.n))
    count, comp = connected_components(a, directed=False)
    if count == 1:
        return g
    seen, extra, prev = set(), [], None
    for v in order:
        if comp[v] not in seen:
            seen.add(comp[v])
            if prev is not None:
                extra.append((prev, v))
            prev = v
    return from_edges(g.n, np.concatenate(
        [_edges(g), np.array(extra, dtype=np.int64)]))


def cage_like(n: int, seed: int, deg: int = 8) -> CSR:
    """A 3-D grid of about n vertices plus random matchings, an expander
    like the DNA electrophoresis matrix cage15."""
    side = max(2, round(n ** (1 / 3)))
    g = grid3d(side, side, side)
    rng = np.random.default_rng(seed)
    extra = [rng.permutation(g.n)[:(g.n // 2) * 2].reshape(-1, 2)
             for _ in range(deg // 4)]
    return from_edges(g.n, np.concatenate([_edges(g)] + extra))


def family_graph(family: str, n: int, seed: int) -> CSR:
    """A graph of ``family`` with about ``n`` vertices."""
    if family == "grid2d":
        nx = max(2, round(math.sqrt(n)))
        return grid2d(nx, max(2, round(n / nx)))
    if family == "grid3d":
        s = max(2, round(n ** (1 / 3)))
        return grid3d(s, s, max(2, round(n / (s * s))))
    if family == "circuit":
        return circuit(n, seed)
    if family == "rgg2d":
        return rgg2d(n, seed)
    if family == "cage_like":
        return cage_like(n, seed)
    raise ValueError(f"unknown family {family!r}")


def config_graph(spec: Dict) -> CSR:
    """The one graph a configuration names (``{"family": ..., sizes}``)."""
    if spec["family"] == "grid3d":
        return grid3d(spec["nx"], spec["ny"], spec["nz"])
    if spec["family"] == "grid2d":
        return grid2d(spec["nx"], spec["ny"])
    return family_graph(spec["family"], spec["n"], spec.get("seed", 0))


def mix(seed: int, k: int) -> int:
    """A 31-bit seed of (seed, k): the k-th draw of a run's stream."""
    h = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, int(k)])
    return int(h.integers(0, 2 ** 31 - 1))


@dataclasses.dataclass(frozen=True)
class Pattern:
    family: str
    n: int
    graph_seed: int
    order_seed: int


def pattern_stream(cfg: Dict, seed: int, count: int) -> List[Pattern]:
    """``count`` requests of a pattern mix.

    Sizes: ``sizes`` sizes spaced log-uniformly over ``[n_min, n_max]``
    (the midpoints of equal steps of log n), in ``bins`` bins of
    consecutive sizes.  The mix deals blocks: each block holds every
    family once with a size of each bin, the size within its bin cycling
    from block to block from an offset drawn from ``seed``, and each block
    is dealt in an order drawn from ``seed``.  So every stretch of whole
    blocks carries the same work whatever the seed, and ``sizes / bins``
    blocks send each family at every size.  The generator and ordering
    seeds of a request are drawn from ``seed`` and its index."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, 0x5EED])
    fams, k, nb = cfg["families"], int(cfg["sizes"]), int(cfg["bins"])
    lo, hi = math.log(cfg["n_min"]), math.log(cfg["n_max"])
    sizes = [int(round(math.exp(lo + (hi - lo) * (i + 0.5) / k)))
             for i in range(k)]
    per = k // nb
    bins = [sizes[b * per:(b + 1) * per] for b in range(nb)]
    offset = rng.integers(0, per, (len(fams), nb))
    out: List[Pattern] = []
    block = 0
    while len(out) < count:
        slots = [(f, bins[b][(block + offset[i, b]) % per])
                 for i, f in enumerate(fams) for b in range(nb)]
        for j in rng.permutation(len(slots)):
            family, n = slots[j]
            out.append(Pattern(family, n, int(rng.integers(0, 2 ** 31 - 1)),
                               int(rng.integers(0, 2 ** 31 - 1))))
        block += 1
    return out[:count]
