"""Host-side graph container mirroring PT-Scotch's centralized graph.

The paper (§2.1) represents graphs by adjacency lists (CSR).  On the host we
keep CSR in numpy; the device data plane uses padded ELL arrays (rectangular
``(n, dmax)`` neighbor / weight tables with ``-1`` fill), the layout the
reference package's kernels take, so both packages see the same tiles.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch import obs


@dataclasses.dataclass
class Graph:
    """Undirected graph in symmetric CSR form (both arc directions stored).

    Mirrors Scotch's centralized graph: ``xadj`` is ``vertloctab`` /
    ``vendloctab`` fused (contiguous), ``adjncy`` is ``edgeloctab``.
    """

    xadj: np.ndarray      # (n+1,) int64 — CSR row pointers
    adjncy: np.ndarray    # (2m,)  int32 — neighbor vertex ids
    vwgt: np.ndarray      # (n,)   int64 — vertex weights
    adjwgt: np.ndarray    # (2m,)  int64 — edge weights (symmetric)

    # ------------------------------------------------------------------ #
    @property
    def n(self) -> int:
        return len(self.xadj) - 1

    @property
    def nnz(self) -> int:
        """Number of arcs (2m)."""
        return len(self.adjncy)

    @property
    def m(self) -> int:
        return self.nnz // 2

    def degrees(self) -> np.ndarray:
        return np.diff(self.xadj)

    def neighbors(self, v: int) -> np.ndarray:
        return self.adjncy[self.xadj[v]:self.xadj[v + 1]]

    def total_vwgt(self) -> int:
        return int(self.vwgt.sum())

    # ------------------------------------------------------------------ #
    @staticmethod
    def from_edges(n: int, edges: np.ndarray,
                   vwgt: Optional[np.ndarray] = None,
                   ewgt: Optional[np.ndarray] = None) -> "Graph":
        """Build from an (m, 2) array of undirected edges (dedup'd, no loops)."""
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        mask = edges[:, 0] != edges[:, 1]
        edges = edges[mask]
        if ewgt is None:
            ewgt = np.ones(len(edges), dtype=np.int64)
        else:
            ewgt = np.asarray(ewgt, dtype=np.int64)[mask]
        # canonicalize + dedup (accumulating weights of parallel edges)
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        key = lo * n + hi
        order = np.argsort(key, kind="stable")
        key, lo, hi, ewgt = key[order], lo[order], hi[order], ewgt[order]
        if len(key):
            uniq = np.concatenate([[True], key[1:] != key[:-1]])
            seg = np.cumsum(uniq) - 1
            wacc = np.zeros(seg[-1] + 1, dtype=np.int64)
            np.add.at(wacc, seg, ewgt)
            lo, hi, ewgt = lo[uniq], hi[uniq], wacc
        src = np.concatenate([lo, hi])
        dst = np.concatenate([hi, lo])
        w = np.concatenate([ewgt, ewgt])
        order = np.argsort(src * np.int64(n) + dst, kind="stable")
        src, dst, w = src[order], dst[order], w[order]
        xadj = np.zeros(n + 1, dtype=np.int64)
        np.add.at(xadj, src + 1, 1)
        xadj = np.cumsum(xadj)
        if vwgt is None:
            vwgt = np.ones(n, dtype=np.int64)
        return Graph(xadj, dst.astype(np.int32), np.asarray(vwgt, np.int64), w)

    @staticmethod
    def from_dense(a: np.ndarray) -> "Graph":
        """Build from a symmetric boolean/weight adjacency matrix."""
        a = np.asarray(a)
        iu, ju = np.nonzero(np.triu(a, 1))
        return Graph.from_edges(a.shape[0], np.stack([iu, ju], 1),
                                ewgt=a[iu, ju].astype(np.int64))

    # ------------------------------------------------------------------ #
    def check(self) -> None:
        """Structural invariants (symmetry, no self loops, sorted ptrs)."""
        assert self.xadj[0] == 0 and self.xadj[-1] == len(self.adjncy)
        assert np.all(np.diff(self.xadj) >= 0)
        n = self.n
        assert np.all(self.adjncy >= 0) and np.all(self.adjncy < n)
        src = np.repeat(np.arange(n, dtype=np.int64), self.degrees())
        assert not np.any(src == self.adjncy), "self loop"
        # symmetry (pattern + weights)
        fwd = src * n + self.adjncy
        bwd = self.adjncy.astype(np.int64) * n + src
        of, ob = np.argsort(fwd, kind="stable"), np.argsort(bwd, kind="stable")
        assert np.array_equal(fwd[of], bwd[ob]), "asymmetric pattern"
        assert np.array_equal(self.adjwgt[of], self.adjwgt[ob]), "asymmetric weights"

    # ------------------------------------------------------------------ #
    @obs.traced("nd:split")
    def induced_subgraph(self, keep: np.ndarray) -> Tuple["Graph", np.ndarray]:
        """Subgraph induced by boolean mask ``keep``.

        Returns (subgraph, old_ids) where ``old_ids[new] = old``.  This is the
        distributed induced-subgraph routine of §3.1, centralized: vertex
        labels of selected vertices are "spread" (here: a renumbering table)
        and adjacency rows filtered.
        """
        keep = np.asarray(keep, dtype=bool)
        old_ids = np.nonzero(keep)[0]
        newid = -np.ones(self.n, dtype=np.int64)
        newid[old_ids] = np.arange(len(old_ids))
        deg = self.degrees()
        src = np.repeat(np.arange(self.n, dtype=np.int64), deg)
        emask = keep[src] & keep[self.adjncy]
        s, d, w = newid[src[emask]], newid[self.adjncy[emask]], self.adjwgt[emask]
        nn = len(old_ids)
        order = np.argsort(s * max(nn, 1) + d, kind="stable")
        s, d, w = s[order], d[order], w[order]
        xadj = np.zeros(nn + 1, dtype=np.int64)
        np.add.at(xadj, s + 1, 1)
        xadj = np.cumsum(xadj)
        return (Graph(xadj, d.astype(np.int32), self.vwgt[old_ids].copy(), w),
                old_ids)

    # ------------------------------------------------------------------ #
    @obs.traced("nd:ell")
    def to_ell(self, dmax: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Padded ELL arrays ``(nbr, wgt)`` of shape (n, dmax); -1/0 fill."""
        deg = self.degrees()
        if dmax is None:
            dmax = int(deg.max()) if self.n else 1
        dmax = max(int(dmax), 1)
        nbr = -np.ones((self.n, dmax), dtype=np.int32)
        wgt = np.zeros((self.n, dmax), dtype=np.int32)
        src = np.repeat(np.arange(self.n, dtype=np.int64), deg)
        col = (np.arange(len(self.adjncy)) - self.xadj[src])
        ok = col < dmax  # truncate ultra-high-degree rows only if dmax forced
        nbr[src[ok], col[ok]] = self.adjncy[ok]
        wgt[src[ok], col[ok]] = self.adjwgt[ok]
        return nbr, wgt

    # ------------------------------------------------------------------ #
    @obs.traced("nd:components")
    def components(self) -> np.ndarray:
        """Connected component id per vertex, ids in order of each
        component's smallest vertex (the order a scan from vertex 0 meets
        them). One compiled pass over the CSR as it is: the pattern is
        symmetric (``check``), so nothing is symmetrised."""
        if self.n == 0:
            return np.zeros(0, dtype=np.int64)
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import connected_components
        adj = csr_matrix((np.ones(self.nnz, dtype=np.int8), self.adjncy,
                          self.xadj), shape=(self.n, self.n))
        _, labels = connected_components(adj, directed=False)
        _, first = np.unique(labels, return_index=True)
        rank = np.empty(len(first), dtype=np.int64)
        rank[np.argsort(first)] = np.arange(len(first))
        return rank[labels]
