"""Symbolic Cholesky: column counts, NNZ and OPC of the factored matrix.

Implements the Gilbert–Ng–Peyton skeleton column-count algorithm (as in
CSparse ``cs_counts``), O(m·α(m,n)).  These are the paper's two quality
metrics (§4): NNZ = Σ_c n_c and OPC = Σ_c n_c² with n_c the nonzeros of
column c of L, diagonal included.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.sparse.etree import etree, postorder


def col_counts(g: Graph, perm: np.ndarray) -> np.ndarray:
    n = g.n
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    iperm = np.empty(n, dtype=np.int64)
    iperm[perm] = np.arange(n)
    parent = etree(g, perm)
    post = postorder(parent)

    # first descendant + leaf deltas
    first = -np.ones(n, dtype=np.int64)
    delta = np.zeros(n, dtype=np.int64)
    for k in range(n):
        j = post[k]
        delta[j] = 1 if first[j] == -1 else 0
        while j != -1 and first[j] == -1:
            first[j] = k
            j = parent[j]

    maxfirst = -np.ones(n, dtype=np.int64)
    prevleaf = -np.ones(n, dtype=np.int64)
    ancestor = np.arange(n, dtype=np.int64)
    xadj, adjncy = g.xadj, g.adjncy
    for k in range(n):
        j = post[k]
        if parent[j] != -1:
            delta[parent[j]] -= 1          # j is not a root
        v = perm[j]
        for u in adjncy[xadj[v]:xadj[v + 1]]:
            i = iperm[u]
            if i <= j or first[j] <= maxfirst[i]:
                continue                   # j not a leaf of row subtree T^i
            maxfirst[i] = first[j]
            jprev = prevleaf[i]
            prevleaf[i] = j
            if jprev == -1:
                delta[j] += 1              # first leaf: A(i,j) in skeleton
            else:
                # q = LCA(jprev, j) with path compression
                q = jprev
                while q != ancestor[q]:
                    q = ancestor[q]
                s = jprev
                while s != q:
                    sp = ancestor[s]
                    ancestor[s] = q
                    s = sp
                delta[j] += 1
                delta[q] -= 1
        if parent[j] != -1:
            ancestor[j] = parent[j]

    counts = delta.copy()
    for k in range(n):                     # accumulate in postorder
        j = post[k]
        if parent[j] != -1:
            counts[parent[j]] += counts[j]
    return counts


def nnz_opc(g: Graph, perm: np.ndarray) -> Tuple[int, float]:
    """(NNZ(L), OPC) for ordering ``perm`` (perm[k] = vertex eliminated k-th)."""
    c = col_counts(g, perm).astype(np.float64)
    return int(c.sum()), float((c * c).sum())


def dense_fill_oracle(g: Graph, perm: np.ndarray) -> Tuple[int, float]:
    """O(n³) boolean elimination — oracle for tests (n small)."""
    n = g.n
    a = np.zeros((n, n), dtype=bool)
    iperm = np.empty(n, dtype=np.int64)
    iperm[perm] = np.arange(n)
    src = np.repeat(np.arange(n), np.diff(g.xadj))
    a[iperm[src], iperm[g.adjncy]] = True
    np.fill_diagonal(a, True)
    nnz, opc = 0, 0.0
    for k in range(n):
        below = np.nonzero(a[k + 1:, k])[0] + k + 1
        nc = len(below) + 1
        nnz += nc
        opc += float(nc) ** 2
        if len(below):
            a[np.ix_(below, below)] = True
    return nnz, opc
