"""Symbolic Cholesky factorisation: the fill and the operation count that
an ordering gives.

For an ordering ``perm`` (``perm[k]`` = the vertex eliminated k-th) of a
graph's symmetric pattern, ``counts`` returns the nonzeros of each
column of the Cholesky factor L, diagonal included, by the elimination
tree and the skeleton column-count algorithm of Gilbert, Ng and Peyton
(as CSparse's ``cs_counts``).  NNZ = Σ c and OPC = Σ c², the two quality
measures of the paper.  ``dense_counts`` eliminates a dense boolean
matrix and is the check of ``counts`` on small graphs.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def is_permutation(perm, n: int) -> bool:
    p = np.asarray(perm)
    if p.ndim != 1 or len(p) != n or not np.issubdtype(p.dtype, np.integer):
        return False
    if n == 0:
        return True
    if p.min() < 0 or p.max() >= n:
        return False
    return bool((np.bincount(p, minlength=n) == 1).all())


def _permuted_rows(xadj: np.ndarray, adjncy: np.ndarray,
                   perm: np.ndarray) -> Tuple[List[List[int]], np.ndarray]:
    n = len(xadj) - 1
    pos = np.empty(n, dtype=np.int64)
    pos[perm] = np.arange(n)
    src = np.repeat(np.arange(n), np.diff(xadj))
    a, b = pos[src], pos[adjncy]
    order = np.lexsort((b, a))
    a, b = a[order], b[order]
    starts = np.searchsorted(a, np.arange(n + 1))
    flat = b.tolist()
    return [flat[starts[i]:starts[i + 1]] for i in range(n)], pos


def _etree(rows: List[List[int]]) -> List[int]:
    n = len(rows)
    parent = [-1] * n
    ancestor = [-1] * n
    for i in range(n):
        for k in rows[i]:
            if k >= i:
                continue
            j = k
            while ancestor[j] != -1 and ancestor[j] != i:
                nxt = ancestor[j]
                ancestor[j] = i
                j = nxt
            if ancestor[j] == -1:
                ancestor[j] = i
                parent[j] = i
    return parent


def _postorder(parent: List[int]) -> List[int]:
    n = len(parent)
    children: List[List[int]] = [[] for _ in range(n)]
    for v in range(n - 1, -1, -1):
        if parent[v] >= 0:
            children[parent[v]].append(v)
    post: List[int] = []
    for root in range(n):
        if parent[root] != -1:
            continue
        stack = [root]
        while stack:
            v = stack[-1]
            if children[v]:
                stack.append(children[v].pop())
            else:
                post.append(stack.pop())
    return post


def counts(xadj: np.ndarray, adjncy: np.ndarray,
           perm: np.ndarray) -> np.ndarray:
    """Column counts of L for the ordering ``perm`` (elimination
    positions), int64 (n,)."""
    n = len(xadj) - 1
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    rows, _ = _permuted_rows(np.asarray(xadj), np.asarray(adjncy),
                             np.asarray(perm, dtype=np.int64))
    parent = _etree(rows)
    post = _postorder(parent)
    first = [-1] * n
    delta = [0] * n
    for k, j in enumerate(post):
        delta[j] = 1 if first[j] == -1 else 0
        while j != -1 and first[j] == -1:
            first[j] = k
            j = parent[j]
    maxfirst = [-1] * n
    prevleaf = [-1] * n
    ancestor = list(range(n))
    for j in post:
        if parent[j] != -1:
            delta[parent[j]] -= 1
        fj = first[j]
        for i in rows[j]:
            if i <= j or fj <= maxfirst[i]:
                continue
            maxfirst[i] = fj
            jprev = prevleaf[i]
            prevleaf[i] = j
            if jprev == -1:
                delta[j] += 1
                continue
            q = jprev
            while q != ancestor[q]:
                q = ancestor[q]
            s = jprev
            while s != q:
                nxt = ancestor[s]
                ancestor[s] = q
                s = nxt
            delta[j] += 1
            delta[q] -= 1
        if parent[j] != -1:
            ancestor[j] = parent[j]
    for j in post:
        if parent[j] != -1:
            delta[parent[j]] += delta[j]
    return np.asarray(delta, dtype=np.int64)


def nnz_opc(xadj, adjncy, perm) -> Tuple[int, float]:
    c = counts(xadj, adjncy, perm).astype(np.float64)
    return int(c.sum()), float((c * c).sum())


def dense_counts(xadj, adjncy, perm) -> np.ndarray:
    """The same counts by eliminating a dense boolean matrix (small n)."""
    n = len(xadj) - 1
    pos = np.empty(n, dtype=np.int64)
    pos[np.asarray(perm)] = np.arange(n)
    a = np.zeros((n, n), dtype=bool)
    src = np.repeat(np.arange(n), np.diff(xadj))
    a[pos[src], pos[np.asarray(adjncy)]] = True
    np.fill_diagonal(a, True)
    out = np.zeros(n, dtype=np.int64)
    for k in range(n):
        below = np.flatnonzero(a[k + 1:, k]) + k + 1
        out[k] = len(below) + 1
        a[np.ix_(below, below)] = True
    return out
