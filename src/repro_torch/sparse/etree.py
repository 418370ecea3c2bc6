"""Elimination tree + postorder (Liu's algorithm with path compression)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph


def etree(g: Graph, perm: np.ndarray) -> np.ndarray:
    """Elimination tree of the permuted matrix.

    ``perm`` is the *ordering*: perm[k] = original vertex eliminated k-th
    (an inverse-permutation fragment assembly in paper terms gives exactly
    this).  Returns parent[] over elimination positions (−1 = root).
    """
    n = g.n
    iperm = np.empty(n, dtype=np.int64)
    iperm[perm] = np.arange(n)
    parent = -np.ones(n, dtype=np.int64)
    ancestor = -np.ones(n, dtype=np.int64)
    xadj, adjncy = g.xadj, g.adjncy
    for i in range(n):
        v = perm[i]
        for u in adjncy[xadj[v]:xadj[v + 1]]:
            k = iperm[u]
            if k >= i:
                continue
            # walk up from k to the root, path-compressing to i
            j = k
            while ancestor[j] != -1 and ancestor[j] != i:
                nxt = ancestor[j]
                ancestor[j] = i
                j = nxt
            if ancestor[j] == -1:
                ancestor[j] = i
                parent[j] = i
    return parent


def postorder(parent: np.ndarray) -> np.ndarray:
    """Postorder of the elimination forest (iterative DFS)."""
    n = len(parent)
    # build child lists (reversed so DFS pops in ascending order)
    head = -np.ones(n, dtype=np.int64)
    nxt = -np.ones(n, dtype=np.int64)
    for v in range(n - 1, -1, -1):
        p = parent[v]
        if p >= 0:
            nxt[v] = head[p]
            head[p] = v
    post = np.empty(n, dtype=np.int64)
    k = 0
    stack = []
    for root in range(n):
        if parent[root] != -1:
            continue
        stack.append(root)
        while stack:
            v = stack[-1]
            c = head[v]
            if c != -1:
                head[v] = nxt[c]   # consume child
                stack.append(c)
            else:
                post[k] = v
                k += 1
                stack.pop()
    assert k == n
    return post
