"""Minimum-degree ordering on a quotient graph.

Used exactly as in the paper (§3.1): only in the *sequential* context, to
order the small leaf subgraphs of nested dissection ("eventually ending in a
coupling with minimum degree methods [10]").  Exact external degrees on a
quotient graph (elements + variables); no supervariables — leaf graphs are
small, clarity wins.
"""
from __future__ import annotations

import heapq
from typing import Optional

import numpy as np

from repro_torch import obs
from repro_torch.core.graph import Graph


@obs.traced("nd:leaf")
def min_degree(g: Graph, tie_seed: int = 0) -> np.ndarray:
    """Return perm (perm[k] = vertex eliminated k-th)."""
    n = g.n
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    adj = [set(map(int, g.neighbors(v))) for v in range(n)]
    elems: list[set] = [set() for _ in range(n)]   # adjacent elements
    elem_vars: dict[int, set] = {}                 # element -> boundary vars
    alive = np.ones(n, dtype=bool)
    rng = np.random.default_rng(tie_seed)
    tiebreak = rng.permutation(n)

    def ext_degree(v: int) -> int:
        s = set(adj[v])
        for e in elems[v]:
            s |= elem_vars[e]
        s.discard(v)
        return len(s)

    heap = [(len(adj[v]), int(tiebreak[v]), v) for v in range(n)]
    heapq.heapify(heap)
    deg_cache = {v: len(adj[v]) for v in range(n)}
    perm = np.empty(n, dtype=np.int64)
    k = 0
    while k < n:
        d, _, v = heapq.heappop(heap)
        if not alive[v] or d != deg_cache[v]:
            continue                               # stale entry
        # eliminate v -> new element
        lv = set(adj[v])
        for e in elems[v]:
            lv |= elem_vars[e]
            del elem_vars[e]                       # absorbed
        lv.discard(v)
        lv = {u for u in lv if alive[u]}
        alive[v] = False
        perm[k] = v
        k += 1
        elem_vars[v] = lv
        absorbed = set(elems[v])
        for u in lv:
            adj[u].discard(v)
            adj[u] -= lv                           # now covered by element v
            elems[u] -= absorbed
            elems[u].add(v)
            nd = ext_degree(u)
            deg_cache[u] = nd
            heapq.heappush(heap, (nd, int(tiebreak[u]), u))
    return perm
