"""Profile ordering used for very large separators.

Only ``rcm`` of the reference's baselines module is needed here:
``nd.separator_perm`` orders separators above 600 vertices with it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph


def rcm(g: Graph) -> np.ndarray:
    """Reverse Cuthill–McKee (BFS from a pseudo-peripheral vertex)."""
    n = g.n
    visited = np.zeros(n, bool)
    order = []
    deg = g.degrees()
    for comp_seed in np.argsort(deg):
        if visited[comp_seed]:
            continue
        # pseudo-peripheral: two BFS sweeps
        far = comp_seed
        for _ in range(2):
            frontier = [far]
            seen = {int(far)}
            while frontier:
                nxt = []
                for v in frontier:
                    for u in g.neighbors(v):
                        if int(u) not in seen:
                            seen.add(int(u))
                            nxt.append(int(u))
                if nxt:
                    far = min(nxt, key=lambda v: deg[v])
                frontier = nxt
        start = far
        visited[start] = True
        order.append(start)
        frontier = [start]
        while frontier:
            nxt = []
            for v in frontier:
                nbrs = sorted((int(u) for u in g.neighbors(v)
                               if not visited[u]), key=lambda u: deg[u])
                for u in nbrs:
                    visited[u] = True
                    order.append(u)
                    nxt.append(u)
            frontier = nxt
    return np.array(order[::-1], dtype=np.int64)
