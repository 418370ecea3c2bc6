"""Ordering baselines the paper compares against (or that frame its results).

* ``parmetis_like``  — nested dissection with the parallel-refinement
  restrictions the paper attributes to ParMETIS [20]: no fold-dup
  duplication, single refinement instance, *strictly-improving moves only*
  (no hill-climbing), refinement on the full graph (no band), and interface
  vertices of the block distribution frozen.  This is the degradation
  mechanism of §3.3, implemented inside the same multilevel machinery so the
  comparison isolates exactly those features.
* ``mindeg_ordering`` — pure sequential minimum degree (paper's other
  classical method, §1).
* ``rcm`` / ``natural`` — profile-ordering reference points; ``rcm`` also
  orders separators above 600 vertices (``nd.separator_perm``).

The nested-dissection baselines take ``device`` as ``nested_dissection``
does (default: the card).
"""
from __future__ import annotations

import numpy as np

from repro_torch import obs
from repro_torch.core.graph import Graph
from repro_torch.core.nd import NDConfig, nested_dissection
from repro_torch.sparse.mindeg import min_degree


def pt_scotch_like(g: Graph, seed: int = 0, nproc: int = 1,
                   cfg: NDConfig | None = None, device=None) -> np.ndarray:
    """The paper's method (default strategy of §4)."""
    return nested_dissection(g, seed=seed, nproc=nproc, cfg=cfg or NDConfig(),
                             device=device)


def parmetis_like(g: Graph, seed: int = 0, nproc: int = 1,
                  device=None) -> np.ndarray:
    cfg = NDConfig(use_band=False, fold_dup=False, refine_strict=True,
                   freeze_interface=True)
    return nested_dissection(g, seed=seed, nproc=nproc, cfg=cfg,
                             device=device)


def mindeg_ordering(g: Graph, seed: int = 0) -> np.ndarray:
    return min_degree(g, tie_seed=seed)


def natural(g: Graph) -> np.ndarray:
    return np.arange(g.n, dtype=np.int64)


@obs.traced("nd:leaf")
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
