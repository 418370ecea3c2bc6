"""Initial separator on the coarsest graph (paper §3.2, "multi-sequential
computation of initial partitions").

Greedy graph growing from a random seed vertex until half the total weight
is absorbed; the frontier of the grown region becomes the vertex separator.
K independent tries (one per fold-dup instance) are refined by FM and the
best wins — the paper's independent multilevel instances collapse to
independent initial partitions + refinements once the graph is centralized.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.graph import Graph
from repro_torch.core.fm import refine_parts, separator_is_valid
from repro_torch.util import mix_seeds


def grow_part(g: Graph, seed: int) -> np.ndarray:
    """One greedy-growing try.  Returns part vector (0/1/2)."""
    rng = np.random.default_rng(seed)
    n = g.n
    total = g.total_vwgt()
    part = np.ones(n, dtype=np.int8)          # all side 1
    start = int(rng.integers(n))
    w0 = 0
    in0 = np.zeros(n, bool)
    frontier = [start]
    # BFS-order growing with slight random shuffling of each layer
    while frontier and w0 * 2 < total:
        rng.shuffle(frontier)
        nxt = []
        for v in frontier:
            if in0[v] or w0 * 2 >= total:
                continue
            in0[v] = True
            w0 += int(g.vwgt[v])
            nxt.extend(int(u) for u in g.neighbors(v) if not in0[u])
        frontier = nxt
    part[in0] = 0
    # separator = side-1 vertices adjacent to side 0
    src = np.repeat(np.arange(n), g.degrees())
    touch = (part[src] == 0) & (part[g.adjncy] == 1)
    part[np.unique(g.adjncy[touch])] = 2
    return part


@obs.traced("nd:initial")
def initial_parts(g: Graph, seed: int, k_tries: int = 8) -> np.ndarray:
    """Stacked greedy-growing tries (K, n) — the host half of the stage.

    The FM refinement of these tries is a separate ``FMWork`` so a driver
    can batch it with work from other subproblems.
    """
    return np.stack([grow_part(g, seed * 1009 + k) for k in range(k_tries)])


def initial_separator(g: Graph, seed: int, k_tries: int = 8,
                      eps_frac: float = 0.1,
                      device=None) -> Tuple[np.ndarray, float]:
    """Best-of-K greedy+FM separator of the (small) coarsest graph.

    All K tries are refined in a single batched FM call (one instance per
    fold-dup working copy) on ``device``.
    """
    nbr, _ = g.to_ell()
    parts0 = initial_parts(g, seed, k_tries)
    part, sep_w, _ = refine_parts(
        nbr, g.vwgt, parts0[0], np.zeros(g.n, bool), mix_seeds(seed, 0),
        k_inst=k_tries, eps_frac=eps_frac, passes=3, n_pert=4,
        parts_init=parts0, device=device)
    assert separator_is_valid(nbr, part)
    return part, sep_w
