"""Balanced edge bisection, the fallback separator's building block.

Only ``edge_bisect`` of the reference's static-mapping module is needed
here: ``nd._fallback_separator`` turns its boundary into a vertex
separator when the multilevel pipeline fails on a large subgraph.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph


def edge_bisect(g: Graph, seed: int = 0, k_tries: int = 4,
                passes: int = 4, eps: float = 0.1) -> np.ndarray:
    """Balanced 2-way partition (0/1) minimizing *weighted edge cut*.

    FM-style hill-climbing with per-pass best-prefix rollback (mapping
    needs the edge-cut objective, unlike ordering's vertex separators).
    Small task graphs (experts, stages) → plain numpy is plenty.
    """
    n = g.n
    if n <= 1:
        return np.zeros(n, dtype=np.int8)
    src = np.repeat(np.arange(n), g.degrees())
    total = g.total_vwgt()
    best_part, best_cut = None, np.inf
    for t in range(k_tries):
        rng = np.random.default_rng(seed * 97 + t)
        part = (rng.permutation(n) < n // 2).astype(np.int8)
        for _ in range(passes):
            # gain[v] = ext(v) - int(v) under current part
            w_to0 = np.zeros(n)
            np.add.at(w_to0, src, g.adjwgt * (part[g.adjncy] == 0))
            w_to1 = np.zeros(n)
            np.add.at(w_to1, src, g.adjwgt * (part[g.adjncy] == 1))
            gain = np.where(part == 0, w_to1 - w_to0, w_to0 - w_to1)
            locked = np.zeros(n, bool)
            w = np.array([g.vwgt[part == 0].sum(),
                          g.vwgt[part == 1].sum()], dtype=float)
            cut = float(g.adjwgt[part[src] != part[g.adjncy]].sum()) / 2
            trace, cur = [], cut
            for _move in range(n):
                cand = np.where(~locked)[0]
                if not len(cand):
                    break
                # feasibility: don't overfill the target side
                p_of = part[cand]
                neww = w[1 - p_of] + g.vwgt[cand]
                feas = neww <= total * (0.5 + eps)
                if not feas.any():
                    break
                scores = np.where(feas, gain[cand], -np.inf)
                v = cand[int(np.argmax(scores))]
                pv = part[v]
                cur -= gain[v]
                w[pv] -= g.vwgt[v]
                w[1 - pv] += g.vwgt[v]
                part[v] = 1 - pv
                locked[v] = True
                trace.append((v, cur))
                # incremental gain update for neighbors of v
                nb = g.neighbors(v)
                wv = g.adjwgt[g.xadj[v]:g.xadj[v + 1]].astype(float)
                same_new = part[nb] == part[v]
                gain[nb] += np.where(same_new, -2 * wv, 2 * wv)
                gain[v] = -gain[v]
            if not trace:
                break
            cuts = np.array([c for _, c in trace])
            k_best = int(np.argmin(cuts))
            if cuts[k_best] >= cut - 1e-9:
                # no improvement: roll everything back, stop passes
                for v, _ in trace:
                    part[v] = 1 - part[v]
                break
            for v, _ in trace[k_best + 1:]:
                part[v] = 1 - part[v]
        final_cut = cut_weight(g, part)
        imb = abs(g.vwgt[part == 0].sum() - g.vwgt[part == 1].sum())
        score = final_cut + (0 if imb <= eps * total else 1e12)
        if score < best_cut:
            best_part, best_cut = part.copy(), score
    return best_part


def cut_weight(g: Graph, assign: np.ndarray) -> float:
    src = np.repeat(np.arange(g.n), g.degrees())
    cut = assign[src] != assign[g.adjncy]
    return float(g.adjwgt[cut].sum()) / 2.0
