"""Static mapping by dual recursive bipartitioning (Scotch's k-way mapping).

The paper's §5 names static mapping as the intended extension of the same
building blocks; here it is the integration point of the ordering library
into the LM framework: MoE experts (tasks, weighted by co-activation
traffic) are mapped onto the device hierarchy (pods × chips, slow
inter-pod links) so that heavy-traffic expert pairs land close together —
minimizing the expensive cross-pod all-to-all bytes.

Algorithm: recursively bisect the task graph (balanced min-cut) while
bisecting the device set along its slowest axis; recurse until single
devices remain.  ``edge_bisect`` is also the building block of
``nd._fallback_separator``, which turns its boundary into a vertex
separator when the multilevel pipeline fails on a large subgraph.

Host numpy throughout (task graphs of experts or stages are small), bit
for bit the reference's ``core.mapping``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.graph import Graph


@dataclasses.dataclass(frozen=True)
class DeviceTier:
    """One level of the device hierarchy: ``count`` groups, crossing such a
    group boundary costs ``link_cost`` per unit traffic."""
    count: int
    link_cost: float


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


def static_map(g: Graph, tiers: Sequence[DeviceTier], seed: int = 0
               ) -> np.ndarray:
    """Map task graph vertices onto the leaves of the device hierarchy.

    Returns assign[v] = flat device index in [0, Π tier.count).
    """
    n_dev = int(np.prod([t.count for t in tiers]))
    assign = np.zeros(g.n, dtype=np.int64)

    def rec(sub: Graph, ids: np.ndarray, dev_lo: int, n_dev_here: int,
            s: int) -> None:
        if n_dev_here <= 1 or sub.n == 0:
            assign[ids] = dev_lo
            return
        half = edge_bisect(sub, seed=s)
        left = n_dev_here // 2
        g0, old0 = sub.induced_subgraph(half == 0)
        g1, old1 = sub.induced_subgraph(half == 1)
        rec(g0, ids[old0], dev_lo, left, s * 2 + 1)
        rec(g1, ids[old1], dev_lo + left, n_dev_here - left, s * 2 + 2)

    rec(g, np.arange(g.n), 0, n_dev, seed + 1)
    return assign


def traffic_cost(g: Graph, assign: np.ndarray,
                 tiers: Sequence[DeviceTier]) -> float:
    """Σ over edges of link_cost(highest tier boundary crossed) · weight."""
    counts = [t.count for t in tiers]
    src = np.repeat(np.arange(g.n), g.degrees())
    a, b = assign[src], assign[g.adjncy]
    cost = np.zeros(len(a))

    def coords(x):
        """Device index -> per-tier coordinates (row-major)."""
        out = []
        for c in reversed(counts):
            out.append(x % c)
            x = x // c
        return list(reversed(out))
    ca, cb = coords(a), coords(b)
    crossed = np.zeros(len(a), bool)
    for t, (xa, xb) in enumerate(zip(ca, cb)):
        newly = (~crossed) & (xa != xb)
        cost[newly] = tiers[t].link_cost
        crossed |= newly
    return float((cost * g.adjwgt).sum()) / 2.0


def expert_placement(coactivation: np.ndarray, n_pods: int, chips_per_pod: int,
                     inter_pod_cost: float = 10.0, seed: int = 0
                     ) -> np.ndarray:
    """Place E experts on (n_pods × chips_per_pod) devices.

    ``coactivation[i, j]`` = expected tokens routed through experts i and j
    in the same layer step (the all-to-all traffic proxy).
    Returns device index per expert.
    """
    E = coactivation.shape[0]
    w = np.maximum(coactivation, coactivation.T)
    iu, ju = np.nonzero(np.triu(w, 1))
    scale = max(w.max(), 1e-9)
    ew = np.maximum((w[iu, ju] / scale * 1000).astype(np.int64), 1)
    g = Graph.from_edges(E, np.stack([iu, ju], 1), ewgt=ew)
    tiers = [DeviceTier(n_pods, inter_pod_cost),
             DeviceTier(chips_per_pod, 1.0)]
    return static_map(g, tiers, seed=seed)
