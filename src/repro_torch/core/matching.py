"""Synchronous probabilistic heavy-edge matching (paper §3.2), in torch.

The paper's request/grant protocol maps one-to-one onto data-parallel rounds:

  * every unmatched vertex picks a mating candidate among its unmatched
    neighbors, "randomly chosen among vertices linked by edges of heaviest
    weight" — here a masked argmax over the ELL row with a random tiebreak;
  * query buffers are exchanged and feasible matings granted — here a
    coin flip splits vertices into proposers/acceptors (so grant chains
    cannot form), and grants are resolved with scatter max/min reductions;
  * unsatisfied requests are notified and vertices re-enqueued — here simply
    the next round's unmatched mask.

We run a fixed number of rounds (default 8) and leave stragglers unmatched
(singletons), the paper's almost-empty stopping rule.  The rounds run as
batched tensor operations on the device of the inputs, one lane per graph;
the grant's max and min reductions are order-independent, so the result
is exact on any device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng

INT_MAX = 2 ** 31 - 1


def heavy_edge_matching_multi(nbr: torch.Tensor, wgt: torch.Tensor,
                              keys: torch.Tensor,
                              rounds: int = 8) -> torch.Tensor:
    """Matching of L ELL graphs: (L, n, d) → (L, n) mate ids.

    nbr (L, n, d) int32 ids (-1 padding), wgt (L, n, d) int32 edge
    weights (0 padding), keys (L, 2) PRNG keys, one per lane.  Returns
    int32 ``match`` with ``match[l, v]`` the mate of v (v for singletons).
    """
    L, n, d = nbr.shape
    dev = nbr.device
    valid = nbr >= 0
    nbr_safe = torch.where(valid, nbr, 0).long()
    flat = nbr_safe.reshape(L, n * d)
    wgt_f = wgt.to(torch.float32)
    vid = torch.arange(n, device=dev).expand(L, n)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    rkeys = prng.split(keys, rounds)                        # (L, rounds, 2)
    match = torch.full((L, n), -1, dtype=torch.long, device=dev)
    for r in range(rounds):
        k_coin, k_tie, k_grant = prng.split(rkeys[:, r], 3).unbind(1)
        unmatched = match < 0
        # coin flip: proposers vs acceptors (breaks grant chains)
        is_prop = prng.bernoulli(k_coin, 0.5, (n,)) & unmatched
        is_acc = ~is_prop & unmatched

        # --- propose: heaviest unmatched acceptor neighbor, random tiebreak
        nbr_ok = valid & is_acc.gather(1, flat).reshape(L, n, d)
        tie = prng.uniform(k_tie, (n, d))
        score = torch.where(nbr_ok, wgt_f + tie, neg_inf)
        best_slot = score.argmax(dim=2, keepdim=True)
        has_cand = nbr_ok.any(dim=2)
        prop = torch.where(is_prop & has_cand,
                           nbr_safe.gather(2, best_slot)[..., 0], -1)
        has_prop = prop >= 0
        prop_w = torch.where(has_prop, wgt.gather(2, best_slot)[..., 0], 0)

        # --- grant: acceptor takes heaviest proposal (random tiebreak)
        gtie = prng.uniform(k_grant, (n,))
        gkey = torch.where(has_prop, prop_w.to(torch.float32) + gtie, neg_inf)
        seg = torch.where(has_prop, prop, n)                 # dump column n
        target = torch.where(has_prop, prop, 0)
        best = torch.full((L, n + 1), float("-inf"), device=dev)
        best = best.scatter_reduce(1, seg, gkey, "amax")
        is_best = has_prop & (gkey >= best.gather(1, target))
        # min proposer id among best-key holders (deterministic final tie)
        winner = torch.full((L, n + 1), INT_MAX, dtype=torch.long,
                            device=dev).scatter_reduce(
            1, seg, torch.where(is_best, vid, INT_MAX), "amin")
        granted = is_best & (winner.gather(1, target) == vid)

        # --- commit both directions
        match = torch.where(granted, prop, match)
        ext = torch.cat([match, match.new_zeros(L, 1)], dim=1)
        ext.scatter_(1, torch.where(granted, prop, n),
                     torch.where(granted, vid, -1))
        match = ext[:, :n]
    return torch.where(match < 0, vid, match).to(torch.int32)


def heavy_edge_matching(nbr: torch.Tensor, wgt: torch.Tensor,
                        key: torch.Tensor, rounds: int = 8) -> torch.Tensor:
    """Single-graph form: (n, d) ELL arrays and one key → (n,) mates."""
    return heavy_edge_matching_multi(nbr[None], wgt[None], key[None],
                                     rounds=rounds)[0]


def validate_matching(match: np.ndarray) -> bool:
    """match is an involution: match[match[v]] == v."""
    match = np.asarray(match)
    return bool(np.all(match[match] == np.arange(len(match))))
