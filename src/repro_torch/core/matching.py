"""Synchronous probabilistic heavy-edge matching (paper §3.2).

The paper's request/grant protocol maps one-to-one onto data-parallel rounds:

  * every unmatched vertex picks a mating candidate among its unmatched
    neighbors, "randomly chosen among vertices linked by edges of heaviest
    weight" — here a masked argmax over the ELL row with a random tiebreak;
  * query buffers are exchanged and feasible matings granted — here a
    coin flip splits vertices into proposers/acceptors (so grant chains
    cannot form), and each acceptor keeps the largest packed (key, id)
    word of its proposals;
  * unsatisfied requests are notified and vertices re-enqueued — here simply
    the next round's unmatched mask.

We run a fixed number of rounds (default 8) and leave stragglers unmatched
(singletons), the paper's almost-empty stopping rule.  The rounds run in
``kernels.matching.heavy_edge_matching_multi``, the one batched entry,
which this module re-exports: on the card as the hand-written kernel
(``csrc/matching.cu``), on the CPU as its plain torch version; both give
the reference's matching exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.matching import heavy_edge_matching_multi

__all__ = ["heavy_edge_matching_multi", "heavy_edge_matching",
           "validate_matching"]


def heavy_edge_matching(nbr: torch.Tensor, wgt: torch.Tensor,
                        key: torch.Tensor, rounds: int = 8) -> torch.Tensor:
    """Single-graph form: (n, d) ELL arrays and one key → (n,) mates."""
    return heavy_edge_matching_multi(nbr[None], wgt[None], key[None],
                                     rounds=rounds)[0]


def validate_matching(match: np.ndarray) -> bool:
    """match is an involution: match[match[v]] == v."""
    match = np.asarray(match)
    return bool(np.all(match[match] == np.arange(len(match))))
