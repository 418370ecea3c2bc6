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

__all__ = ["hash_mix", "hash_u32", "hash_unit", "heavy_edge_matching_multi",
           "heavy_edge_matching", "validate_matching"]

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c,
    with every partial product below 2^48."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """Avalanche hash (lowbias32) of 32-bit values held in int64."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash_mix(*xs) -> torch.Tensor:
    """Chain ``hash_u32`` over several broadcastable integer tensors (or
    ints); each value is taken mod 2^32, as the reference's cast to
    uint32 takes it.  Returns int64 values in [0, 2^32)."""
    h = None
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    for x in xs:
        x = torch.as_tensor(x, device=dev).long() & _M32
        prev = 0x9E3779B9 if h is None else h
        h = hash_u32(prev ^ ((_mul32(x, 0x85EBCA6B) + 1) & _M32))
    return h


def hash_unit(*xs) -> torch.Tensor:
    """Deterministic uniform tie break in [0, 1): the hash rounded to
    float32 (to nearest), times 2^-32."""
    return hash_mix(*xs).to(torch.float32) * (2.0 ** -32)


def heavy_edge_matching(nbr: torch.Tensor, wgt: torch.Tensor,
                        key: torch.Tensor, rounds: int = 8) -> torch.Tensor:
    """Single-graph form: (n, d) ELL arrays and one key → (n,) mates."""
    return heavy_edge_matching_multi(nbr[None], wgt[None], key[None],
                                     rounds=rounds)[0]


def validate_matching(match: np.ndarray) -> bool:
    """match is an involution: match[match[v]] == v."""
    match = np.asarray(match)
    return bool(np.all(match[match] == np.arange(len(match))))
