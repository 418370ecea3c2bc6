"""Heavy-edge matching: the CUDA kernel, its plain version, a count.

``heavy_edge_matching_multi`` is the port of the reference's
``core/matching.py`` ``heavy_edge_matching_multi`` (a jitted XLA program,
not Pallas): ``rounds`` synchronous propose/grant rounds over every lane
of an (L, n, d) ELL bucket, each lane with its own threefry key.  On a
CUDA tensor the wrapper launches ``csrc/matching.cu``, which draws the
coins and tie breaks itself from the lanes' keys, in the design
``band_batch.lane_plan`` picks from the lanes' size: one launch a call on
a thread-block cluster per lane, or, for lanes above ``CLUSTER_MAX_SLOTS``
slots, ``2 * rounds + 1`` launches over the whole card (propose and commit
per round, then the singletons); on a CPU tensor it runs
``heavy_edge_matching_multi_plain``.
``launches`` counts the CUDA kernel launches.

Both versions resolve the grant as the kernel does: every proposal packs
its grant key and proposer id into one 64-bit word, and an acceptor keeps
the largest word, which names the heaviest proposal and, among equal
keys, the smallest proposer: exactly the reference's ``segment_max`` then
``segment_min``.  An id outside [-1, n) is taken as padding by both.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch import obs, prng
from repro_torch.kernels import build
from repro_torch.kernels.band_batch import check_tensors, lane_plan

#: number of CUDA kernels ``heavy_edge_matching_multi`` launched
launches = 0

_LOW_MAX = 0x7FFFFFFF
_EMPTY = -2 ** 63


def grant_word(gkey: torch.Tensor, vid: torch.Tensor) -> torch.Tensor:
    """int64 words ordered as (gkey, then the smaller id): the high half is
    an order-preserving signed image of the float32 ``gkey`` (the kernel's
    unsigned image with the sign bit flipped), the low half
    ``0x7FFFFFFF - vid``."""
    bits = gkey.view(torch.int32).long()
    image = torch.where(bits >= 0, bits, bits ^ _LOW_MAX)
    return image * 2 ** 32 + (_LOW_MAX - vid)


def heavy_edge_matching_multi_plain(nbr: torch.Tensor, wgt: torch.Tensor,
                                    keys: torch.Tensor, rounds: int = 8,
                                    tally: Optional[List[tuple]] = None
                                    ) -> torch.Tensor:
    """The rounds in torch, on any device (the kernel's plain version).

    ``tally``, if given, gets one ``(coins, ties, grants)`` per round: the
    draws that round's data needs (a coin per unmatched vertex, a tie break
    per slot a proposer scores, a grant key per proposal).
    """
    L, n, d = nbr.shape
    dev = nbr.device
    valid = (nbr >= 0) & (nbr < n)
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
        best_slot = score.argmax(dim=2, keepdim=True)       # first maximum
        has_cand = nbr_ok.any(dim=2)
        prop = torch.where(is_prop & has_cand,
                           nbr_safe.gather(2, best_slot)[..., 0], -1)
        has_prop = prop >= 0

        # --- grant: each acceptor keeps its largest packed word
        gkey = wgt.gather(2, best_slot)[..., 0].to(torch.float32) + \
            prng.uniform(k_grant, (n,))
        word = torch.where(has_prop, grant_word(gkey, vid), _EMPTY)
        seg = torch.where(has_prop, prop, n)                 # dump column n
        best = torch.full((L, n + 1), _EMPTY, dtype=torch.long, device=dev)
        best = best.scatter_reduce(1, seg, word, "amax")
        granted = has_prop & (best.gather(1, seg) == word)

        # --- commit both directions
        match = torch.where(granted, prop, match)
        ext = torch.cat([match, match.new_zeros(L, 1)], dim=1)
        ext.scatter_(1, torch.where(granted, prop, n),
                     torch.where(granted, vid, -1))
        match = ext[:, :n]
        if tally is not None:
            tally.append((int(unmatched.sum()),
                          int((nbr_ok & is_prop[..., None]).sum()),
                          int(has_prop.sum())))
    return torch.where(match < 0, vid, match).to(torch.int32)


def _check(nbr: torch.Tensor, wgt: torch.Tensor, keys: torch.Tensor,
           rounds: int) -> None:
    if nbr.dim() != 3:
        raise ValueError(f"nbr (L, n, d) expected, got {tuple(nbr.shape)}")
    L, n, d = nbr.shape
    check_tensors(nbr, {"nbr": (nbr, torch.int32, (L, n, d)),
                        "wgt": (wgt, torch.int32, (L, n, d)),
                        "keys": (keys, torch.int64, (L, 2))})
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")


def heavy_edge_matching_multi_kernel(nbr: torch.Tensor, wgt: torch.Tensor,
                                     keys: torch.Tensor,
                                     rounds: int = 8) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (CUDA tensors only), in
    the design ``lane_plan`` picks."""
    global launches
    _check(nbr, wgt, keys, rounds)
    if nbr.device.type != "cuda":
        raise ValueError("heavy_edge_matching_multi_kernel takes CUDA tensors")
    nbr, wgt, keys = nbr.contiguous(), wgt.contiguous(), keys.contiguous()
    L, n, d = nbr.shape
    match = torch.empty((L, n), dtype=torch.int32, device=nbr.device)
    # the grant words (2, L, n), then prop (L, n) int32 and roles (L, n) bytes
    scratch = torch.empty(2 * L * n + (5 * L * n + 7) // 8,
                          dtype=torch.int64, device=nbr.device)
    lib = build.load("matching")
    stream = torch.cuda.current_stream(nbr.device).cuda_stream
    args = (nbr.data_ptr(), wgt.data_ptr(), keys.data_ptr(),
            match.data_ptr(), scratch.data_ptr(), L, n, d, int(rounds))
    design, C = lane_plan(n, d)
    if design == "cluster":
        err, count = lib.matching_cluster_launch(*args, C, stream), 1
    else:
        err = lib.matching_grid_launch(*args, stream)
        count = 2 * int(rounds) + 1
    build.check(err, "matching")
    if L and n:
        launches += count
    return match


@obs.traced("match:launch")
def heavy_edge_matching_multi(nbr: torch.Tensor, wgt: torch.Tensor,
                              keys: torch.Tensor,
                              rounds: int = 8) -> torch.Tensor:
    """Matching of L ELL graphs: (L, n, d) → (L, n) int32 mate ids.

    nbr (L, n, d) int32 ids (-1 padding), wgt (L, n, d) int32 edge weights
    (0 padding), keys (L, 2) int64 PRNG keys, one per lane; n and d are the
    bucket's padded shape, on which the draws depend.  ``match[l, v]`` is
    the mate of v (v for singletons).  CUDA tensors go to the kernel, CPU
    tensors to the plain version.
    """
    _check(nbr, wgt, keys, rounds)
    if nbr.device.type == "cuda":
        return heavy_edge_matching_multi_kernel(nbr, wgt, keys, rounds)
    return heavy_edge_matching_multi_plain(nbr, wgt, keys, rounds)
