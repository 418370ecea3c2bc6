"""The distributed plane's kernels: wrappers, plain versions, counts.

The ports of the reference's four device programs of the distributed
slice: ``ell_relax_step`` (``kernels/ops.py:93``, XLA) and the three
``shard_map`` programs of ``core/dgraph.py``, ``halo_exchange_stacked``,
``distributed_bfs_stacked`` and ``distributed_matching_stacked``.  On one
card the ``parts`` mesh axis is a tensor dimension: a lane of P parts is
an (L, P, n_loc_max) stack, and each ``all_gather`` a read across P.  On
CUDA tensors each wrapper launches its kernel from ``csrc/dgraph.cu``; on
CPU tensors it runs the plain torch version beside it, which computes
the same function.  A wrapper never hands card work to its plain version.

The counts are of CUDA kernel launches:

* ``relax_launches``: ``ell_relax`` launches, one per ``ell_relax_step``
  call and one per step of the distributed BFS, whose steps run this
  kernel in its distributed form (ghosts read from the owners' rows);
* ``halo_launches``: one per ``halo`` call;
* ``dbfs_launches``: the BFS's own kernel, ``dbfs_init`` (the source
  mask and each ghost's owner slot), one per call;
* ``dmatch_launches``: ``1 + 3 * rounds`` per call (init, then propose,
  grant and commit a round).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core.matching import hash_mix, hash_unit
from repro_torch.kernels import build
from repro_torch.kernels.matching import grant_word

#: the distributed BFS's unreached distance (the reference's BIG)
BIG = 2 ** 30
_EMPTY = -2 ** 63

relax_launches = 0
halo_launches = 0
dbfs_launches = 0
dmatch_launches = 0


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _int32(name: str, t: torch.Tensor, dims: int) -> None:
    if t.dtype != torch.int32 or t.dim() != dims:
        raise ValueError(f"{name}: want a {dims}-d int32 tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _same_device(*ts: torch.Tensor) -> None:
    if len({t.device for t in ts}) != 1:
        raise ValueError("the tensors must lie on one device")


# ------------------------------------------------------------ relaxation
def ell_relax_plain(nbr: torch.Tensor, ext: torch.Tensor,
                    big: int) -> torch.Tensor:
    """min over valid slots of ext[l, nbr[l, v, s]] + 1, padding read as
    ``big``: nbr (L, n, d), ext (L, m) → (L, n) int32.  An id outside
    [0, m) is padding."""
    L, n, d = nbr.shape
    valid = (nbr >= 0) & (nbr < ext.shape[1])
    idx = torch.where(valid, nbr, 0).long().reshape(L, n * d)
    dn = ext.gather(1, idx).reshape(L, n, d)
    dn = torch.where(valid, dn, big)
    return (dn.amin(dim=2) + 1).to(torch.int32)


def ell_relax(nbr: torch.Tensor, ext: torch.Tensor, big: int) -> torch.Tensor:
    """One lane-stacked min-plus ELL relaxation (the reference's
    ``ell_relax_step`` with a lane axis): nbr (L, n, d) int32 ids, -1
    padding; ext (L, m) int32 → (L, n) int32.  CUDA tensors go to the
    kernel, CPU tensors to the plain version."""
    global relax_launches
    _int32("nbr", nbr, 3)
    _int32("ext", ext, 2)
    if ext.shape[0] != nbr.shape[0]:
        raise ValueError(f"nbr {tuple(nbr.shape)} and ext "
                         f"{tuple(ext.shape)} differ in lanes")
    _same_device(nbr, ext)
    if nbr.device.type != "cuda":
        return ell_relax_plain(nbr, ext, big)
    nbr, ext = nbr.contiguous(), ext.contiguous()
    L, n, d = nbr.shape
    out = torch.empty((L, n), dtype=torch.int32, device=nbr.device)
    err = build.load("dgraph").ell_relax_launch(
        nbr.data_ptr(), ext.data_ptr(), out.data_ptr(), L, n, d,
        ext.shape[1], int(big), _stream(nbr))
    build.check(err, "ell_relax")
    if L and n:
        relax_launches += 1
    return out


# ------------------------------------------------------------ halo
def owner_slots(gid: torch.Tensor, vtxdist: torch.Tensor,
                nlm: int) -> torch.Tensor:
    """Each global id's flat slot ``owner * nlm + local`` in its lane's
    (P, nlm) rows: owner = upper_bound(vtxdist, gid) − 1 clipped to
    [0, P−1], local clipped to [0, nlm−1] (dgraph.py:833-837); gid (L, K),
    vtxdist (L, P+1) → (L, K) int64.  Ids < 0 give slot 0."""
    P = vtxdist.shape[1] - 1
    g = gid.clamp(min=0).long()
    vd = vtxdist.long().contiguous()
    owner = (torch.searchsorted(vd, g.contiguous(), right=True) - 1
             ).clamp(0, P - 1)
    local = (g - vd.gather(1, owner)).clamp(0, nlm - 1)
    return owner * nlm + local


def halo_plain(x: torch.Tensor, ghost_gid: torch.Tensor,
               vtxdist: torch.Tensor) -> torch.Tensor:
    """x (L, P, nlm), ghost_gid (L, P, G), vtxdist (L, P+1) → (L, P,
    nlm + G): each part's values, then each ghost's owner value (0 for
    a ghost id of -1)."""
    L, P, nlm = x.shape
    G = ghost_gid.shape[2]
    flat = x.reshape(L, P * nlm)
    slot = owner_slots(ghost_gid.reshape(L, P * G), vtxdist, nlm)
    vals = flat.gather(1, slot).reshape(L, P, G)
    vals = torch.where(ghost_gid >= 0, vals, torch.zeros_like(vals))
    return torch.cat([x, vals], dim=2)


def _check_parts(x, ghost_gid, vtxdist) -> None:
    L, P = x.shape[:2]
    if ghost_gid.shape[:2] != (L, P) or vtxdist.shape != (L, P + 1):
        raise ValueError(f"want ghost_gid (L, P, G) and vtxdist (L, P+1) "
                         f"for x {tuple(x.shape)}, got "
                         f"{tuple(ghost_gid.shape)}, {tuple(vtxdist.shape)}")


def halo(x: torch.Tensor, ghost_gid: torch.Tensor,
         vtxdist: torch.Tensor) -> torch.Tensor:
    """The lane-stacked halo exchange: x (L, P, nlm) int32, ghost_gid
    (L, P, G) int32, vtxdist (L, P+1) int32 → (L, P, nlm + G) int32.
    CUDA tensors go to the kernel (one launch), CPU tensors to the plain
    version."""
    global halo_launches
    _int32("x", x, 3)
    _int32("ghost_gid", ghost_gid, 3)
    _int32("vtxdist", vtxdist, 2)
    _check_parts(x, ghost_gid, vtxdist)
    _same_device(x, ghost_gid, vtxdist)
    if x.device.type != "cuda":
        return halo_plain(x, ghost_gid, vtxdist)
    x, ghost_gid, vtxdist = (t.contiguous() for t in (x, ghost_gid, vtxdist))
    L, P, nlm = x.shape
    G = ghost_gid.shape[2]
    out = torch.empty((L, P, nlm + G), dtype=torch.int32, device=x.device)
    err = build.load("dgraph").halo_launch(
        x.data_ptr(), ghost_gid.data_ptr(), vtxdist.data_ptr(),
        out.data_ptr(), L, P, nlm, G, _stream(x))
    build.check(err, "halo")
    if L and P:
        halo_launches += 1
    return out


# ------------------------------------------------------------ BFS
def dbfs_plain(nbr: torch.Tensor, src: torch.Tensor, ghost_gid: torch.Tensor,
               vtxdist: torch.Tensor, width: int) -> torch.Tensor:
    """``width`` synchronous steps, each a halo exchange and a relaxation
    of every part against its extended vector, min with the old distance
    (dgraph.py:933-943): nbr (L, P, nlm, d), src (L, P, nlm) → (L, P,
    nlm) int32, BIG beyond ``width``."""
    L, P, nlm, d = nbr.shape
    dist = torch.where(src != 0, 0, BIG).to(torch.int32)
    for _ in range(width):
        ext = halo_plain(dist, ghost_gid, vtxdist)
        relaxed = ell_relax_plain(nbr.reshape(L * P, nlm, d),
                                  ext.reshape(L * P, -1), BIG)
        dist = torch.minimum(dist, relaxed.reshape(L, P, nlm))
    return dist


def dbfs(nbr: torch.Tensor, src: torch.Tensor, ghost_gid: torch.Tensor,
         vtxdist: torch.Tensor, width: int) -> torch.Tensor:
    """The lane-stacked distributed band BFS: nbr (L, P, nlm, d) int32
    compact ids (ghosts at ≥ nlm), src (L, P, nlm) int32 (nonzero =
    source), ghost_gid (L, P, G), vtxdist (L, P+1) → (L, P, nlm) int32.
    CUDA tensors go to the kernels (``dbfs_init``, then ``ell_relax`` a
    step: 1 + width launches), CPU tensors to the plain version."""
    global dbfs_launches, relax_launches
    _int32("nbr", nbr, 4)
    _int32("src", src, 3)
    _int32("ghost_gid", ghost_gid, 3)
    _int32("vtxdist", vtxdist, 2)
    _check_parts(src, ghost_gid, vtxdist)
    if nbr.shape[:3] != src.shape:
        raise ValueError(f"nbr {tuple(nbr.shape)} and src "
                         f"{tuple(src.shape)} differ in (L, P, nlm)")
    _same_device(nbr, src, ghost_gid, vtxdist)
    if nbr.device.type != "cuda":
        return dbfs_plain(nbr, src, ghost_gid, vtxdist, width)
    nbr, src, ghost_gid, vtxdist = (t.contiguous() for t in (
        nbr, src, ghost_gid, vtxdist))
    L, P, nlm, d = nbr.shape
    G = ghost_gid.shape[2]
    bufs = torch.empty((2, L, P, nlm), dtype=torch.int32, device=nbr.device)
    gidx = torch.empty((L, P, G), dtype=torch.int64, device=nbr.device)
    err = build.load("dgraph").dbfs_launch(
        nbr.data_ptr(), src.data_ptr(), ghost_gid.data_ptr(),
        vtxdist.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
        gidx.data_ptr(), L, P, nlm, d, G, int(width), _stream(nbr))
    build.check(err, "dbfs")
    if L and P and nlm:
        dbfs_launches += 1
        relax_launches += int(width)
    return bufs[0]


# ------------------------------------------------------------ matching
def dmatch_plain(nbr: torch.Tensor, ewgt: torch.Tensor,
                 ghost_gid: torch.Tensor, vtxdist: torch.Tensor,
                 n_loc: torch.Tensor, seeds: torch.Tensor, rounds: int,
                 cap: int = 0, tally: Optional[List[tuple]] = None
                 ) -> torch.Tensor:
    """The request/grant rounds of dgraph.py:1015-1131 in torch.

    nbr, ewgt (L, P, nlm, d) int32; ghost_gid (L, P, G); vtxdist (L,
    P+1); n_loc (L, P); seeds (L,) int32, already masked to 31 bits →
    (L, P, nlm) int32 mate gids, -1 where unmatched; an id outside
    [0, nlm + G) is padding.  With ``cap`` > 0
    each part's proposals beyond the first ``cap`` (in row order) drop,
    as the reference's compact gather drops them.  ``tally``, if given,
    gets one ``(rows, scanned, proposals)`` per round: the rows, the real
    slots of the unmatched proposers (each scans its row) and the
    proposals — the hashes a round's data needs.
    """
    L, P, nlm, d = nbr.shape
    G = ghost_gid.shape[2]
    dev = nbr.device
    vd = vtxdist.long()
    li = torch.arange(nlm, device=dev)
    valid_loc = li.view(1, 1, nlm) < n_loc.long().unsqueeze(2)
    lo = vd[:, :P].unsqueeze(2)
    my_gid = torch.where(valid_loc, lo + li, -1)                 # (L,P,nlm)
    ext_gid = torch.cat([my_gid, ghost_gid.long()], dim=2)      # (L,P,W)
    valid_e = (nbr >= 0) & (nbr < nlm + G)
    nb = torch.where(valid_e, nbr, 0).long()
    ewf = ewgt.to(torch.float32)
    seed = seeds.long().view(L, 1, 1)
    gslot = owner_slots(ghost_gid.reshape(L, P * G), vtxdist, nlm)
    gok = (ghost_gid >= 0).reshape(L, P * G)
    nseg = P * nlm + 1

    def ext_at(ext, idx):               # ext (L, P, W), idx (L, P, nlm, d)
        return ext.gather(2, idx.reshape(L, P, nlm * d)).reshape(idx.shape)

    match = torch.full((L, P, nlm), -1, dtype=torch.long, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    for r in range(rounds):
        unmatched = (match < 0) & valid_loc
        unm_flat = unmatched.reshape(L, P * nlm)
        unm_g = unm_flat.gather(1, gslot) & gok
        ext_unm = torch.cat([unmatched, unm_g.reshape(L, P, G)], dim=2)
        is_prop_ext = (hash_mix(ext_gid, r, seed) & 1) == 1
        tgt = ext_at(ext_gid, nb)
        cand = (valid_e & ext_at(ext_unm, nb) & ~ext_at(is_prop_ext, nb)
                & (tgt >= 0))
        tie = hash_unit(my_gid.unsqueeze(3), tgt, r + 17)
        score = torch.where(cand, ewf + tie, neg_inf)
        slot = score.argmax(dim=3, keepdim=True)
        has = cand.any(dim=3) & unmatched & is_prop_ext[:, :, :nlm]
        prop_tgt = torch.where(has, tgt.gather(3, slot)[..., 0], -1)
        prop_w = torch.where(has, ewf.gather(3, slot)[..., 0], 0.0)
        if tally is not None:
            scans = unmatched & is_prop_ext[:, :, :nlm]
            tally.append((L * P * nlm, int((valid_e & scans[..., None]).sum()),
                          int(has.sum())))
        if cap:
            rank = has.long().cumsum(dim=2) - 1
            has = has & (rank < cap)
        # grant: each acceptor slot keeps the largest packed word
        tg_flat = prop_tgt.reshape(L, P * nlm)
        has_flat = has.reshape(L, P * nlm)
        seg = torch.where(has_flat, owner_slots(tg_flat, vtxdist, nlm),
                          nseg - 1)
        gsc = prop_w.reshape(L, P * nlm) + hash_unit(
            my_gid.reshape(L, P * nlm), tg_flat, r + 31)
        word = torch.where(has_flat, grant_word(
            gsc, my_gid.reshape(L, P * nlm)), _EMPTY)
        best = torch.full((L, nseg), _EMPTY, dtype=torch.long, device=dev)
        best = best.scatter_reduce(1, seg, word, "amax")
        winner = torch.where(best == _EMPTY, 0x7FFFFFFF,
                             0x7FFFFFFF - (best & 0xFFFFFFFF))[:, :P * nlm]
        win_mine = winner.reshape(L, P, nlm)
        can_accept = unmatched & ~is_prop_ext[:, :, :nlm]
        grant = torch.where(can_accept & (win_mine < 0x7FFFFFFF),
                            win_mine, -1)
        win_t = winner.gather(1, owner_slots(tg_flat, vtxdist, nlm)
                              ).reshape(L, P, nlm)
        got = (prop_tgt >= 0) & (win_t == my_gid)
        match = torch.where(got, prop_tgt, match)
        match = torch.where(grant >= 0, grant, match)
    return match.to(torch.int32)


def dmatch(nbr: torch.Tensor, ewgt: torch.Tensor, ghost_gid: torch.Tensor,
           vtxdist: torch.Tensor, n_loc: torch.Tensor, seeds: torch.Tensor,
           rounds: int = 8, cap: int = 0) -> torch.Tensor:
    """The lane-stacked distributed heavy-edge matching: shapes as
    ``dmatch_plain``; (L, P, nlm) int32 mate gids, -1 where unmatched.
    CUDA tensors go to the kernels (1 + 3 * rounds launches), CPU tensors
    to the plain version."""
    global dmatch_launches
    for name, t, dims in (("nbr", nbr, 4), ("ewgt", ewgt, 4),
                          ("ghost_gid", ghost_gid, 3),
                          ("vtxdist", vtxdist, 2), ("n_loc", n_loc, 2),
                          ("seeds", seeds, 1)):
        _int32(name, t, dims)
    L, P = nbr.shape[:2]
    _check_parts(nbr[..., 0], ghost_gid, vtxdist)
    if ewgt.shape != nbr.shape or n_loc.shape != (L, P) or \
            seeds.shape != (L,):
        raise ValueError("want ewgt like nbr, n_loc (L, P) and seeds (L,)")
    if rounds < 0 or cap < 0:
        raise ValueError(f"rounds and cap must be >= 0, got {rounds}, {cap}")
    _same_device(nbr, ewgt, ghost_gid, vtxdist, n_loc, seeds)
    if nbr.device.type != "cuda":
        return dmatch_plain(nbr, ewgt, ghost_gid, vtxdist, n_loc, seeds,
                            rounds, cap)
    args = [t.contiguous() for t in (nbr, ewgt, ghost_gid, vtxdist, n_loc,
                                     seeds)]
    nlm, d = nbr.shape[2:]
    G = ghost_gid.shape[2]
    cells = L * P * nlm
    match = torch.empty((L, P, nlm), dtype=torch.int32, device=nbr.device)
    # gidx (int64), two u64 tables, prop_tgt and prop_w (4 bytes each)
    scratch = torch.empty(L * P * G + 2 * cells + cells, dtype=torch.int64,
                          device=nbr.device)
    err = build.load("dgraph").dmatch_launch(
        *(t.data_ptr() for t in args), match.data_ptr(), scratch.data_ptr(),
        L, P, nlm, d, G, int(rounds), int(cap), _stream(nbr))
    build.check(err, "dmatch")
    if cells:
        dmatch_launches += 1 + 3 * int(rounds)
    return match
