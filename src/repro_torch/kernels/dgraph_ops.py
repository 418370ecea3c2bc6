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

The BFS and the matching run in the design ``band_batch.lane_plan`` picks
for a lane of ``P * n_loc_max`` rows and ``d`` slots (``plan``): up to
2^18 slots, one launch a call on a thread-block cluster per lane;
above it, a launch a phase over the whole card.

The counts are of CUDA kernel launches.  The BFS's and the matching's C
entries report what they enqueued, and ``dbfs_kernel`` / ``dmatch_kernel``
add that; ``dbfs_counts`` and ``dmatch_count`` are the designs' formulas,
which ``planned_launches`` applies to a run's launch records:

* ``relax_launches``: ``ell_relax`` launches, one per ``ell_relax_step``
  call and, in the grid design, one per step of the distributed BFS,
  whose steps run this kernel in its distributed form (ghosts read from
  the owners' rows); the cluster design launches none;
* ``halo_launches``: one per ``halo`` call;
* ``dbfs_launches``: the BFS's own kernel, one per call: the cluster
  kernel, or ``dbfs_init`` (the source mask and each ghost's lane-local
  slot, the table the steps read) in the grid design;
* ``dmatch_launches``: one per call on the cluster design; on the grid
  design ``1 + 2 * rounds`` (init, then propose, which posts the grant,
  and commit a round), or ``1 + 3 * rounds`` with a cap (a grant launch
  a round ranks the proposals).

``state_place`` names where the last BFS or matching launch kept its
state: the cluster design in the CTAs' shared memory where each CTA's
share fits (``"shared"`` for one CTA, ``"distributed"`` for more, other
CTAs' rows read over distributed shared memory), else in device memory
(``"device"``); ``"grid"`` for the grid design.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.matching import hash_mix, hash_unit
from repro_torch.kernels import build
from repro_torch.kernels.band_batch import lane_plan
from repro_torch.kernels.matching import grant_word

#: the distributed BFS's unreached distance (the reference's BIG)
BIG = 2 ** 30
_EMPTY = -2 ** 63

relax_launches = 0
halo_launches = 0
dbfs_launches = 0
dmatch_launches = 0
state_place: Optional[str] = None
#: the C entries' placement codes
_PLACES = {-1: "grid", 0: "device", 1: "shared", 2: "distributed"}


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _int32(name: str, t: torch.Tensor, dims: int) -> None:
    if t.dtype != torch.int32 or t.dim() != dims:
        raise ValueError(f"{name}: want a {dims}-d int32 tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _same_device(*ts: torch.Tensor) -> None:
    if len({t.device for t in ts}) != 1:
        raise ValueError("the tensors must lie on one device")


def _enqueue(entry: str, what: str, args: tuple,
             stream: int) -> Tuple[int, int]:
    """Call the dgraph C entry ``entry`` and return what it reports it
    enqueued: (its own kernels, its ``ell_relax`` kernels); its state's
    placement goes to ``state_place``."""
    global state_place
    counts = (ctypes.c_int * 3)()
    err = getattr(build.load("dgraph"), entry)(
        *args, ctypes.addressof(counts), stream)
    build.check(err, what)
    state_place = _PLACES[counts[2]]
    return counts[0], counts[1]


def plan(P: int, nlm: int, d: int) -> Tuple[str, Optional[int]]:
    """The design of the BFS and matching kernels for lanes of P parts of
    ``nlm`` rows and ``d`` slots: ``lane_plan(P * nlm, d)``, a lane being
    its P parts' rows."""
    return lane_plan(P * nlm, d)


def dbfs_counts(design: str, width: int) -> Tuple[int, int]:
    """(``dbfs_launches``, ``relax_launches``) one BFS call adds in
    ``design``: the cluster kernel alone, or ``dbfs_init`` and an
    ``ell_relax`` a step."""
    return (1, 0) if design == "cluster" else (1, int(width))


def dmatch_count(design: str, rounds: int, cap: int) -> int:
    """Kernel launches of one matching call in ``design``."""
    if design == "cluster":
        return 1
    return 1 + (3 if cap else 2) * int(rounds)


def planned_launches(records) -> dict:
    """The launches this module's counts gain on the card from a run with
    these launch records (``obs`` ``launch`` payloads; only the kinds
    ``dhalo``, ``dbfs`` and ``dmatch`` launch here), each BFS and
    matching call in its planned design: keyed by the counts' names."""
    want = dict.fromkeys(("relax_launches", "halo_launches",
                          "dbfs_launches", "dmatch_launches"), 0)
    for r in records:
        if r["kind"] == "dhalo":
            want["halo_launches"] += 1
        if r["kind"] not in ("dbfs", "dmatch"):
            continue
        design = plan(r["nparts"], *r["bucket"][:2])[0]
        if r["kind"] == "dbfs":
            own, steps = dbfs_counts(design, r["rounds"])
            want["dbfs_launches"] += own
            want["relax_launches"] += steps
        else:
            want["dmatch_launches"] += dmatch_count(design, r["rounds"],
                                                    r["cap"])
    return want


def dmatch_scratch(design: str, L: int, P: int, nlm: int, G: int,
                   C: Optional[int]) -> int:
    """int64 words of the matching's scratch in ``design`` (the layouts of
    ``dmatch_launch`` and ``dmatch_cluster_launch``)."""
    cells = L * P * nlm
    if design == "cluster":
        ints = 4 * cells + L * P * G + 2 * L * C * P
        return 2 * cells + -(-(4 * ints + cells) // 8)
    tiles = -(-nlm // 256)
    return L * P * G + 3 * cells + -(-(L * P * tiles) // 2)


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
#: the most lanes a halo call takes: the kernel's parameter block holds
#: each lane's slot table pointer (``kHaloLanes`` of ``csrc/dgraph.cu``)
HALO_LANES = 4000


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


def lane_slots(ghost_gid: torch.Tensor, vtxdist: torch.Tensor,
               nlm: int) -> torch.Tensor:
    """The ghost slot tables a halo reads: ghost_gid (L, P, G), vtxdist
    (L, P+1) → (L, P, G) int32, each ghost's lane-local slot
    (``owner_slots``), -1 for a padding ghost (id < 0)."""
    L, P, G = ghost_gid.shape
    slot = owner_slots(ghost_gid.reshape(L, P * G), vtxdist, nlm)
    return torch.where(ghost_gid >= 0, slot.reshape(L, P, G),
                       -1).to(torch.int32)


def halo_plain(x: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """x (L, P, nlm), slots (L, P, G) ghost slot tables (``lane_slots``)
    → (L, P, nlm + G): each part's values, then each ghost's value at its
    lane-local slot (0 for -1, or any slot outside the lane's rows)."""
    L, P, nlm = x.shape
    ok = (slots >= 0) & (slots < P * nlm)
    idx = torch.where(ok, slots, 0).reshape(L, -1).long()
    vals = x.reshape(L, P * nlm).gather(1, idx).reshape(slots.shape)
    return torch.cat([x, torch.where(ok, vals, torch.zeros_like(vals))],
                     dim=2)


def halo(x: torch.Tensor, tables: Sequence[torch.Tensor]) -> torch.Tensor:
    """The lane-stacked halo exchange: x (L, P, nlm) int32 and, for each
    of its 1 to ``HALO_LANES`` lanes, a (P, G) int32 ghost slot table
    (``lane_slots``; lanes may share one) → (L, P, nlm + G) int32.  CUDA
    tensors go to the kernel (one launch, each lane's table read where
    it lies), CPU tensors to the plain version."""
    global halo_launches
    _int32("x", x, 3)
    L, P, nlm = x.shape
    if not 1 <= len(tables) == L <= HALO_LANES:
        raise ValueError(f"want one slot table for each of 1 to "
                         f"{HALO_LANES} lanes, got {len(tables)} for "
                         f"x {tuple(x.shape)}")
    for t in tables:
        _int32("slot table", t, 2)
        if t.shape != (P, tables[0].shape[1]):
            raise ValueError(f"want (P, G) slot tables alike, P = {P}, got "
                             f"{tuple(t.shape)}")
    _same_device(x, *tables)
    if x.device.type != "cuda":
        return halo_plain(x, torch.stack(list(tables)))
    x = x.contiguous()
    tables = [t.contiguous() for t in tables]
    G = tables[0].shape[1]
    out = torch.empty((L, P, nlm + G), dtype=torch.int32, device=x.device)
    ptrs = (ctypes.c_void_p * L)(*(t.data_ptr() for t in tables))
    err = build.load("dgraph").halo_launch(
        x.data_ptr(), ctypes.addressof(ptrs), out.data_ptr(), L, P, nlm, G,
        _stream(x))
    build.check(err, "halo")
    halo_launches += 1
    return out


# ------------------------------------------------------------ BFS
def _check_parts(x, ghost_gid, vtxdist) -> None:
    L, P = x.shape[:2]
    if ghost_gid.shape[:2] != (L, P) or vtxdist.shape != (L, P + 1):
        raise ValueError(f"want ghost_gid (L, P, G) and vtxdist (L, P+1) "
                         f"for x {tuple(x.shape)}, got "
                         f"{tuple(ghost_gid.shape)}, {tuple(vtxdist.shape)}")


def dbfs_plain(nbr: torch.Tensor, src: torch.Tensor, ghost_gid: torch.Tensor,
               vtxdist: torch.Tensor, width: int) -> torch.Tensor:
    """``width`` synchronous steps, each a halo exchange and a relaxation
    of every part against its extended vector, min with the old distance
    (dgraph.py:933-943): nbr (L, P, nlm, d), src (L, P, nlm) → (L, P,
    nlm) int32, BIG beyond ``width``."""
    L, P, nlm, d = nbr.shape
    dist = torch.where(src != 0, 0, BIG).to(torch.int32)
    slots = lane_slots(ghost_gid, vtxdist, nlm)
    for _ in range(width):
        ext = halo_plain(dist, slots)
        relaxed = ell_relax_plain(nbr.reshape(L * P, nlm, d),
                                  ext.reshape(L * P, -1), BIG)
        dist = torch.minimum(dist, relaxed.reshape(L, P, nlm))
    return dist


def dbfs(nbr: torch.Tensor, src: torch.Tensor, ghost_gid: torch.Tensor,
         vtxdist: torch.Tensor, width: int) -> torch.Tensor:
    """The lane-stacked distributed band BFS: nbr (L, P, nlm, d) int32
    compact ids (ghosts at ≥ nlm), src (L, P, nlm) int32 (nonzero =
    source), ghost_gid (L, P, G), vtxdist (L, P+1) → (L, P, nlm) int32.
    CUDA tensors go to the kernels in the design ``plan`` picks (one
    launch on a cluster a lane, or ``dbfs_init`` then ``ell_relax`` a
    step), CPU tensors to the plain version."""
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
    return dbfs_kernel(nbr, src, ghost_gid, vtxdist, width,
                       *plan(*nbr.shape[1:]))


def dbfs_kernel(nbr: torch.Tensor, src: torch.Tensor,
                ghost_gid: torch.Tensor, vtxdist: torch.Tensor, width: int,
                design: str, C: Optional[int] = None) -> torch.Tensor:
    """Launch the BFS's kernels in ``design`` ("cluster" with C CTAs a
    lane, or "grid") on CUDA tensors checked by ``dbfs``, and count what
    the C entry enqueued."""
    global dbfs_launches, relax_launches
    nbr, src, ghost_gid, vtxdist = (t.contiguous() for t in (
        nbr, src, ghost_gid, vtxdist))
    L, P, nlm, d = nbr.shape
    G = ghost_gid.shape[2]
    bufs = torch.empty((2, L, P, nlm), dtype=torch.int32, device=nbr.device)
    gslot = torch.empty((L, P, G), dtype=torch.int32, device=nbr.device)
    args = (nbr.data_ptr(), src.data_ptr(), ghost_gid.data_ptr(),
            vtxdist.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
            gslot.data_ptr(), L, P, nlm, d, G, int(width))
    if design == "cluster":
        own, steps = _enqueue("dbfs_cluster_launch", "dbfs",
                              (*args, int(C)), _stream(nbr))
    else:
        own, steps = _enqueue("dbfs_launch", "dbfs", args, _stream(nbr))
    dbfs_launches += own
    relax_launches += steps
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
    CUDA tensors go to the kernels in the design ``plan`` picks
    (``dmatch_count`` launches), CPU tensors to the plain version."""
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
    return dmatch_kernel(nbr, ewgt, ghost_gid, vtxdist, n_loc, seeds,
                         rounds, cap, *plan(P, *nbr.shape[2:]))


def dmatch_kernel(nbr: torch.Tensor, ewgt: torch.Tensor,
                  ghost_gid: torch.Tensor, vtxdist: torch.Tensor,
                  n_loc: torch.Tensor, seeds: torch.Tensor, rounds: int,
                  cap: int, design: str,
                  C: Optional[int] = None) -> torch.Tensor:
    """Launch the matching's kernels in ``design`` ("cluster" with C CTAs
    a lane, or "grid") on CUDA tensors checked by ``dmatch``, and count
    what the C entry enqueued."""
    global dmatch_launches
    args = [t.contiguous() for t in (nbr, ewgt, ghost_gid, vtxdist, n_loc,
                                     seeds)]
    L, P, nlm, d = nbr.shape
    G = ghost_gid.shape[2]
    match = torch.empty((L, P, nlm), dtype=torch.int32, device=nbr.device)
    scratch = torch.empty(dmatch_scratch(design, L, P, nlm, G, C),
                          dtype=torch.int64, device=nbr.device)
    ptrs = [t.data_ptr() for t in args] + [match.data_ptr(),
                                           scratch.data_ptr()]
    dims = (L, P, nlm, d, G, int(rounds), int(cap))
    if design == "cluster":
        own, _ = _enqueue("dmatch_cluster_launch", "dmatch",
                          (*ptrs, *dims, int(C)), _stream(nbr))
    else:
        own, _ = _enqueue("dmatch_launch", "dmatch", (*ptrs, *dims),
                          _stream(nbr))
    dmatch_launches += own
    return match
