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

On a group of devices (``core.dgraph.make_parts_group``, the reference's
``parts`` mesh) each member holds a contiguous range of parts
``[p0, p1)``: it keeps a replica of every part's rows of the state, writes
its own parts' rows, and ``core.dgraph`` copies each member's rows into
the others' replicas between phases (the reference's ``all_gather``).
So the grid designs' kernels take a part range: ``halo(..., parts=)``,
``dbfs_init`` and ``dbfs_step`` (the BFS a step at a time) and
``DMatchParts`` (the matching a phase at a time: propose, then, after the
gather of the proposals, post and commit).  A group always runs the grid
design: a cluster cannot wait for another device's rows.

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

On a group of D members each member launches its own: a halo call is D
halo launches, a BFS call D ``dbfs_init`` and ``D * width`` relaxations,
a matching call ``D * (1 + 3 * rounds)`` (init; propose, post and commit
a round), ``D * (1 + 4 * rounds)`` with a cap (the range's proposals
ranked and compacted after the propose).

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


def plan(P: int, nlm: int, d: int,
         group: int = 1) -> Tuple[str, Optional[int]]:
    """The design of the BFS and matching kernels for lanes of P parts of
    ``nlm`` rows and ``d`` slots: ``lane_plan(P * nlm, d)``, a lane being
    its P parts' rows; the grid on a group of ``group`` > 1 members."""
    if group > 1:
        return "grid", None
    return lane_plan(P * nlm, d)


def dbfs_counts(design: str, width: int, group: int = 1) -> Tuple[int, int]:
    """(``dbfs_launches``, ``relax_launches``) one BFS call adds in
    ``design`` on ``group`` members: the cluster kernel alone, or
    ``dbfs_init`` and an ``ell_relax`` a step on each member."""
    if design == "cluster":
        return 1, 0
    return group, group * int(width)


def dmatch_count(design: str, rounds: int, cap: int, group: int = 1) -> int:
    """Kernel launches of one matching call in ``design`` on ``group``
    members."""
    if design == "cluster":
        return 1
    if group > 1:
        return group * (1 + (4 if cap else 3) * int(rounds))
    return 1 + (3 if cap else 2) * int(rounds)


def planned_launches(records) -> dict:
    """The launches this module's counts gain on the card from a run with
    these launch records (``obs`` ``launch`` payloads; only the kinds
    ``dhalo``, ``dbfs`` and ``dmatch`` launch here), each BFS and
    matching call in its planned design on its record's ``group``
    members (1 where the record has none): keyed by the counts' names."""
    want = dict.fromkeys(("relax_launches", "halo_launches",
                          "dbfs_launches", "dmatch_launches"), 0)
    for r in records:
        group = r.get("group", 1)
        if r["kind"] == "dhalo":
            want["halo_launches"] += group
        if r["kind"] not in ("dbfs", "dmatch"):
            continue
        design = plan(r["nparts"], *r["bucket"][:2], group=group)[0]
        if r["kind"] == "dbfs":
            own, steps = dbfs_counts(design, r["rounds"], group)
            want["dbfs_launches"] += own
            want["relax_launches"] += steps
        else:
            want["dmatch_launches"] += dmatch_count(design, r["rounds"],
                                                    r["cap"], group)
    return want


def part_range(P: int, parts) -> Tuple[int, int]:
    """``parts`` as a range ``(p0, p1)`` of P parts, ``(0, P)`` for None;
    raises unless 0 <= p0 < p1 <= P."""
    p0, p1 = (0, P) if parts is None else (int(parts[0]), int(parts[1]))
    if not 0 <= p0 < p1 <= P:
        raise ValueError(f"want a part range of {P} parts, got {parts}")
    return p0, p1


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


def halo_plain(x: torch.Tensor, slots: torch.Tensor,
               parts=None) -> torch.Tensor:
    """x (L, P, nlm), slots (L, p1 - p0, G) the ghost slot tables of parts
    ``parts`` = [p0, p1) (``lane_slots``; all P parts by default) → (L,
    p1 - p0, nlm + G): each of those parts' values, then each ghost's value
    at its lane-local slot (0 for -1, or any slot outside the lane's
    rows)."""
    L, P, nlm = x.shape
    p0, p1 = part_range(P, parts)
    ok = (slots >= 0) & (slots < P * nlm)
    idx = torch.where(ok, slots, 0).reshape(L, -1).long()
    vals = x.reshape(L, P * nlm).gather(1, idx).reshape(slots.shape)
    return torch.cat([x[:, p0:p1],
                      torch.where(ok, vals, torch.zeros_like(vals))], dim=2)


def halo(x: torch.Tensor, tables: Sequence[torch.Tensor],
         parts=None) -> torch.Tensor:
    """The lane-stacked halo exchange: x (L, P, nlm) int32 and, for each
    of its 1 to ``HALO_LANES`` lanes, a (P, G) int32 ghost slot table
    (``lane_slots``; lanes may share one) → (L, p1 - p0, nlm + G) int32,
    the rows of parts ``parts`` = [p0, p1) (all P by default: a group
    member's call takes its own).  CUDA tensors go to the kernel (one
    launch, each lane's table read where it lies), CPU tensors to the
    plain version."""
    global halo_launches
    _int32("x", x, 3)
    L, P, nlm = x.shape
    p0, p1 = part_range(P, parts)
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
        return halo_plain(x, torch.stack(list(tables))[:, p0:p1], (p0, p1))
    x = x.contiguous()
    tables = [t.contiguous() for t in tables]
    G = tables[0].shape[1]
    out = torch.empty((L, p1 - p0, nlm + G), dtype=torch.int32,
                      device=x.device)
    ptrs = (ctypes.c_void_p * L)(*(t.data_ptr() for t in tables))
    err = build.load("dgraph").halo_parts_launch(
        x.data_ptr(), ctypes.addressof(ptrs), out.data_ptr(), L, P, nlm, G,
        p0, p1, _stream(x))
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


def dbfs_init_plain(src: torch.Tensor, ghost_gid: torch.Tensor,
                    vtxdist: torch.Tensor, dist: torch.Tensor,
                    parts=None) -> torch.Tensor:
    """``dbfs_init``'s plain version: the sources src (L, p1 - p0, nlm) of
    parts [p0, p1) into their rows of dist (L, P, nlm), 0 or BIG; returns
    their ghosts' slot table (L, p1 - p0, G) (``lane_slots``)."""
    p0, p1 = part_range(dist.shape[1], parts)
    dist[:, p0:p1] = torch.where(src != 0, 0, BIG).to(torch.int32)
    return lane_slots(ghost_gid, vtxdist, dist.shape[2])


def dbfs_step_plain(nbr: torch.Tensor, dist: torch.Tensor,
                    slots: torch.Tensor, parts=None) -> torch.Tensor:
    """One synchronous BFS step of parts [p0, p1) (the relaxation in its
    distributed form): each part against its halo-extended row of dist
    (L, P, nlm), min with its old distance; nbr (L, p1 - p0, nlm, d),
    slots (L, p1 - p0, G) → (L, p1 - p0, nlm) int32 (dgraph.py:933-943)."""
    L, pr, nlm, d = nbr.shape
    p0, p1 = part_range(dist.shape[1], parts)
    ext = halo_plain(dist, slots, (p0, p1))
    relaxed = ell_relax_plain(nbr.reshape(L * pr, nlm, d),
                              ext.reshape(L * pr, -1), BIG)
    return torch.minimum(dist[:, p0:p1], relaxed.reshape(L, pr, nlm))


def dbfs_plain(nbr: torch.Tensor, src: torch.Tensor, ghost_gid: torch.Tensor,
               vtxdist: torch.Tensor, width: int) -> torch.Tensor:
    """``width`` synchronous steps, each a halo exchange and a relaxation
    of every part against its extended vector, min with the old distance
    (dgraph.py:933-943): nbr (L, P, nlm, d), src (L, P, nlm) → (L, P,
    nlm) int32, BIG beyond ``width``."""
    dist = torch.empty(src.shape, dtype=torch.int32, device=src.device)
    slots = dbfs_init_plain(src, ghost_gid, vtxdist, dist)
    for _ in range(width):
        dist = dbfs_step_plain(nbr, dist, slots)
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


def dbfs_init(src: torch.Tensor, ghost_gid: torch.Tensor,
              vtxdist: torch.Tensor, dist: torch.Tensor,
              parts=None) -> torch.Tensor:
    """A group member's BFS start: the sources src (L, p1 - p0, nlm) int32
    of parts ``parts`` = [p0, p1) into their rows of dist (L, P, nlm)
    int32, in place; returns their ghosts' lane-local slots (L, p1 - p0,
    G) int32 (ghost_gid (L, p1 - p0, G), vtxdist (L, P + 1)), the table
    ``dbfs_step`` reads.  CUDA tensors go to ``dbfs_init`` (one launch),
    CPU tensors to the plain version."""
    global dbfs_launches
    for name, t, dims in (("src", src, 3), ("ghost_gid", ghost_gid, 3),
                          ("vtxdist", vtxdist, 2), ("dist", dist, 3)):
        _int32(name, t, dims)
    L, P, nlm = dist.shape
    p0, p1 = part_range(P, parts)
    if src.shape != (L, p1 - p0, nlm) or ghost_gid.shape[:2] != (
            L, p1 - p0) or vtxdist.shape != (L, P + 1) or \
            not dist.is_contiguous():
        raise ValueError(f"want src (L, p1 - p0, nlm), ghost_gid (L, p1 - "
                         f"p0, G), vtxdist (L, P + 1) and a contiguous dist "
                         f"for dist {tuple(dist.shape)} and parts "
                         f"{(p0, p1)}")
    _same_device(src, ghost_gid, vtxdist, dist)
    if dist.device.type != "cuda":
        return dbfs_init_plain(src, ghost_gid, vtxdist, dist, (p0, p1))
    src, ghost_gid, vtxdist = (t.contiguous() for t in (src, ghost_gid,
                                                        vtxdist))
    G = ghost_gid.shape[2]
    gslot = torch.empty((L, p1 - p0, G), dtype=torch.int32,
                        device=dist.device)
    err = build.load("dgraph").dbfs_parts_init_launch(
        src.data_ptr(), ghost_gid.data_ptr(), vtxdist.data_ptr(),
        dist.data_ptr(), gslot.data_ptr(), L, P, nlm, G, p0, p1,
        _stream(dist))
    build.check(err, "dbfs_init")
    if L:
        dbfs_launches += 1
    return gslot


def dbfs_step(nbr: torch.Tensor, din: torch.Tensor, dout: torch.Tensor,
              gslot: torch.Tensor, parts=None) -> None:
    """A group member's BFS step: the rows of parts ``parts`` = [p0, p1)
    of dout (L, P, nlm) relaxed against din (L, P, nlm), which holds every
    part's distances (the relaxation in its distributed form); nbr (L,
    p1 - p0, nlm, d) and gslot (L, p1 - p0, G) int32 from ``dbfs_init``.
    CUDA tensors go to ``ell_relax`` (one launch), CPU tensors to the
    plain version."""
    global relax_launches
    for name, t, dims in (("nbr", nbr, 4), ("din", din, 3),
                          ("dout", dout, 3), ("gslot", gslot, 3)):
        _int32(name, t, dims)
    L, P, nlm = din.shape
    p0, p1 = part_range(P, parts)
    if nbr.shape[:3] != (L, p1 - p0, nlm) or dout.shape != din.shape or \
            gslot.shape[:2] != (L, p1 - p0) or not (
                din.is_contiguous() and dout.is_contiguous()):
        raise ValueError(f"want nbr (L, p1 - p0, nlm, d), gslot (L, p1 - "
                         f"p0, G) and contiguous din, dout alike for din "
                         f"{tuple(din.shape)} and parts {(p0, p1)}")
    _same_device(nbr, din, dout, gslot)
    if din.device.type != "cuda":
        dout[:, p0:p1] = dbfs_step_plain(nbr, din, gslot, (p0, p1))
        return
    nbr, gslot = nbr.contiguous(), gslot.contiguous()
    err = build.load("dgraph").dbfs_parts_step_launch(
        nbr.data_ptr(), din.data_ptr(), dout.data_ptr(), gslot.data_ptr(),
        L, P, nlm, nbr.shape[3], gslot.shape[2], p0, p1, _stream(din))
    build.check(err, "dbfs_step")
    if L:
        relax_launches += 1


# ------------------------------------------------------------ matching
def _match_state(L: int, P: int, nlm: int, cap: int,
                 device) -> dict:
    """The rows of a matching's state that a group's members gather, every
    part's: the mates, the proposals (target gid, -1 for none, and float
    weight) and with a cap each part's first ``cap`` proposals in row
    order (``ctgt``, -1 padded, ``cw``, and the proposers' gids
    ``cgid``)."""
    def t(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=device)
    return {"match": t((L, P, nlm)), "prop_tgt": t((L, P, nlm)),
            "prop_w": t((L, P, nlm), torch.float32),
            "ctgt": t((L, P, cap)), "cw": t((L, P, cap), torch.float32),
            "cgid": t((L, P, cap))}


class _PlainMatch:
    """The request/grant rounds of dgraph.py:1015-1131 in torch, a phase at
    a time, for parts [p0, p1) of each lane: the plain version of the grid
    matching's kernels.  nbr, ewgt (L, p1 - p0, nlm, d) int32; ghost_gid
    (L, p1 - p0, G); vtxdist (L, P + 1); n_loc (L, P); seeds (L,) int32,
    already masked to 31 bits; ``state`` (``_match_state``) holds every
    part's rows.  ``propose`` writes the range's proposals (and, with a
    cap, its compacted ones: the reference's compact gather keeps each
    part's first ``cap`` in row order), ``post`` takes every part's from
    ``state`` into the winner table, ``commit`` the range's mates.  An id
    outside [0, nlm + G) is padding."""

    def __init__(self, nbr, ewgt, ghost_gid, vtxdist, n_loc, seeds,
                 state: dict, parts=None, cap: int = 0):
        L, pr, nlm, d = nbr.shape
        P = vtxdist.shape[1] - 1
        self.p0, self.p1 = p0, p1 = part_range(P, parts)
        G = ghost_gid.shape[2]
        dev = nbr.device
        self.L, self.P, self.pr, self.nlm, self.cap = L, P, pr, nlm, cap
        self.vtxdist, self.state = vtxdist, state
        vd = vtxdist.long()
        li = torch.arange(nlm, device=dev)
        self.valid_all = li.view(1, 1, nlm) < n_loc.long().unsqueeze(2)
        self.gid_all = torch.where(self.valid_all,
                                   vd[:, :P].unsqueeze(2) + li, -1)
        self.my_gid = self.gid_all[:, p0:p1]                    # (L,pr,nlm)
        self.ext_gid = torch.cat([self.my_gid, ghost_gid.long()], dim=2)
        self.valid_e = (nbr >= 0) & (nbr < nlm + G)
        self.nb = torch.where(self.valid_e, nbr, 0).long()
        self.ewf = ewgt.to(torch.float32)
        self.seed = seeds.long().view(L, 1, 1)
        self.gslot = owner_slots(ghost_gid.reshape(L, pr * G), vtxdist, nlm)
        self.gok = (ghost_gid >= 0).reshape(L, pr * G)
        self.tgt = self._at(self.ext_gid, self.nb)

    def _at(self, ext, idx):            # ext (L, pr, W), idx (L, pr, nlm, d)
        return ext.gather(2, idx.reshape(self.L, self.pr, -1)).reshape(
            idx.shape)

    def propose(self, r: int, tally: Optional[List[tuple]] = None) -> None:
        L, P, pr, nlm, p0, p1 = (self.L, self.P, self.pr, self.nlm, self.p0,
                                 self.p1)
        st = self.state
        unmatched_all = (st["match"].long() < 0) & self.valid_all
        unmatched = unmatched_all[:, p0:p1]
        unm_g = unmatched_all.reshape(L, P * nlm).gather(1, self.gslot) \
            & self.gok
        ext_unm = torch.cat([unmatched, unm_g.reshape(L, pr, -1)], dim=2)
        is_prop_ext = (hash_mix(self.ext_gid, r, self.seed) & 1) == 1
        tgt = self.tgt
        cand = (self.valid_e & self._at(ext_unm, self.nb)
                & ~self._at(is_prop_ext, self.nb) & (tgt >= 0))
        tie = hash_unit(self.my_gid.unsqueeze(3), tgt, r + 17)
        score = torch.where(cand, self.ewf + tie,
                            torch.tensor(float("-inf"), device=tgt.device))
        slot = score.argmax(dim=3, keepdim=True)
        is_prop = is_prop_ext[:, :, :nlm]
        has = cand.any(dim=3) & unmatched & is_prop
        prop_tgt = torch.where(has, tgt.gather(3, slot)[..., 0], -1)
        prop_w = torch.where(has, self.ewf.gather(3, slot)[..., 0], 0.0)
        if tally is not None:
            scans = unmatched & is_prop
            tally.append((L * pr * nlm,
                          int((self.valid_e & scans[..., None]).sum()),
                          int(has.sum())))
        st["prop_tgt"][:, p0:p1] = prop_tgt.to(torch.int32)
        st["prop_w"][:, p0:p1] = prop_w
        self.unmatched, self.is_prop = unmatched, is_prop
        if self.cap:
            cap = self.cap
            rank = has.long().cumsum(dim=2) - 1
            keep = has & (rank < cap)
            pos = torch.where(keep, rank, cap)
            for name, v, fill in (("ctgt", prop_tgt, -1),
                                  ("cw", prop_w, 0.0),
                                  ("cgid", self.my_gid, -1)):
                dst = torch.full((L, pr, cap + 1), fill, dtype=v.dtype,
                                 device=v.device)
                dst.scatter_(2, pos, torch.where(keep, v, fill))
                st[name][:, p0:p1] = dst[..., :cap].to(st[name].dtype)

    def post(self, r: int) -> None:
        L, P, nlm = self.L, self.P, self.nlm
        st = self.state
        if self.cap:
            tg, w, gid = (st["ctgt"].long().reshape(L, -1),
                          st["cw"].reshape(L, -1),
                          st["cgid"].long().reshape(L, -1))
        else:
            tg, w, gid = (st["prop_tgt"].long().reshape(L, -1),
                          st["prop_w"].reshape(L, -1),
                          self.gid_all.reshape(L, -1))
        has = tg >= 0
        nseg = P * nlm + 1
        seg = torch.where(has, owner_slots(tg, self.vtxdist, nlm), nseg - 1)
        word = torch.where(has, grant_word(
            w + hash_unit(gid, tg, r + 31), gid), _EMPTY)
        best = torch.full((L, nseg), _EMPTY, dtype=torch.long,
                          device=tg.device)
        best = best.scatter_reduce(1, seg, word, "amax")
        self.winner = torch.where(best == _EMPTY, 0x7FFFFFFF,
                                  0x7FFFFFFF - (best & 0xFFFFFFFF)
                                  )[:, :P * nlm]

    def commit(self, r: int) -> None:
        L, pr, nlm, p0, p1 = self.L, self.pr, self.nlm, self.p0, self.p1
        st, winner = self.state, self.winner
        win_mine = winner[:, p0 * nlm:p1 * nlm].reshape(L, pr, nlm)
        can_accept = self.unmatched & ~self.is_prop
        grant = torch.where(can_accept & (win_mine < 0x7FFFFFFF), win_mine,
                            -1)
        ptg = st["prop_tgt"][:, p0:p1].long()
        win_t = winner.gather(1, owner_slots(ptg.reshape(L, -1),
                                             self.vtxdist, nlm)
                              ).reshape(L, pr, nlm)
        got = (ptg >= 0) & (win_t == self.my_gid)
        match = st["match"][:, p0:p1].long()
        match = torch.where(got, ptg, match)
        match = torch.where(grant >= 0, grant, match)
        st["match"][:, p0:p1] = match.to(torch.int32)


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
    proposals — the hashes a round's data needs.  ``_PlainMatch`` on the
    whole part range, a round its three phases.
    """
    L, P, nlm = nbr.shape[:3]
    state = _match_state(L, P, nlm, cap, nbr.device)
    state["match"].fill_(-1)
    plain = _PlainMatch(nbr, ewgt, ghost_gid, vtxdist, n_loc, seeds, state,
                        cap=cap)
    for r in range(rounds):
        plain.propose(r, tally)
        plain.post(r)
        plain.commit(r)
    return state["match"]


class DMatchParts:
    """A group member's share of the matching: parts ``parts`` = [p0, p1)
    of each lane.  nbr, ewgt (L, p1 - p0, nlm, d), ghost_gid (L, p1 - p0,
    G) int32: the range's structure; vtxdist (L, P + 1), n_loc (L, P),
    seeds (L,) int32.  ``state`` (``_match_state``) holds every part's rows
    of the mates and proposals: the member writes its own, and its group
    gathers the others' into them, ``gathered(phase)`` naming which.  A
    round is ``propose(r)``, the gather of ``gathered("propose")`` (at the
    cap's width with a cap), ``finish(r)`` (every part's proposals posted
    to this member's winner table, its own rows committed), then, before
    the next propose, the gather of ``gathered("commit")``, the mates.
    CUDA tensors go to the kernels (``dmatch_parts_launch``: 1 launch to
    start, 1 + [cap > 0] a propose, 2 a finish), CPU tensors to
    ``_PlainMatch``."""

    def __init__(self, nbr, ewgt, ghost_gid, vtxdist, n_loc, seeds,
                 parts=None, cap: int = 0):
        for name, t, dims in (("nbr", nbr, 4), ("ewgt", ewgt, 4),
                              ("ghost_gid", ghost_gid, 3),
                              ("vtxdist", vtxdist, 2), ("n_loc", n_loc, 2),
                              ("seeds", seeds, 1)):
            _int32(name, t, dims)
        L, pr, nlm, d = nbr.shape
        P = vtxdist.shape[1] - 1
        self.parts = p0, p1 = part_range(P, parts)
        if ewgt.shape != nbr.shape or pr != p1 - p0 or \
                ghost_gid.shape[:2] != (L, pr) or vtxdist.shape[0] != L or \
                n_loc.shape != (L, P) or seeds.shape != (L,):
            raise ValueError(f"want nbr, ewgt (L, p1 - p0, nlm, d), "
                             f"ghost_gid (L, p1 - p0, G), vtxdist (L, P+1), "
                             f"n_loc (L, P), seeds (L,) for parts {parts}")
        if not 0 <= cap <= nlm:
            raise ValueError(f"cap must be in [0, {nlm}], got {cap}")
        _same_device(nbr, ewgt, ghost_gid, vtxdist, n_loc, seeds)
        self.cap = cap
        self.cuda = nbr.device.type == "cuda"
        self.state = _match_state(L, P, nlm, cap, nbr.device)
        if not self.cuda:
            self.state["match"].fill_(-1)
            self._plain = _PlainMatch(nbr, ewgt, ghost_gid, vtxdist, n_loc,
                                      seeds, self.state, parts, cap)
            return
        self._args = [t.contiguous() for t in (nbr, ewgt, ghost_gid,
                                               vtxdist, n_loc, seeds)]
        G = ghost_gid.shape[2]
        dev = nbr.device
        self._scratch = (
            torch.empty((L, pr, G), dtype=torch.int64, device=dev),
            torch.empty(2 * L * P * nlm, dtype=torch.int64, device=dev),
            torch.empty((L, P, -(-nlm // 256)), dtype=torch.int32,
                        device=dev))
        self._dims = (L, P, nlm, d, G, cap, p0, p1)
        self._phase(0, 0)

    def _phase(self, phase: int, r: int) -> None:
        global dmatch_launches
        st, (gidx, tables, tiles) = self.state, self._scratch
        ptrs = [t.data_ptr() for t in (
            *self._args, st["match"], gidx, tables, st["prop_tgt"],
            st["prop_w"], tiles, st["ctgt"], st["cw"], st["cgid"])]
        own, _ = _enqueue("dmatch_parts_launch", "dmatch",
                          (*ptrs, *self._dims, phase, r),
                          _stream(self._args[0]))
        dmatch_launches += own

    def gathered(self, phase: str) -> List[torch.Tensor]:
        """The state a group gathers after ``phase``: the proposals after
        "propose" (compacted with a cap), the mates after "commit"."""
        if phase == "commit":
            return [self.state["match"]]
        names = ("ctgt", "cw", "cgid") if self.cap else ("prop_tgt",
                                                         "prop_w")
        return [self.state[n] for n in names]

    def propose(self, r: int) -> None:
        if self.cuda:
            self._phase(1, r)
        else:
            self._plain.propose(r)

    def finish(self, r: int) -> None:
        if self.cuda:
            self._phase(2, r)
        else:
            self._plain.post(r)
            self._plain.commit(r)

    @property
    def match(self) -> torch.Tensor:
        """Every part's mates (L, P, nlm) int32: the member's own rows final
        after the last ``finish``."""
        return self.state["match"]


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
