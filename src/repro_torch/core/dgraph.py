"""Distributed graph structure and its collectives (paper §2.1).

The port of the reference's ``core/dgraph.py``.  A P-way distributed
graph is a ``DGraph`` of stacked per-part host arrays:

  * ``vtxdist``   — the paper's ``procvrttab``: global vertex ranges per
    part (owner lookup by range search);
  * ``nbr_gst``   — the paper's ``edgegsttab``: ELL adjacency in compact
    local indexing, where ids < n_loc_max are local and ids ≥ n_loc_max
    address the ghost slots, numbered by (owner, global id) — the
    cache-friendly agglomeration order of §2.1;
  * ``ewgt_gst``  — the ELL edge weights (heavy-edge matching needs them);
  * ``ghost_gid`` — global ids of each part's ghost slots (the receive
    manifest of the halo exchange).

Two kinds of routines live here:

  * **collectives** (``halo_exchange_stacked``, ``distributed_bfs_stacked``,
    ``distributed_matching_stacked``, and their one-lane forms) — the
    reference's ``shard_map`` programs.  On one card the ``parts`` mesh
    axis is a tensor dimension: same-bucket graphs stack along a leading
    lane axis into (L, P, n_loc_max) tensors, and one kernel call
    (``kernels.dgraph_ops``, ``csrc/dgraph.cu``) serves every lane, each
    ``all_gather`` of the reference becoming a read across P.  Per-lane
    work never mixes lanes, so a stacked call's lane equals its singleton
    call bit for bit.  The collectives run on ``device`` (the card unless
    the caller names the CPU, where the kernels' plain versions run).
    Only the real lanes launch: there is no power-of-two lane padding
    (the reference's ``_lane_pad`` bounded its jit cache), so each launch
    record has ``lanes_pad == lanes``.
  * **groups of devices** (``make_parts_group``, ``PartsGroup``) — the
    counterpart of the reference's ``make_parts_mesh``: a collective
    called with ``group=`` places the P parts on the group's members in
    contiguous blocks, each member's kernels write its own parts' rows,
    and each ``all_gather`` is a copy of every member's rows into the
    others' replicas (``Tensor.copy_``: a peer copy between cards, a copy
    inside the card between members on one card), ordered by CUDA events
    and no host synchronisation.  The result is the one-device call's, bit
    for bit, for every group.
  * **structure rebuilds** (``distribute``, ``dgraph_induced``,
    ``dgraph_fold``, ``dgraph_coarsen``) — host reshuffles of the stacked
    arrays that model the owner-routed ``MPI_Alltoallv`` of the paper's
    redistribution steps, staged in flat arc arrays, never through a
    centralized CSR graph.  They are numpy copies of the reference's.

The instrumentation (``instrument``, ``track_gathers``, ``track_halos``,
``stage`` and the emitters) lives in ``obs.instrument`` and is
re-exported here under the reference's names.  The reference's jit-cache
management (``_JitCache``, ``set_jit_cache_capacity``, ``jit_cache_size``)
has no counterpart: PyTorch compiles nothing a shape.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.graph import Graph
from repro_torch.kernels import dgraph_ops
from repro_torch.obs.instrument import (_note_band_stats, _note_gather,
                                        _note_halo, _note_launch,
                                        instrument, stage, track_gathers,
                                        track_halos)
from repro_torch.util import HostStage, download, download_into, \
    pow2, resolve_device, upload

__all__ = [
    "DGraph", "PartsGroup", "boundary_mask", "color_by_gid",
    "dgraph_arcs", "dgraph_bucket", "dgraph_coarsen", "dgraph_fold",
    "dgraph_induced", "distribute", "distributed_bfs",
    "distributed_bfs_stacked", "distributed_matching",
    "distributed_matching_stacked", "ghost_slots", "halo_exchange_fn",
    "halo_exchange_stacked", "halo_reference", "instrument",
    "make_parts_group", "np_hash_mix",
    "pull_by_gid", "reshard_vector", "scatter_by_gid", "shard_gids",
    "shard_vector", "stage", "to_host", "track_gathers",
    "track_halos", "unshard_vector", "valid_mask", "_note_band_stats",
    "_note_gather", "_note_halo", "_note_launch",
]


@dataclasses.dataclass
class DGraph:
    """Host-resident description of a P-way distributed graph."""
    vtxdist: np.ndarray        # (P+1,) global ranges
    nbr_gst: np.ndarray        # (P, n_loc_max, dmax) compact local/ghost ids
    ewgt_gst: np.ndarray       # (P, n_loc_max, dmax) edge weights (0 pad)
    ghost_gid: np.ndarray      # (P, n_ghost_max) global ids of ghosts (-1 pad)
    n_loc: np.ndarray          # (P,) real local counts
    n_ghost: np.ndarray        # (P,) real ghost counts
    vwgt: np.ndarray           # (P, n_loc_max)

    @property
    def nparts(self) -> int:
        return len(self.vtxdist) - 1

    @property
    def n_loc_max(self) -> int:
        return self.nbr_gst.shape[1]

    @property
    def n_global(self) -> int:
        return int(self.vtxdist[-1])


def _build_dgraph(vtxdist: np.ndarray, src: np.ndarray, dst: np.ndarray,
                  w: np.ndarray, vwgt: np.ndarray,
                  bucket: bool = True) -> DGraph:
    """Assemble the stacked shard arrays from an owner-routed arc list.

    The shared back end of every structure rebuild (``distribute``,
    ``dgraph_induced``, ``dgraph_fold``, ``dgraph_coarsen``).  ``src`` /
    ``dst`` / ``w`` are flat *directed* arc arrays in global ids (each
    undirected edge appears in both directions) — the staging buffers of
    the owner-routed Alltoallv that the paper's redistribution performs;
    ``vwgt`` is the flat (n,) vertex-weight vector in global-id order.
    Parallel arcs are deduplicated with accumulated weights (exactly
    ``Graph.from_edges``'s canonicalization), so rebuilding through here
    matches the centralized builders arc-for-arc.

    Timed as the ``rebuild`` stage (every structure rebuild funnels
    through here), so the bench's per-stage wall-clock breakdown can
    separate host reshuffles from device collectives.
    """
    with stage("rebuild"):
        return _build_dgraph_impl(vtxdist, src, dst, w, vwgt, bucket=bucket)


def _build_dgraph_impl(vtxdist, src, dst, w, vwgt, bucket=True) -> DGraph:
    vtxdist = np.asarray(vtxdist, dtype=np.int64)
    nparts = len(vtxdist) - 1
    n = int(vtxdist[-1])
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    w = np.asarray(w, dtype=np.int64)
    if len(src):
        order = np.lexsort((dst, src))
        src, dst, w = src[order], dst[order], w[order]
        uniq = np.concatenate(
            [[True], (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])])
        seg = np.cumsum(uniq) - 1
        wacc = np.zeros(seg[-1] + 1, dtype=np.int64)
        np.add.at(wacc, seg, w)
        src, dst, w = src[uniq], dst[uniq], wacc

    n_loc = np.diff(vtxdist)
    n_loc_max = int(n_loc.max()) if nparts else 1
    deg = np.bincount(src, minlength=max(n, 1))[:max(n, 1)]
    dmax = int(deg.max()) if len(src) else 1
    if bucket:
        n_loc_max = pow2(max(n_loc_max, 1), 8)
        dmax = pow2(max(dmax, 1), 4)
    n_loc_max = max(n_loc_max, 1)
    dmax = max(dmax, 1)

    owner = np.searchsorted(vtxdist, np.arange(n), side="right") - 1
    p_src = owner[src]
    xadj = np.concatenate([[0], np.cumsum(deg)])
    col = np.arange(len(dst)) - xadj[src]
    li_src = src - vtxdist[p_src]
    remote = p_src != owner[dst]

    # ghost manifests: unique (shard, gid) pairs among remote arc heads.
    # Ascending gid is ascending (owner, gid) because vtxdist is sorted —
    # the §2.1 cache-friendly agglomeration order.
    keys = p_src[remote] * np.int64(max(n, 1)) + dst[remote]
    uk = np.unique(keys)
    gp = uk // max(n, 1)
    ggid = uk % max(n, 1)
    counts = np.bincount(gp, minlength=nparts)
    offs = np.concatenate([[0], np.cumsum(counts)])
    gslot = np.arange(len(uk)) - offs[gp]
    n_ghost = counts.astype(np.int64)
    n_ghost_max = max(int(n_ghost.max()) if nparts else 0, 1)
    if bucket:
        n_ghost_max = pow2(n_ghost_max, 4)
    ghost_gid = -np.ones((nparts, n_ghost_max), dtype=np.int64)
    ghost_gid[gp, gslot] = ggid

    nbr_gst = -np.ones((nparts, n_loc_max, dmax), dtype=np.int32)
    ewgt_gst = np.zeros((nparts, n_loc_max, dmax), dtype=np.int32)
    cidx = dst - vtxdist[owner[dst]] if len(dst) else dst
    if len(uk):
        cidx[remote] = n_loc_max + gslot[np.searchsorted(uk, keys)]
    nbr_gst[p_src, li_src, col] = cidx
    ewgt_gst[p_src, li_src, col] = w

    vwgt_sh = np.zeros((nparts, n_loc_max), dtype=np.int64)
    vwgt_sh[owner, np.arange(n) - vtxdist[owner]] = np.asarray(vwgt, np.int64)
    return DGraph(vtxdist, nbr_gst, ewgt_gst, ghost_gid, n_loc, n_ghost,
                  vwgt_sh)


def distribute(g: Graph, nparts: int,
               vtxdist: Optional[np.ndarray] = None,
               bucket: bool = True) -> DGraph:
    """Distribute a host graph (the paper's user-defined ranges).

    Args:
      g: centralized host graph (symmetric CSR).
      nparts: number of shards P.
      vtxdist: optional (P+1,) custom ownership ranges (the coarse graphs
        of distributed coarsening keep coarse vertices on the owner of
        their representative); the default is a balanced block
        distribution.
      bucket: round padded shard shapes up to powers of two so that
        same-bucket subgraphs share one collective call.

    Returns a ``DGraph`` whose stacked arrays hold g partitioned by
    ``vtxdist`` ranges.
    """
    n = g.n
    if vtxdist is None:
        vtxdist = np.linspace(0, n, nparts + 1).astype(np.int64)
    else:
        vtxdist = np.asarray(vtxdist, dtype=np.int64)
        assert len(vtxdist) == nparts + 1 and vtxdist[-1] == n
    src = np.repeat(np.arange(n, dtype=np.int64), g.degrees())
    return _build_dgraph(vtxdist, src, g.adjncy, g.adjwgt, g.vwgt,
                         bucket=bucket)


# ------------------------------------------------------------------ #
# groups of devices: the counterpart of the reference's parts mesh
# ------------------------------------------------------------------ #
class PartsGroup:
    """D devices that hold a distributed graph's P parts (the reference's
    ``parts`` mesh, ``make_parts_mesh``; built by ``make_parts_group``).

    A collective of P parts runs on the group's first ``min(D, P)``
    members, member g holding the contiguous, balanced block of parts
    ``layout(P)[g]`` = [g·P // D', (g+1)·P // D'); at D' = 1 it is the
    one-device call on the first member.  ``ranges`` is the layout of the
    group's own ``nparts``.  Each member has its own CUDA stream (on the
    CPU none); a call allocates each member's
    replica of the per-row state, (L, P, ...) every part's rows, on that
    member's stream, and synchronises every member before it returns, so
    nothing of a call outlives it.  A sequence of devices may repeat one:
    two members on one card take the path two cards take, their rows
    crossing by a copy inside the card instead of over NVLink.  Calls on
    one group are serialised (``lock``).
    """

    def __init__(self, devices: Sequence[torch.device], nparts: int):
        self.devices = tuple(devices)
        self.nparts = int(nparts)
        self.streams = tuple(torch.cuda.Stream(d) if d.type == "cuda"
                             else None for d in self.devices)
        self.lock = threading.RLock()
        self.ranges = self.layout(self.nparts)

    def __repr__(self) -> str:
        return (f"PartsGroup({[str(d) for d in self.devices]}, "
                f"nparts={self.nparts})")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> bool:
        """Whether no two members share a device."""
        return len(set(self.devices)) == len(self.devices)

    def layout(self, P: int) -> Tuple[Tuple[int, int], ...]:
        """The part ranges of a P-part collective, one a member of the
        first ``min(D, P)``."""
        D = min(self.size, int(P))
        return tuple((g * P // D, (g + 1) * P // D) for g in range(D))

    @contextlib.contextmanager
    def on(self, m: int):
        """Member m's device and stream current (the launches' and
        copies' of its rows)."""
        if self.streams[m] is None:
            yield
            return
        with torch.cuda.device(self.devices[m]), \
                torch.cuda.stream(self.streams[m]):
            yield

    def record(self, m: int):
        """An event after what member m has enqueued (None on the CPU)."""
        if self.streams[m] is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.streams[m])
        return ev

    @contextlib.contextmanager
    def copying(self, src: int, dst: int, event):
        """The streams of a copy of member ``src``'s rows into member
        ``dst``'s replica, after ``event`` (``record(src)``): on one device,
        dst's stream waits for the event; between two, the copy runs on
        src's stream (PyTorch orders it with dst's both ways)."""
        if self.streams[dst] is None:
            yield
            return
        with contextlib.ExitStack() as stack:
            if self.devices[src] != self.devices[dst]:
                stack.enter_context(torch.cuda.stream(self.streams[src]))
            stack.enter_context(torch.cuda.device(self.devices[dst]))
            stack.enter_context(torch.cuda.stream(self.streams[dst]))
            self.streams[dst].wait_event(event)
            yield

    def synchronize(self) -> None:
        for s in self.streams:
            if s is not None:
                s.synchronize()


def make_parts_group(devices, nparts: int) -> PartsGroup:
    """The group of devices that holds P = ``nparts`` parts, the
    counterpart of the reference's ``make_parts_mesh``.

    ``devices`` is an int D, the first D cards (raises if fewer exist:
    the group never folds onto fewer), or a sequence of devices, which may
    repeat one (``["cuda:0"] * D`` runs the group's every line on one
    card) and may be all CPUs (the kernels' plain versions under the same
    schedule: ``make_parts_group(["cpu"] * 3, 8)``).  At most ``nparts``
    members; no mix of CPU and card.  No collective forms a group by
    itself: ``group=None`` keeps the one-device path.
    """
    if isinstance(devices, int):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if devices < 1 or devices > have:
            raise RuntimeError(f"a group of {devices} cards: this host has "
                               f"{have}")
        devs = [torch.device("cuda", i) for i in range(devices)]
    else:
        devs = [torch.device(d) for d in devices]
        if not devs or len({d.type for d in devs}) != 1 or \
                devs[0].type not in ("cpu", "cuda"):
            raise ValueError(f"want a non-empty sequence of CPU or of CUDA "
                             f"devices, got {list(devices)}")
        if devs[0].type == "cuda":
            resolve_device("cuda")
            devs = [torch.device("cuda", d.index or 0) for d in devs]
            have = torch.cuda.device_count()
            if max(d.index for d in devs) >= have:
                raise RuntimeError(f"{[str(d) for d in devs]}: this host has "
                                   f"{have} cards")
        else:
            devs = [torch.device("cpu")] * len(devs)
    if len(devs) > nparts:
        raise ValueError(f"{len(devs)} devices for {nparts} parts")
    return PartsGroup(devs, nparts)


def _gather_rows(group: PartsGroup, ranges, rows: Sequence[Sequence]) -> int:
    """The reference's ``all_gather`` on a group: each member m's rows of
    parts ``ranges[m]`` of each tensor ``rows[m][i]`` ((L, P, ...) replicas,
    one list a member) copied into every other member's ``rows[k][i]``,
    each copy after an event of m's stream.  Returns the bytes copied."""
    events = [group.record(m) for m in range(len(ranges))]
    moved = 0
    for k in range(len(ranges)):
        for m, (p0, p1) in enumerate(ranges):
            if m == k:
                continue
            with group.copying(m, k, events[m]):
                for dst, src in zip(rows[k], rows[m]):
                    part = src[:, p0:p1]
                    dst[:, p0:p1].copy_(part, non_blocking=True)
                    moved += part.numel() * part.element_size()
    return moved


# ------------------------------------------------------------------ #
# sharded <-> flat host vectors
# ------------------------------------------------------------------ #
def shard_vector(dg: DGraph, x: np.ndarray, fill=0) -> np.ndarray:
    """Flat global (n,) -> sharded (P, n_loc_max) (padding = fill).

    A scatter (host value distributed *out* to shards), so it is not part
    of the instrumented gather API.
    """
    out = np.full((dg.nparts, dg.n_loc_max), fill, dtype=np.asarray(x).dtype)
    for p in range(dg.nparts):
        lo, hi = dg.vtxdist[p], dg.vtxdist[p + 1]
        out[p, :hi - lo] = x[lo:hi]
    return out


def _raster_flat(dg: DGraph, xs: np.ndarray) -> np.ndarray:
    """Sharded (P, n_loc_max) -> flat (n,) without touching the gather log.

    Internal staging primitive for the structure rebuilds; user-facing
    centralization must go through ``unshard_vector`` so it is counted.
    """
    xs = np.asarray(xs)
    li = np.arange(dg.n_loc_max)
    keep = (li[None, :] < dg.n_loc[:, None]).reshape(-1)
    return xs.reshape(dg.nparts * dg.n_loc_max, *xs.shape[2:])[keep]


def unshard_vector(dg: DGraph, xs: np.ndarray) -> np.ndarray:
    """Gather a sharded (P, n_loc_max) vector into a flat global (n,).

    One of the two instrumented centralizing gathers (with ``to_host``);
    the gather-free pipeline only applies it to sub-threshold objects.
    """
    _note_gather("unshard_vector", dg.n_global)
    return _raster_flat(dg, xs)


def shard_gids(dg: DGraph) -> np.ndarray:
    """(P, n_loc_max) global vertex id per local slot (-1 on padding)."""
    li = np.arange(dg.n_loc_max, dtype=np.int64)
    gid = dg.vtxdist[:-1, None] + li[None, :]
    return np.where(li[None, :] < dg.n_loc[:, None], gid, -1)


def valid_mask(dg: DGraph) -> np.ndarray:
    """(P, n_loc_max) bool: True on real local slots, False on padding."""
    li = np.arange(dg.n_loc_max)
    return li[None, :] < dg.n_loc[:, None]


def pull_by_gid(dg: DGraph, values_sh: np.ndarray, gid: np.ndarray,
                fill=0) -> np.ndarray:
    """Owner-routed value pull: out[...] = values of vertices ``gid``.

    ``values_sh`` is a (P, n_loc_max) sharded vector on ``dg``'s layout;
    ``gid`` is any-shape global ids (< 0 yields ``fill``).  This is the
    host-side model of the paper's point-to-point value fetch (the same
    owner lookup the halo exchange performs on device); data volume is
    O(len(gid)) words, independent of graph size.
    """
    gid = np.asarray(gid, dtype=np.int64)
    ok = (gid >= 0) & (gid < dg.n_global)
    gsafe = np.clip(gid, 0, max(dg.n_global - 1, 0))
    owner = np.searchsorted(dg.vtxdist, gsafe, side="right") - 1
    owner = np.clip(owner, 0, dg.nparts - 1)
    li = np.clip(gsafe - dg.vtxdist[owner], 0, dg.n_loc_max - 1)
    out = np.asarray(values_sh)[owner, li]
    return np.where(ok, out, fill)


def scatter_by_gid(dg: DGraph, target_sh: np.ndarray, gid: np.ndarray,
                   vals: np.ndarray) -> np.ndarray:
    """Owner-routed value push: write ``vals`` at vertices ``gid``.

    The inverse of ``pull_by_gid``: returns a copy of ``target_sh``
    (a (P, n_loc_max) sharded vector on ``dg``'s layout) with
    ``vals[k]`` written to the owner slot of ``gid[k]`` (negative ids
    skipped).  Models the project-back message of band refinement; data
    volume is O(len(gid)) words.
    """
    gid = np.asarray(gid, dtype=np.int64).reshape(-1)
    vals = np.asarray(vals).reshape(-1)
    ok = (gid >= 0) & (gid < dg.n_global)
    gid, vals = gid[ok], vals[ok]
    owner = np.searchsorted(dg.vtxdist, gid, side="right") - 1
    out = np.asarray(target_sh).copy()
    out[owner, gid - dg.vtxdist[owner]] = vals
    return out


def reshard_vector(src_dg: DGraph, dst_dg: DGraph, xs: np.ndarray,
                   fill=0) -> np.ndarray:
    """Move a sharded vector between two layouts of the *same* vertex set.

    Used when fold-dup rejoins: the winning duplicate's part vector lives
    on the folded layout and is pulled back onto the full group's layout.
    """
    assert src_dg.n_global == dst_dg.n_global
    return pull_by_gid(src_dg, xs, shard_gids(dst_dg), fill=fill)


# ------------------------------------------------------------------ #
# boundary masks + deterministic coloring (alternating-color schedule)
# ------------------------------------------------------------------ #
def np_hash_mix(x: np.ndarray, *salts: int) -> np.ndarray:
    """lowbias32 chain on int arrays (numpy mirror of matching.hash_mix).

    Every shard evaluates the same pure function of global ids alone, so
    symmetric rules (conflict-repair losers, boundary colors) need no
    extra messages — the same argument as the matching protocol's coins.
    """
    def lb(v):
        v = v ^ (v >> np.uint32(16))
        v = v * np.uint32(0x7FEB352D)
        v = v ^ (v >> np.uint32(15))
        v = v * np.uint32(0x846CA68B)
        return v ^ (v >> np.uint32(16))

    h = np.full(np.shape(x), 0x9E3779B9, dtype=np.uint32)
    for v in (x,) + salts:
        v = np.asarray(v).astype(np.uint32)
        h = lb(h ^ (v * np.uint32(0x85EBCA6B) + np.uint32(1)))
    return h


def boundary_mask(dg: DGraph) -> np.ndarray:
    """(P, n_loc_max) bool: local vertices with ≥ 1 cross-shard edge.

    A vertex is *boundary* when any ELL slot addresses the ghost ring
    (compact index ≥ n_loc_max).  Interior vertices can never create a
    cross-shard 0–1 edge, so refinement schedules only need to gate the
    boundary set.
    """
    return (dg.nbr_gst >= dg.n_loc_max).any(axis=2) & valid_mask(dg)


def color_by_gid(dg: DGraph, salt: int = 0, exchange: bool = True,
                 device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic two-coloring of vertices by gid hash (§3.3 schedule).

    Returns ``(hash_ext, color_ext)``, both (P, n_loc_max + n_ghost_max):
    the full uint32 hash (for tiebreaks on monochromatic edges) and the
    color (hash & 1, int8; -1 on padding) for every local slot *and* its
    ghost ring.  Local colors are computed from ``shard_gids``; ghost
    colors are the same pure hash of ``ghost_gid``, so owner and
    neighbor always agree with no messages.  With ``exchange`` the ghost
    colors are additionally halo-exchanged from the owners and
    cross-checked against the local recomputation — callers that
    re-color every round (the alternating-color band schedule rotates
    the salt to avoid starving tiebreak losers) validate the first
    coloring this way and skip the exchange for the rest, keeping the
    per-round exchange budget flat.  The exchange runs on ``device``
    (the card unless the caller names the CPU).
    """
    gid = shard_gids(dg)
    h_loc = np_hash_mix(np.maximum(gid, 0), salt & 0x7FFFFFFF)
    h_gst = np_hash_mix(np.maximum(dg.ghost_gid, 0), salt & 0x7FFFFFFF)
    hash_ext = np.concatenate([h_loc, h_gst], axis=1)
    col_loc = np.where(gid >= 0, (h_loc & 1).astype(np.int32), -1)
    gok = dg.ghost_gid >= 0
    if exchange:
        col_ext = halo_exchange_fn(dg, device)(col_loc)
        assert np.array_equal(np.where(gok, col_ext[:, dg.n_loc_max:], 0),
                              np.where(gok, h_gst & 1, 0)), \
            "halo-exchanged ghost colors disagree with the gid hash"
    color_ext = np.concatenate(
        [col_loc, np.where(gok, (h_gst & 1).astype(np.int32), -1)],
        axis=1).astype(np.int8)
    return hash_ext, color_ext


# ------------------------------------------------------------------ #
# structure rebuilds (host-modelled Alltoallv)
# ------------------------------------------------------------------ #
def dgraph_arcs(dg: DGraph) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flat directed arc triples (src_gid, dst_gid, w) of the structure.

    The staging form every rebuild routes through; both directions of
    each undirected edge are present (ELL rows are symmetric).
    """
    nlm = dg.n_loc_max
    p, li, slot = np.nonzero(dg.nbr_gst >= 0)
    c = dg.nbr_gst[p, li, slot].astype(np.int64)
    src = dg.vtxdist[p] + li
    loc = c < nlm
    dst = np.where(loc, dg.vtxdist[p] + c,
                   dg.ghost_gid[p, np.maximum(c - nlm, 0)])
    w = dg.ewgt_gst[p, li, slot].astype(np.int64)
    return src, dst, w


@obs.traced("dnd:gather")
def to_host(dg: DGraph) -> Graph:
    """Gather the distributed structure back into one centralized Graph.

    The §3.1 centralization step: below the sequential threshold the
    subgraph is gathered onto one process and ordered there.  Instrumented
    (see ``track_gathers``): the gather-free pipeline only calls this on
    sub-threshold subgraphs, coarsest graphs, and band graphs.
    """
    _note_gather("to_host", dg.n_global)
    src, dst, w = dgraph_arcs(dg)
    keep = src < dst                      # one direction; from_edges mirrors
    vwgt = _raster_flat(dg, dg.vwgt)
    return Graph.from_edges(dg.n_global,
                            np.stack([src[keep], dst[keep]], 1),
                            vwgt=vwgt, ewgt=w[keep])


@obs.traced("dnd:induced")
def dgraph_induced(dg: DGraph, keep_sh: np.ndarray,
                   nparts: Optional[int] = None,
                   payloads: Sequence[np.ndarray] = (),
                   fills: Sequence = (),
                   bucket: bool = True
                   ) -> Tuple[DGraph, List[np.ndarray]]:
    """Distributed induced subgraph (paper §3.1, gather-free form).

    Args:
      keep_sh: (P, n_loc_max) bool mask of kept vertices (padding slots
        ignored).
      nparts: target shard count.  ``None`` keeps every kept vertex on its
        current owner (in-place extraction — the band path); an integer
        redistributes onto balanced blocks over that many shards (the
        paper folds each separated part onto its child process group).
      payloads: per-vertex (P, n_loc_max) arrays (e.g. original-id
        vectors) to carry onto the new layout.
      fills: padding fill value per payload (default 0).

    Kept vertices are renumbered by ascending global id, so the induced
    numbering is independent of the shard layout; new ownership ranges
    come from a prefix sum over per-shard keep counts (the offset
    exchange of the paper's redistribution).  Returns the sub-DGraph and
    the payloads mapped onto its layout.
    """
    keep = np.asarray(keep_sh, dtype=bool) & valid_mask(dg)
    counts = keep.sum(axis=1).astype(np.int64)
    n_new = int(counts.sum())
    if nparts is None:
        new_vtxdist = np.concatenate([[0], np.cumsum(counts)])
    else:
        new_vtxdist = np.linspace(0, n_new, nparts + 1).astype(np.int64)

    # rank kept vertices in shard-major raster order == ascending gid
    flatk = keep.reshape(-1)
    newid_flat = -np.ones(dg.n_global, dtype=np.int64)
    old_gid = shard_gids(dg).reshape(-1)[flatk]          # ascending
    newid_flat[old_gid] = np.arange(n_new)

    src, dst, w = dgraph_arcs(dg)
    ns, nd = newid_flat[src], newid_flat[dst]
    ka = (ns >= 0) & (nd >= 0)
    vwgt_new = dg.vwgt.reshape(-1)[flatk]
    sub = _build_dgraph(new_vtxdist, ns[ka], nd[ka], w[ka], vwgt_new,
                        bucket=bucket)
    mapped = []
    for i, pay in enumerate(payloads):
        fill = fills[i] if i < len(fills) else 0
        flat = np.asarray(pay).reshape(-1)[flatk]        # by new gid
        mapped.append(shard_vector(sub, flat, fill=fill))
    return sub, mapped


@obs.traced("dnd:fold")
def dgraph_fold(dg: DGraph, bucket: bool = True) -> DGraph:
    """Fold the structure onto ⌈P/2⌉ shards (paper §3.2).

    Adjacent shard pairs merge (ownership ranges stay contiguous); global
    vertex ids are unchanged, so sharded vectors move between the two
    layouts with ``reshard_vector``.  Each fold-dup half runs an
    independent multilevel instance on (a duplicate of) the folded
    structure.
    """
    new_vtxdist = np.concatenate([dg.vtxdist[:-1:2], dg.vtxdist[-1:]])
    src, dst, w = dgraph_arcs(dg)
    vwgt = _raster_flat(dg, dg.vwgt)
    return _build_dgraph(new_vtxdist, src, dst, w, vwgt, bucket=bucket)


@obs.traced("dnd:coarsen")
def dgraph_coarsen(dg: DGraph, match_sh: np.ndarray,
                   bucket: bool = True) -> Tuple[DGraph, np.ndarray]:
    """Distributed coarse-graph build from a sharded matching (§3.2).

    ``match_sh`` is (P, n_loc_max) mate global ids (self for singletons,
    as ``distributed_matching(..., flat=False)`` returns).  Each coarse
    vertex lives on the owner of its *representative* (min endpoint of
    the matched pair), so no vertex migrates at a coarsening step; coarse
    ownership ranges are the prefix sum of per-shard representative
    counts (identical to ``coarsen.coarse_vtxdist``), and the coarse
    numbering matches the centralized ``coarsen_once`` bit-for-bit.

    Returns ``(coarse_dg, cmap_sh)`` with cmap_sh[p, i] = coarse global
    id of fine local vertex i on shard p (-1 on padding).
    """
    gid = shard_gids(dg)
    valid = gid >= 0
    match = np.where(valid, np.asarray(match_sh, dtype=np.int64), -1)
    match = np.where(valid & (match >= 0) & (match < dg.n_global),
                     match, gid)
    rep = np.minimum(gid, match)
    is_rep = valid & (rep == gid)
    counts = is_rep.sum(axis=1).astype(np.int64)
    cvtxdist = np.concatenate([[0], np.cumsum(counts)])

    crank = (np.cumsum(is_rep.reshape(-1)) - 1).reshape(is_rep.shape)
    cmap_rep = np.where(is_rep, crank, np.int64(-1))
    # non-representatives read their mate's coarse id from its owner (the
    # mate is always the representative: rep = min of the pair)
    cmap_mate = pull_by_gid(dg, cmap_rep, match, fill=-1)
    cmap_sh = np.where(is_rep, cmap_rep, cmap_mate)
    assert int((cmap_sh[valid] < 0).sum()) == 0, \
        "match_sh is not an involution (mate's mate differs); pass a " \
        "matching from distributed_matching or repair symmetry first"
    cmap_sh = np.where(valid, cmap_sh, -1)

    cmap_flat = cmap_sh.reshape(-1)[valid.reshape(-1)]   # by fine gid
    nc = int(cvtxdist[-1])
    cvwgt = np.zeros(nc, dtype=np.int64)
    np.add.at(cvwgt, cmap_flat, _raster_flat(dg, dg.vwgt))
    src, dst, w = dgraph_arcs(dg)
    cs, cd = cmap_flat[src], cmap_flat[dst]
    ka = cs != cd                        # drop collapsed pairs
    cdg = _build_dgraph(cvtxdist, cs[ka], cd[ka], w[ka], cvwgt,
                        bucket=bucket)
    return cdg, cmap_sh


# ------------------------------------------------------------------ #
# lane-stacked collectives
# ------------------------------------------------------------------ #
def dgraph_bucket(dg: DGraph) -> Tuple[int, int, int, int]:
    """Bucket of a DGraph: ``(nparts, n_loc_max, dmax, n_ghost_max)``.

    Same-bucket graphs lane-stack into one kernel call
    (``distribute(bucket=True)`` pads shard shapes to powers of two
    precisely so sibling subgraphs of a recursion land together).
    """
    return (dg.nparts, dg.n_loc_max, dg.nbr_gst.shape[2],
            dg.ghost_gid.shape[1])


def _same_bucket(dgs: Sequence[DGraph], what: str) -> Tuple[int, ...]:
    key = dgraph_bucket(dgs[0])
    if not all(dgraph_bucket(d) == key for d in dgs):
        raise ValueError(f"{what} needs same-bucket graphs")
    return key


def _lanes(arrs, device) -> torch.Tensor:
    """Per-lane host arrays stacked as one int32 tensor on ``device``."""
    return torch.from_numpy(np.stack([np.asarray(a, np.int32)
                                      for a in arrs])).to(device)


def _tags(tags) -> dict:
    return {"tags": list(tags)} if tags is not None else {}


#: ghost slot tables resolved by ``ghost_slots`` in this process
slot_resolutions = 0


def ghost_slots(dg: DGraph, device: torch.device) -> torch.Tensor:
    """``dg``'s ghost slot table on ``device``: (P, n_ghost_max) int32,
    each ghost's lane-local owner slot ``owner * n_loc_max + local``, -1
    for padding (``dgraph_ops.lane_slots``'s values, found here with
    numpy on the host arrays).

    Resolved once per device and kept beside the DGraph's fields, not
    among them: equality, ``repr`` and the service's fingerprints see
    only the fields.  The port never reassigns a DGraph's arrays; a
    structure rebuild makes a new DGraph, which resolves its own table.
    """
    global slot_resolutions
    kept = dg.__dict__.setdefault("_ghost_slots", {})
    table = kept.get(device)
    if table is None:
        gid = np.asarray(dg.ghost_gid, np.int64)
        vd = np.asarray(dg.vtxdist, np.int64)
        owner = np.clip(np.searchsorted(vd, gid, side="right") - 1, 0,
                        dg.nparts - 1)
        local = np.clip(gid - vd[owner], 0, dg.n_loc_max - 1)
        slots = np.where(gid >= 0, owner * dg.n_loc_max + local, -1)
        table = torch.from_numpy(slots.astype(np.int32)).to(device)
        kept[device] = table
        slot_resolutions += 1
    return table


#: each thread's pinned staging buffer of its halo calls
_HALO_STAGE = HostStage()


def stage_halo(xs: Sequence[np.ndarray], G: int,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A halo call's words in the thread's pinned staging buffer
    (``HostStage``): the lanes' (P, n_loc_max) payloads of 4-byte words
    packed as (L, P, n_loc_max) int32, and after them room for the
    (L, P, n_loc_max + G) result; so a call uploads in one copy and
    downloads in one copy, and allocates no pinned memory."""
    L, (P, nlm) = len(xs), xs[0].shape
    buf = _HALO_STAGE.take(L * P * (2 * nlm + G), device)
    payload = buf[:L * P * nlm].view(L, P, nlm)
    words = payload.numpy()
    for i, x in enumerate(xs):
        words[i] = x.view(np.int32)
    return payload, buf[L * P * nlm:].view(L, P, nlm + G)


def _placement(group: Optional[PartsGroup], nparts: int, device):
    """Where a P-part collective runs: ``(device, None)`` on one device
    (the group's first member where its layout of P parts has one), else
    ``(None, ranges)``, the group's layout."""
    if group is None:
        return resolve_device(device), None
    ranges = group.layout(nparts)
    if len(ranges) == 1:
        return group.devices[0], None
    return None, ranges


def _group_note(group: Optional[PartsGroup], ranges, moved: list) -> dict:
    """A group call's launch record fields: its members and the bytes
    copied between them."""
    if group is None:
        return {}
    return {"group": len(ranges) if ranges else 1,
            "xbytes": int(sum(moved))}


def _load_key(kind: str, dev, ranges) -> tuple:
    """A dispatch's ``obs.first_use`` key: per device type, or per
    group size."""
    return (kind, "group", len(ranges)) if ranges else (kind, dev.type)


def _halo_group(group: PartsGroup, ranges, dgs, xs, G: int, moved: list
                ) -> np.ndarray:
    """A halo call on a group: each member uploads its parts' rows of
    the payload (from its block of the thread's pinned stage, sized for
    every member's rows) into its replica, the rows are gathered, each
    member's kernel extends its parts, and each downloads its rows."""
    L, (P, nlm) = len(xs), xs[0].shape
    row = L * (2 * nlm + G)
    stage = _HALO_STAGE.take(P * row, group.devices[0])
    reps, outs = [], []
    for m, (p0, p1) in enumerate(ranges):
        dev, pr = group.devices[m], p1 - p0
        with group.on(m):
            buf = stage[p0 * row:p1 * row]
            payload = buf[:L * pr * nlm].view(L, pr, nlm)
            words = payload.numpy()
            for i, x in enumerate(xs):
                words[i] = x[p0:p1].view(np.int32)
            rep = torch.empty((L, P, nlm), dtype=torch.int32, device=dev)
            rep[:, p0:p1].copy_(payload, non_blocking=True)
            reps.append(rep)
            outs.append(buf[L * pr * nlm:].view(L, pr, nlm + G))
    moved.append(_gather_rows(group, ranges, [[r] for r in reps]))
    for m, (p0, p1) in enumerate(ranges):
        with group.on(m):
            tables = [ghost_slots(d, group.devices[m]) for d in dgs]
            ext = dgraph_ops.halo(reps[m], tables, parts=(p0, p1))
            outs[m].copy_(ext, non_blocking=True)
    group.synchronize()
    out = np.empty((L, P, nlm + G), np.int32)
    for m, (p0, p1) in enumerate(ranges):
        out[:, p0:p1] = outs[m].numpy()
    return out


def halo_exchange_stacked(dgs: Sequence[DGraph],
                          xs: Sequence[np.ndarray],
                          tags: Optional[Sequence] = None,
                          device=None,
                          group: Optional[PartsGroup] = None
                          ) -> List[np.ndarray]:
    """Halo-exchange many same-bucket graphs in ONE kernel launch.

    ``xs[i]`` is graph i's (P, n_loc_max) sharded vector of 4-byte words
    (int32 or float32, one dtype for the whole stack; every exchange of
    the ordering is int32); returns the (P, n_loc_max + n_ghost_max)
    extended vectors.  Lane i's result equals a singleton exchange on
    ``dgs[i]`` bit for bit.  ``tags`` (optional, one per lane) records
    each lane's originating request in the launch metadata — the wave
    router's cross-request attribution.  A call stages the payload in
    the thread's pinned buffer (``stage_halo``), uploads it in one copy,
    reads each graph's ghost slot table where it is kept
    (``ghost_slots``), and downloads the result in one copy into the same
    buffer.  With ``group`` (``make_parts_group``) the parts lie on its
    members: one launch a member, its rows gathered into the others'
    first (``_halo_group``).
    """
    nparts, nlm, _, G = key = _same_bucket(dgs, "halo_exchange_stacked")
    dev, ranges = _placement(group, nparts, device)
    t0 = time.perf_counter()
    xs = [np.asarray(x) for x in xs]
    dtype = xs[0].dtype
    if dtype.itemsize != 4 or any(x.dtype != dtype for x in xs):
        raise TypeError(f"the halo exchange moves 4-byte words of one dtype, "
                        f"got {sorted({str(x.dtype) for x in xs})}")
    L = len(dgs)
    if len(xs) != L or any(x.shape != (nparts, nlm) for x in xs):
        raise ValueError(f"want one ({nparts}, {nlm}) vector a graph, got "
                         f"{[x.shape for x in xs]} for {L} graphs")

    moved: list = []

    def dispatch():
        if ranges:
            with group.lock:
                return _halo_group(group, ranges, dgs, xs, G, moved)
        tables = [ghost_slots(d, dev) for d in dgs]
        payload, result = stage_halo(xs, G, dev)
        return download_into(dgraph_ops.halo(upload(payload, dev), tables),
                             result)

    out = obs.timed_dispatch("halo", "dhalo", _load_key("dhalo", dev, ranges),
                             dispatch, since=t0, lanes=L, lanes_pad=L,
                             bucket=key)
    out = out.view(dtype)
    # words: the reference's model of the launch's all_gather traffic
    _note_launch("dhalo", nparts, L, L, key[1:], 1, L * nparts * nlm,
                 **_tags(tags), **_group_note(group, ranges, moved))
    for _ in range(L):                   # per-work sync budget
        _note_halo(nparts * nlm)
    return [out[i] for i in range(L)]


def halo_exchange_fn(dg: DGraph, device=None,
                     group: Optional[PartsGroup] = None):
    """Returns halo(x (P, n_loc_max)) -> (P, n_loc_max + n_ghost_max), the
    one-lane form of ``halo_exchange_stacked`` on ``device`` or
    ``group``."""
    def halo(x):
        return halo_exchange_stacked([dg], [x], device=device,
                                     group=group)[0]
    return halo


def halo_reference(dg: DGraph, x: np.ndarray) -> np.ndarray:
    """Host oracle for tests."""
    Pn, G = dg.ghost_gid.shape
    out = np.zeros((Pn, dg.n_loc_max + G), dtype=x.dtype)
    flat = np.zeros(dg.vtxdist[-1], dtype=x.dtype)
    for p in range(Pn):
        lo, hi = dg.vtxdist[p], dg.vtxdist[p + 1]
        flat[lo:hi] = x[p, :hi - lo]
    for p in range(Pn):
        out[p, :dg.n_loc_max] = x[p]
        for k, gid in enumerate(dg.ghost_gid[p]):
            if gid >= 0:
                out[p, dg.n_loc_max + k] = flat[gid]
    return out


# ------------------------------------------------------------------ #
# distributed band-BFS (lane-stacked)
# ------------------------------------------------------------------ #
def _dbfs_group(group: PartsGroup, ranges, dgs, srcs, width: int,
                moved: list) -> np.ndarray:
    """A BFS call on a group: each member starts its parts' distances
    (``dgraph_ops.dbfs_init``), then each step gathers the distances and
    each member relaxes its parts (``dbfs_step``); the reference's
    ``scan`` of ``all_gather`` and relaxation."""
    L, (P, nlm) = len(dgs), dgs[0].nbr_gst.shape[:2]
    nbrs, bufs, slots = [], [], []
    for m, (p0, p1) in enumerate(ranges):
        dev = group.devices[m]
        with group.on(m):
            nbrs.append(_lanes([d.nbr_gst[p0:p1] for d in dgs], dev))
            bufs.append(torch.empty((2, L, P, nlm), dtype=torch.int32,
                                    device=dev))
            slots.append(dgraph_ops.dbfs_init(
                _lanes([s[p0:p1] for s in srcs], dev),
                _lanes([d.ghost_gid[p0:p1] for d in dgs], dev),
                _lanes([d.vtxdist for d in dgs], dev), bufs[m][0],
                (p0, p1)))
    for k in range(width):
        moved.append(_gather_rows(group, ranges, [[b[k % 2]] for b in bufs]))
        for m, parts in enumerate(ranges):
            with group.on(m):
                dgraph_ops.dbfs_step(nbrs[m], bufs[m][k % 2],
                                     bufs[m][(k + 1) % 2], slots[m], parts)
    out = np.empty((L, P, nlm), np.int32)
    for m, (p0, p1) in enumerate(ranges):
        with group.on(m):
            out[:, p0:p1] = download(bufs[m][width % 2][:, p0:p1])
    group.synchronize()
    return out


def distributed_bfs_stacked(dgs: Sequence[DGraph],
                            srcs: Sequence[np.ndarray],
                            width: int,
                            tags: Optional[Sequence] = None,
                            device=None,
                            group: Optional[PartsGroup] = None
                            ) -> List[np.ndarray]:
    """Band-distance sweeps of many same-bucket graphs in ONE call.

    ``width`` synchronous steps, each a halo exchange and a min-plus
    relaxation (``ell_relax_step``) of every part against its extended
    vector; distances beyond ``width`` stay ``dgraph_ops.BIG``.  Per-lane
    steps never mix lanes, so each lane equals its singleton sweep bit
    for bit.  ``tags`` attributes lanes to requests.  With ``group`` the
    parts lie on its members, a step a gather and a launch a member
    (``_dbfs_group``).
    """
    nparts, nlm, dmax, G = key = _same_bucket(dgs,
                                              "distributed_bfs_stacked")
    dev, ranges = _placement(group, nparts, device)
    t0 = time.perf_counter()
    L = len(dgs)
    moved: list = []

    def dispatch():
        if ranges:
            with group.lock:
                return _dbfs_group(group, ranges, dgs, srcs, width, moved)
        return download(dgraph_ops.dbfs(
            _lanes([d.nbr_gst for d in dgs], dev), _lanes(srcs, dev),
            _lanes([d.ghost_gid for d in dgs], dev),
            _lanes([d.vtxdist for d in dgs], dev), width))

    dist = obs.timed_dispatch("bfs", "dbfs", _load_key("dbfs", dev, ranges),
                              dispatch, since=t0, lanes=L, lanes_pad=L,
                              bucket=key, width=width)
    # words: the reference's model of the all_gather traffic (one
    # exchange of the distances a step)
    _note_launch("dbfs", nparts, L, L, key[1:], width,
                 width * L * nparts * nlm, **_tags(tags),
                 **_group_note(group, ranges, moved))
    return [dist[i] for i in range(L)]


def distributed_bfs(dg: DGraph, src_mask: np.ndarray, width: int,
                    device=None,
                    group: Optional[PartsGroup] = None) -> np.ndarray:
    """Band-graph distance sweep (§3.3) on the distributed structure: one
    halo exchange per relaxation — the paper's 'spreading distance
    information from all of the separator vertices, using our halo exchange
    routine'.  One-lane wrapper over ``distributed_bfs_stacked``."""
    return distributed_bfs_stacked([dg], [src_mask], width,
                                   device=device, group=group)[0]


# ------------------------------------------------------------------ #
# distributed heavy-edge matching (paper §3.2, lane-stacked)
# ------------------------------------------------------------------ #
def _match_proposal_cap(dgs: Sequence[DGraph], nlm: int) -> int:
    """Lossless per-shard proposal bound of a matching lane stack.

    A vertex can propose in *any* round only if it is valid and has at
    least one valid ELL edge (``cand`` requires one), so the max over
    shards and lanes of that count bounds every round's true proposal
    width — compaction at this cap never drops a proposal, keeping the
    compact protocol bit-identical to the dense one regardless of which
    lanes happen to share the launch.  Quantized up to sub-pow2 steps
    (``max(8, nlm // 8)``), as the reference quantizes it.
    """
    k = 1
    for d in dgs:
        can = (shard_gids(d) >= 0) & (d.nbr_gst >= 0).any(axis=2)
        k = max(k, int(can.sum(axis=1).max()))
    q = max(8, nlm // 8)
    return min(nlm, -(-k // q) * q)


def _dmatch_group(group: PartsGroup, ranges, dgs, seeds, rounds: int,
                  cap: int, moved: list) -> np.ndarray:
    """A matching call on a group (the reference's round, dgraph.py
    1052-1118): each member proposes for its parts; the proposals are
    gathered (at the cap's width with a cap); each member posts every
    part's proposals to its own winner table, so that each derives the
    whole table, and commits its parts; the mates are gathered before the
    next round's proposals read the ghosts' (``dgraph_ops.DMatchParts``)."""
    L, (P, nlm) = len(dgs), dgs[0].nbr_gst.shape[:2]
    members = []
    for m, (p0, p1) in enumerate(ranges):
        dev = group.devices[m]
        with group.on(m):
            members.append(dgraph_ops.DMatchParts(
                _lanes([d.nbr_gst[p0:p1] for d in dgs], dev),
                _lanes([d.ewgt_gst[p0:p1] for d in dgs], dev),
                _lanes([d.ghost_gid[p0:p1] for d in dgs], dev),
                _lanes([d.vtxdist for d in dgs], dev),
                _lanes([d.n_loc for d in dgs], dev),
                _lanes([s & 0x7FFFFFFF for s in seeds], dev),
                (p0, p1), cap))
    for r in range(rounds):
        if r:
            moved.append(_gather_rows(
                group, ranges, [mm.gathered("commit") for mm in members]))
        for m, mm in enumerate(members):
            with group.on(m):
                mm.propose(r)
        moved.append(_gather_rows(
            group, ranges, [mm.gathered("propose") for mm in members]))
        for m, mm in enumerate(members):
            with group.on(m):
                mm.finish(r)
    out = np.empty((L, P, nlm), np.int32)
    for m, (p0, p1) in enumerate(ranges):
        with group.on(m):
            out[:, p0:p1] = download(members[m].match[:, p0:p1])
    group.synchronize()
    return out


def distributed_matching_stacked(dgs: Sequence[DGraph],
                                 seeds: Sequence[int],
                                 rounds: int = 8,
                                 tags: Optional[Sequence] = None,
                                 device=None,
                                 group: Optional[PartsGroup] = None
                                 ) -> List[np.ndarray]:
    """Match many same-bucket graphs in ONE call.

    Returns, per graph, the sharded (P, n_loc_max) mate global ids
    (``flat=False`` contract: -1→self masking and owner-routed symmetry
    repair applied on the host).  Coins, tie breaks and the per-lane
    grant reductions are functions of each lane's own (gids, seed)
    alone, so lane i's matching equals ``distributed_matching(dgs[i],
    ...)`` bit for bit.

    When the proposer bound is small enough to pay (3·cap <
    2·n_loc_max), the proposal gather runs at the lossless cap of
    ``_match_proposal_cap`` (the reference's default, compaction on);
    the kernels then rank each part's proposals and keep the first
    ``cap``, which by construction are all of them, so the result equals
    the dense protocol's.  The launch record carries ``cap`` and the
    counterfactual ``words_dense``.  With ``group`` the parts lie on its
    members, two gathers a round (``_dmatch_group``); the cap is the same
    on every member, since every member's winner table takes every
    proposal.
    """
    nparts, nlm, dmax, G = key = _same_bucket(
        dgs, "distributed_matching_stacked")
    dev, ranges = _placement(group, nparts, device)
    t0 = time.perf_counter()
    L = len(dgs)
    cap = _match_proposal_cap(dgs, nlm)
    if 3 * cap >= 2 * nlm:
        cap = 0

    moved: list = []

    def dispatch():
        if ranges:
            with group.lock:
                return _dmatch_group(group, ranges, dgs, seeds, rounds, cap,
                                     moved)
        return download(dgraph_ops.dmatch(
            _lanes([d.nbr_gst for d in dgs], dev),
            _lanes([d.ewgt_gst for d in dgs], dev),
            _lanes([d.ghost_gid for d in dgs], dev),
            _lanes([d.vtxdist for d in dgs], dev),
            _lanes([d.n_loc for d in dgs], dev),
            _lanes([s & 0x7FFFFFFF for s in seeds], dev), rounds, cap))

    m = obs.timed_dispatch("match", "dmatch",
                           _load_key("dmatch", dev, ranges), dispatch,
                           since=t0, lanes=L, lanes_pad=L, bucket=key,
                           rounds=rounds, cap=cap)
    # words, the reference's model of the all_gather traffic: per dense
    # round the unmatched-mask halo, proposal targets and proposal
    # weights; a compact round the halo at n_loc_max plus three cap-wide
    # buffers (targets, weights, proposer gids)
    words_dense = rounds * 3 * L * nparts * nlm
    words = rounds * L * nparts * (nlm + 3 * cap) if cap else words_dense
    _note_launch("dmatch", nparts, L, L, key[1:], rounds, words, cap=cap,
                 words_dense=words_dense, **_tags(tags),
                 **_group_note(group, ranges, moved))
    out = []
    for i, dg in enumerate(dgs):
        gid = shard_gids(dg)
        valid = gid >= 0
        m_sh = m[i].astype(np.int64)
        m_sh = np.where(valid & (m_sh >= 0) & (m_sh < dg.n_global),
                        m_sh, gid)
        # defensive symmetry repair (protocol is symmetric by
        # construction): each vertex checks its mate's mate via an
        # owner-routed pull
        mate_of_mate = pull_by_gid(dg, m_sh, m_sh, fill=-1)
        out.append(np.where(valid & (mate_of_mate == gid), m_sh, gid))
    return out


def distributed_matching(dg: DGraph, seed: int, rounds: int = 8,
                         flat: bool = True, device=None,
                         group: Optional[PartsGroup] = None) -> np.ndarray:
    """Synchronous probabilistic heavy-edge matching across parts.

    The paper's request/grant protocol (§3.2): each round, unmatched
    proposers pick their heaviest unmatched acceptor neighbour (ghosts
    included, through the owners' unmatched flags); every part derives
    the same per-acceptor winner table from the proposals — acceptors
    grant from their slots, proposers read their target's slot, and both
    ends commit with no grant gather-back.  Coin flips and tie breaks
    are hashes of (gid, round, seed), so the result is independent of the
    part layout.

    With ``flat`` the matching is gathered into a flat global (n,) array
    with match[v] = v for singletons; with ``flat=False`` it stays
    sharded: (P, n_loc_max) mate global ids (-1 on padding), the form
    ``dgraph_coarsen`` consumes.  One-lane wrapper over
    ``distributed_matching_stacked``.
    """
    m_sh = distributed_matching_stacked([dg], [seed], rounds,
                                        device=device, group=group)[0]
    if flat:
        return unshard_vector(dg, m_sh)
    return m_sh
