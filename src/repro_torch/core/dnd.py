"""Gather-free distributed nested dissection (paper §2.2 + §3),
frontier-batched.

The port of the reference's ``core/dnd.py``.  End-to-end *sharded*
ordering pipeline: above the centralization thresholds, every structure
the recursion touches stays distributed —

  * **distributed dissection** — separators are computed on the sharded
    ``DGraph`` (multilevel: ``dgraph.distributed_matching`` +
    ``dgraph.dgraph_coarsen`` keep coarse vertices on their
    representative's owner), and the two separated parts are extracted
    with the *distributed induced subgraph* routine
    (``dgraph.dgraph_induced``), each redistributed onto its child
    process group (⌈p/2⌉ / ⌊p/2⌋, paper §3.1) — never through a
    centralized CSR graph;
  * **fold-dup** (§3.2) — once vertices per process drop below
    ``fold_threshold`` the group folds (``dgraph.dgraph_fold``) and two
    duplicate multilevel instances run with independent seeds; the best
    projected separator wins at rejoin and is re-refined by the full
    group;
  * **sharded band refinement** (§3.3) — the band is extracted *in
    place* on each shard from the distributed BFS distances (one halo
    exchange and one ``ell_relax_step`` per width step).  Small bands
    (≤ ``band_central_threshold``) are centralized and refined by k
    multi-sequential FM lanes; large bands stay sharded, refined in
    alternating-color phases (gid-hash two-coloring, at most one movable
    endpoint per cross-shard edge per phase, ghost pulls pushed to
    owners — conflict-free by construction, asserted);
  * **distributed ordering tree** (§2.2) — ``DistOrdering`` records, per
    ND node, its column-block range in the inverse permutation and, per
    shard, the locally-held ordering fragments, so the inverse
    permutation can be *assembled sharded* (``assemble_sharded``);
  * **centralize threshold** (§3.1) — subtrees below
    ``centralize_threshold`` are gathered and handed, all together, to
    the ordering service's breadth-first scheduler (``core.nd.nd_task``
    under a ``WaveRouter``).

**Frontier-batched execution.**  Every stage above is written as a
*work-yielding generator* (mirroring ``nd.separator_task``): tasks yield
typed descriptors — ``DMatchWork``, ``DBFSWork``, ``DHaloWork``, plain
``FMWork`` / ``BFSWork`` / ``MatchWork`` for centralized subproblems,
and lists of ``FMWork`` for the per-phase fragment batches of the
sharded band — and receive the results.  Two drivers execute the same
generators:

  * the **depth-first driver** (``DNDConfig.frontier=False``) runs each
    work the moment it is yielded and spawned subtasks to completion in
    order — the bit-parity oracle;
  * the **frontier driver** (default) walks the whole task tree in
    readiness *waves* through the service's ``WaveRouter``: every
    same-bucket ``DGraph`` stacks along a lane axis into ONE kernel call
    (``dgraph.*_stacked``), and centralized works run through the
    bucketed executors, so per-wave launch count is O(shape buckets),
    not O(live subproblems).

Lane-stacked collectives are bit-identical to singleton execution, so
the two drivers produce **bit-identical orderings**.  Every device work
runs on the caller's ``device`` (the card unless the caller names the
CPU).  With ``group`` (``dgraph.make_parts_group``, the reference's
``parts`` mesh) the sharded works' collectives place their parts on the
group's members, and the centralized works (fm, match and bfs of the
endgame and of centralized bands) run on ``device``, by default the
group's first member; the orderings are the same bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core import dgraph as _dg
from repro_torch.core.band import band_graph_with_anchors
from repro_torch.core.dgraph import (DGraph, boundary_mask, color_by_gid,
                                     dgraph_coarsen, dgraph_fold,
                                     dgraph_induced, np_hash_mix,
                                     pull_by_gid, reshard_vector,
                                     scatter_by_gid, shard_gids,
                                     shard_vector, to_host, unshard_vector,
                                     valid_mask)
from repro_torch.core.fm import FMWork, fm_lane_count, separator_is_valid
from repro_torch.core.graph import Graph
from repro_torch.core.initsep import initial_parts
from repro_torch.core.nd import (NDConfig, _Spawn, child_nprocs,
                                 child_seeds, separator_perm,
                                 separator_task)
from repro_torch.obs.instrument import track_band_stats  # noqa: F401
from repro_torch.util import mix_seeds


@dataclasses.dataclass
class DNDConfig(NDConfig):
    """NDConfig + the distributed-pipeline knobs.

    ``centralize_threshold``: subtrees below this size are gathered and
    deferred to the batched sequential endgame (§3.1).
    ``band_central_threshold``: bands at most this size are centralized
    for multi-sequential FM; larger bands are refined sharded.
    ``band_sync_rounds`` / ``band_shard_lanes``: synchronous halo-sync
    rounds and FM lanes per shard of the sharded band refinement.
    ``band_alt_colors``: schedule sharded-band boundary moves by an
    alternating gid-hash two-coloring — each sync round becomes two
    color phases in which every cross-shard edge has at most one movable
    endpoint, so boundary vertices refine without conflicts (the
    lock-all-boundary legacy schedule is the False setting).
    ``band_check_conflicts``: assert the alternating schedule really
    produced zero cross-shard 0–1 conflicts (the repair rule stays as a
    guarded fallback either way).
    ``frontier``: drive the recursion breadth-first with lane-stacked
    wave execution (the default); False replays the depth-first
    one-launch-per-step driver (the bit-parity oracle).
    """
    centralize_threshold: int = 256     # below: gather + defer to scheduler
    match_rounds: int = 8               # distributed matching rounds
    min_reduction: float = 0.97         # coarsening stall bound
    band_central_threshold: int = 2048  # bands ≤ this centralize (§3.3)
    band_sync_rounds: int = 2           # sharded-band halo-sync rounds
    band_shard_lanes: int = 4           # FM lanes per shard (sharded band)
    band_alt_colors: bool = True        # alternating-color boundary moves
    band_check_conflicts: bool = True   # assert zero conflicts under alt
    frontier: bool = True               # wave-batched lane-stacked driver


# ------------------------------------------------------------------ #
# distributed ordering tree (paper §2.2)
# ------------------------------------------------------------------ #
@dataclasses.dataclass
class DistNode:
    """One ND node: a column-block range of the inverse permutation.

    ``start`` / ``size`` delimit the global index range this node's
    subtree orders — fixed at dissection time from the separated part
    sizes, so no later exchange is needed to place fragments.
    """
    parent: int
    start: int
    size: int
    kind: str = "nd"                # "nd" | "sep"


@dataclasses.dataclass
class DistFragment:
    """One shard-held piece of the inverse permutation.

    ``gids`` are original global vertex ids in elimination order;
    ``start`` is the fragment's absolute position (node column-block
    start + the prefix-sum offset of the preceding shards' pieces);
    ``shard`` records which process holds the piece.
    """
    node: int
    start: int
    shard: int
    gids: np.ndarray


class DistOrdering:
    """Distributed ordering tree: fragments + column-block ranges (§2.2).

    Mirrors the paper's structure: "a distributed tree ... every process
    holds the fragments of the inverse permutation computed by the
    subtrees it took part in".  Each ND node carries its column-block
    range; leaves carry per-shard fragments whose absolute offsets are
    prefix sums of fragment sizes — so the inverse permutation exists as
    shard-local slices (``assemble_sharded``) and is only concatenated
    on one host when the caller explicitly asks (``assemble``).
    """

    root = 0

    def __init__(self, n: int, nparts: int):
        self.n = int(n)
        self.nparts = max(int(nparts), 1)
        self.nodes: List[DistNode] = [DistNode(-1, 0, self.n)]
        self.frags: List[DistFragment] = []

    # -------------------------------------------------------------- #
    def add_node(self, parent: int, start: int, size: int,
                 kind: str = "nd") -> int:
        """Create a child node covering [start, start+size); returns id."""
        pn = self.nodes[parent]
        assert pn.start <= start and start + size <= pn.start + pn.size, \
            "child column block escapes parent range"
        self.nodes.append(DistNode(parent, int(start), int(size), kind))
        return len(self.nodes) - 1

    def column_block(self, node_id: int) -> Tuple[int, int]:
        """The node's [start, end) range in the inverse permutation."""
        nd = self.nodes[node_id]
        return nd.start, nd.start + nd.size

    def add_fragment(self, node_id: int, gids: np.ndarray,
                     shard: int) -> None:
        """Attach one whole-node fragment held by ``shard``."""
        nd = self.nodes[node_id]
        assert len(gids) == nd.size, "fragment does not cover its node"
        self.frags.append(DistFragment(node_id, nd.start, int(shard),
                                       np.asarray(gids, np.int64)))

    def add_sharded_fragments(self, node_id: int,
                              pieces: Sequence[np.ndarray]) -> None:
        """Attach one fragment per shard; offsets by prefix-sum exchange.

        ``pieces[q]`` is shard q's locally-held, locally-ordered slice of
        the node's sub-ordering.  Absolute starts are the exclusive
        prefix sum of piece sizes over shard rank — the offset exchange
        the paper performs to glue ordering-tree fragments.
        """
        nd = self.nodes[node_id]
        sizes = [len(p) for p in pieces]
        assert sum(sizes) == nd.size, "shard pieces do not cover the node"
        offs = np.concatenate([[0], np.cumsum(sizes)])
        for q, piece in enumerate(pieces):
            if len(piece):
                self.frags.append(DistFragment(
                    node_id, nd.start + int(offs[q]), q,
                    np.asarray(piece, np.int64)))

    # -------------------------------------------------------------- #
    @obs.traced("dnd:assemble")
    def assemble(self) -> np.ndarray:
        """Concatenate all fragments into the flat inverse permutation.

        perm[k] = original vertex eliminated k-th.  This is the explicit
        centralization step (for benchmarks / host consumers); the
        pipeline itself never calls it — use ``assemble_sharded`` to keep
        the result distributed.
        """
        perm = np.empty(self.n, dtype=np.int64)
        seen = 0
        for f in sorted(self.frags, key=lambda f: f.start):
            assert f.start == seen, (
                f"fragment at {f.start} overlaps/gaps previous end {seen}")
            perm[f.start:f.start + len(f.gids)] = f.gids
            seen += len(f.gids)
        assert seen == self.n, f"fragments cover {seen} of {self.n}"
        return perm

    def assemble_sharded(self, vtxdist: Optional[np.ndarray] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-shard slices of the inverse permutation (no concatenation).

        Shard q receives global positions [vtxdist[q], vtxdist[q+1]) of
        the inverse permutation (balanced blocks by default).  Every
        fragment knows its absolute start, so routing is a pure local
        write per (fragment, overlapping shard) pair — the paper's
        offset-exchange assembly.  Returns ``(slices, vtxdist)`` where
        ``slices`` is (P, max_slice) with -1 padding.
        """
        if vtxdist is None:
            vtxdist = np.linspace(0, self.n, self.nparts + 1
                                  ).astype(np.int64)
        vtxdist = np.asarray(vtxdist, np.int64)
        P = len(vtxdist) - 1
        width = int(np.diff(vtxdist).max()) if P else 0
        out = -np.ones((P, max(width, 1)), dtype=np.int64)
        for f in self.frags:
            lo, hi = f.start, f.start + len(f.gids)
            q = int(np.searchsorted(vtxdist, lo, side="right") - 1)
            q = max(q, 0)
            while q < P and vtxdist[q] < hi:
                a, b = max(lo, int(vtxdist[q])), min(hi, int(vtxdist[q + 1]))
                if a < b:
                    out[q, a - vtxdist[q]:b - vtxdist[q]] = \
                        f.gids[a - lo:b - lo]
                q += 1
        return out, vtxdist

    def fragment_shards(self) -> np.ndarray:
        """Number of fragments held per shard (bookkeeping / tests)."""
        counts = np.zeros(self.nparts, dtype=np.int64)
        for f in self.frags:
            counts[f.shard % self.nparts] += 1
        return counts


# ------------------------------------------------------------------ #
# separator quality (best-projected-separator-wins, sharded)
# ------------------------------------------------------------------ #
def _eval_part_sh(dg: DGraph, part_sh: np.ndarray, eps_frac: float
                  ) -> Tuple[float, float, float]:
    """(score, sep_w, imb): min separator weight among balance-feasible."""
    v = valid_mask(dg)
    vw = dg.vwgt
    w0 = float(vw[v & (part_sh == 0)].sum())
    w1 = float(vw[v & (part_sh == 1)].sum())
    ws = float(vw[v & (part_sh == 2)].sum())
    imb = abs(w0 - w1)
    total = w0 + w1 + ws
    score = ws if imb <= eps_frac * total else ws + total
    return score, ws, imb


def conflict_loser(vg: np.ndarray, ug: np.ndarray, rnd: int,
                   seed: int) -> np.ndarray:
    """Symmetric loser rule for a conflicted cross-shard 0–1 edge.

    ``True`` where the first endpoint (``vg``) loses and returns to the
    separator.  Both endpoints' owners evaluate the same rule from the
    two global ids alone — no extra messages, like the matching
    protocol's coins — and the rule is *antisymmetric* for distinct
    gids (swapping the arguments flips the result, gid tiebreak on hash
    collisions), so the two shard perspectives always agree on the one
    loser.  Under the alternating-color schedule this is only a guarded
    fallback: the schedule itself admits no conflicts.
    """
    hv = np_hash_mix(vg, rnd, seed & 0x7FFFFFFF)
    hu = np_hash_mix(ug, rnd, seed & 0x7FFFFFFF)
    return (hv < hu) | ((hv == hu) & (vg < ug))


def _cross_conflicts(bpart: np.ndarray, part_ext: np.ndarray,
                     pb: np.ndarray, lib: np.ndarray, cb: np.ndarray
                     ) -> np.ndarray:
    """Mask of conflicted cross-shard arcs under the exchanged view.

    ``(pb, lib, cb)`` is the refinement's cached cross-shard arc index
    (local endpoint, ghost compact index ≥ n_loc_max); the mask marks
    arcs whose ghost neighbor sits on the opposite 0/1 side.  Every
    conflicted edge shows up once per incident shard, so both owners
    see it and the antisymmetric loser rule picks the same vertex from
    either perspective.
    """
    lp = bpart[pb, lib].astype(np.int32)
    gp_ = part_ext[pb, cb]
    return ((lp == 0) & (gp_ == 1)) | ((lp == 1) & (gp_ == 0))


# ------------------------------------------------------------------ #
# typed device-work descriptors of the distributed data plane
# ------------------------------------------------------------------ #
@dataclasses.dataclass
class DMatchWork:
    """One distributed-matching request; result: (P, n_loc_max) mates."""
    dg: DGraph
    seed: int
    rounds: int = 8


@dataclasses.dataclass
class DBFSWork:
    """One distributed band-BFS request; result: (P, n_loc_max) dists."""
    dg: DGraph
    src: np.ndarray                     # (P, n_loc_max) int32 source mask
    width: int


@dataclasses.dataclass
class DHaloWork:
    """One host-level halo exchange; result: (P, n_loc_max + G) ext."""
    dg: DGraph
    x: np.ndarray                       # (P, n_loc_max)


# ------------------------------------------------------------------ #
# band refinement (§3.3): centralized below threshold, sharded above
# ------------------------------------------------------------------ #
def _centralize_band_task(dg: DGraph, part_sh: np.ndarray,
                          dist_sh: np.ndarray, seed: int, k_fm: int,
                          cfg: DNDConfig):
    """Multi-sequential FM on the centralized band (small bands).

    The band subgraph is extracted in place (``dgraph_induced`` with
    ownership preserved), gathered — the band is O(n^{2/3}) on meshes,
    far below ``band_central_threshold`` — and refined by ``k_fm``
    perturbed FM lanes (ONE yielded ``FMWork``); the winning separator
    is scattered back to the owners.  Constructs the exact FM problem
    ``band.extract_band`` would (shared ``band_graph_with_anchors``), so
    this path is bit-identical to the centralized pipeline.
    """
    with obs.span("band:extract"):
        width = cfg.band_width
        v = valid_mask(dg)
        keep = v & (dist_sh <= width)
        band_dg, (bpart_sh, bdist_sh, bgid_sh) = dgraph_induced(
            dg, keep, payloads=(part_sh, dist_sh, shard_gids(dg)),
            fills=(3, 0, -1))
        g_band = to_host(band_dg)
        bpart = unshard_vector(band_dg, bpart_sh).astype(np.int8)
        bdist = unshard_vector(band_dg, bdist_sh)
        bgid = unshard_vector(band_dg, bgid_sh)

        out = v & ~keep
        w_out0 = int(dg.vwgt[out & (part_sh == 0)].sum())
        w_out1 = int(dg.vwgt[out & (part_sh == 1)].sum())
        band, bpart_full, locked = band_graph_with_anchors(
            g_band, bpart, bdist, width, w_out0, w_out1)
        nbr_b, _ = band.to_ell()
    bref, _, _ = yield FMWork(
        nbr=nbr_b, vwgt=band.vwgt, part=bpart_full, locked=locked,
        seed=mix_seeds(seed, 7), k_inst=k_fm, eps_frac=cfg.eps_frac,
        passes=cfg.fm_passes, n_pert=8)
    assert separator_is_valid(nbr_b, bref)
    with obs.span("band:project"):
        return scatter_by_gid(dg, part_sh, bgid, bref[:g_band.n])


@obs.traced("dnd:band")
def _sharded_band_task(dg: DGraph, part_sh: np.ndarray, keep_sh: np.ndarray,
                       dist_sh: np.ndarray, seed: int, cfg: DNDConfig):
    """Shard-local band FM with alternating-color boundary moves (§3.3).

    The band stays sharded: each shard refines the fragment it owns,
    with its ghost ring present but *locked* (remote-owned vertices
    cannot be moved locally) and per-side anchors carrying the rest of
    the graph's weight, so boundary gains and global balance are exact.

    **Schedule** (``band_alt_colors``, default): boundary vertices are
    two-colored by a gid hash and each sync round runs as two *color
    phases* — phase ``ph`` unlocks local boundary vertices of color
    ``ph % 2`` while the opposite color (and, as always, every ghost
    copy) stays locked; of a *monochromatic* cross-shard pair only the
    (hash, gid)-larger endpoint is ever unlocked.  Every cross-shard
    edge therefore has at most one movable endpoint per phase.  When a
    movable vertex drags a locked ghost into the separator, the pull is
    *pushed to the owner* (an owner-routed O(pulled) message — pushes
    only ever move vertices to the separator, so concurrent pushes
    cannot disagree), which makes the fragment-local FM accounting
    globally exact and leaves the phase with **zero** cross-shard 0–1
    conflicts — checked as an invariant each phase.  All shard
    fragments of a phase are yielded as ONE ``FMWork`` list (bucketed
    into one fused-FM kernel dispatch — ``kernels.fm_fused``, mode
    switch ``REPRO_FM_MODE``; under the frontier driver the list batches
    with every other live band refinement of the wave, regardless of the
    fragments' per-lane move budgets since ``max_moves`` left the bucket
    key), and
    one halo exchange per phase both verifies the invariant and feeds
    the next phase — the same per-round exchange budget as the legacy
    schedule.

    The legacy schedule (``band_alt_colors=False``) keeps every local
    vertex movable every round and repairs concurrent-move conflicts
    after the fact with the symmetric hash rule (``conflict_loser``,
    the losing endpoint returns to the separator); under the
    alternating schedule that repair survives only as a guarded
    fallback behind the zero-conflict assertion.
    """
    width = cfg.band_width
    band_dg, (bpart_sh, bdist_sh, bgid_sh) = dgraph_induced(
        dg, keep_sh, payloads=(part_sh, dist_sh, shard_gids(dg)),
        fills=(3, 0, -1))
    P = band_dg.nparts
    nlm = band_dg.n_loc_max
    vwgt_ext = np.asarray((yield DHaloWork(band_dg,
                                           band_dg.vwgt.astype(np.int32))))
    band_gid = shard_gids(band_dg)      # band-graph ids (colors, repair)
    vb = valid_mask(band_dg)

    # out-of-band side weights never change during band refinement; the
    # in-band side weights do, so global totals recompute every phase
    v_full = valid_mask(dg)
    out_full = v_full & ~np.asarray(keep_sh, bool)
    w_out = [int(dg.vwgt[out_full & (part_sh == s)].sum()) for s in (0, 1)]
    bpart = np.asarray(bpart_sh, np.int8).copy()
    bdist = np.asarray(bdist_sh)

    # cross-shard arc index (fixed for the whole refinement): shared by
    # the per-round yield rule, the conflict check and the repair rule
    pb, lib, slb = np.nonzero(band_dg.nbr_gst >= nlm)
    cb = band_dg.nbr_gst[pb, lib, slb].astype(np.int64)
    vg_b = band_gid[pb, lib]
    ug_b = band_dg.ghost_gid[pb, cb - nlm]

    alt = cfg.band_alt_colors and P > 1
    if alt:
        bmask = boundary_mask(band_dg)

    n_phases = (2 if alt else 1) * cfg.band_sync_rounds

    stats = {"schedule": "alt" if alt else "locked", "n": band_dg.n_global,
             "nparts": P, "phases": n_phases, "conflicts": [],
             "repairs": [], "pulls": [], "anchor_min": None,
             "halos": 2 + (1 if alt else 0)}    # vwgt + initial + colors

    # phase-invariant fragment structure, built once per shard: only the
    # anchor edges and the part/weight views change between phases
    frag_base: List[Optional[Tuple]] = []
    for p in range(P):
        n_p = int(band_dg.n_loc[p])
        if n_p == 0:
            frag_base.append(None)
            continue
        G_p = int(band_dg.n_ghost[p])
        rows = band_dg.nbr_gst[p, :n_p]
        li, sl = np.nonzero(rows >= 0)
        c = rows[li, sl].astype(np.int64)
        tgt = np.where(c < nlm, c, n_p + (c - nlm))
        frag_base.append((n_p, G_p, np.stack([li, tgt], 1),
                          bdist[p, :n_p], band_dg.vwgt[p, :n_p],
                          vwgt_ext[p, nlm:nlm + G_p]))

    part_ext = np.asarray((yield DHaloWork(band_dg,
                                           bpart.astype(np.int32))))
    color = yield_to_nbr = None
    for ph in range(n_phases):
        if alt and ph % 2 == 0:
            # round r's coloring + yield set (salt rotates per round): a
            # fixed coloring would freeze the same tiebreak losers for
            # the whole refinement (dense boundaries starve); rotating
            # the hash salt per sync round unlocks a different subset
            # each round while the per-phase at-most-one-movable-endpoint
            # invariant still holds (the coloring is constant within a
            # round).  Only round 0's ghost colors are halo-validated —
            # later colorings are the same pure gid hash, recomputable
            # locally.
            r = ph // 2
            hash_ext, color_ext = color_by_gid(
                band_dg, mix_seeds(seed, 29, r), exchange=False)
            if r == 0:
                col_ext = np.asarray((yield DHaloWork(
                    band_dg, color_ext[:, :nlm].astype(np.int32))))
                gok = band_dg.ghost_gid >= 0
                assert np.array_equal(
                    np.where(gok, col_ext[:, nlm:], 0),
                    np.where(gok, color_ext[:, nlm:].astype(np.int32), 0)
                ), "halo-exchanged ghost colors disagree with the gid hash"
            # monochromatic cross-shard pairs: the (hash, gid)-smaller
            # endpoint yields to its neighbor this round, so those edges
            # too have at most one movable endpoint in their color's phase
            hv_b, hu_b = hash_ext[pb, lib], hash_ext[pb, cb]
            mono = color_ext[pb, lib] == color_ext[pb, cb]
            u_wins = mono & ((hu_b > hv_b)
                             | ((hu_b == hv_b) & (ug_b > vg_b)))
            yield_to_nbr = np.zeros((P, nlm), bool)
            yield_to_nbr[pb[u_wins], lib[u_wins]] = True
            color = color_ext[:, :nlm]
        w_glob = [w_out[s] + int(band_dg.vwgt[vb & (bpart == s)].sum())
                  for s in (0, 1)]
        works: List[FMWork] = []
        shards: List[Tuple[int, np.ndarray]] = []
        for p in range(P):
            if frag_base[p] is None:
                continue
            n_p, G_p, edges0, ldist, lw, gw = frag_base[p]
            edges = edges0
            lpart = bpart[p, :n_p]
            gpart = part_ext[p, nlm:nlm + G_p]
            a0, a1 = n_p + G_p, n_p + G_p + 1
            for s, a in ((0, a0), (1, a1)):
                ll = np.nonzero((ldist == width) & (lpart == s))[0]
                if len(ll):
                    edges = np.concatenate(
                        [edges, np.stack([np.full(len(ll), a), ll], 1)])
            frag_w = [int(lw[lpart == s].sum()) + int(gw[gpart == s].sum())
                      for s in (0, 1)]
            # rest-of-graph anchors: the residual of the freshly
            # recomputed global side totals over the fragment's share.
            # The totals are recomputed from the live part vector every
            # phase (repair kicks and ghost-pull pushes included), so a
            # negative residual can only mean broken round-weight
            # accounting — assert instead of clamping the drift away.
            anchor_w = [w_glob[s] - frag_w[s] for s in (0, 1)]
            assert min(anchor_w) >= 0, (
                f"band round-weight drift: shard {p} phase {ph} holds "
                f"side weights {frag_w} exceeding globals {w_glob}")
            stats["anchor_min"] = (min(anchor_w)
                                   if stats["anchor_min"] is None
                                   else min(stats["anchor_min"],
                                            *anchor_w))
            locked = np.zeros(n_p + G_p + 2, bool)
            locked[n_p:] = True                 # ghosts + anchors
            if alt:
                locked[:n_p] = bmask[p, :n_p] & (
                    (color[p, :n_p] != ph % 2) | yield_to_nbr[p, :n_p])
            if not np.any((lpart == 2) & ~locked[:n_p]):
                continue        # no movable separator vertex: FM no-ops
            frag = Graph.from_edges(n_p + G_p + 2, edges)
            vwgt_f = np.concatenate([lw, gw, anchor_w])
            part_f = np.concatenate([lpart, gpart, [0, 1]]).astype(np.int8)
            nbr_f, _ = frag.to_ell()
            works.append(FMWork(
                nbr=nbr_f, vwgt=vwgt_f, part=part_f, locked=locked,
                seed=mix_seeds(seed, 41, ph, p),
                k_inst=cfg.band_shard_lanes, eps_frac=cfg.eps_frac,
                passes=cfg.fm_passes, n_pert=8))
            shards.append((p, gpart))
        if not works:
            if not alt:
                break           # nothing can ever move again
            stats["conflicts"].append(0)
            stats["repairs"].append(0)
            stats["pulls"].append(0)
            continue            # the other color phase may still refine
        fm_out = yield works    # ONE bucketed dispatch (wave-batched)
        pull_gids: List[np.ndarray] = []
        for (p, gpart_in), (pf, _, _) in zip(shards, fm_out):
            n_p = int(band_dg.n_loc[p])
            G_p = int(band_dg.n_ghost[p])
            bpart[p, :n_p] = pf[:n_p]
            if alt:
                # ghost pulls: local moves dragged these locked remote
                # vertices into the separator; push the pulls to the
                # owners so the fragment accounting is globally real
                pulled = (pf[n_p:n_p + G_p] == 2) & (gpart_in <= 1)
                if pulled.any():
                    pull_gids.append(band_dg.ghost_gid[p, :G_p][pulled])
        n_pulls = 0
        if pull_gids:
            pg_all = np.concatenate(pull_gids)
            n_pulls = len(pg_all)
            bpart = scatter_by_gid(band_dg, bpart, pg_all,
                                   np.full(n_pulls, 2, np.int8))
        stats["pulls"].append(n_pulls)

        # one halo exchange per phase: provides this phase's cross-shard
        # view for the conflict check AND the ghost parts of the next
        # phase — the per-round exchange budget of the legacy schedule
        part_ext = np.asarray((yield DHaloWork(band_dg,
                                               bpart.astype(np.int32))))
        stats["halos"] += 1
        cmask = _cross_conflicts(bpart, part_ext, pb, lib, cb)
        n_conf = int(cmask.sum())
        stats["conflicts"].append(n_conf)
        n_rep = 0
        if n_conf:
            assert not (alt and cfg.band_check_conflicts), (
                f"alternating-color schedule produced {n_conf} "
                f"cross-shard 0-1 conflict arcs in phase {ph}: the "
                "at-most-one-movable-endpoint invariant is broken")
            # guarded fallback (the legacy schedule's repair): the
            # endpoint losing the symmetric hash rule returns to the
            # separator — both owners compute the same loser from the
            # two gids alone, so validity is restored without messages
            lose_local = conflict_loser(vg_b[cmask], ug_b[cmask], ph, seed)
            pk, lk = pb[cmask][lose_local], lib[cmask][lose_local]
            # a vertex losing on several arcs is kicked once
            n_rep = len(np.unique(pk.astype(np.int64) * nlm + lk))
            bpart[pk, lk] = 2
            part_ext = np.asarray((yield DHaloWork(
                band_dg, bpart.astype(np.int32))))
            stats["halos"] += 1
        stats["repairs"].append(n_rep)
    _dg._note_band_stats(stats)

    # project back: each shard writes its refined local band parts to the
    # owners of the original vertices (carried in the bgid payload)
    return scatter_by_gid(dg, part_sh, np.asarray(bgid_sh)[vb], bpart[vb])


@obs.traced("dnd:band")
def _band_refine_task(dg: DGraph, part_sh: np.ndarray, seed: int,
                      p_cur: int, cfg: DNDConfig):
    """§3.3 at one distributed level: sharded BFS + FM refinement.

    The distance sweep always runs on the sharded structure (one halo
    exchange per width step, reusing ``ell_relax_step``); the refinement
    path depends on the band size: centralized multi-sequential lanes
    below ``band_central_threshold``, shard-local FM above.
    """
    k_fm = fm_lane_count(p_cur, cfg.k_fm_cap, cfg.fold_dup)
    v = valid_mask(dg)
    if cfg.use_band:
        dist_sh = np.asarray((yield DBFSWork(
            dg, (part_sh == 2).astype(np.int32), cfg.band_width)))
        dist_sh = np.where(v, dist_sh, np.int32(2 ** 30))
        keep = v & (dist_sh <= cfg.band_width)
    else:                               # ablation: refine the whole level
        dist_sh = np.zeros_like(part_sh, dtype=np.int32)
        keep = v
    band_n = int(keep.sum())
    if band_n + 2 <= cfg.band_central_threshold or dg.nparts == 1:
        if cfg.use_band:
            return (yield from _centralize_band_task(dg, part_sh, dist_sh,
                                                     seed, k_fm, cfg))
        g = to_host(dg)
        part = unshard_vector(dg, part_sh).astype(np.int8)
        nbr_f, _ = g.to_ell()
        part, _, _ = yield FMWork(
            nbr=nbr_f, vwgt=g.vwgt, part=part,
            locked=np.zeros(g.n, bool), seed=mix_seeds(seed, 7),
            k_inst=k_fm, eps_frac=cfg.eps_frac, passes=cfg.fm_passes,
            n_pert=8)
        assert separator_is_valid(nbr_f, part)
        return shard_vector(dg, part, fill=3)
    return (yield from _sharded_band_task(dg, part_sh, keep, dist_sh, seed,
                                          cfg))


def _band_refine_level_sh(dg: DGraph, part_sh: np.ndarray, seed: int,
                          p_cur: int, cfg: DNDConfig,
                          device=None) -> np.ndarray:
    """Synchronous wrapper over ``_band_refine_task`` (tests, ablation)."""
    return _drive_depth_first(_band_refine_task(dg, part_sh, seed, p_cur,
                                                cfg), device)


# ------------------------------------------------------------------ #
# distributed multilevel separator
# ------------------------------------------------------------------ #
def _coarsest_task(g: Graph, seed: int, cfg: DNDConfig):
    """Initial separator on a (centralized) coarsest graph.

    The one FM refinement is yielded, so coarsest separators of every
    live branch share a bucketed dispatch under the frontier driver.
    """
    if g.n < 4:
        return None
    parts0 = initial_parts(g, seed, k_tries=min(cfg.k_init, 32))
    nbr, _ = g.to_ell()
    part, _, _ = yield FMWork(
        nbr=nbr, vwgt=g.vwgt, part=parts0[0], locked=np.zeros(g.n, bool),
        seed=mix_seeds(seed, 0), k_inst=len(parts0), eps_frac=cfg.eps_frac,
        passes=3, n_pert=4, parts_init=parts0)
    assert separator_is_valid(nbr, part)
    return part


@obs.traced("dnd:scatter")
def _centralized_part(dg: DGraph, part: Optional[np.ndarray]
                      ) -> Optional[np.ndarray]:
    """Shard a host-computed part vector back onto dg's layout."""
    if part is None:
        return None
    return shard_vector(dg, part.astype(np.int8), fill=3)


def _dsep_task(dg: DGraph, seed: int, cfg: DNDConfig, inst_budget: int):
    """Multilevel separator of a sharded graph, as a work-yielding task.

    Returns a (P, n_loc_max) int8 part vector (0/1/2, 3 on padding) or
    None when degenerate.  ``inst_budget`` caps the fold-dup instance
    tree (paper: "resort to folding only when ... reaches some minimum
    threshold" — here also a memory cap, mirroring
    ``coarsen_multilevel``'s ``max_instances``).  Centralization only
    happens at bounded sizes: fully-folded instances (n < 2·fold
    threshold) and coarsest graphs (n ≤ coarse_target).  Fully-folded
    single-process instances run ``nd.separator_task`` *inline* (via
    ``yield from``), so their matching / BFS / FM works batch with the
    rest of the frontier.
    """
    p, n = dg.nparts, dg.n_global
    if n < 4:
        return None
    if p <= 1:
        # a fully-folded instance: one process, the sequential pipeline
        part = yield from separator_task(to_host(dg), seed, 1, cfg)
        return _centralized_part(dg, part)
    if n <= cfg.coarse_target:
        part = yield from _coarsest_task(to_host(dg), seed, cfg)
        return _centralized_part(dg, part)

    if cfg.fold_dup and n / p < cfg.fold_threshold and inst_budget >= 2:
        # fold-dup: the group splits; each half holds a duplicate of the
        # folded structure and runs an independent multilevel instance.
        # Best projected separator wins at rejoin (§3.2).  The two
        # halves are spawned as sibling tasks, so under the frontier
        # driver their device waves lane-stack with each other (and with
        # every other live instance of the tree).
        dgf = dgraph_fold(dg)
        halves = yield _Spawn([
            _dsep_task(dgf, s_half, cfg, inst_budget // 2)
            for s_half in (mix_seeds(seed, 11), mix_seeds(seed, 12))])
        with obs.span("dnd:rejoin"):
            cand = [ph for ph in halves if ph is not None]
            if not cand:
                return None
            best = min(cand,
                       key=lambda q: _eval_part_sh(dgf, q, cfg.eps_frac)[0])
            # the rejoined group refines the winning duplicate's separator at
            # the fold level with its full complement of FM lanes (§3.3)
            part_sh = reshard_vector(dgf, dg, best, fill=3)
        return (yield from _band_refine_task(dg, part_sh,
                                             mix_seeds(seed, 13), p, cfg))

    match_sh = yield DMatchWork(dg, mix_seeds(seed, 5), cfg.match_rounds)
    cdg, cmap_sh = dgraph_coarsen(dg, match_sh)
    if cdg.n_global > n * cfg.min_reduction:    # stalled coarsening
        if n <= max(cfg.centralize_threshold, cfg.coarse_target):
            part = yield from _coarsest_task(to_host(dg), seed, cfg)
            return _centralized_part(dg, part)
        if cdg.n_global >= n:
            return None
        # slow but nonzero progress on a big graph: keep going sharded
    part_c = yield from _dsep_task(cdg, mix_seeds(seed, 101), cfg,
                                   inst_budget)
    if part_c is None:
        return None
    # separator projection: fine vertex reads its coarse vertex's part
    # from the coarse owner (coarse vertices stayed on their
    # representative's owner, so most reads are shard-local)
    with obs.span("dnd:project"):
        part_sh = pull_by_gid(cdg, part_c, cmap_sh, fill=3).astype(np.int8)
    return (yield from _band_refine_task(dg, part_sh, seed, p, cfg))


def distributed_separator(dg: DGraph, seed: int,
                          cfg: Optional[DNDConfig] = None, device=None,
                          group=None) -> Optional[np.ndarray]:
    """Top-level entry: sharded separator of a distributed graph.

    Returns the (P, n_loc_max) int8 part vector (0/1/2, padding 3) or
    None when the graph is degenerate.  Drives ``_dsep_task`` depth-first
    (the frontier batching lives in ``distributed_nested_dissection``'s
    driver, which owns a whole task tree), its collectives on ``group``
    where one is given.
    """
    cfg = cfg or DNDConfig()
    return _drive_depth_first(_dsep_task(dg, seed, cfg,
                                         max(cfg.k_fm_cap, 1)), device,
                              group)


def _fallback_task(dg: DGraph):
    """Validity-first fallback: gid bisection, boundary into separator.

    Mirrors ``nd._fallback_separator``'s role when the multilevel
    heuristic degenerates on a big subgraph, without centralizing: side
    by global-id rank, then every side-1 vertex adjacent to side 0 (ghost
    parts via one halo exchange) moves into the separator — no 0–1 edge
    survives, on any shard.
    """
    gid = shard_gids(dg)
    valid = gid >= 0
    part = np.where(gid < dg.n_global // 2, 0, 1).astype(np.int8)
    part[~valid] = 3
    ext = np.asarray((yield DHaloWork(dg, part.astype(np.int32))))
    p, li, sl = np.nonzero(dg.nbr_gst >= 0)
    c = dg.nbr_gst[p, li, sl].astype(np.int64)
    nbr_part = ext[p, c]
    mine = part[p, li]
    to_sep = (mine == 1) & (nbr_part == 0)
    part[p[to_sep], li[to_sep]] = 2
    return part


def _resolve_task(dg: DGraph, part_sh: Optional[np.ndarray],
                  cfg: DNDConfig):
    """Degenerate-separator policy of the sharded recursion."""
    v = valid_mask(dg)

    def degenerate(ps):
        return ps is None or min(int(((ps == 0) & v).sum()),
                                 int(((ps == 1) & v).sum())) == 0

    if degenerate(part_sh):
        if dg.n_global > 4 * cfg.leaf_size:
            part_sh = yield from _fallback_task(dg)
        if degenerate(part_sh):
            return None
    return part_sh


# ------------------------------------------------------------------ #
# distributed ND task tree
# ------------------------------------------------------------------ #
@dataclasses.dataclass
class _Deferred:
    """One centralized subtree, ordered later by the batched scheduler."""
    g: Graph
    gids: np.ndarray
    seed: int
    nproc: int
    node: int
    shard: int


@obs.traced("dnd:defer")
def _defer(dg: DGraph, gids_sh: np.ndarray, seed: int, nproc: int,
           node_id: int, dord: DistOrdering,
           deferred: List[_Deferred]) -> None:
    """§3.1 centralization: gather a sub-threshold subtree for the batch.

    The subtree is assigned (round-robin by node id) to the shard that
    will hold its ordering fragment in the distributed tree.
    """
    g = to_host(dg)
    gids = unshard_vector(dg, gids_sh)
    deferred.append(_Deferred(g, gids, seed, nproc, node_id,
                              node_id % dord.nparts))


def _dnd_task(dg: DGraph, gids_sh: np.ndarray, seed: int, cfg: DNDConfig,
              dord: DistOrdering, node_id: int,
              deferred: List[_Deferred]):
    """One ND tree node as a task: separator, split, spawn the children."""
    p, n = dg.nparts, dg.n_global
    start = dord.nodes[node_id].start
    if p <= 1 or n <= max(cfg.centralize_threshold, cfg.leaf_size):
        # the subtree is sequential from here; defer it so all deferred
        # subtrees batch through the scheduler at once
        _defer(dg, gids_sh, seed, p, node_id, dord, deferred)
        return
    part_sh = yield from _dsep_task(dg, seed, cfg, max(cfg.k_fm_cap, 1))
    part_sh = yield from _resolve_task(dg, part_sh, cfg)
    if part_sh is None:
        _defer(dg, gids_sh, seed, 1, node_id, dord, deferred)
        return
    with obs.span("dnd:split"):
        v = valid_mask(dg)
        n0 = int(((part_sh == 0) & v).sum())
        n1 = int(((part_sh == 1) & v).sum())
        ns = n - n0 - n1
        p0, p1 = child_nprocs(p)
        s0, s1 = child_seeds(seed)
        # distributed induced subgraphs, each redistributed onto its child
        # process group (§3.1: part 0 onto ⌈p/2⌉ processes, part 1 onto ⌊p/2⌋)
        dg0, (g0ids,) = dgraph_induced(dg, (part_sh == 0) & v, nparts=p0,
                                       payloads=(gids_sh,), fills=(-1,))
        dg1, (g1ids,) = dgraph_induced(dg, (part_sh == 1) & v, nparts=p1,
                                       payloads=(gids_sh,), fills=(-1,))
        c0 = dord.add_node(node_id, start, n0)
        c1 = dord.add_node(node_id, start + n0, n1)

        # separator ordered last (highest indices of the column block)
        if ns:
            snode = dord.add_node(node_id, start + n0 + n1, ns, "sep")
            if ns <= max(cfg.centralize_threshold, cfg.leaf_size):
                dgs, (sgids_sh,) = dgraph_induced(dg, (part_sh == 2) & v,
                                                  nparts=1,
                                                  payloads=(gids_sh,),
                                                  fills=(-1,))
                gs = to_host(dgs)
                sgids = unshard_vector(dgs, sgids_sh)
                dord.add_fragment(snode, sgids[separator_perm(gs, seed)],
                                  node_id % dord.nparts)
            else:
                # huge separator: each shard keeps its local fragment,
                # ordered by local id; offsets by the §2.2 prefix-sum exchange
                pieces = [gids_sh[q][v[q] & (part_sh[q] == 2)]
                          for q in range(p)]
                dord.add_sharded_fragments(snode, pieces)

    # the two sides are independent subtrees (paper §3.1): spawned as
    # sibling tasks so the frontier driver advances them concurrently
    yield _Spawn([_dnd_task(dg0, g0ids, s0, cfg, dord, c0, deferred),
                  _dnd_task(dg1, g1ids, s1, cfg, dord, c1, deferred)])


# ------------------------------------------------------------------ #
# drivers: depth-first (oracle) and frontier (wave-batched)
# ------------------------------------------------------------------ #
def _drive_depth_first(gen, device=None, group=None):
    """Depth-first driver: every yielded work executes immediately as a
    one-work wave of the router's ``execute_wave`` on ``device`` (the
    program the frontier driver runs for a one-lane bucket; the sharded
    works' collectives on ``group`` where one is given, ``device`` then
    defaulting to its first member); spawned subtasks run to completion
    in order.  One launch per device step — the oracle the frontier driver
    is asserted bit-identical against.
    """
    from repro_torch.service.router import execute_wave
    device = _group_device(device, group)
    try:
        item = next(gen)
        while True:
            if isinstance(item, _Spawn):
                res = [_drive_depth_first(sub, device, group)
                       for sub in item.tasks]
            else:
                res = execute_wave([item], device=device, group=group)[0][0]
            item = gen.send(res)
    except StopIteration as stop:
        return stop.value


def _group_device(device, group):
    """The device of the centralized works: ``device``, or the group's
    first member where the caller names none."""
    if device is None and group is not None:
        return group.devices[0]
    return device


# ------------------------------------------------------------------ #
# distributed ND entry points
# ------------------------------------------------------------------ #
def distributed_order_batch(dgs: List[DGraph], seeds=0, cfgs=None,
                            return_trees: bool = False, device=None,
                            group=None):
    """Order N distributed graphs concurrently through ONE wave router.

    Every request's task tree is submitted to a shared
    ``service.router.WaveRouter`` on ``device``, so each wave gathers the
    outstanding device works of ALL requests and dispatches each shape
    bucket once — lanes from different requests stack into the same
    kernel call.  Per-lane results are pure functions of the lane's
    inputs, so each ordering is bit-identical to ordering it alone.  The
    centralized endgames of all requests merge into a single
    ``order_batch`` call, sharing their matching / BFS / FM dispatches
    across requests too.

    Args:
      dgs: sharded input graphs; requests may differ in size and seed.
      seeds: one int for all, or one per request.
      cfgs: one ``DNDConfig`` per request (None → defaults).  All
        requests must use the frontier driver (``cfg.frontier=True``);
        the DFS oracle is inherently one-at-a-time.
      return_trees: return ``DistOrdering`` trees instead of perms.
      device: where the centralized works run (by default the group's
        first member, or the card).
      group: the ``dgraph.PartsGroup`` whose members hold the sharded
        works' parts; None runs them on ``device``.

    Returns a list of permutations (or trees), one per request.
    """
    from repro_torch.service.router import WaveRouter
    from repro_torch.service.scheduler import order_batch
    n = len(dgs)
    if isinstance(seeds, int):
        seeds = [seeds] * n
    if cfgs is None:
        cfgs = [DNDConfig() for _ in range(n)]
    assert len(seeds) == n and len(cfgs) == n
    assert all(c.frontier for c in cfgs), \
        "distributed_order_batch requires the frontier driver"
    dords = [DistOrdering(dg.n_global, dg.nparts) for dg in dgs]
    deferreds: List[List[_Deferred]] = [[] for _ in range(n)]
    device = _group_device(device, group)
    router = WaveRouter(device=device, group=group)
    with obs.span("dnd", requests=n,
                  n=int(sum(dg.n_global for dg in dgs)),
                  driver="frontier"):
        for i, (dg, seed, cfg) in enumerate(zip(dgs, seeds, cfgs)):
            root = _dnd_task(dg, shard_gids(dg), seed, cfg, dords[i],
                             DistOrdering.root, deferreds[i])
            router.submit(root, tag=i)
        router.run()
        # ONE merged endgame: the gathered subtrees of every request
        # drain through the scheduler's bucketed executor together
        flat = [(i, d) for i, ds in enumerate(deferreds) for d in ds]
        if flat:
            with _dg.stage("endgame"):
                perms = order_batch([d.g for _, d in flat],
                                    [d.seed for _, d in flat],
                                    [d.nproc for _, d in flat],
                                    [cfgs[i] for i, _ in flat],
                                    tags=[i for i, _ in flat],
                                    device=device)
            for (i, d), perm in zip(flat, perms):
                dords[i].add_fragment(d.node, d.gids[perm], d.shard)
    if return_trees:
        return dords
    out = []
    for dg, dord in zip(dgs, dords):
        perm = dord.assemble()
        assert np.array_equal(np.sort(perm), np.arange(dg.n_global)), \
            "not a permutation"
        out.append(perm)
    return out


def distributed_order_task(dg: DGraph, seed: int, cfg: DNDConfig,
                           hints=None, rec=None):
    """One distributed request as a single suspendable task tree.

    The incremental (pump-driven) counterpart of
    ``distributed_order_batch``: the whole request — top sharded
    dissection AND its centralized endgame — is one composite generator
    a service ``WaveRouter`` can park and resume at any wave boundary.
    The endgame subtrees spawn as ``core.nd.nd_task`` siblings
    the moment this request's top tree finishes, so they share waves
    with whatever else is live on the router (the cross-request endgame
    merge happens per-wave rather than in one deferred batch — same
    per-lane computations, bit-identical orderings).

    ``hints`` / ``rec`` carry the warm-start surface into the endgame:
    each deferred subtree's splits are recorded under (and replayed
    from) paths prefixed ``n<node-id>``, which are stable across
    structurally identical runs because the deferred node ids are
    determined by the recursion shape — and the recursion shape is
    replayed from the same splits.  The sharded top-level separators
    are not warm-started (their part vectors live sharded; see
    DESIGN.md §7 invariants).

    Returns the completed ``DistOrdering`` (assembly is the caller's —
    the service assembles outside the router so parked requests never
    block it).
    """
    from repro_torch.core.nd import nd_task
    from repro_torch.core.ordering import Ordering
    dord = DistOrdering(dg.n_global, dg.nparts)
    deferred: List[_Deferred] = []
    yield _Spawn([_dnd_task(dg, shard_gids(dg), seed, cfg, dord,
                            DistOrdering.root, deferred)])
    if deferred:
        orderings = [Ordering(d.g.n) for d in deferred]
        yield _Spawn([
            nd_task(d.g, np.arange(d.g.n, dtype=np.int64), d.seed,
                    d.nproc, cfg, o, o.root, 0, hints=hints,
                    rec=rec, path=f"n{d.node}")
            for d, o in zip(deferred, orderings)])
        for d, o in zip(deferred, orderings):
            perm = o.assemble()
            dord.add_fragment(d.node, d.gids[perm], d.shard)
    return dord


def distributed_nested_dissection(dg: DGraph, seed: int = 0,
                                  cfg: Optional[DNDConfig] = None,
                                  return_tree: bool = False, device=None,
                                  group=None):
    """Full gather-free ordering of a distributed graph.

    Args:
      dg: the sharded input graph (P shards).
      seed: deterministic seed; the whole pipeline (matching coins, FM
        perturbations, tiebreaks) derives from it, so equal (dg, seed,
        cfg) give identical orderings.
      cfg: DNDConfig; None uses defaults.  ``cfg.frontier`` picks the
        driver; both drivers return bit-identical orderings (asserted in
        the frontier tests), the frontier one in O(buckets) launches per
        wave instead of O(live subproblems).
      return_tree: return the ``DistOrdering`` (fragments stay sharded)
        instead of the flat permutation.
      device: where the device works run: the card unless the caller
        names ``"cpu"`` (raises if there is no card); with ``group`` only
        the centralized ones, by default on its first member.
      group: a ``dgraph.PartsGroup`` (``make_parts_group``) whose members
        hold the sharded works' parts, the reference's ``parts`` mesh;
        the permutation is the same for every group.

    The top levels dissect on the sharded representation — no
    ``to_host`` / ``unshard_vector`` above the configured thresholds, as
    asserted by the gather-free tests under ``dgraph.track_gathers()``.
    The frontier path is the one-request special case of
    ``distributed_order_batch``; the DFS path (``cfg.frontier=False``)
    keeps its own depth-first oracle drive.  Subtrees below
    ``cfg.centralize_threshold`` are gathered and ordered *together* by
    the service scheduler's bucketed breadth-first executor.  Returns
    perm (perm[k] = vertex eliminated k-th) unless ``return_tree``.
    """
    cfg = cfg or DNDConfig()
    device = _group_device(device, group)
    if cfg.frontier:
        return distributed_order_batch([dg], [seed], [cfg],
                                       return_trees=return_tree,
                                       device=device, group=group)[0]
    from repro_torch.service.scheduler import order_batch
    dord = DistOrdering(dg.n_global, dg.nparts)
    deferred: List[_Deferred] = []
    root = _dnd_task(dg, shard_gids(dg), seed, cfg, dord,
                     DistOrdering.root, deferred)
    with obs.span("dnd", n=dg.n_global, nparts=dg.nparts, seed=seed,
                  driver="dfs"):
        _drive_depth_first(root, device, group)
        if deferred:
            with _dg.stage("endgame"):
                perms = order_batch([d.g for d in deferred],
                                    [d.seed for d in deferred],
                                    [d.nproc for d in deferred],
                                    [cfg] * len(deferred), device=device)
            for d, perm in zip(deferred, perms):
                dord.add_fragment(d.node, d.gids[perm], d.shard)
    if return_tree:
        return dord
    perm = dord.assemble()
    assert np.array_equal(np.sort(perm), np.arange(dg.n_global)), \
        "not a permutation"
    return perm
