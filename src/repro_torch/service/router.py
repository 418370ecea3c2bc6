"""Unified wave router: one shared lane stack for the whole service.

The port of the reference's ``service/router.py``.  One
**WaveRouter** owns the frontier of *all* concurrently-submitted task
trees and executes every wave through one stage table:

  * centralized work — ``FMWork`` (bare or in per-phase lists),
    ``BFSWork`` and ``MatchWork`` — runs through the bucketed executors
    of ``core.fm``, ``core.band`` and ``core.coarsen``, one dispatch per
    ELL bucket.  FM buckets key on ``(n_pad, d_pad, passes, pos_only)``
    only: move budgets are per-lane data of the FM kernels, so works
    with different ``max_moves`` share a launch;
  * distributed work — ``DMatchWork`` / ``DBFSWork`` / ``DHaloWork`` of
    ``core.dnd`` — groups by ``dgraph_bucket`` (plus rounds / width /
    dtype) and each group runs as ONE lane-stacked collective call of
    ``core.dgraph``, however many requests contributed lanes.

Same-bucket works of every live task — siblings at any depth, different
*requests* — stack into the lanes of one kernel call.

Launches per wave are therefore bounded by live shape buckets, not by
requests.  Per-lane results are pure functions of each lane's own inputs
(each kernel's lanes equal their singleton calls bit for bit), so
routing N trees through shared waves is bit-identical to driving them
one at a time, or through the looped ``core.nd.nested_dissection``.

The router runs its works on one device (``device``, the card unless the
caller names ``"cpu"``), and the distributed kinds' collectives on the
device group ``group`` where one is given (``RouterConfig.group``, the
reference's ``mesh``: a ``dgraph.PartsGroup`` whose members hold the
parts; ``device`` then defaults to its first member).  Its recovery ladder (retry, FM kernel-path
degrade, isolate, excise) never moves work to another device: on the
card the FM ladder is fused → hoisted, both CUDA kernels, and a group
that fails at hoisted is isolated and then excised; on the CPU it keeps
the reference's third rung, the plain torch oracle.  The distributed
kinds' ladder is retry and isolate, as in the reference: it has no
plain rung.

``RouterConfig`` carries the reference's ``mesh`` as ``group``; it leaves
out the reference's ``jit_cache_capacity`` (which bounds a JAX
jit-builder cache with no counterpart under PyTorch), and its
``frontier_waves``, ``max_wave_works`` and ``pump_wave_budget``, which
nothing reads.

Tasks are generators yielding typed work descriptors (or ``_Spawn``
lists of subtasks) and receiving results — the protocol
``core.nd.separator_task`` already speaks.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.band import BFSWork, execute_bfs_works
from repro_torch.core.coarsen import MatchWork, execute_match_works
from repro_torch.core.dgraph import (PartsGroup, dgraph_bucket,
                                     distributed_bfs_stacked,
                                     distributed_matching_stacked,
                                     halo_exchange_stacked)
from repro_torch.core.dnd import DBFSWork, DHaloWork, DMatchWork, _Spawn
from repro_torch.core.fm import FMWork, execute_fm_works
from repro_torch.kernels.ops import FM_MODES, fm_mode_default
from repro_torch.obs.instrument import _note_wave, instrument
from repro_torch.service import faults as _faults
from repro_torch.train.fault import StragglerMonitor
from repro_torch.util import resolve_device


# ------------------------------------------------------------------ #
# configuration
# ------------------------------------------------------------------ #
@dataclasses.dataclass
class RouterConfig:
    """Wave-router configuration, with an env-var default.

    ``straggler_factor``: a wave slower than this factor × the running
    wave-time EWMA is counted in ``WaveRouter.stats()`` and
    ``repro_router_straggler_waves_total``; loose by default because a
    wave that builds or loads a kernel library dwarfs steady-state waves.
    A pump's wave budget is the admission policy's
    (``sched_policy.PolicyConfig.wave_budget``).

    ``group``: the device group that serves the distributed kinds
    (``dmatch``, ``dbfs``, ``dhalo``), a ``dgraph.PartsGroup`` built by
    ``dgraph.make_parts_group``; None runs them on the router's device.
    """
    straggler_factor: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("REPRO_STRAGGLER_FACTOR", "4.0")))
    group: Optional[PartsGroup] = None


# ------------------------------------------------------------------ #
# work typing (the router's stage table)
# ------------------------------------------------------------------ #
def work_kind(work) -> str:
    """Stage-table kind of one yielded work descriptor."""
    if isinstance(work, (list, FMWork)):
        return "fm"
    if isinstance(work, BFSWork):
        return "bfs"
    if isinstance(work, MatchWork):
        return "match"
    if isinstance(work, DMatchWork):
        return "dmatch"
    if isinstance(work, DBFSWork):
        return "dbfs"
    if isinstance(work, DHaloWork):
        return "dhalo"
    raise TypeError(f"unknown work kind: {type(work).__name__}")


# ------------------------------------------------------------------ #
# recovery ladder — rungs 1–3 live at the wave level
# ------------------------------------------------------------------ #
def fm_ladder_modes(device) -> Tuple[str, ...]:
    """The FM kernel-path degrade ladder (rung 2) on ``device``.

    Every rung is bit-identical, so degrading trades only speed for
    independence from the suspect code path: the fused pass-loop kernel,
    then the hoisted pass loop (gain and move-loop kernels), then, on
    the CPU only, the plain torch oracle.  The oracle has no kernel, and
    the card's work never runs as plain torch, so on the card the ladder
    ends at hoisted.
    """
    if resolve_device(device).type == "cuda":
        return FM_MODES[:2]
    return FM_MODES


class _WorkFailed:
    """Sentinel result of ONE work whose dispatch failed beyond the
    ladder — co-riding works of the same wave keep their real results."""
    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


class TaskFailure:
    """Terminal result of an excised task tree: the root was removed
    from the frontier after its work failed beyond the ladder.  The
    service resolves (or cold-readmits) its riders; ``run()`` re-raises
    for non-service callers."""
    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error

    def __repr__(self):
        return f"TaskFailure({self.error!r})"


def _failure_of(result) -> Optional[BaseException]:
    """The failure carried by one wave result (list works fail if any
    of their slots failed), or None for a clean result."""
    if isinstance(result, _WorkFailed):
        return result.error
    if isinstance(result, list):
        for r in result:
            if isinstance(r, _WorkFailed):
                return r.error
    return None


class _Recovery:
    """Per-router recovery state: retry budgets (rung 1), the sticky
    per-request kernel degrade level (rung 2), and isolation counters
    (rung 3's group→singleton split).  Degrade is keyed by request tag —
    never process-global: co-riders of an un-degraded request keep the
    fast path, and ``pop_tag`` hands the per-request totals to the
    service for ``OrderResult.retries`` / ``.degraded``.

    ``modes`` is the device's FM ladder (``fm_ladder_modes``); its base
    level is the process-default mode (``REPRO_FM_MODE``), which must be
    on the ladder: the oracle on the card raises ``ValueError``, as the
    looped driver does.
    """

    def __init__(self, cfg: Optional[_faults.RecoveryConfig] = None,
                 device=None):
        self.cfg = cfg or _faults.RecoveryConfig()
        self.modes = fm_ladder_modes(device)
        mode = fm_mode_default()
        if mode not in self.modes:
            raise ValueError(f"REPRO_FM_MODE={mode!r} is not on this "
                             f"device's FM ladder {self.modes}")
        self.base_level = self.modes.index(mode)
        self.degrade_by_tag: Dict = {}
        self.retries_by_tag: Dict = defaultdict(int)
        self.isolations = 0

    def level_of(self, tag) -> int:
        return self.degrade_by_tag.get(tag, self.base_level)

    def note_retry(self, kind: str, tags, attempt: int) -> None:
        """Bill one transient retry and sleep its capped backoff."""
        obs.REGISTRY.inc("repro_service_retries_total", kind=kind)
        for tg in set(tags):
            if tg is not None:
                self.retries_by_tag[tg] += 1
        with obs.span("recover:retry", kind=kind, attempt=attempt):
            time.sleep(self.cfg.backoff(attempt))

    def retry_loop(self, kind: str, tags, run):
        """Rung 1: re-run transient failures with capped backoff; any
        other failure (or an exhausted budget) escalates to the caller."""
        attempt = 0
        while True:
            try:
                return run()
            except Exception as err:
                if not (_faults.is_transient(err)
                        and attempt < self.cfg.max_retries):
                    raise
                attempt += 1
                self.note_retry(kind, tags, attempt)

    def note_degrade(self, tags, level: int, err: BaseException) -> None:
        obs.REGISTRY.inc("repro_service_degraded_total",
                         mode=self.modes[level])
        for tg in set(tags):
            if tg is not None:
                self.degrade_by_tag[tg] = max(self.level_of(tg), level)
        with obs.span("recover:degrade", mode=self.modes[level],
                      error=type(err).__name__):
            pass

    def note_isolate(self, kind: str, tags, err: BaseException) -> None:
        self.isolations += 1
        with obs.span("recover:isolate", kind=kind,
                      error=type(err).__name__):
            pass

    def pop_tag(self, tag) -> Tuple[int, bool]:
        """(retries, degraded) accumulated for one finished request."""
        retries = int(self.retries_by_tag.pop(tag, 0))
        degraded = (self.degrade_by_tag.pop(tag, self.base_level)
                    > self.base_level)
        return retries, degraded


def _validate_fm_outs(works: Sequence[FMWork], outs) -> None:
    """Rung 4's kernel-side half: a selected FM result must be finite
    with in-range parts, else the wave treats the dispatch as failed
    (``CorruptResult``) and the ladder degrades — so NaN-corrupted
    outputs take the same recovery path as raised faults."""
    for w, (part, sep_w, imb) in zip(works, outs):
        p = np.asarray(part)
        if (not np.isfinite(sep_w) or not np.isfinite(imb)
                or (p.size and (p.min() < 0 or p.max() > 2))):
            raise _faults.CorruptResult(
                f"fm output failed validation (sep_w={sep_w!r}, "
                f"parts in [{p.min() if p.size else 0}, "
                f"{p.max() if p.size else 0}])")


def _fm_ladder(rec: _Recovery, works: Sequence[FMWork], tags,
               level: int, device):
    """Run one FM group with retry (rung 1) + degrade (rung 2): on a
    non-transient failure or invalid output, step the device's mode
    ladder and re-dispatch; raises once its last rung fails."""
    lv = max(level, rec.base_level)
    while True:
        mode = rec.modes[lv]
        try:
            outs = rec.retry_loop(
                "fm", tags,
                lambda: execute_fm_works(works, device, mode=mode))
            _validate_fm_outs(works, outs)
            return outs
        except Exception as err:
            if lv + 1 >= len(rec.modes):
                raise
            lv += 1
            rec.note_degrade(tags, lv, err)


def execute_wave(works: List, level: Optional[int] = None,
                 tags: Optional[Sequence] = None,
                 recovery: Optional[_Recovery] = None,
                 device=None,
                 group: Optional[PartsGroup] = None) -> Tuple[List, dict]:
    """Execute one wave of mixed works on ``device``, bucketed +
    lane-stacked; the distributed kinds' collectives on ``group`` where
    one is given.

    ``FMWork`` (bare or in per-phase lists), ``BFSWork`` and
    ``MatchWork`` run through the bucketed executors, one dispatch per
    bucket; ``DMatchWork`` / ``DBFSWork`` / ``DHaloWork`` group by
    ``(kind, dgraph_bucket, rounds | width | dtype)``, one lane-stacked
    collective call per group.  Per-lane results are independent of
    wave composition, so wave execution is bit-identical to singleton
    execution.

    ``tags`` (optional, aligned with ``works``) attributes each work to
    its originating request: the wave summary then carries ``requests``
    (distinct tags present) and ``shared_launches`` (bucket groups that
    received lanes from ≥ 2 requests — the cross-request sharing the
    router exists for).

    Returns (results in input order, wave summary with per-kind works /
    buckets / launches plus the wave's wall-clock ``t_s`` and per-stage
    ``stage_s`` rollup).  The launches are *measured*: the executors'
    launch records in a nested ``instrument()`` block.  When tracing is
    enabled the wave runs under a ``router:wave`` span whose children
    are the bucket dispatch spans.

    ``recovery`` (a router's ``_Recovery``, None for bare callers)
    activates the wave-level recovery ladder: transient dispatch faults
    retry with capped backoff, failing/corrupt FM groups degrade down
    the device's mode ladder, and a group that fails beyond the ladder
    is *isolated* — each of its works re-runs as a singleton dispatch so
    one poisoned lane cannot fail its co-riders; works that still fail
    come back as ``_WorkFailed`` results (the router excises their task
    trees) while every other result slot stays valid.
    """
    for w in works:
        work_kind(w)                    # reject unknown kinds up front
    dev = resolve_device(device)
    results: List = [None] * len(works)
    summary: Dict[str, dict] = {"works": {}, "buckets": {},
                                "launches": {}}
    t_wave = time.perf_counter()
    tag_of = (lambda i: None) if tags is None else (lambda i: tags[i])
    group_tags: Dict[Tuple, set] = defaultdict(set)
    rec = recovery

    def guarded(kind: str, idxs: List[int], run_all, run_one) -> List:
        """Rungs 1+3 around one bucket-group dispatch: retry the whole
        group, then isolate per-work on terminal failure."""
        if rec is None:
            return run_all()
        tags_l = [tag_of(i) for i in idxs]
        try:
            return rec.retry_loop(kind, tags_l, run_all)
        except Exception as err:
            rec.note_isolate(kind, tags_l, err)
            outs: List = []
            for i in idxs:
                try:
                    outs.append(rec.retry_loop(
                        kind, [tag_of(i)], lambda i=i: run_one(i)))
                except Exception as e1:
                    outs.append(_WorkFailed(e1))
            return outs

    def guarded_fm(items: List[Tuple[int, Optional[int], FMWork]]
                   ) -> List:
        """FM groups additionally split by each request's sticky
        degrade level and run through the mode ladder (rung 2)."""
        if rec is None:
            return execute_fm_works([w for _, _, w in items], dev)
        by_level: Dict[int, List[int]] = defaultdict(list)
        for pos, (i, _, _w) in enumerate(items):
            by_level[rec.level_of(tag_of(i))].append(pos)
        outs: List = [None] * len(items)
        for lv in sorted(by_level):
            poss = by_level[lv]
            g_works = [items[p][2] for p in poss]
            g_tags = [tag_of(items[p][0]) for p in poss]
            try:
                g_outs = _fm_ladder(rec, g_works, g_tags, lv, dev)
            except Exception as err:
                rec.note_isolate("fm", g_tags, err)
                g_outs = []
                for p in poss:
                    i, _, w = items[p]
                    try:
                        g_outs.append(_fm_ladder(
                            rec, [w], [tag_of(i)],
                            rec.level_of(tag_of(i)), dev)[0])
                    except Exception as e1:
                        g_outs.append(_WorkFailed(e1))
            for p, r in zip(poss, g_outs):
                outs[p] = r
        return outs

    def note(kind: str, n_works: int, n_buckets: int) -> None:
        summary["works"][kind] = summary["works"].get(kind, 0) + n_works
        summary["buckets"][kind] = (summary["buckets"].get(kind, 0)
                                    + n_buckets)

    # flatten FM lists, bucket by kind
    fm_items: List[Tuple[int, Optional[int], FMWork]] = []
    bfs_items: List[Tuple[int, BFSWork]] = []
    mt_items: List[Tuple[int, MatchWork]] = []
    for i, w in enumerate(works):
        if isinstance(w, list):
            if not all(isinstance(s, FMWork) for s in w):
                raise TypeError("a list work holds FMWork items only")
            results[i] = [None] * len(w)
            fm_items.extend((i, j, s) for j, s in enumerate(w))
        elif isinstance(w, FMWork):
            fm_items.append((i, None, w))
        elif isinstance(w, BFSWork):
            bfs_items.append((i, w))
        elif isinstance(w, MatchWork):
            mt_items.append((i, w))

    # the wave's launch counts are *measured*: every executor below
    # notes its real dispatches into the active instrument blocks, and
    # this nested block captures exactly this wave's records — so the
    # launches == buckets budget compares against what actually ran
    n_requests = (len({tags[i] for i in range(len(works))})
                  if tags is not None and works else 1)
    with instrument() as wave_ins, \
            obs.span("router:wave", level=level, works=len(works),
                     requests=n_requests):
        if fm_items:
            outs = guarded_fm(fm_items)
            for (i, j, _), r in zip(fm_items, outs):
                if j is None:
                    results[i] = r
                else:
                    results[i][j] = r
            note("fm", len(fm_items),
                 len({w.bucket_key() for _, _, w in fm_items}))
            for i, _, w in fm_items:
                group_tags[("fm", w.bucket_key())].add(tag_of(i))
        if bfs_items:
            outs = guarded(
                "bfs", [i for i, _ in bfs_items],
                lambda: execute_bfs_works([w for _, w in bfs_items], dev),
                lambda i: execute_bfs_works([works[i]], dev)[0])
            for (i, _), r in zip(bfs_items, outs):
                results[i] = r
            note("bfs", len(bfs_items),
                 len({w.bucket_key() for _, w in bfs_items}))
            for i, w in bfs_items:
                group_tags[("bfs", w.bucket_key())].add(tag_of(i))
        if mt_items:
            outs = guarded(
                "match", [i for i, _ in mt_items],
                lambda: execute_match_works([w for _, w in mt_items], dev),
                lambda i: execute_match_works([works[i]], dev)[0])
            for (i, _), r in zip(mt_items, outs):
                results[i] = r
            note("match", len(mt_items),
                 len({w.bucket_key() for _, w in mt_items}))
            for i, w in mt_items:
                group_tags[("match", w.bucket_key())].add(tag_of(i))

        # distributed data plane: lane-stack per bucket, ONE call a group
        groups: Dict[Tuple, List[int]] = defaultdict(list)
        for i, w in enumerate(works):
            if isinstance(w, DMatchWork):
                groups[("dmatch", dgraph_bucket(w.dg), w.rounds)].append(i)
            elif isinstance(w, DBFSWork):
                groups[("dbfs", dgraph_bucket(w.dg), w.width)].append(i)
            elif isinstance(w, DHaloWork):
                groups[("dhalo", dgraph_bucket(w.dg),
                        str(np.asarray(w.x).dtype))].append(i)
        counts: Dict[str, List[int]] = defaultdict(list)
        for key, idxs in groups.items():
            kind = key[0]
            counts[kind].append(len(idxs))

            def run_group(sub: List[int], kind=kind, key=key) -> List:
                lane_tags = (None if tags is None
                             else [tags[i] for i in sub])
                dgs = [works[i].dg for i in sub]
                if kind == "dmatch":
                    return distributed_matching_stacked(
                        dgs, [works[i].seed for i in sub], key[2],
                        tags=lane_tags, device=dev, group=group)
                if kind == "dbfs":
                    return distributed_bfs_stacked(
                        dgs, [works[i].src for i in sub], key[2],
                        tags=lane_tags, device=dev, group=group)
                return halo_exchange_stacked(
                    dgs, [works[i].x for i in sub], tags=lane_tags,
                    device=dev, group=group)

            outs = guarded(kind, idxs,
                           lambda idxs=idxs: run_group(idxs),
                           lambda i: run_group([i])[0])
            for i, r in zip(idxs, outs):
                results[i] = r
            group_tags[key].update(tag_of(i) for i in idxs)
        for kind, ns in counts.items():
            note(kind, sum(ns), len(ns))
    for launch in wave_ins.launches:
        summary["launches"][launch["kind"]] = \
            summary["launches"].get(launch["kind"], 0) + 1
    summary["t_s"] = time.perf_counter() - t_wave
    summary["stage_s"] = {k: round(v, 6)
                          for k, v in wave_ins.stage_s.items()}
    summary["requests"] = n_requests
    summary["shared_launches"] = sum(
        1 for s in group_tags.values() if len(s) >= 2)
    return results, summary


# ------------------------------------------------------------------ #
# the router: shared frontier over many task trees
# ------------------------------------------------------------------ #
@dataclasses.dataclass
class _Task:
    """Frontier bookkeeping of one live generator."""
    gen: object
    parent: Optional["_Task"]
    slot: int
    tag: object = None              # originating request (inherited)
    reported: bool = False          # root surfaced by pop_completed()
    started: bool = False
    n_pending: int = 0
    child_results: List = dataclasses.field(default_factory=list)
    done: bool = False
    result: object = None


def _advance(task: _Task, value, blocked: List[Tuple[_Task, object]]
             ) -> None:
    """Run a task until it blocks on device work, spawns, or finishes.

    Finishing delivers the return value to the parent's result slot;
    the parent resumes (recursively) once its last child finishes.
    Spawned subtasks inherit the task's request tag.
    """
    while True:
        try:
            if task.started:
                item = task.gen.send(value)
            else:
                task.started = True
                item = next(task.gen)
        except StopIteration as stop:
            task.result, task.done = stop.value, True
            parent = task.parent
            if parent is not None:
                parent.child_results[task.slot] = stop.value
                parent.n_pending -= 1
                if parent.n_pending == 0:
                    _advance(parent, list(parent.child_results), blocked)
            return
        if isinstance(item, _Spawn):
            if not item.tasks:
                value = []
                continue
            task.n_pending = len(item.tasks)
            task.child_results = [None] * len(item.tasks)
            for k, sub in enumerate(item.tasks):
                _advance(_Task(sub, task, k, tag=task.tag), None, blocked)
            return
        blocked.append((task, item))
        return


def _root_of(task: _Task) -> _Task:
    while task.parent is not None:
        task = task.parent
    return task


class WaveRouter:
    """Shared frontier driver over any number of submitted task trees.

    ``submit`` registers a task-tree generator under a request tag and
    advances it until it blocks; ``run`` then walks ALL submitted trees
    in readiness waves — every wave gathers the outstanding works of
    every live task (siblings at any depth, different *requests*) and
    executes them through ``execute_wave`` on the router's device, so
    same-bucket lanes share launches across request boundaries.  Wave
    summaries are recorded into the active ``obs.instrument`` blocks as
    ``waves``.

    Per-lane results are independent of wave composition, so the
    results are bit-identical to driving each tree alone.  ``submit``
    after a ``run`` is allowed: the router is reusable drain-to-drain.

    **Preemption surface**: ``pump(max_waves, select)`` advances the
    frontier by a *bounded* number of waves, and each wave executes only
    the outstanding works of the *selected* request tags — everything
    else stays **parked**: the suspended generators keep their host
    state and their yielded work descriptors verbatim, so a later pump
    resumes them bit-identically.  New submits between pumps simply join
    the frontier, which is what lets a small request preempt a long
    ordering *between* waves.  ``run()`` is the unbounded,
    select-everything special case.

    Per-request execution attribution: every executed wave's wall clock
    is split across the request tags that contributed works to it,
    proportional to their work counts, and accumulated into
    ``exec_s_by_tag``.

    The router is single-pumper state: a caller that pumps from several
    threads serializes its pumps (``OrderingService`` holds a lock).  A
    pump's kernels run on its thread's current CUDA stream, and every
    dispatch ends in a download that waits for them.
    """

    def __init__(self, cfg: Optional[RouterConfig] = None,
                 recovery_cfg: Optional[_faults.RecoveryConfig] = None,
                 device=None, group: Optional[PartsGroup] = None):
        self.cfg = cfg or RouterConfig()
        #: the device group of the distributed kinds (``RouterConfig.group``
        #: unless given here)
        self.group = group if group is not None else self.cfg.group
        if device is None and self.group is not None:
            device = self.group.devices[0]
        self.device = resolve_device(device)
        self._roots: List[_Task] = []
        self._blocked: List[Tuple[_Task, object]] = []
        self._level = 0
        self.exec_s_by_tag: Dict = defaultdict(float)
        self.recovery = _Recovery(recovery_cfg, self.device)
        self._stragglers = StragglerMonitor(
            factor=self.cfg.straggler_factor)
        self._waves = 0

    def submit(self, gen, tag=None) -> int:
        """Register one task tree; returns its index into ``run()``."""
        idx = len(self._roots)
        task = _Task(gen, None, 0, tag=idx if tag is None else tag)
        self._roots.append(task)
        with obs.span("router:advance"):
            _advance(task, None, self._blocked)
        return idx

    # -------------------------------------------------------------- #
    def pump(self, max_waves: Optional[int] = None,
             select=None) -> int:
        """Advance the frontier by at most ``max_waves`` waves.

        ``select`` (a container of tags, or None for all) gates which
        blocked works may execute: works of unselected tags stay parked.
        Returns the number of waves executed (0 when nothing selected is
        blocked, so a pump loop can detect quiescence).
        """
        waves = 0
        wave_retries = 0
        while self._blocked and (max_waves is None or waves < max_waves):
            if select is None:
                active, parked = self._blocked, []
            else:
                active = [e for e in self._blocked if e[0].tag in select]
                parked = [e for e in self._blocked
                          if e[0].tag not in select]
            if not active:
                break
            self._blocked = []
            tags = [t.tag for t, _ in active]
            t0 = time.perf_counter()
            try:
                inj = _faults.active()
                if inj is not None:
                    inj.check("wave", tags=tags)
                results, summary = execute_wave(
                    [w for _, w in active], level=self._level, tags=tags,
                    recovery=self.recovery, device=self.device,
                    group=self.group)
            except BaseException as err:
                # exception-safe unwind: active and parked entries go
                # back on the frontier *before* anything propagates, so
                # the suspended generators stay resumable
                self._blocked = active + parked
                if (_faults.is_transient(err) and wave_retries
                        < self.recovery.cfg.max_retries):
                    wave_retries += 1
                    self.recovery.note_retry("wave", tags, wave_retries)
                    continue
                raise
            wave_retries = 0
            if self._stragglers.observe(time.perf_counter() - t0):
                obs.REGISTRY.inc("repro_router_straggler_waves_total")
                summary["straggler"] = True
            summary["level"] = self._level
            summary["parked"] = len(parked)
            _note_wave(summary)
            # proportional wall attribution: each tag's share of this
            # wave is its fraction of the executed works
            share = summary["t_s"] / len(tags)
            for tag in tags:
                self.exec_s_by_tag[tag] += share
            dead: set = set()
            with obs.span("router:advance"):
                for (t, _), r in zip(active, results):
                    root = _root_of(t)
                    if id(root) in dead:
                        continue        # tree already excised this wave
                    err = _failure_of(r)
                    if err is None:
                        try:
                            _advance(t, r, self._blocked)
                            continue
                        except Exception as adv_err:
                            # a generator choking on its (possibly
                            # faulted) result fails only its own tree
                            err = adv_err
                    dead.add(id(root))
                    self._excise(root, err)
            self._blocked.extend(parked)
            self._waves += 1
            self._level += 1
            waves += 1
        return waves

    def _excise(self, root: _Task, error: BaseException) -> None:
        """Rung 3: terminally fail ONE task tree mid-drain.

        The root completes with a ``TaskFailure`` result and every
        blocked entry of its tree leaves the frontier — co-riding
        requests keep their lanes and their pending works untouched.
        """
        root.done = True
        root.result = TaskFailure(error)
        self._blocked = [(t, w) for (t, w) in self._blocked
                         if _root_of(t) is not root]
        with obs.span("recover:excise", tag=str(root.tag),
                      error=type(error).__name__):
            pass

    def stats(self) -> dict:
        """Wave-level robustness counters (service ``stats()`` surfaces
        these as ``router``)."""
        return {"waves": self._waves,
                "straggler_waves": self._stragglers.flagged,
                "wave_ewma_s": float(self._stragglers.ewma or 0.0),
                "isolations": self.recovery.isolations}

    def live_tags(self) -> List:
        """Tags of submitted roots that have not finished yet."""
        return [t.tag for t in self._roots if not t.done]

    def pop_completed(self) -> List[Tuple[object, object]]:
        """(tag, result) of roots completed since the last call, each
        exactly once, in submission order."""
        out = []
        for t in self._roots:
            if t.done and not t.reported:
                t.reported = True
                out.append((t.tag, t.result))
        return out

    def run(self) -> List:
        """Drive all submitted trees to completion; results in order.

        A tree excised by the recovery ladder re-raises its failure
        here; only the service, which drains through
        ``pump``/``pop_completed``, handles ``TaskFailure`` results.
        """
        self.pump()
        if not all(t.done for t in self._roots):
            raise RuntimeError("router finished with live tasks")
        for t in self._roots:
            if isinstance(t.result, TaskFailure):
                raise t.result.error
        return [t.result for t in self._roots]


def drive_frontier(root_gen, cfg: Optional[RouterConfig] = None,
                   device=None):
    """Drive ONE task tree through a private router."""
    router = WaveRouter(cfg, device=device)
    router.submit(root_gen)
    return router.run()[0]
