"""Ordering service front end: submit / pump / drain / poll / stats.

The port of the reference's ``service/api.py``: host-graph requests
(``submit``) and distributed ones (``submit_distributed``, a sharded
``core.dgraph.DGraph`` ordered by ``core.dnd``'s task tree on the same
router).  Usage:

    svc = OrderingService()           # the card; device="cpu" for the host
    rids = [svc.submit(g, seed=0, nproc=16, deadline_s=0.5)
            for g in graphs]
    svc.drain()                       # pump until every queue is empty
    perm = svc.poll(rids[0]).perm
    print(svc.stats())                # hit rate, per-class p50/p95, misses

``submit`` fingerprints the request (CSR content + seed + nproc + config)
and tags it with a **size class** (``size_class()``), an optional
**deadline** (``deadline_s``, relative seconds) and a freeform ``slo``
tier label; a cache hit resolves immediately and duplicate fingerprints
— queued *or already in flight* — are coalesced so each unique problem
is ordered once.

**The control plane is an incremental ``pump`` loop** (DESIGN.md §7),
not a monolithic drain: requests wait in per-size-class admission
queues; each ``pump`` asks ``sched_policy.SchedPolicy`` which queued
requests to admit and which in-flight orderings may advance, then runs
a *bounded* number of router waves (the preemption budget) before
re-planning.  In-flight orderings are suspendable task trees parked
between waves with their full lane state, so a small-class request
submitted mid-flight preempts a long cage-like ordering *between its
waves* instead of queuing behind it — and the parked ordering later
resumes bit-identically (lane purity; asserted by the preemption
tests).  ``drain()`` simply pumps until everything resolves.

**Cross-fingerprint warm starts** (opt-in, ``warm_starts=True``): a
second structural index maps topology-modulo-weights fingerprints to
completed ordering trees; a near-hit replays the cached tree's
separator splits (re-validated per node) instead of running full
multilevel, and the result is OPC-guarded against the cached tree's
recorded quality — degradation triggers an exact cold re-run.  Warm
starts trade the bit-exact "equal (graph, seed, nproc, cfg) imply
identical permutations" contract for latency, which is why they are
off by default and never affect the exact fingerprint cache.

Contracts: graphs are ``core.graph.Graph`` (symmetric CSR, host numpy);
results carry ``perm`` with perm[k] = vertex eliminated k-th, always a
permutation of [0, n).  With warm starts off the pipeline is
deterministic given (graph, seed, nproc, cfg) — equal fingerprints
imply identical permutations, which is what makes the exact cache
sound.  The service is single-process; pumps are serialized by an
internal lock while ``submit`` / ``poll`` / ``stats`` stay responsive
on other threads.  Every ordering's works run on the service's device
(``device``: the card unless the caller names ``"cpu"``), on the current
CUDA stream of the thread that pumps, and each dispatch ends in a
download that waits for its kernels.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch import obs
from repro_torch.core.dgraph import DGraph
from repro_torch.core.dnd import DNDConfig, distributed_order_task
from repro_torch.core.graph import Graph
from repro_torch.core.nd import NDConfig
from repro_torch.core.ordering import Ordering
from repro_torch.service import faults
from repro_torch.service.cache import FingerprintCache, WarmStartIndex
from repro_torch.service.fingerprint import (dgraph_fingerprint,
                                             dgraph_structural_fingerprint,
                                             request_fingerprint,
                                             structural_fingerprint)
from repro_torch.service.router import TaskFailure, WaveRouter
from repro_torch.service.scheduler import request_task
from repro_torch.service.sched_policy import (CLASS_ORDER, ReqMeta,
                                              SchedPolicy)
from repro_torch.sparse.symbolic import nnz_opc

#: size-class boundaries (vertex count → class label); the classes key
#: the per-class admission queues, the scheduling policy's preemption
#: order, the per-class latency percentiles of ``stats()["by_class"]``
#: and BENCH_service.json's ``exec_ms_by_class``
_SIZE_CLASSES = ((256, "xs"), (1024, "s"), (8192, "m"))


def size_class(n: int) -> str:
    """Bucket a graph size into the service's latency size classes."""
    for bound, label in _SIZE_CLASSES:
        if n < bound:
            return label
    return "l"


def _is_permutation(perm, n: int) -> bool:
    """Rung 4's service-side gate: exactly the integers [0, n) once.

    O(n) bincount check on every computed result — cheap next to the
    ordering itself, and the last line of the never-cache-corrupt
    invariant (``cache.put`` re-checks as defense in depth).
    """
    p = np.asarray(perm)
    if p.ndim != 1 or p.shape[0] != n or not np.issubdtype(
            p.dtype, np.integer):
        return False
    if n == 0:
        return True
    if p.min() < 0 or p.max() >= n:
        return False
    return bool((np.bincount(p, minlength=n) == 1).all())


@dataclasses.dataclass
class OrderResult:
    request_id: int
    perm: Optional[np.ndarray]      # None unless ``status == "ok"``
    cached: bool                    # served from the fingerprint cache
    latency_s: float                # submit → resolve (wait + execution)
    queue_wait_s: float             # submit → admission (0 on cache hits)
    exec_s: float                   # THIS request's attributed wave share
    fingerprint: str
    size_class: str = ""            # see ``size_class()``
    deadline_missed: Optional[bool] = None  # None: no deadline given
    warm: bool = False              # resolved via a warm-started tree
    #: terminal status (DESIGN.md §8): every submitted request reaches
    #: exactly one of ``ok`` (valid permutation), ``shed`` (deadline
    #: infeasible — never started), ``failed`` (recovery ladder
    #: exhausted) — there is no fourth state and no silent hang
    status: str = "ok"
    retries: int = 0                # transient retries billed to this fp
    degraded: bool = False          # kernel path degraded below default


@dataclasses.dataclass
class _PendingReq:
    request_id: int
    t_submit: float
    graph: Graph
    seed: int
    nproc: int
    cfg: NDConfig
    deadline: Optional[float] = None    # absolute perf_counter time
    slo: str = ""


@dataclasses.dataclass
class _PendingDistReq:
    request_id: int
    t_submit: float
    dg: DGraph
    seed: int
    cfg: DNDConfig
    deadline: Optional[float] = None
    slo: str = ""


@dataclasses.dataclass
class _Admission:
    """One unique fingerprint waiting in an admission queue."""
    fp: str
    kind: str                       # "host" | "dist"
    meta: ReqMeta
    reqs: List                      # coalesced _PendingReq / _PendingDistReq
    struct_fp: str                  # topology-modulo-weights key
    n: int
    fault_readmits: int = 0         # cold re-admissions after failures


@dataclasses.dataclass
class _Inflight:
    """One admitted fingerprint living on the router."""
    adm: _Admission
    t_admit: float
    assemble: Callable              # (root result) -> perm
    rec: Optional[dict]             # recorded splits (path -> part)
    warm_tree: object               # cache.WarmTree or None
    warm_used: bool
    exec_acc: float = 0.0           # exec carried across warm fallback


class OrderingService:
    """SLO-aware batched nested-dissection ordering service."""

    def __init__(self, cfg: Optional[NDConfig] = None,
                 cache_capacity: int = 1024,
                 result_capacity: int = 4096,
                 latency_window: int = 4096,
                 policy: Optional[SchedPolicy] = None,
                 warm_starts: bool = False,
                 warm_capacity: int = 256,
                 warm_opc_ratio_max: float = 1.03,
                 warm_record: Optional[bool] = None,
                 device=None, group=None):
        self.default_cfg = cfg or NDConfig()
        self.cache = FingerprintCache(cache_capacity)
        self.policy = policy or SchedPolicy()
        # warm starts are OPT-IN: replaying a structural near-hit's
        # splits changes the permutation an exact (graph, seed, nproc,
        # cfg) tuple resolves to depending on index state, so services
        # that rely on the bit-exact determinism contract keep this off
        self.warm_starts = warm_starts
        self.warm = WarmStartIndex(warm_capacity)
        self.warm_opc_ratio_max = warm_opc_ratio_max
        # recording defaults to following warm_starts: a service that
        # never warm-starts should not pay the per-request OPC and
        # split-copy bookkeeping of building an index it will not read
        self._warm_record = warm_starts if warm_record is None \
            else warm_record
        self._next_rid = 0
        # resolved results are retained FIFO-bounded: a long-running
        # service must not grow per served request (perms live on in the
        # LRU cache; old request ids just stop polling successfully)
        self._result_capacity = result_capacity
        self._results: "OrderedDict[int, OrderResult]" = OrderedDict()
        #: per-size-class admission queues: class -> fp -> _Admission
        self._queues: Dict[str, "OrderedDict[str, _Admission]"] = {
            cls: OrderedDict() for cls in CLASS_ORDER}
        self._inflight: Dict[str, _Inflight] = {}
        # the router resolves the device: the card unless told otherwise,
        # or the group's first member; the group (``dgraph.PartsGroup``)
        # holds the parts of every submit_distributed request's collectives
        self._router = WaveRouter(device=device, group=group)
        self.device = self._router.device
        self.group = self._router.group
        self._latencies: deque = deque(maxlen=latency_window)
        # queue-wait and execution components recorded separately: the
        # end-to-end latency of a pumped request is dominated by how
        # long it sat in the queue, which says nothing about how fast
        # its waves executed — reporting one conflated percentile made
        # the service look 10000× slower than its compute (the old
        # p95_latency_ms of BENCH_service.json)
        self._queue_waits: deque = deque(maxlen=latency_window)
        self._execs: deque = deque(maxlen=latency_window)
        self._execs_by_class: Dict[str, deque] = {}
        self._qwaits_by_class: Dict[str, deque] = {}
        #: per-class [met, missed] deadline counters (explicit deadlines)
        self._deadline_by_class: Dict[str, List[int]] = {}
        self._latency_window = latency_window
        self._n_submitted = 0
        self._n_computed = 0
        self._n_pumps = 0
        self._n_warm_hits = 0
        self._n_warm_fallbacks = 0
        self._drain_time_s = 0.0
        self._n_drained = 0
        #: terminal-status counters (every request ends in exactly one)
        self._n_shed = 0
        self._n_failed = 0
        self._n_retries = 0
        self._n_degraded = 0
        # chaos harness: REPRO_FAULT_PLAN installs a process-global
        # injector once (no-op when unset or already active)
        faults.maybe_install_from_env()
        # submit / poll / stats run on the caller's thread while pumps
        # may run on a worker: every mutation of the queues, result map
        # and latency deques happens under this lock.  RLock because the
        # submit cache-hit path resolves inline while already holding it.
        self._lock = threading.RLock()
        # pumps are serialized separately: the router and in-flight
        # generators are single-pumper state, but submits must never
        # block on an executing wave
        self._pump_lock = threading.Lock()

    # ------------------------------------------------------------------ #
    def submit(self, g: Graph, seed: int = 0, nproc: int = 1,
               cfg: Optional[NDConfig] = None,
               deadline_s: Optional[float] = None,
               slo: str = "") -> int:
        """Enqueue an ordering request; returns a request id.

        ``deadline_s`` (relative seconds from now) and ``slo`` (freeform
        tier label) feed the pump policy: requests are admitted in
        (size-class, deadline) priority order and can preempt in-flight
        larger-class orderings between waves.  Cache hits resolve
        immediately (poll right away); misses resolve across subsequent
        ``pump`` calls (``drain`` pumps to completion).
        """
        cfg = cfg or self.default_cfg
        t0 = time.perf_counter()
        fp = request_fingerprint(g, seed, nproc, cfg)   # pure: no lock
        deadline = None if deadline_s is None else t0 + deadline_s
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            self._n_submitted += 1
            perm = self.cache.get(fp)
            if perm is not None:
                obs.REGISTRY.inc("repro_service_requests_total",
                                 result="hit")
                self._resolve(rid, perm, True, t0, fp, queue_wait=0.0,
                              n=g.n, deadline=deadline)
                return rid
            obs.REGISTRY.inc("repro_service_requests_total", result="miss")
            req = _PendingReq(rid, t0, g, seed, nproc, cfg, deadline, slo)
            self._enqueue(fp, "host", req, g.n, slo,
                          lambda: structural_fingerprint(g))
            return rid

    def submit_distributed(self, dg: DGraph, seed: int = 0,
                           cfg: Optional[DNDConfig] = None,
                           deadline_s: Optional[float] = None,
                           slo: str = "") -> int:
        """Enqueue a distributed (sharded ``DGraph``) ordering request.

        Same cache/coalescing/SLO semantics as ``submit``; the task
        tree (top sharded dissection plus its centralized endgame) is
        one suspendable unit on the shared router, so distributed
        orderings park and resume between waves exactly like host ones.
        Its collectives run on the service's ``group`` where it has one
        (the same permutation, so the cache serves both).
        """
        cfg = cfg or DNDConfig()
        t0 = time.perf_counter()
        fp = dgraph_fingerprint(dg, seed, cfg)          # pure: no lock
        deadline = None if deadline_s is None else t0 + deadline_s
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            self._n_submitted += 1
            perm = self.cache.get(fp)
            if perm is not None:
                obs.REGISTRY.inc("repro_service_requests_total",
                                 result="hit")
                self._resolve(rid, perm, True, t0, fp, queue_wait=0.0,
                              n=dg.n_global, deadline=deadline)
                return rid
            obs.REGISTRY.inc("repro_service_requests_total", result="miss")
            req = _PendingDistReq(rid, t0, dg, seed, cfg, deadline, slo)
            self._enqueue(fp, "dist", req, dg.n_global, slo,
                          lambda: dgraph_structural_fingerprint(dg))
            return rid

    def _enqueue(self, fp: str, kind: str, req, n: int, slo: str,
                 struct_fp_fn) -> None:
        """Coalesce a missed request into its admission queue (or onto
        the already in-flight computation of the same fingerprint)."""
        live = self._inflight.get(fp)
        if live is not None:
            live.adm.reqs.append(req)
            return
        cls = size_class(n)
        adm = self._queues[cls].get(fp)
        if adm is not None:
            adm.reqs.append(req)
            # the earliest deadline among coalesced requests drives EDF
            if (req.deadline is not None
                    and (adm.meta.deadline is None
                         or req.deadline < adm.meta.deadline)):
                adm.meta = dataclasses.replace(adm.meta,
                                               deadline=req.deadline)
            return
        meta = ReqMeta(tag=fp, size_class=cls, t_enqueue=req.t_submit,
                       deadline=req.deadline, slo=slo)
        self._queues[cls][fp] = _Admission(
            fp, kind, meta, [req], struct_fp_fn(), n)

    def poll(self, rid: int) -> Optional[OrderResult]:
        """Result for a request id, or None while still queued."""
        with self._lock:
            return self._results.get(rid)

    def queue_depth(self) -> int:
        with self._lock:
            return (sum(len(a.reqs) for q in self._queues.values()
                        for a in q.values())
                    + sum(len(f.adm.reqs)
                          for f in self._inflight.values()))

    # ------------------------------------------------------------------ #
    def pump(self, max_waves: Optional[int] = None) -> Dict[int, OrderResult]:
        """One scheduling iteration of the serving control plane.

        Admits queued requests per the policy, advances the *selected*
        in-flight orderings by at most the pump's wave budget (parking
        the rest with their lane state intact), and resolves whatever
        completed.  Returns {request_id: OrderResult} for the requests
        resolved by this call.  Wave execution runs *outside* the
        service lock, so submits on other threads stay responsive
        mid-pump (they queue for the next pump).
        """
        resolved: Dict[int, OrderResult] = {}
        with self._pump_lock:
            t0 = time.perf_counter()
            with self._lock:
                queued = [adm.meta for cls in CLASS_ORDER
                          for adm in self._queues[cls].values()]
                inflight = [f.adm.meta for f in self._inflight.values()]
                # measured per-class exec medians feed the policy's
                # deadline-feasibility check (ladder rung 5)
                est = {cls: float(np.percentile(np.asarray(dq), 50))
                       for cls, dq in self._execs_by_class.items()
                       if len(dq)}
                plan = self.policy.plan(queued, inflight, t0,
                                        exec_est=est)
                adms = []
                for tag in plan.admit:
                    for cls in CLASS_ORDER:
                        adm = self._queues[cls].pop(tag, None)
                        if adm is not None:
                            adms.append(adm)
                            break
                shed_adms = []
                for tag in plan.shed:
                    for cls in CLASS_ORDER:
                        adm = self._queues[cls].pop(tag, None)
                        if adm is not None:
                            shed_adms.append(adm)
                            break
                for adm in shed_adms:
                    with obs.span("recover:shed", tag=adm.fp[:16],
                                  size_class=adm.meta.size_class):
                        pass
                    for req in adm.reqs:
                        resolved[req.request_id] = self._resolve(
                            req.request_id, None, False, req.t_submit,
                            adm.fp,
                            queue_wait=max(0.0, t0 - req.t_submit),
                            exec_s=0.0, n=adm.n, deadline=req.deadline,
                            status="shed")
                self._n_pumps += 1
            obs.REGISTRY.inc("repro_service_pumps_total")
            if plan.parked:
                obs.REGISTRY.inc("repro_service_parked_total",
                                 len(plan.parked))
            for adm in adms:
                self._admit(adm, t0)
            waves = 0
            if self._inflight:
                budget = (max_waves if max_waves is not None
                          else plan.max_waves)
                with obs.span("sched:pump", admitted=len(adms),
                              inflight=len(self._inflight),
                              parked=len(plan.parked), budget=budget):
                    waves = self._router.pump(budget, select=plan.active)
            for tag, result in self._router.pop_completed():
                resolved.update(self._finish(tag, result))
            with self._lock:
                self._drain_time_s += time.perf_counter() - t0
                self._n_drained += len(resolved)
        return resolved

    def drain(self) -> Dict[int, OrderResult]:
        """Pump until every queued and in-flight request resolves.

        Returns {request_id: OrderResult} for the requests resolved by
        this call — the batch-serving surface on top of the incremental
        pump loop (duplicate fingerprints computed once and fanned out,
        same-bucket lanes of concurrent requests sharing launches).
        """
        resolved: Dict[int, OrderResult] = {}
        with self._lock:
            busy = self.queue_depth() > 0 or bool(self._inflight)
        if not busy:
            return resolved
        with obs.span("drain"):
            while True:
                resolved.update(self.pump())
                with self._lock:
                    if not (self.queue_depth() > 0 or self._inflight):
                        break
        return resolved

    # ------------------------------------------------------------------ #
    def _admit(self, adm: _Admission, now: float,
               cold: bool = False) -> None:
        """Move one admission onto the router (warm-started if indexed).

        ``cold`` forces the exact path regardless of the warm index —
        the OPC-guard fallback re-admits through it.
        """
        hints = None
        warm_tree = None
        if self.warm_starts and not cold:
            warm_tree = self.warm.get(adm.struct_fp)
            if warm_tree is not None:
                hints = warm_tree.parts
                self._n_warm_hits += 1
                obs.REGISTRY.inc("repro_service_warm_total", result="hit")
            else:
                obs.REGISTRY.inc("repro_service_warm_total", result="miss")
        rec = {} if self._warm_record else None
        head = adm.reqs[0]
        if adm.kind == "host":
            ordering = Ordering(head.graph.n)
            gen = request_task(head.graph, head.seed, head.nproc,
                               head.cfg, ordering, hints=hints, rec=rec)
            assemble = lambda result, o=ordering: o.assemble()  # noqa: E731
        else:
            gen = distributed_order_task(head.dg, head.seed, head.cfg,
                                         hints=hints, rec=rec)
            assemble = lambda result: result.assemble()         # noqa: E731
        self._router.submit(gen, tag=adm.fp)
        with self._lock:
            self._inflight[adm.fp] = _Inflight(
                adm, now, assemble, rec, warm_tree,
                warm_used=hints is not None)

    def _finish(self, fp: str, result) -> Dict[int, OrderResult]:
        """Resolve one completed fingerprint — or recover.

        Before anything resolves ``ok`` the result passes rung 4's
        validation gates: an excised tree (``TaskFailure``) or a failing
        assembly goes to ``_fail_or_readmit``; the assembled permutation
        is checked for validity (after the ``result``-site injection
        point), and warm starts keep their OPC guard.  A corrupt result
        is **never** written to the fingerprint cache and **never**
        resolves ``ok`` — it re-runs cold or fans out ``failed``.
        """
        resolved: Dict[int, OrderResult] = {}
        with self._lock:
            inflight = self._inflight.pop(fp)
            adm = inflight.adm
            exec_s = (inflight.exec_acc
                      + self._router.exec_s_by_tag.pop(fp, 0.0))
            if isinstance(result, TaskFailure):
                return self._fail_or_readmit(fp, inflight, exec_s,
                                             result.error)
            t_chk = time.perf_counter()
            try:
                perm = inflight.assemble(result)
            except Exception as err:
                return self._fail_or_readmit(fp, inflight, exec_s, err)
            inj = faults.active()
            if inj is not None:
                perm = inj.corrupt_result(fp, perm)
            if not _is_permutation(perm, adm.n):
                return self._fail_or_readmit(
                    fp, inflight, exec_s, faults.CorruptResult(
                        f"assembled result for {fp[:16]} is not a "
                        f"permutation of [0, {adm.n})"))
            if inflight.warm_used and adm.kind == "host":
                # OPC guard: a warm-started tree must match the recorded
                # quality of its source (OPC is structure+perm only, so
                # the comparison is exact across weight changes);
                # degradation triggers the exact-parity fallback —
                # re-run cold.
                opc = float(nnz_opc(adm.reqs[0].graph, perm)[1])
                exec_s += time.perf_counter() - t_chk
                src = inflight.warm_tree
                if (src.opc >= 0
                        and opc > self.warm_opc_ratio_max * src.opc):
                    self._n_warm_fallbacks += 1
                    obs.REGISTRY.inc("repro_service_warm_total",
                                     result="fallback")
                    self._admit(adm, inflight.t_admit, cold=True)
                    self._inflight[fp].exec_acc = exec_s
                    return {}
            self.cache.put(fp, perm)
            if (self._warm_record and inflight.rec is not None
                    and not inflight.warm_used):
                # record the cold tree's splits for future structural
                # near-hits; OPC (the guard's yardstick) for host graphs
                # only: the distributed guard would need a centralizing
                # gather, so dist entries rely on per-node validation
                opc = (float(nnz_opc(adm.reqs[0].graph, perm)[1])
                       if adm.kind == "host" else -1.0)
                self.warm.put(adm.struct_fp, inflight.rec, opc, adm.n, fp)
            retries, degraded = self._router.recovery.pop_tag(fp)
            for k, req in enumerate(adm.reqs):
                res = self._resolve(
                    req.request_id, perm, k > 0, req.t_submit, fp,
                    queue_wait=max(0.0, inflight.t_admit - req.t_submit),
                    exec_s=exec_s, n=adm.n, deadline=req.deadline,
                    warm=inflight.warm_used, retries=retries,
                    degraded=degraded)
                resolved[req.request_id] = res
            self._n_computed += 1
        return resolved

    def _fail_or_readmit(self, fp: str, inflight: _Inflight,
                         exec_s: float, error: BaseException
                         ) -> Dict[int, OrderResult]:
        """Ladder rung 3's service half: one failed/invalid computation
        re-admits **cold** through the normal queue path (the warm
        fallback's shape) up to ``max_readmits`` times; past the budget
        every coalesced rider — queued or in flight — resolves
        ``status=failed`` so none can hang in ``poll()``.
        """
        adm = inflight.adm
        if adm.fault_readmits < self._router.recovery.cfg.max_readmits:
            adm.fault_readmits += 1
            obs.REGISTRY.inc("repro_service_readmits_total")
            with obs.span("recover:readmit", tag=fp[:16],
                          error=type(error).__name__,
                          attempt=adm.fault_readmits):
                pass
            self._admit(adm, inflight.t_admit, cold=True)
            self._inflight[fp].exec_acc = exec_s
            return {}
        retries, degraded = self._router.recovery.pop_tag(fp)
        resolved: Dict[int, OrderResult] = {}
        for req in adm.reqs:
            resolved[req.request_id] = self._resolve(
                req.request_id, None, False, req.t_submit, fp,
                queue_wait=max(0.0, inflight.t_admit - req.t_submit),
                exec_s=exec_s, n=adm.n, deadline=req.deadline,
                status="failed", retries=retries, degraded=degraded)
        return resolved

    # ------------------------------------------------------------------ #
    def stats(self) -> Dict[str, float]:
        """Service counters: dedup/cache/warm effectiveness, latency,
        deadline compliance, throughput.

        End-to-end latency is reported alongside its two components so
        queue pressure and execution speed are visible separately:
        ``queue_wait_ms`` percentiles measure how long requests sat in
        the admission queues (a function of pump cadence and policy),
        and ``exec_ms`` percentiles measure each request's *own
        attributed* share of the waves it rode — both pooled and per
        size class (``by_class``), where each class also carries its
        explicit-deadline met/missed counts.
        """
        def pcts(values, suffix):
            arr = np.asarray(list(values)) if values else np.zeros(1)
            return {
                f"p50_{suffix}_ms":
                    round(float(np.percentile(arr, 50)) * 1e3, 3),
                f"p95_{suffix}_ms":
                    round(float(np.percentile(arr, 95)) * 1e3, 3),
            }
        with self._lock:
            by_class = {}
            for cls in sorted(set(self._execs_by_class)
                              | set(self._qwaits_by_class)):
                execs = self._execs_by_class.get(cls, ())
                met, missed = self._deadline_by_class.get(cls, (0, 0))
                by_class[cls] = {
                    "count": len(execs),
                    **pcts(execs, "exec"),
                    **pcts(self._qwaits_by_class.get(cls, ()),
                           "queue_wait"),
                    "deadline_total": met + missed,
                    "deadline_misses": missed,
                    "deadline_miss_rate": round(
                        missed / (met + missed), 4) if met + missed
                        else 0.0,
                }
            return {
                "requests": self._n_submitted,
                "computed": self._n_computed,
                "cache_hits": self.cache.hits,
                "cache_hit_rate": round(self.cache.hit_rate, 4),
                "cache_size": len(self.cache),
                "queue_depth": self.queue_depth(),
                "inflight": len(self._inflight),
                "pumps": self._n_pumps,
                "warm_hits": self._n_warm_hits,
                "warm_fallbacks": self._n_warm_fallbacks,
                "warm_size": len(self.warm),
                "shed": self._n_shed,
                "failed": self._n_failed,
                "fault_retries": self._n_retries,
                "degraded": self._n_degraded,
                "router": self._router.stats(),
                **pcts(self._latencies, "latency"),
                **pcts(self._queue_waits, "queue_wait"),
                **pcts(self._execs, "exec"),
                "by_class": by_class,
                "deadline_miss_rate": round(
                    sum(m for _, m in self._deadline_by_class.values())
                    / max(sum(t + m for t, m in
                              self._deadline_by_class.values()), 1), 4),
                "orderings_per_sec": round(
                    self._n_drained / self._drain_time_s, 3)
                    if self._drain_time_s else 0.0,
            }

    # ------------------------------------------------------------------ #
    def _resolve(self, rid: int, perm: Optional[np.ndarray],
                 cached: bool,
                 t_submit: float, fp: str, queue_wait: float = 0.0,
                 exec_s: Optional[float] = None,
                 n: Optional[int] = None,
                 deadline: Optional[float] = None,
                 warm: bool = False, status: str = "ok",
                 retries: int = 0,
                 degraded: bool = False) -> OrderResult:
        t_now = time.perf_counter()
        lat = t_now - t_submit
        if exec_s is None:              # cache hit: the lookup IS the work
            exec_s = lat
        cls = size_class(n) if n is not None else ""
        # shed/failed requests never count against SLO compliance (they
        # have their own terminal accounting) nor into the latency/exec
        # percentiles that feed the feasibility estimator
        missed = (None if deadline is None or status != "ok"
                  else bool(t_now > deadline))
        res = OrderResult(rid, perm, cached, lat, float(queue_wait),
                          float(exec_s), fp, cls, missed, warm,
                          status, int(retries), bool(degraded))
        self._results[rid] = res
        while len(self._results) > self._result_capacity:
            self._results.popitem(last=False)
        self._n_retries += int(retries)
        self._n_degraded += bool(degraded)
        if status != "ok":
            if status == "shed":
                self._n_shed += 1
                obs.REGISTRY.inc("repro_service_shed_total",
                                 size_class=cls)
            else:
                self._n_failed += 1
                obs.REGISTRY.inc("repro_service_failed_total",
                                 size_class=cls)
            tracer = obs.current()
            if tracer is not None:
                tracer.add_span("request", t_submit, t_now,
                                attrs={"rid": rid, "status": status,
                                       "fingerprint": fp[:16],
                                       "size_class": cls})
            return res
        self._latencies.append(lat)
        self._queue_waits.append(float(queue_wait))
        self._execs.append(float(exec_s))
        if cls:
            self._execs_by_class.setdefault(
                cls, deque(maxlen=self._latency_window)).append(
                    float(exec_s))
            self._qwaits_by_class.setdefault(
                cls, deque(maxlen=self._latency_window)).append(
                    float(queue_wait))
            obs.REGISTRY.observe("repro_service_exec_seconds",
                                 float(exec_s), size_class=cls)
            obs.REGISTRY.observe("repro_service_queue_wait_seconds",
                                 float(queue_wait), size_class=cls)
            if missed is not None:
                counters = self._deadline_by_class.setdefault(cls, [0, 0])
                counters[1 if missed else 0] += 1
                obs.REGISTRY.inc(
                    "repro_service_deadline_total", size_class=cls,
                    result="missed" if missed else "met")
        tracer = obs.current()
        if tracer is not None:
            # retrospective request span tree: the latency breakdown is
            # only known at resolve time (queue_wait then exec)
            root = tracer.add_span(
                "request", t_submit, t_now,
                attrs={"rid": rid, "fingerprint": fp[:16],
                       "size_class": cls, "cached": cached})
            if queue_wait > 0.0:
                tracer.add_span("queue_wait", t_submit,
                                t_submit + queue_wait,
                                parent_id=root.span_id)
            tracer.add_span("exec", t_now - float(exec_s), t_now,
                            parent_id=root.span_id)
        return res
