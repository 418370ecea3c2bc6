"""SLO-aware pump policy: which suspended orderings advance this wave.

A copy of the reference's ``service/sched_policy.py``: host bookkeeping, no
device work.

The service's ``pump`` loop (DESIGN.md §7) separates *mechanism* from
*policy*: the ``WaveRouter`` can park and resume any ordering between
waves bit-identically (lane purity), and this module decides **which**
orderings advance each pump.  The decision is a ``PumpPlan``:

  * ``admit`` — queued requests to move from the admission queues onto
    the router's frontier this pump, in priority order;
  * ``active`` — tags of in-flight orderings allowed to execute waves
    (the complement is **parked**: their generators stay suspended);
  * ``max_waves`` — this pump's preemption budget, i.e. how many waves
    run before control returns to the policy so newly submitted small
    requests get a scheduling opportunity;
  * ``shed`` — queued requests whose explicit deadlines are infeasible
    even starting now (judged from measured per-class exec estimates);
    the service resolves them terminally as ``status=shed`` instead of
    letting a doomed queue collapse everyone's deadlines (recovery
    ladder rung 5, DESIGN.md §8).

The default ``SchedPolicy`` is strict size-class priority with EDF
within a class, plus two anti-starvation escapes:

  * **deadline rescue** — a parked ordering whose effective deadline is
    within ``rescue_margin_s`` is activated regardless of class (it
    would otherwise miss *because* of the policy);
  * **park aging** — nothing stays parked longer than ``max_park_s``.

Classes in ``preemptible`` (default: the big ``m``/``l`` classes) are
parked whenever a strictly smaller class has live work; ``xs``/``s``
are never parked — that is the whole point: one cage-like graph must
not stall every co-drained small request (the p95 exec pathology of
BENCH_service.json).  Requests without an explicit deadline get their
class's default SLO (``default_slo_s``) as the effective deadline, so
EDF is total.

The policy never returns an empty ``active`` set while work is live —
when only preemptible orderings remain they run (the smallest present
class is always active), so a pump loop is deadlock-free by
construction.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

#: size classes in strictly ascending priority-relevant order (the
#: admission-queue order and the preemption order; see api.size_class)
CLASS_ORDER: Tuple[str, ...] = ("xs", "s", "m", "l")

#: per-class default SLO in seconds for requests submitted without an
#: explicit deadline: effective_deadline = t_enqueue + default_slo_s
DEFAULT_SLO_S: Dict[str, float] = {
    "xs": 0.25, "s": 1.0, "m": 10.0, "l": 120.0}


def class_rank(cls: str) -> int:
    """Priority rank of a size class (lower = smaller = more urgent)."""
    try:
        return CLASS_ORDER.index(cls)
    except ValueError:
        return len(CLASS_ORDER)         # unknown classes sort last


@dataclasses.dataclass(frozen=True)
class ReqMeta:
    """Scheduling-relevant view of one queued or in-flight request."""
    tag: str                        # router tag (the request fingerprint)
    size_class: str
    t_enqueue: float                # perf_counter at submit
    deadline: Optional[float] = None    # absolute perf_counter, None=SLO
    slo: str = ""                   # freeform tier label ("interactive")

    def effective_deadline(self) -> float:
        if self.deadline is not None:
            return self.deadline
        return self.t_enqueue + DEFAULT_SLO_S.get(self.size_class, 60.0)


@dataclasses.dataclass
class PumpPlan:
    """One pump's scheduling decision (see module docstring)."""
    admit: List[str]                # queued tags to admit, in order
    active: Set[str]                # in-flight + admitted tags that run
    parked: Set[str]                # complement: suspended this pump
    max_waves: int                  # the pump's preemption budget
    #: queued tags shed by feasibility admission control (rung 5,
    #: DESIGN.md §8): the service resolves their riders ``status=shed``
    shed: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PolicyConfig:
    """Knob surface of the default policy (env-var defaults, the
    ``RouterConfig`` idiom)."""
    #: waves per pump before re-planning (the preemption budget)
    wave_budget: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get("REPRO_PUMP_WAVES",
                                                   "2")))
    #: classes that may be parked while smaller classes have live work
    preemptible: Tuple[str, ...] = ("m", "l")
    #: parked orderings this close to their deadline run anyway
    rescue_margin_s: float = 0.25
    #: hard bound on continuous parking (starvation escape)
    max_park_s: float = 30.0
    #: deadline-feasibility shedding (REPRO_SHED=0 disables): a queued
    #: request with an *explicit* deadline is shed when even an
    #: immediate start could not finish in time, judged from the
    #: service's measured per-class exec percentiles
    shed_infeasible: bool = dataclasses.field(
        default_factory=lambda: os.environ.get("REPRO_SHED", "1") != "0")
    #: slack multiplier on the exec estimate: shed iff
    #: deadline - now < shed_factor * est_exec_s
    shed_factor: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get("REPRO_SHED_FACTOR",
                                                     "1.0")))


class SchedPolicy:
    """Strict size-class priority + EDF + anti-starvation escapes."""

    def __init__(self, cfg: Optional[PolicyConfig] = None):
        self.cfg = cfg or PolicyConfig()
        self._parked_since: Dict[str, float] = {}

    # -------------------------------------------------------------- #
    def plan(self, queued: Sequence[ReqMeta], inflight: Sequence[ReqMeta],
             now: float,
             exec_est: Optional[Dict[str, float]] = None) -> PumpPlan:
        """Decide admissions, sheds, and the active set for one pump.

        ``queued`` are admission-queue heads (not yet on the router);
        ``inflight`` are suspended-or-running orderings.  Everything
        queued and feasible is admitted (admission itself is cheap —
        parking is what throttles execution), ordered (class rank,
        effective deadline, enqueue time); the active set is computed
        over the union.

        ``exec_est`` maps size class → an exec-seconds estimate (the
        service passes its measured per-class p50).  A queued request
        with an **explicit** deadline that even an immediate start
        could not meet (``deadline - now < shed_factor × est``) is shed
        instead of admitted — its riders get a clean terminal
        ``status=shed`` rather than dragging the queue into collapse.
        SLO-defaulted deadlines never shed (the SLO is a target, not a
        contract), and classes with no measurement yet are assumed
        feasible.
        """
        cfg = self.cfg
        shed: List[str] = []
        if cfg.shed_infeasible and exec_est:
            feasible = []
            for m in queued:
                est = exec_est.get(m.size_class)
                if (m.deadline is not None and est is not None
                        and m.deadline - now < cfg.shed_factor * est):
                    shed.append(m.tag)
                else:
                    feasible.append(m)
            queued = feasible
        admit = sorted(
            queued, key=lambda m: (class_rank(m.size_class),
                                   m.effective_deadline(), m.t_enqueue))
        live = list(inflight) + admit
        active: Set[str] = set()
        parked: Set[str] = set()
        if live:
            min_rank = min(class_rank(m.size_class) for m in live)
            for m in live:
                if self._runs(m, min_rank, now):
                    active.add(m.tag)
                else:
                    parked.add(m.tag)
        # park-age bookkeeping: a tag's clock starts when first parked
        # and resets whenever it runs (or finishes and drops out)
        for tag in list(self._parked_since):
            if tag not in parked:
                del self._parked_since[tag]
        for tag in parked:
            self._parked_since.setdefault(tag, now)
        assert not live or active, "policy parked every live ordering"
        return PumpPlan(admit=[m.tag for m in admit], active=active,
                        parked=parked, max_waves=max(cfg.wave_budget, 1),
                        shed=shed)

    # -------------------------------------------------------------- #
    def _runs(self, m: ReqMeta, min_rank: int, now: float) -> bool:
        cfg = self.cfg
        if m.size_class not in cfg.preemptible:
            return True
        if class_rank(m.size_class) <= min_rank:
            return True                 # nothing smaller is live
        if m.effective_deadline() - now <= cfg.rescue_margin_s:
            return True                 # deadline rescue
        since = self._parked_since.get(m.tag)
        if since is not None and now - since >= cfg.max_park_s:
            return True                 # park aging
        return False
