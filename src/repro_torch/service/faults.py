"""Deterministic fault injection + recovery configuration (DESIGN.md §8).

The port of the reference's ``service/faults.py``, on the port's
``obs`` event bus and fault hook.

PT-Scotch's fold-dup already embraces redundancy — duplicate separator
instances race and the best wins — but the serving stack had no failure
story: one raised dispatch or one NaN-corrupted kernel output took down
a whole ``pump()`` and every co-riding request in the shared lane
stacks.  This module is the *chaos half* of the failure model: a seeded
``FaultPlan`` describes typed faults to inject at the existing dispatch
boundaries, and a ``FaultInjector`` fires them deterministically.  The
*recovery half* — retry, degrade, excise, validate, shed — lives in
``service/router.py`` and ``service/api.py`` and is configured by
``RecoveryConfig`` here.

Injection sites (one per existing dispatch boundary):

  * the ``obs.timed_dispatch`` kinds — ``fm`` / ``bfs`` / ``match``
    (the centralized bucketed executors, incl. ``kernels/ops
    .fm_refine_batch`` behind the ``fm`` dispatch), hooked through
    ``obs.set_fault_hook`` so the core layers stay service-free.  The
    reference's ``dhalo`` / ``dbfs`` / ``dmatch`` sites stay valid in a
    plan, so one plan serves both packages; they fire once the
    distributed slice gives the port those dispatches;
  * ``wave`` — checked by ``WaveRouter.pump`` before each wave executes;
  * ``result`` — checked by the service before a completed ordering is
    validated/cached (corrupts the assembled permutation).

Typed faults:

  * ``transient``  — raises ``TransientFault`` (retryable);
  * ``persistent`` — raises ``PersistentFault`` (never retried: the
    ladder degrades, isolates, or excises);
  * ``nan``        — corrupts the dispatch output in place of raising
    (``fm`` only: NaN separator weights + out-of-range parts), so the
    *validation* rungs are exercised, not the exception path;
  * ``corrupt_perm`` — corrupts the assembled permutation (``result``
    site only) so the never-cache-corrupt invariant is exercised;
  * ``delay``      — sleeps ``delay_s`` (a straggler; observable via the
    router's ``StragglerMonitor`` wave EWMA).

Decisions are pure functions of ``(plan.seed, site, invocation index)``
— equal plans against equal workloads inject identically, which is what
lets the chaos bench assert that every ``ok`` result is bit-identical
to the fault-free run.  ``REPRO_FAULT_PLAN`` (a JSON plan, or ``@path``
to one) configures a process-global injector at service construction.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs


# ------------------------------------------------------------------ #
# fault taxonomy
# ------------------------------------------------------------------ #
class FaultError(RuntimeError):
    """Base of all injected faults (never raised by real code paths)."""


class TransientFault(FaultError):
    """A fault worth retrying (the injected stand-in for a flaky
    dispatch: preempted device, dropped collective, OOM race)."""


class PersistentFault(FaultError):
    """A fault retries cannot fix — the ladder must degrade the kernel
    path, isolate lanes, or excise the ordering."""


class CorruptResult(RuntimeError):
    """Raised by the *validators* (not injected) when a dispatch output
    or an assembled permutation fails its invariant check."""


def is_transient(exc: BaseException) -> bool:
    """Ladder rung 1 classification: only explicitly-transient faults
    are retried; everything else escalates (degrade/isolate/excise)."""
    return isinstance(exc, TransientFault)


#: dispatch-boundary sites reachable through the obs hook
DISPATCH_SITES = ("fm", "bfs", "match", "dhalo", "dbfs", "dmatch")
#: all valid sites, with the kinds each may inject
_SITE_KINDS: Dict[str, Tuple[str, ...]] = {
    **{s: ("transient", "persistent", "delay") for s in DISPATCH_SITES},
    "fm": ("transient", "persistent", "delay", "nan"),
    "wave": ("transient", "persistent", "delay"),
    "result": ("corrupt_perm", "delay"),
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injection rule of a plan.

    Fires at explicit site-invocation indices (``at``) or with a seeded
    per-invocation probability (``rate``); ``count`` caps total fires
    (None = unbounded).  ``tag`` restricts the rule to dispatches that
    carry the given request tag — the handle for poisoning ONE ordering
    in a shared wave (the lane-excision scenario) without touching its
    co-riders.  Tag-filtered rules only apply at sites where tags are
    known (``wave`` / ``result``, and any dispatch the router attributes).
    """
    site: str
    kind: str               # transient|persistent|nan|corrupt_perm|delay
    at: Tuple[int, ...] = ()
    rate: float = 0.0
    count: Optional[int] = None
    delay_s: float = 0.05
    tag: Optional[str] = None

    def __post_init__(self):
        kinds = _SITE_KINDS.get(self.site)
        if kinds is None:
            raise ValueError(f"unknown fault site {self.site!r} (valid: "
                             f"{sorted(_SITE_KINDS)})")
        if self.kind not in kinds:
            raise ValueError(
                f"fault kind {self.kind!r} not valid at site "
                f"{self.site!r} (valid: {kinds})")
        if not self.at and self.rate <= 0.0:
            raise ValueError("FaultSpec needs explicit `at` indices or "
                             "a positive `rate`")


class FaultPlan:
    """A seeded, serializable schedule of ``FaultSpec`` rules."""

    def __init__(self, seed: int = 0,
                 specs: Sequence[FaultSpec] = ()):
        self.seed = int(seed)
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)

    # ---------------------------------------------------------------- #
    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "specs": [dataclasses.asdict(s) for s in self.specs]})

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        doc = json.loads(text)
        specs = []
        for d in doc.get("specs", []):
            d = dict(d)
            d["at"] = tuple(d.get("at") or ())
            specs.append(FaultSpec(**d))
        return cls(seed=doc.get("seed", 0), specs=specs)

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        """Plan from ``REPRO_FAULT_PLAN`` (JSON, or ``@path`` to a JSON
        file); None when unset/empty."""
        raw = os.environ.get("REPRO_FAULT_PLAN", "").strip()
        if not raw:
            return None
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                raw = f.read()
        return cls.from_json(raw)


# ------------------------------------------------------------------ #
# recovery-ladder configuration (the mechanism lives in router/api)
# ------------------------------------------------------------------ #
@dataclasses.dataclass
class RecoveryConfig:
    """Knob surface of the recovery ladder (env-var defaults, the
    ``RouterConfig`` idiom)."""
    #: rung 1 — per-dispatch retries for transient faults
    max_retries: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "REPRO_FAULT_RETRIES", "2")))
    #: capped exponential backoff between retries (train/fault.py's
    #: ``RestartPolicy`` shape: base * 2^(attempt-1), capped)
    backoff_s: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "REPRO_FAULT_BACKOFF_S", "0.01")))
    backoff_cap_s: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "REPRO_FAULT_BACKOFF_CAP_S", "0.25")))
    #: rung 3 — cold re-admissions of an excised/invalid ordering before
    #: its riders resolve ``status=failed``
    max_readmits: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "REPRO_FAULT_READMITS", "1")))

    def backoff(self, attempt: int) -> float:
        return min(self.backoff_s * (2 ** max(attempt - 1, 0)),
                   self.backoff_cap_s)


# ------------------------------------------------------------------ #
# the injector
# ------------------------------------------------------------------ #
def _draw(seed: int, site: str, idx: int, rule: int) -> float:
    """Deterministic uniform in [0, 1): a pure function of the plan
    seed and the site invocation, independent of process state."""
    h = hashlib.blake2b(f"{seed}|{site}|{idx}|{rule}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


class FaultInjector:
    """Active injection state: plan + thread-safe per-site counters.

    ``check(site, tags)`` is called at every boundary; it may sleep
    (``delay``), raise (``transient``/``persistent``), or return a
    corruption directive the *caller* applies (``nan`` /
    ``corrupt_perm``) — corruption must flow through the normal return
    path so the validation rungs, not the exception rungs, catch it.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._left: Dict[int, Optional[int]] = {
            r: s.count for r, s in enumerate(plan.specs)}
        self.injected = 0
        self.injected_by: Dict[Tuple[str, str], int] = {}

    # ---------------------------------------------------------------- #
    def check(self, site: str, tags: Optional[Sequence] = None
              ) -> Optional[str]:
        with self._lock:
            idx = self._counts.get(site, 0)
            self._counts[site] = idx + 1
            fired = None
            for r, spec in enumerate(self.plan.specs):
                if spec.site != site:
                    continue
                if spec.tag is not None and (
                        tags is None or spec.tag not in tags):
                    continue
                if self._left[r] == 0:
                    continue
                hit = (idx in spec.at if spec.at
                       else _draw(self.plan.seed, site, idx, r) < spec.rate)
                if hit:
                    fired = spec
                    if self._left[r] is not None:
                        self._left[r] -= 1
                    break
            if fired is None:
                return None
            self.injected += 1
            key = (site, fired.kind)
            self.injected_by[key] = self.injected_by.get(key, 0) + 1
        obs.REGISTRY.inc("repro_service_faults_injected_total",
                         site=site, kind=fired.kind)
        with obs.span(f"fault:{fired.kind}", site=site, idx=idx):
            if fired.kind == "delay":
                time.sleep(fired.delay_s)
                return None
        if fired.kind == "transient":
            raise TransientFault(f"injected transient at {site}[{idx}]")
        if fired.kind == "persistent":
            raise PersistentFault(f"injected persistent at {site}[{idx}]")
        return fired.kind               # "nan" | "corrupt_perm"

    # ---------------------------------------------------------------- #
    def dispatch_hook(self, kind: str, thunk):
        """The ``obs.timed_dispatch`` wrapper: inject, run, corrupt."""
        directive = self.check(kind)
        out = thunk()
        if directive == "nan":
            out = _corrupt_dispatch(kind, out)
        return out

    def corrupt_result(self, tag, perm: np.ndarray) -> np.ndarray:
        """``result``-site check: possibly return an invalid 'perm'."""
        if self.check("result", tags=(tag,)) == "corrupt_perm":
            perm = np.array(perm, copy=True)
            if perm.size >= 2:          # duplicate an entry: not a perm
                perm[1] = perm[0]
            else:
                perm[:] = -1
        return perm

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {f"{site}:{kind}": n
                    for (site, kind), n in sorted(self.injected_by.items())}


def _corrupt_dispatch(kind: str, out):
    """NaN-corrupt a dispatch output (``fm`` only, see ``_SITE_KINDS``):
    out-of-range parts + NaN weights, certain to fail validation."""
    assert kind == "fm", kind
    parts, sep_w, imb = out
    parts = np.full_like(np.asarray(parts), 7)
    sep_w = np.full_like(np.asarray(sep_w, dtype=np.float64), np.nan)
    imb = np.full_like(np.asarray(imb, dtype=np.float64), np.nan)
    return parts, sep_w, imb


# ------------------------------------------------------------------ #
# installation (process-global, or scoped via ``fault_injection``)
# ------------------------------------------------------------------ #
_ACTIVE: Optional[FaultInjector] = None


def active() -> Optional[FaultInjector]:
    return _ACTIVE


def install(plan: Optional[FaultPlan]) -> Optional[FaultInjector]:
    """Install (or, with None, remove) the process-global injector."""
    global _ACTIVE
    if plan is None:
        _ACTIVE = None
        obs.set_fault_hook(None)
        return None
    inj = FaultInjector(plan)
    _ACTIVE = inj
    obs.set_fault_hook(inj.dispatch_hook)
    return inj


def maybe_install_from_env() -> Optional[FaultInjector]:
    """Install from ``REPRO_FAULT_PLAN`` once (no-op when unset or when
    an injector is already active) — called at service construction."""
    if _ACTIVE is not None:
        return _ACTIVE
    plan = FaultPlan.from_env()
    if plan is None:
        return None
    return install(plan)


@contextlib.contextmanager
def fault_injection(plan: FaultPlan):
    """Scoped injection: install for the block, restore after."""
    global _ACTIVE
    prev = _ACTIVE
    inj = FaultInjector(plan)
    _ACTIVE = inj
    prev_hook = obs.set_fault_hook(inj.dispatch_hook)
    try:
        yield inj
    finally:
        _ACTIVE = prev
        obs.set_fault_hook(prev_hook)
