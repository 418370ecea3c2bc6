"""Structured span tracing + the instrumentation event bus.

The port of the reference's ``repro/obs/tracer.py``.  Two planes share
this module:

* **Event bus** — collectors (any object with ``on_event(kind,
  payload)``) register under a lock; ``emit`` fans every event out to
  all of them.  ``obs.instrument.instrument()`` registers its
  ``Instrumentation`` here, and a permanent metrics collector
  (``obs.metrics``) keeps global counters.
  The lock is held across the fan-out so read-modify-write updates
  (``stage_s`` accumulation) stay atomic when a service drain thread and
  the caller's thread emit concurrently.

* **Span tracer** — opt-in wall-clock attribution.  ``tracing()``
  installs a global ``Tracer``; ``span(name, **attrs)`` opens a timed
  span parented on the innermost open span of the *current thread /
  context* (a ``contextvars`` stack, so worker threads and async tasks
  nest correctly and never corrupt each other's ancestry).  When no
  tracer is installed, ``span`` returns a shared null context — the
  disabled path is one module-global read and no allocation, which is
  what keeps the tracer off the hot path when no one traces.

Compile vs dispatch attribution rides on ``first_use(key)``: the bucketed
executors pass the key of what their first dispatch loads (a stage's
CUDA library on the card, ``kernels.build.load``); the first sighting of
a key is billed as ``compile``, later sightings as steady-state
``dispatch``.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple


# ------------------------------------------------------------------ #
# event bus (collector registry)
# ------------------------------------------------------------------ #
_LOCK = threading.Lock()
_COLLECTORS: List[object] = []


def register_collector(collector: object) -> None:
    """Add a collector; it receives every subsequent ``emit``."""
    with _LOCK:
        _COLLECTORS.append(collector)


def unregister_collector(collector: object) -> None:
    """Remove a collector **by identity** (nested blocks may compare
    equal after a broadcast event; value-based removal would orphan the
    outer block)."""
    with _LOCK:
        for k in range(len(_COLLECTORS) - 1, -1, -1):
            if _COLLECTORS[k] is collector:
                del _COLLECTORS[k]
                break


def emit(kind: str, payload: dict) -> None:
    """Fan one event out to every registered collector, atomically."""
    with _LOCK:
        for c in _COLLECTORS:
            c.on_event(kind, payload)


# ------------------------------------------------------------------ #
# compile-key tracking
# ------------------------------------------------------------------ #
_SEEN_KEYS: set = set()


def first_use(key: Tuple) -> bool:
    """True the first time ``key`` is seen in this process.

    Keys name what a dispatch loads on first use (a stage's CUDA
    library), so "first use" is the call that pays the build or load
    instead of a steady-state dispatch.
    """
    with _LOCK:
        if key in _SEEN_KEYS:
            return False
        _SEEN_KEYS.add(key)
        return True


def forget_use(key: Tuple) -> None:
    """Forget one compile key: its next dispatch is a ``first_use``
    again (the hook for a cache that evicts what a key loaded)."""
    with _LOCK:
        _SEEN_KEYS.discard(key)


# ------------------------------------------------------------------ #
# spans
# ------------------------------------------------------------------ #
@dataclasses.dataclass
class Span:
    """One timed interval; ``attrs`` may be filled while the span is
    open (e.g. lanes / bucket of a dispatch decided mid-span)."""
    span_id: int
    parent_id: Optional[int]
    name: str
    t0: float
    t1: Optional[float] = None
    tid: int = 0
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)


# Per-thread / per-context stack of open span ids.  A tuple (immutable)
# so concurrent readers never see a half-mutated stack.
_SPAN_STACK: contextvars.ContextVar[Tuple[int, ...]] = \
    contextvars.ContextVar("repro_obs_span_stack", default=())


class Tracer:
    """Collects spans; thread-safe; exports Chrome trace_event JSON."""

    def __init__(self, annotate_device: bool = False):
        self.spans: List[Span] = []
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._tids: Dict[int, int] = {}
        # ``annotate_device`` also opens each span as a
        # ``torch.profiler.record_function`` range, so a profiler trace
        # of the card shows the spans beside the kernels
        self._annotation_cls = None
        if annotate_device:
            from torch.profiler import record_function
            self._annotation_cls = record_function

    # -------------------------------------------------------------- #
    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            return self._tids.setdefault(ident, len(self._tids))

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Open a span parented on the current context's innermost open
        span; yields the ``Span`` so callers may add attrs."""
        sid = next(self._ids)
        stack = _SPAN_STACK.get()
        sp = Span(sid, stack[-1] if stack else None, name,
                  time.perf_counter(), tid=self._tid(), attrs=dict(attrs))
        token = _SPAN_STACK.set(stack + (sid,))
        ann = (self._annotation_cls(name)
               if self._annotation_cls is not None else None)
        if ann is not None:
            ann.__enter__()
        try:
            yield sp
        finally:
            if ann is not None:
                ann.__exit__(None, None, None)
            _SPAN_STACK.reset(token)
            sp.t1 = time.perf_counter()
            with self._lock:
                self.spans.append(sp)

    def add_span(self, name: str, t0: float, t1: float,
                 attrs: Optional[dict] = None,
                 parent_id: Optional[int] = None) -> Span:
        """Record a retrospective span (e.g. a service request whose
        queue-wait interval is only known at resolve time)."""
        sp = Span(next(self._ids), parent_id, name, float(t0), float(t1),
                  tid=self._tid(), attrs=dict(attrs or {}))
        with self._lock:
            self.spans.append(sp)
        return sp

    # -------------------------------------------------------------- #
    def export_chrome(self, path: str) -> None:
        """Write Chrome/Perfetto ``trace_event`` JSON (``ph: "X"``
        complete events; ``args`` carry span/parent ids and attrs so the
        tree round-trips through ``load_chrome``)."""
        with self._lock:
            spans = list(self.spans)
        base = min((s.t0 for s in spans), default=0.0)
        events = []
        for s in spans:
            t1 = s.t1 if s.t1 is not None else s.t0
            events.append({
                "name": s.name, "ph": "X", "pid": 1, "tid": s.tid,
                "ts": round((s.t0 - base) * 1e6, 3),
                "dur": round((t1 - s.t0) * 1e6, 3),
                "args": {"span_id": s.span_id, "parent_id": s.parent_id,
                         **s.attrs},
            })
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"},
                      f, default=str)


def load_chrome(path: str) -> List[Span]:
    """Rebuild spans from an ``export_chrome`` file (seconds, relative
    to the trace origin)."""
    with open(path) as f:
        doc = json.load(f)
    spans = []
    for ev in doc["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args", {}))
        sid = args.pop("span_id", None)
        pid = args.pop("parent_id", None)
        t0 = ev["ts"] / 1e6
        spans.append(Span(sid, pid, ev["name"], t0,
                          t0 + ev["dur"] / 1e6, tid=ev.get("tid", 0),
                          attrs=args))
    return spans


# ------------------------------------------------------------------ #
# global tracer
# ------------------------------------------------------------------ #
_TRACER: Optional[Tracer] = None
_NULL_CM = contextlib.nullcontext()     # stateless: shared & reentrant


def current() -> Optional[Tracer]:
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


@contextlib.contextmanager
def tracing(tracer: Optional[Tracer] = None, annotate_device: bool = False):
    """Install a global tracer for the block; yields the ``Tracer``.

    Tracing only *observes* (timestamps around the same calls) — output
    permutations are bit-identical with tracing on or off.
    """
    global _TRACER
    t = tracer or Tracer(annotate_device=annotate_device)
    prev, _TRACER = _TRACER, t
    try:
        yield t
    finally:
        _TRACER = prev


def span(name: str, **attrs):
    """Open a span on the global tracer; shared no-op context when
    tracing is disabled (no allocation on the disabled path)."""
    t = _TRACER
    if t is None:
        return _NULL_CM
    return t.span(name, **attrs)


# ------------------------------------------------------------------ #
# timed dispatch helper
# ------------------------------------------------------------------ #
# Fault-injection seam: the service's chaos harness installs a wrapper
# here so every timed dispatch — the fm/bfs/match bucketed executors —
# is an injection boundary, without `core` ever importing the service
# layer.  The wrapper
# is called as ``wrapper(kind, thunk) -> out``; None means pass-through.
_FAULT_HOOK = None


def set_fault_hook(fn):
    """Install (or clear, with None) the dispatch fault hook; returns
    the previous hook so scoped installers can restore it."""
    global _FAULT_HOOK
    prev, _FAULT_HOOK = _FAULT_HOOK, fn
    return prev


def timed_dispatch(stage: str, kind: str, load_key: Tuple, thunk, *,
                   since: float, **attrs):
    """Run ``thunk`` as one traced device dispatch.

    Opens a ``dispatch:{kind}`` leaf span (attrs + ``compile`` flag),
    bills the wall-clock from ``since`` (a ``time.perf_counter()``
    reading taken before the caller packed the dispatch's inputs) to the
    thunk's end to ``stage`` via a ``stage`` event, with the
    compile/dispatch phase decided by ``first_use(load_key)``, and
    returns the thunk's value.  The stage events are the only stage
    clock (``instrument().stage_s``).  The thunk ends in the host
    download, so a fault hook sees host arrays.  When a
    fault hook is installed the thunk runs through it (injected
    raises/delays/corruption happen *inside* the dispatch span, where a
    real device fault would).
    """
    is_compile = first_use(load_key)
    hook = _FAULT_HOOK
    with span(f"dispatch:{kind}", compile=is_compile, **attrs):
        out = thunk() if hook is None else hook(kind, thunk)
    emit("stage", {"name": stage, "seconds": time.perf_counter() - since,
                   "compile": is_compile})
    return out
