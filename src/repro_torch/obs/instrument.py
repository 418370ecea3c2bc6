"""Instrumentation: one entry point for the data plane's counters.

The port of ``Instrumentation`` / ``instrument()`` and the ``_note_*``
emitters of the reference's ``repro/core/dgraph.py``.  They live here,
beside the event bus, so that the bucketed executors (``core.fm``,
``core.coarsen``, ``core.band``), the distributed plane (``core.dgraph``,
``core.dnd``) and the service's router record into them without
importing each other.  ``core.dgraph`` re-exports them under the
reference's names (``dgraph.instrument``, ``dgraph.track_gathers``,
``dgraph.stage``, ...), and ``core.dnd`` re-exports
``track_band_stats``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Tuple

from repro_torch import obs


@dataclasses.dataclass(eq=False)      # identity semantics: nested blocks
class Instrumentation:                # with equal contents must not alias
    """Counters recorded by one ``instrument()`` block.

    ``gathers``   — one ``(kind, n_elements)`` per centralizing gather
      of the distributed plane (``dgraph.to_host`` / ``unshard_vector``);
      the gather-free tests bound it.
    ``halos``     — exchanged element count (P · n_loc_max words) per
      host-level halo exchange, one entry per *work*: a lane-stacked
      launch serving L works appends L entries.  Exchanges inside the
      distributed BFS and matching are not counted.
    ``band_stats``— one dict per sharded-band refinement (appended by
      ``dnd``'s band task; see ``dnd.track_band_stats``).
    ``launches``  — one dict per device dispatch of a bucketed executor:
      ``{"kind", "nparts", "lanes", "lanes_pad", "bucket", "rounds",
      "words"}``, kinds ``fm`` / ``bfs`` / ``match`` (nparts 0, words
      0); the distributed collectives record ``dhalo`` / ``dbfs`` /
      ``dmatch`` with ``words``, the reference's model of the launch's
      ``all_gather`` traffic.  A dispatch is one call of the stage's
      kernel wrapper over one bucket; the kernels it launches are
      counted by the wrappers
      (``kernels.matching.launches`` and the like).  The wave router's
      summaries count *these records*, not their own bookkeeping.
    ``stage_s``   — accumulated wall-clock seconds per pipeline stage
      (``match`` / ``bfs`` / ``halo`` / ``fm`` / ``rebuild`` /
      ``endgame``); ``endgame`` times a whole deferred-subtree batch and
      so contains the ``fm`` / ``bfs`` / ``match`` shares its executors
      bill.
    ``waves``     — one summary dict per router wave: outstanding works /
      shape buckets / launches / wall-clock (``t_s``) / per-stage seconds
      (``stage_s``) by kind.
    ``span_s`` / ``span_self_s`` — while a tracer is installed
      (``obs.tracing``), seconds per span name of the spans that closed
      in the block: their whole durations, and their self time (each
      less its child spans).  Empty when nothing traces.
    """
    gathers: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    halos: List[int] = dataclasses.field(default_factory=list)
    launches: List[dict] = dataclasses.field(default_factory=list)
    band_stats: List[dict] = dataclasses.field(default_factory=list)
    stage_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    waves: List[dict] = dataclasses.field(default_factory=list)
    span_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    span_self_s: Dict[str, float] = dataclasses.field(default_factory=dict)

    def on_event(self, kind: str, payload: dict) -> None:
        """Event-bus entry point (called with the bus lock held, so the
        read-modify-write ``stage_s`` accumulation is atomic under
        concurrent emitters)."""
        if kind == "gather":
            self.gathers.append((payload["kind"], payload["n"]))
        elif kind == "halo":
            self.halos.append(payload["n"])
        elif kind == "launch":
            self.launches.append(payload)
        elif kind == "band_stats":
            self.band_stats.append(payload)
        elif kind == "stage":
            name, sec = payload["name"], float(payload["seconds"])
            self.stage_s[name] = self.stage_s.get(name, 0.0) + sec
        elif kind == "wave":
            self.waves.append(payload)
        elif kind == "span":
            name = payload["name"]
            self.span_s[name] = self.span_s.get(name, 0.0) + \
                payload["seconds"]
            self.span_self_s[name] = self.span_self_s.get(name, 0.0) + \
                payload["self_s"]


@contextlib.contextmanager
def instrument():
    """Record all data-plane counters executed inside the block.

    Yields an ``Instrumentation``.  Blocks nest: every active block
    receives every event.  Registration lives on the ``repro_torch.obs``
    event bus, whose lock makes concurrent emitters (a service drain
    thread under a caller-thread reader) safe; removal is **by
    identity** so nested blocks with equal contents never evict each
    other.
    """
    ins = Instrumentation()
    obs.register_collector(ins)
    try:
        yield ins
    finally:
        obs.unregister_collector(ins)


@contextlib.contextmanager
def track_gathers():
    """A view over ``instrument()``: yields its ``gathers`` list."""
    with instrument() as ins:
        yield ins.gathers


@contextlib.contextmanager
def track_halos():
    """A view over ``instrument()``: yields its ``halos`` list."""
    with instrument() as ins:
        yield ins.halos


@contextlib.contextmanager
def track_band_stats():
    """A view over ``instrument()``: yields its ``band_stats`` list (one
    dict per sharded-band refinement, ``dnd._sharded_band_task``)."""
    with instrument() as ins:
        yield ins.band_stats


def _note_gather(kind: str, size: int) -> None:
    obs.emit("gather", {"kind": kind, "n": int(size)})


def _note_halo(size: int) -> None:
    obs.emit("halo", {"n": int(size)})


def _note_band_stats(stats: dict) -> None:
    obs.emit("band_stats", stats)


def _note_launch(kind: str, nparts: int, lanes: int, lanes_pad: int,
                 bucket: Tuple[int, ...], rounds: int, words: int,
                 **extra) -> None:
    """Record one dispatch; ``extra`` carries dispatch-specific metadata
    (``tags``: per-lane request attribution)."""
    payload = {"kind": kind, "nparts": int(nparts),
               "lanes": int(lanes), "lanes_pad": int(lanes_pad),
               "bucket": tuple(bucket), "rounds": int(rounds),
               "words": int(words)}
    payload.update(extra)
    obs.emit("launch", payload)


def _note_stage(name: str, seconds: float, compile: bool = False) -> None:
    obs.emit("stage", {"name": name, "seconds": float(seconds),
                       "compile": compile})


def _note_wave(summary: dict) -> None:
    obs.emit("wave", summary)


@contextlib.contextmanager
def stage(name: str):
    """Time a host pipeline stage (``rebuild``, ``endgame``) into every
    active ``instrument()`` block, under a ``stage:{name}`` span; device
    dispatches bill theirs through ``obs.timed_dispatch``."""
    t0 = time.perf_counter()
    with obs.span(f"stage:{name}"):
        try:
            yield
        finally:
            _note_stage(name, time.perf_counter() - t0)
