"""Instrumentation: one entry point for the data plane's counters.

The port of ``Instrumentation`` / ``instrument()`` and the ``_note_*``
emitters of the reference's ``repro/core/dgraph.py``.  They live here,
beside the event bus, so that the bucketed executors (``core.fm``,
``core.coarsen``, ``core.band``) and the service's router record into
them without importing each other; the distributed slice will import
them from here too.

Left out until that slice: the reference's ``gathers``, ``halos`` and
``band_stats`` lists (with ``track_gathers`` / ``track_halos`` and their
emitters), which only its distributed plane (``dgraph`` / ``dnd``)
fills.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Tuple

from repro_torch import obs


@dataclasses.dataclass(eq=False)      # identity semantics: nested blocks
class Instrumentation:                # with equal contents must not alias
    """Counters recorded by one ``instrument()`` block.

    ``launches``  — one dict per device dispatch of a bucketed executor:
      ``{"kind", "nparts", "lanes", "lanes_pad", "bucket", "rounds",
      "words"}``, kinds ``fm`` / ``bfs`` / ``match`` (nparts 0, words
      0).  A dispatch is one call of the stage's kernel wrapper over one
      bucket; the kernels it launches are counted by the wrappers
      (``kernels.matching.launches`` and the like).  The wave router's
      summaries count *these records*, not their own bookkeeping.
    ``stage_s``   — accumulated wall-clock seconds per pipeline stage
      (``match`` / ``bfs`` / ``fm``).
    ``stage_detail`` — per stage, the compile/dispatch split:
      ``{stage: {"compile_s", "dispatch_s"}}``; a dispatch whose load key
      is seen for the first time (``obs.first_use``) bills its wall to
      ``compile_s``.
    ``waves``     — one summary dict per router wave: outstanding works /
      shape buckets / launches / wall-clock (``t_s``) / per-stage seconds
      (``stage_s``) by kind.
    """
    launches: List[dict] = dataclasses.field(default_factory=list)
    stage_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    waves: List[dict] = dataclasses.field(default_factory=list)
    stage_detail: Dict[str, Dict[str, float]] = \
        dataclasses.field(default_factory=dict)

    def on_event(self, kind: str, payload: dict) -> None:
        """Event-bus entry point (called with the bus lock held, so the
        read-modify-write ``stage_s`` accumulation is atomic under
        concurrent emitters)."""
        if kind == "launch":
            self.launches.append(payload)
        elif kind == "stage":
            name, sec = payload["name"], float(payload["seconds"])
            self.stage_s[name] = self.stage_s.get(name, 0.0) + sec
            d = self.stage_detail.setdefault(
                name, {"compile_s": 0.0, "dispatch_s": 0.0})
            d["compile_s" if payload.get("compile") else "dispatch_s"] += sec
        elif kind == "wave":
            self.waves.append(payload)


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
