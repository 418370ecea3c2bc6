"""Stage seconds by kind of dispatch, read off the program's event bus.

The program bills each device dispatch's host-clock seconds (its packing,
upload, kernels and download) to a stage (``match``, ``bfs``, ``fm``,
``halo``) with a ``stage`` event, and records the dispatch with a
``launch`` event of its kind right after it.  ``ByKind`` bills each
stage event to the kind of the launch that follows, so that the
distributed matching and BFS (``dmatch``, ``dbfs``) and the halo
(``dhalo``) stand apart from the centralized ones, and adds the host
stages ``rebuild`` and ``endgame`` by name (``endgame`` holds the
dispatches of the orderings it runs).
"""
from __future__ import annotations

import contextlib
from typing import Dict

HOST_STAGES = ("rebuild", "endgame")
DISPATCH_KINDS = ("match", "bfs", "fm", "dmatch", "dbfs", "dhalo")


class ByKind:
    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self._pending = 0.0

    def on_event(self, kind: str, payload: dict) -> None:
        if kind == "stage":
            if payload["name"] in HOST_STAGES:
                self._add(payload["name"], payload["seconds"])
            else:
                self._pending = float(payload["seconds"])
        elif kind == "launch":
            self._add(payload["kind"], self._pending)
            self._pending = 0.0

    def _add(self, name: str, sec: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + float(sec)


@contextlib.contextmanager
def by_kind():
    from repro_torch import obs
    col = ByKind()
    obs.register_collector(col)
    try:
        yield col
    finally:
        obs.unregister_collector(col)
