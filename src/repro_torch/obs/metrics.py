"""Metrics registry: counters + histograms, Prometheus-style export.

The port of the reference's ``repro/obs/metrics.py``; the metric names
are the reference's.

A lightweight always-on companion to the span tracer: counters cost one
locked dict update per *event* (events fire per launch / stage / request,
never per element), so the registry stays registered on the event bus for
the life of the process.  ``snapshot()`` returns plain dicts for benches
and tests; ``render_prometheus()`` emits the text exposition format
(counters, and summaries with p50/p95 quantiles for histograms).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np


def _key(name: str, labels: Dict[str, str]) -> Tuple:
    return (name,) + tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_labels(labels) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class Registry:
    """Thread-safe named counters and bounded-sample histograms."""

    def __init__(self, histogram_window: int = 4096):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple, float] = {}
        self._hists: Dict[Tuple, deque] = {}
        self._window = histogram_window

    # -------------------------------------------------------------- #
    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value

    def observe(self, name: str, value: float, **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            if k not in self._hists:
                self._hists[k] = deque(maxlen=self._window)
            self._hists[k].append(float(value))

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._hists.clear()

    # -------------------------------------------------------------- #
    def snapshot(self) -> dict:
        """Plain-dict view: counters and histogram summaries."""
        with self._lock:
            counters = {k: v for k, v in self._counters.items()}
            hists = {k: list(v) for k, v in self._hists.items()}

        def render_key(k):
            name, labels = k[0], k[1:]
            return name + _fmt_labels(labels)

        out = {"counters": {render_key(k): v for k, v in counters.items()},
               "histograms": {}}
        for k, samples in hists.items():
            arr = np.asarray(samples)
            out["histograms"][render_key(k)] = {
                "count": len(samples),
                "sum": float(arr.sum()),
                "p50": float(np.percentile(arr, 50)),
                "p95": float(np.percentile(arr, 95)),
            }
        return out

    def render_prometheus(self) -> str:
        """Text exposition: counters + summary quantiles."""
        with self._lock:
            counters = sorted(self._counters.items())
            hists = sorted((k, list(v)) for k, v in self._hists.items())
        lines = []
        seen_types = set()
        for k, v in counters:
            name, labels = k[0], k[1:]
            if name not in seen_types:
                lines.append(f"# TYPE {name} counter")
                seen_types.add(name)
            lines.append(f"{name}{_fmt_labels(labels)} {v:g}")
        for k, samples in hists:
            name, labels = k[0], k[1:]
            if name not in seen_types:
                lines.append(f"# TYPE {name} summary")
                seen_types.add(name)
            arr = np.asarray(samples)
            for q in (0.5, 0.95):
                ql = labels + (("quantile", f"{q:g}"),)
                lines.append(
                    f"{name}{_fmt_labels(ql)} "
                    f"{float(np.percentile(arr, q * 100)):g}")
            lines.append(f"{name}_count{_fmt_labels(labels)} {len(samples)}")
            lines.append(
                f"{name}_sum{_fmt_labels(labels)} {float(arr.sum()):g}")
        return "\n".join(lines) + "\n"


#: process-global default registry (benches / service read this)
REGISTRY = Registry()


class MetricsCollector:
    """Event-bus collector mapping instrumentation events onto the
    default registry.  Registered once at ``repro_torch.obs`` import.
    The reference's gather and halo events come from the distributed
    plane, which the port has not yet; so do launch ``words``."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or REGISTRY

    def on_event(self, kind: str, payload: dict) -> None:
        r = self.registry
        if kind == "launch":
            r.inc("repro_launches_total", kind=payload["kind"])
            r.inc("repro_launch_lanes_total", payload["lanes"],
                  kind=payload["kind"])
        elif kind == "stage":
            phase = "compile" if payload.get("compile") else "dispatch"
            r.inc("repro_stage_seconds_total", payload["seconds"],
                  stage=payload["name"], phase=phase)
