"""Fault tolerance and elastic scaling for the training loop.

The port of the reference's ``train.fault``:

  * **Failure detection**: a heartbeat registry per host (``Heartbeat``);
    a missed deadline marks the host dead and triggers a restart from the
    checkpoint on the surviving set.
  * **Elastic re-mesh**: checkpoints are topology-independent
    (``checkpoint.py``); ``plan_elastic_mesh`` picks the largest feasible
    (data, model) grid for the surviving device count, any data width
    ≥ 1 (PT-Scotch's fold: no power of two of the original size).
  * **Restarts**: ``RestartPolicy`` bounds them and backs off; the
    trainer (``launch.train``) drives it on a simulated failure.
  * **Straggler mitigation**: the data pipeline sends hedged reads; at
    the step level, ``StragglerMonitor`` tracks a step-time EWMA and flags
    outliers.  The service's wave router uses it too.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Heartbeat:
    deadline_s: float = 30.0
    last_seen: Dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, host: int, now: Optional[float] = None) -> None:
        self.last_seen[host] = time.monotonic() if now is None else now

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [h for h, t in self.last_seen.items()
                if now - t > self.deadline_s]


def plan_elastic_mesh(n_devices: int, model_parallel: int
                      ) -> Tuple[int, int]:
    """Largest (data, model) grid for the surviving devices.

    Model-parallel width is fixed by the checkpointed layout; data width is
    whatever is left — any integer ≥ 1 works (the PT-Scotch fold property:
    no power-of-two requirement)."""
    if n_devices < model_parallel:
        raise ValueError(
            f"need ≥{model_parallel} devices for TP={model_parallel}")
    return n_devices // model_parallel, model_parallel


class StragglerMonitor:
    """EWMA step timer; flags steps slower than ``factor``× the mean."""

    def __init__(self, factor: float = 2.0, alpha: float = 0.1):
        self.factor = factor
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        is_straggler = (self.ewma is not None
                        and dt > self.factor * self.ewma)
        self.ewma = dt if self.ewma is None else \
            (1 - self.alpha) * self.ewma + self.alpha * dt
        if is_straggler:
            self.flagged += 1
        return is_straggler


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 10
    backoff_s: float = 1.0
    restarts: int = 0

    def should_restart(self) -> bool:
        return self.restarts < self.max_restarts

    def record(self) -> float:
        self.restarts += 1
        return self.backoff_s * min(2 ** (self.restarts - 1), 32)
