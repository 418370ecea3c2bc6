"""Straggler detection, the part of the reference's ``repro/train/fault.py``
that the service's wave router uses.

The rest of that module (heartbeats, the elastic mesh plan, the restart
policy) serves the training loop and waits for the LM scaffold's slice.
"""
from __future__ import annotations

from typing import Optional


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
