"""What the metric readers (``metrics/<name>.py``) share.

A reader takes the run's ``harness.Window`` and returns a number, or
None when the run has nothing for it to read (the harness then leaves
the metric out of the line).
"""
from __future__ import annotations

import math
import re
from typing import List, Optional, Sequence

from orderbench import roofline, stages

FM_KERNEL = "fm_fused_kernel"
#: the band BFS's kernels (``csrc/bfs_multi.cu``), matched by their whole
#: name: ``dgraph.cu``'s ``dbfs_lanes`` and ``dbfs_init`` contain these
BFS_KERNEL = re.compile(r"\bbfs_(lanes|init|relax)\b")


def ok_orderings(w) -> int:
    return sum(1 for r in w.orderings if r["ok"])


def per_ordering(w, seconds: float) -> Optional[float]:
    n = ok_orderings(w)
    return seconds / n if n else None


def dispatch_s(w) -> float:
    """Seconds the program billed to device dispatches (each one's
    packing, upload, kernels and download)."""
    return sum(w.by_kind.get(k, 0.0) for k in stages.DISPATCH_KINDS)


def nearest_rank(values: Sequence[float], q: float) -> Optional[float]:
    """The q-quantile by nearest rank (an infinite value counts)."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def latencies(w) -> List[float]:
    """Each request's seconds from the client's submit to its result;
    a request without a permutation counts as infinite."""
    return [r["t_done"] - r["t_submit"]
            if r["status"] == "ok" and r["t_done"] is not None
            else math.inf for r in w.requests]


def fm_roofline_pct(w) -> Optional[float]:
    """The FM launches' least time by bytes over their device time."""
    if w.profile is None:
        return None
    kernel = sum(s for name, s in w.profile["kernel_s"].items()
                 if FM_KERNEL in name)
    if kernel <= 0 or not w.fm_launches:
        return None
    return 100.0 * roofline.fm_bound_s(w.fm_launches) / kernel


def bfs_roofline_pct(w) -> Optional[float]:
    """The band BFS calls' least time by bytes over the device time of
    the ``BFS_KERNEL`` kernels in the trace; None for a run without band
    BFS calls."""
    if w.profile is None or not w.bfs_launches:
        return None
    kernel = sum(s for name, s in w.profile["kernel_s"].items()
                 if BFS_KERNEL.search(name))
    if kernel <= 0:
        return None
    return 100.0 * roofline.bfs_bound_s(w.bfs_launches) / kernel


def idle_pct(w) -> Optional[float]:
    """The share of the traced window with nothing on the card, averaged
    over the cards the run uses."""
    if w.profile is None or not w.profile["busy_s"] or w.wall_s <= 0:
        return None
    busy = w.profile["busy_s"]
    return 100.0 * (1.0 - sum(busy.values()) / len(busy) / w.wall_s)
