"""Reading the device trace of a traced run.

The traced window runs under ``torch.profiler`` (CPU and CUDA activities)
with the program's spans annotated (``obs.tracing(annotate_device=True)``),
and the profile stays in memory.  ``summarize`` reduces it to:

* ``busy_s`` per device: the union of the intervals in which a kernel, a
  copy or a memset ran on it;
* ``kernel_s``: device seconds by kernel name;
* ``idle_by_span``: each idle gap of a device, charged to the innermost
  host span (an annotation) open at the gap's middle, summed by span name
  and averaged over the devices.
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Sequence, Tuple

DEVICE_ACTIVITIES = ("kernel", "memcpy", "memset")


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _label(spans, starts, t: int) -> str:
    """The innermost span (latest start) open at time t."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(-1, i - 2000), -1):
        a, b, name = spans[j]
        if b >= t:
            best = name
            break
    return best or "no span"


_HOST_PREFIXES = ("aten::", "cuda", "cu", "Memcpy", "Memset", "Activity",
                  "Profiler", "Runtime", "Driver", "Lazy", "ProfilerStep")


def _classify(events):
    """(device events, host annotations) of a kineto event list, each as
    (start ns, end ns, device, name).  Where the events do not say their
    activity (older PyTorch), a CUDA event is a device event unless an
    annotation of its name exists, and a host event whose name is no op
    or runtime call is an annotation."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in events:
        a = e.start_ns()
        b = a + e.duration_ns()
        at = getattr(e, "activity_type", None)
        name = e.name()
        if at is not None:
            kind = str(at()).lower()
            if "annotation" in kind:
                if "gpu" not in kind:
                    host.append((a, b, None, name))
            elif any(k in kind for k in DEVICE_ACTIVITIES):
                dev.append((a, b, e.device_index(), name))
            continue
        if e.device_type() == cuda:
            dev.append((a, b, e.device_index(), name))
        elif not name.startswith(_HOST_PREFIXES):
            host.append((a, b, None, name))
    marks = {h[3] for h in host}
    dev = [d for d in dev if d[3] not in marks]
    return dev, host


def summarize(prof, devices: Sequence[int]) -> Dict:
    events = prof.profiler.kineto_results.events()
    dev, host = _classify(events)
    dev_iv: Dict[int, List[Tuple[int, int]]] = collections.defaultdict(list)
    kernel_s: Dict[str, float] = collections.Counter()
    for a, b, d, name in dev:
        dev_iv[d].append((a, b))
        kernel_s[name] += (b - a) / 1e9
    spans = sorted((a, b, name) for a, b, _, name in host)
    stamps = [x for a, b, _, _ in dev + host for x in (a, b)]
    lo, hi = (min(stamps), max(stamps)) if stamps else (0, 0)
    starts = [s[0] for s in spans]
    busy, gaps = {}, collections.Counter()
    for d in devices:
        iv = _union(dev_iv.get(d, []))
        busy[d] = sum(b - a for a, b in iv) / 1e9
        edges = [lo] + [x for ab in iv for x in ab] + [hi]
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                gaps[_label(spans, starts, (a + b) // 2)] += \
                    (b - a) / 1e9 / len(devices)
    return dict(busy_s=busy, kernel_s=dict(kernel_s),
                idle_by_span=dict(gaps),
                events=len(events), device_events=len(dev),
                annotations=len(host))


def top(d: Dict[str, float], k: int = 10) -> List[List]:
    return [[name, s] for name, s in
            sorted(d.items(), key=lambda kv: -kv[1])[:k]]
