"""Render a top-down time tree from a captured Chrome trace.

Usage:
    PYTHONPATH=src python -m repro_torch.scripts.trace_summary TRACE.json
        [--depth N] [--min-coverage 0.95] [--top K]

The port's counterpart of the reference's ``scripts/trace_summary.py``.
Reads a trace written by ``repro_torch.obs.Tracer.export_chrome`` (the
span tree round-trips through the ``span_id`` / ``parent_id`` args),
aggregates sibling spans by name, and prints, per node: total seconds,
share of the trace, call count, and self time (total minus child
total).  The
``coverage`` line is the union of root-span intervals over the trace
extent — ``--min-coverage`` turns it into an exit status for CI, which
asserts the trace accounts for >= 95% of the measured wall-clock.
"""
from __future__ import annotations

import argparse
import sys
from collections import defaultdict
from typing import Dict, List, Optional

from repro_torch.obs import Span, load_chrome


def build_tree(spans: List[Span]) -> Dict[Optional[int], List[Span]]:
    """children[parent_id] -> spans, sorted by start time."""
    by_id = {s.span_id: s for s in spans}
    children: Dict[Optional[int], List[Span]] = defaultdict(list)
    for s in spans:
        pid = s.parent_id if s.parent_id in by_id else None
        children[pid].append(s)
    for v in children.values():
        v.sort(key=lambda s: s.t0)
    return children


def coverage(spans: List[Span]) -> float:
    """Union of root-span intervals over the whole trace extent."""
    if not spans:
        return 0.0
    t_lo = min(s.t0 for s in spans)
    t_hi = max(s.t1 for s in spans)
    if t_hi <= t_lo:
        return 1.0
    by_id = {s.span_id for s in spans}
    roots = sorted(((s.t0, s.t1) for s in spans
                    if s.parent_id not in by_id), key=lambda iv: iv[0])
    covered, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in roots:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                covered += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        covered += cur_hi - cur_lo
    return covered / (t_hi - t_lo)


def _dur(s: Span) -> float:
    return (s.t1 if s.t1 is not None else s.t0) - s.t0


def render(spans: List[Span], max_depth: int = 6, top: int = 12) -> str:
    """The top-down tree: siblings aggregated by name, heaviest first."""
    children = build_tree(spans)
    total = sum(_dur(s) for s in children.get(None, [])) or 1e-12
    lines = []

    def walk(parent_ids: List[int], depth: int, prefix: str) -> None:
        groups: Dict[str, List[Span]] = defaultdict(list)
        for pid in parent_ids:
            for c in children.get(pid, []):
                groups[c.name].append(c)
        rows = sorted(groups.items(),
                      key=lambda kv: -sum(_dur(s) for s in kv[1]))
        for name, group in rows[:top]:
            tot = sum(_dur(s) for s in group)
            kid_ids = [s.span_id for s in group]
            child_tot = sum(_dur(c) for sid in kid_ids
                            for c in children.get(sid, []))
            self_s = max(tot - child_tot, 0.0)
            lines.append(
                f"{prefix}{name:<28s} {tot:9.3f}s {100 * tot / total:5.1f}%"
                f"  x{len(group):<5d} self {self_s:8.3f}s")
            if depth + 1 < max_depth:
                walk(kid_ids, depth + 1, prefix + "  ")
        dropped = len(rows) - top
        if dropped > 0:
            rest = sum(_dur(s) for _, g in rows[top:] for s in g)
            lines.append(f"{prefix}... {dropped} more groups"
                         f" {rest:9.3f}s")

    root_groups: Dict[str, List[Span]] = defaultdict(list)
    by_id = {s.span_id for s in spans}
    for s in spans:
        if s.parent_id not in by_id:
            root_groups[s.name].append(s)
    lines.append(f"{'TOTAL (root spans)':<28s} {total:9.3f}s 100.0%"
                 f"  x{sum(len(g) for g in root_groups.values())}")
    walk([None], 0, "  ")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="chrome trace JSON from export_chrome")
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--min-coverage", type=float, default=None,
                    help="exit 1 if root spans cover less of the trace "
                         "extent than this fraction")
    args = ap.parse_args(argv)
    spans = load_chrome(args.trace)
    print(render(spans, max_depth=args.depth, top=args.top))
    cov = coverage(spans)
    print(f"\ncoverage: {100 * cov:.2f}% of trace extent "
          f"({len(spans)} spans)")
    if args.min_coverage is not None and cov < args.min_coverage:
        print(f"FAIL: coverage {cov:.4f} < {args.min_coverage}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
