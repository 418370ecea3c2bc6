"""Host spans the benchmark records around the program's host steps in a
traced run, so that the trace says what the host was doing while the
card sat idle.

Each wrapped function runs under ``torch.profiler.record_function(
"host:<name>")``, where the program's callers look it up: the coarse
graph's build and the matching's ELL tiles (``core.coarsen``), the
initial separators, the band's extraction and projection and the leaves'
minimum degree (``core.nd``), and the packing of the FM, matching and
BFS buckets.  The spans only observe; the program's spans (``obs``) are
annotated beside them.
"""
from __future__ import annotations

import contextlib

#: (module, function) pairs, each as its callers look it up
WRAPPED = (("repro_torch.core.coarsen", "coarsen_once"),
           ("repro_torch.core.coarsen", "match_work_for"),
           ("repro_torch.core.coarsen", "pack_match_bucket"),
           ("repro_torch.core.band", "pack_bfs_bucket"),
           ("repro_torch.core.fm", "pack_fm_bucket"),
           ("repro_torch.core.nd", "initial_parts"),
           ("repro_torch.core.nd", "extract_band"),
           ("repro_torch.core.nd", "project_band"),
           ("repro_torch.core.nd", "min_degree"))


@contextlib.contextmanager
def installed():
    import importlib

    from torch.profiler import record_function
    saved = []

    def wrap(fn, label):
        def call(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return call

    for mod_name, name in WRAPPED:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, name)
        saved.append((mod, name, fn))
        setattr(mod, name, wrap(fn, f"host:{name}"))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
