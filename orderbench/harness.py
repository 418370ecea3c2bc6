"""One run of one cell: set-up, the measured window, the check, the result.

``run`` finds the cell in ``BENCHMARK.json``, its configuration in
``configs/<config>.json``, its traffic in ``traffic/<traffic>.json`` and
each metric's reader in ``metrics/<metric>.py``, all by name, so a new
cell, mix or metric is a new file and a new entry.  It returns the
result object and the checks; ``run.py`` prints them.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from orderbench import check, drive, record, stages
from orderbench.reference import symbolic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def bench_file(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def find(bench: Dict, workload: str):
    """The cell, its configuration and its traffic, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, traffic


def metrics_of(bench: Dict, workload: str, traced: bool) -> List[Dict]:
    """The metrics a run of ``workload`` reports: with ``traced`` the
    per-layer ones, else the end-to-end ones, each named for the cell by
    its ``workloads`` key or, without one, by its ``moves``."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"orderbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Window:
    """What the metric readers read."""

    def __init__(self):
        self.setup_s = 0.0
        self.wall_s = 0.0
        self.orderings: List[dict] = []     # one-client entries
        self.requests: List[dict] = []      # the service entry
        self.t0 = 0.0
        self.ins = None                     # obs.instrument() record
        self.by_kind: Dict[str, float] = {}  # stages.ByKind seconds
        self.opc: List[float] = []
        self.profile: Optional[Dict] = None
        self.fm_launches: List[dict] = []
        self.bfs_launches: List[dict] = []
        self.devices: List[int] = []


def _sync(device: str) -> None:
    if device == "cuda":
        import torch
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


@contextlib.contextmanager
def _profiled(traced: bool, device: str):
    if not traced:
        yield None
        return
    import torch
    from repro_torch import obs
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    from orderbench import spans
    with torch.profiler.profile(activities=acts) as prof, \
            obs.tracing(annotate_device=True), spans.installed():
        yield prof


def run(workload: str, seed: int, seconds: float, traced: bool, *,
        device: str = "cuda", bench: Optional[Dict] = None,
        cfg_override: Optional[Dict] = None,
        traffic_override: Optional[Dict] = None,
        t_start: Optional[float] = None, log=print,
        window_hook=contextlib.nullcontext) -> Dict:
    """One run; returns ``{"result": ..., "checks": [...]}``.

    ``device`` "cpu" runs the program's plain versions (tests only);
    ``cfg_override`` / ``traffic_override`` update the files' values;
    ``window_hook()`` is entered around the window alone (the tests plant
    their faults there).
    """
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or bench_file()
    cell, cfg, traffic = find(bench, workload)
    cfg.update(cfg_override or {})
    traffic.update(traffic_override or {})
    import torch
    from repro_torch.obs.instrument import instrument

    drv = drive.make(cfg, traffic, seed, device)
    drv.setup()
    rec = record.Recorder(seed)
    with rec.installed():
        warm_s = drv.warm_up()
    counts = dict(rec.counts)
    rec.counts.clear()
    scale = max(seconds, warm_s) / max(warm_s, 1e-3)
    rec.set_strides({k: v * scale for k, v in counts.items()},
                    check.sampled(traffic))
    rec.keep, rec.shapes = True, traced
    w = Window()
    w.devices = list(range(int(cell["chips"])))
    _sync(device)
    if device == "cuda":
        for d in w.devices:
            torch.cuda.reset_peak_memory_stats(d)
    w.setup_s = time.perf_counter() - t_start
    with window_hook(), rec.installed(), instrument() as ins, \
            stages.by_kind() as kinds, _profiled(traced, device) as prof:
        out = drv.window(seconds)
        _sync(device)
    w.ins, w.by_kind, w.wall_s = ins, kinds.seconds, out["wall_s"]
    if device == "cuda":
        peak = max(torch.cuda.max_memory_allocated(d) for d in w.devices)
    else:
        peak = 0
    if traced and prof is not None:
        from orderbench import devtrace
        w.profile = devtrace.summarize(prof, w.devices if device == "cuda"
                                      else [])
        w.fm_launches = rec.fm_launch_shapes()
        w.bfs_launches = rec.bfs_launch_shapes()
        del prof
        log(f"trace: {w.profile['events']} events, "
            f"{w.profile['device_events']} on the devices, "
            f"{w.profile['annotations']} host spans; busy "
            f"{json.dumps(w.profile['busy_s'])} of {w.wall_s:.3f} s",
            file=sys.stderr)

    # --- after the window: the program's state freed, then the check
    perms = drv.permutations()
    if isinstance(drv, drive.Stream):
        w.requests, w.t0 = drv.requests, out["t0"]
    else:
        w.orderings = drv.results
    samples = rec.host_samples()
    called = drive.kinds_called(dict(rec.counts))
    start = drv.start_checks()
    drv.release()
    rec.samples = []
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    not_perm = lost = 0
    want_opc = any(m["name"] == "opc" for m in metrics_of(bench, workload,
                                                           False))
    for g, perm in perms:
        if perm is None:
            lost += 1
            continue
        if not symbolic.is_permutation(perm, g.n):
            not_perm += 1
        elif want_opc and not traced:
            w.opc.append(symbolic.nnz_opc(g.xadj, g.adjncy, perm)[1])
    checks = [("not_perm", not_perm, 0), ("lost", lost, 0)] + start
    kchecks, checked = check.kernel_checks(samples, called, cfg,
                                           check.required(cfg, traffic))
    checks += kchecks
    hits = sum(1 for r in w.requests if r["cached"])
    for r in w.requests:
        if r["status"] != "ok":
            log(f"request {r['index']} {r['pattern']} ended {r['status']}",
                file=sys.stderr)
    log(f"checked after the window in {time.perf_counter() - t_check:.1f} "
        f"s: {json.dumps(checked)}; cache hits {hits}; calls by (kind, big): "
        f"{json.dumps({f'{k}.{int(b)}': v for (k, b), v in rec.counts.items()})}",
        file=sys.stderr)

    metrics = {}
    for m in metrics_of(bench, workload, traced):
        value = reader(m["name"])(w)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if device == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(0) if device == "cuda"
                else "cpu",
                "count": len(w.devices), "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= lim for _, v, lim in checks),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev_info}
    if traced and w.profile is not None:
        from orderbench import devtrace
        busy = w.profile["busy_s"]
        dev_info["busy_s"] = sum(busy.values()) / max(len(busy), 1)
        dev_info["window_s"] = w.wall_s
        result["breakdown"] = {
            "device_ops": devtrace.top(w.profile["kernel_s"]),
            "idle_gaps": devtrace.top(w.profile["idle_by_span"])}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return {"result": result, "checks": checks, "warm_s": warm_s}
