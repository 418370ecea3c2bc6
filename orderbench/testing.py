"""Small CPU runs of the harness for the benchmark's tests.

``cpu_run`` drives one cell on the CPU (the program's plain versions) at
a size a test can hold: the mesh cells on a small grid, the pattern mix
at 100-400 vertices with 4 clients, and every kernel call sampled.  The
distributed cell centralizes no level above 64 vertices, so that its
small grid takes the sharded refinement (halo exchanges, shard
fragments) that the full-size cell takes.  A run whose traffic names
``cards`` (a cell's file, or ``traffic``) puts its parts on that many
CPU members (``drive.Ordering``), under the schedule the cards take.
``nd``'s keys are merged into the configuration's ``nd_config`` (on the
distributed entry after ``SHARDED_BELOW``): ``nd={"use_band": True}``
runs a no-band cell's path with the band graph.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

SMALL_MESH = {"graph": {"family": "grid3d", "nx": 6, "ny": 6, "nz": 6}}
SMALL_DIST = {"graph": {"family": "grid3d", "nx": 8, "ny": 8, "nz": 8}}
SHARDED_BELOW = {"band_central_threshold": 64}
SMALL_MIX = {"n_min": 100, "n_max": 400, "sizes": 4, "bins": 2}


def cpu_run(workload: str, seed: int = 2 ** 31 + 5, seconds: float = 0.2,
            traced: bool = False, mesh: dict = None, window_hook=None,
            traffic: dict = None, nd: dict = None):
    from orderbench import harness
    bench = harness.bench_file()
    cell, base_cfg, base = harness.find(bench, workload)
    if cell["config"].startswith("patterns-mix"):
        cfg, small_traffic = dict(SMALL_MIX), {"clients": 4, "requests": 64}
    else:
        dist = base["entry"] == "distributed_nested_dissection"
        cfg, small_traffic = dict(mesh or (SMALL_DIST if dist
                                           else SMALL_MESH)), {}
        if dist:
            cfg["nd_config"] = dict(base_cfg["nd_config"], **SHARDED_BELOW)
    if nd:
        cfg["nd_config"] = dict(cfg.get("nd_config", base_cfg["nd_config"]),
                                **nd)
    every_call = {k: [10 ** 6, 10 ** 6] for k in base["check_calls"]}
    traffic = dict(small_traffic, **(traffic or {}), check_calls=every_call)
    kw = {} if window_hook is None else {"window_hook": window_hook}
    return harness.run(workload, seed, seconds, traced, device="cpu",
                       bench=bench, cfg_override=cfg,
                       traffic_override=traffic, log=lambda *a, **k: None,
                       **kw)
