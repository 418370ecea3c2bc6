"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 orderbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository's root, on a machine with the cards the cell asks
for.  The run sets up, warms up on the cell's own shapes, measures for
``--seconds`` seconds, checks what the window produced against the plain
reference, and prints each compared number beside its limit as its last
lines on standard error and, as the last line of standard output, one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` the ``breakdown``, and last ``checks``).
With ``--trace 1`` the metrics are the cell's per-layer ones, read under
``torch.profiler``; else its end-to-end ones.  It exits non-zero, and
prints no result, without enough cards or when JAX or the JAX package
was loaded.  ``--control short_matching`` runs the control
(``control.py``) in the program's place for the window.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """The program as the configuration states it, its caches inside the
    checkout, and no fault plan."""
    os.environ["REPRO_FM_MODE"] = "fused"
    for name in ("REPRO_FM_GAIN", "REPRO_FAULT_PLAN"):
        os.environ.pop(name, None)
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        p for p in sys.path if p and Path(p).resolve() != here]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None)
    args = ap.parse_args(argv)
    _environment()
    from orderbench import control, harness
    bench = harness.bench_file()
    cell, _, _ = harness.find(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this "
              f"host has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    hook = {}
    if args.control:
        hook["window_hook"] = lambda: control.installed(args.control)
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), bench=bench, t_start=T_START, **hook)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 3
    for name, value, limit in out["checks"]:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
