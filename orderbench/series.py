"""Run cells several times, one process a run, and summarize the spreads.

    python3 orderbench/series.py --out <dir> --seconds 45 \
        m3d-30.single:1,2,3 m3d-30.single:4:trace mix.stream16:5,6

Each argument is ``<workload>:<seed>[,<seed>...][:trace]``; the runs go
in the order given, each ``run.py`` process to its end before the next.
Every run's standard output and error go to ``<dir>/<workload>.<seed>
[.trace].log``; the result lines go to ``<dir>/results.jsonl``.  At the
end it prints, per cell and metric, the median and the spread: the
distance between the first and third quartiles (``statistics.quantiles``,
n=4) as a share of the median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def spread(values):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", default=None)
    ap.add_argument("--stop", action="store_true",
                    help="stop after the first run that prints no result")
    ap.add_argument("runs", nargs="+")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    table = {}
    for spec in args.runs:
        parts = spec.split(":")
        workload, seeds = parts[0], [int(s) for s in parts[1].split(",")]
        trace = len(parts) > 2 and parts[2] == "trace"
        for seed in seeds:
            cmd = [sys.executable, str(HERE / "run.py"), "--workload",
                   workload, "--seed", str(seed), "--seconds",
                   str(args.seconds), "--trace", str(int(trace))]
            if args.control:
                cmd += ["--control", args.control]
            t0 = time.time()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                  text=True)
            dt = time.time() - t0
            name = f"{workload}.{seed}{'.trace' if trace else ''}"
            (out / f"{name}.log").write_text(
                proc.stdout + "\n--- stderr\n" + proc.stderr)
            line = proc.stdout.strip().splitlines()[-1:] or [""]
            try:
                res = json.loads(line[0])
            except json.JSONDecodeError:
                res = None
            with open(out / "results.jsonl", "a") as f:
                f.write(json.dumps(dict(workload=workload, seed=seed,
                                        trace=trace, rc=proc.returncode,
                                        seconds=dt, result=res)) + "\n")
            short = {k: round(v["value"], 6) for k, v in
                     (res or {}).get("metrics", {}).items()}
            print(f"{name} rc={proc.returncode} {dt:.1f}s correct="
                  f"{(res or {}).get('correct')} {json.dumps(short)}",
                  flush=True)
            if res is None:
                print(proc.stderr[-3000:], flush=True)
                if args.stop:
                    return 1
            else:
                key = (workload, trace)
                for k, v in res["metrics"].items():
                    table.setdefault(key, {}).setdefault(k, []).append(
                        v["value"])
    for (workload, trace), metrics in table.items():
        for k, vals in metrics.items():
            s = spread(vals)
            print(f"spread {workload}{' trace' if trace else ''} {k}: "
                  f"median {statistics.median(vals):.6g} n {len(vals)} "
                  f"spread {s if s is None else round(s, 5)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
