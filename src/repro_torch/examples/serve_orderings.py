"""Serve a stream of ordering requests through the batched service.

    PYTHONPATH=src python -m repro_torch.examples.serve_orderings \\
        [--device cpu]

Submits a mixed batch of FE-mesh / circuit analog graphs, drains the queue
once (all separator subproblems across all graphs execute as bucketed
batches, one kernel launch a bucket on the card), then replays the stream
to show fingerprint-cache hits resolving in microseconds.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.graphs.generators import circuit, grid2d, grid3d
from repro_torch.service import OrderingService
from repro_torch.sparse.symbolic import nnz_opc


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    graphs = {
        "mesh2d-A": grid2d(16, 16),
        "mesh3d":   grid3d(7, 7, 7),
        "mesh2d-B": grid2d(20, 12),
        "circuit":  circuit(500, seed=7),
    }
    svc = OrderingService(device=args.device)

    print(f"— submit + drain (batched breadth-first execution, "
          f"{args.device}) —")
    rids = {name: svc.submit(g, seed=0, nproc=16)
            for name, g in graphs.items()}
    if svc.poll(rids["mesh2d-A"]) is not None:
        raise RuntimeError("a request resolved before the drain")
    svc.drain()
    for name, g in graphs.items():
        res = svc.poll(rids[name])
        nnz, opc = nnz_opc(g, res.perm)
        print(f"{name:10s} |V|={g.n:5d}  OPC={opc:.3e}  "
              f"latency={res.latency_s * 1e3:8.1f} ms  cached={res.cached}")

    print("\n— replay the same stream (fingerprint-cache hits) —")
    for name, g in graphs.items():
        rid = svc.submit(g, seed=0, nproc=16)
        res = svc.poll(rid)                        # resolved at submit time
        if not res.cached or not np.array_equal(
                res.perm, svc.poll(rids[name]).perm):
            raise RuntimeError(f"{name}: the replay missed the cache")
        print(f"{name:10s} cache hit, latency={res.latency_s * 1e6:6.0f} µs")

    stats = svc.stats()
    print("\nservice stats:")
    for k, v in stats.items():
        print(f"  {k:20s} {v}")
    return {name: svc.poll(rid).perm for name, rid in rids.items()}


if __name__ == "__main__":
    main()
