"""Parallel ordering scaling demo + the distributed data structure at work.

    PYTHONPATH=src python -m repro_torch.examples.order_mesh [--device cpu]

Part 1 sweeps the simulated process count and shows the paper's headline
result: PT-Scotch ordering quality is stable (or improves) with p while the
ParMETIS-like baseline degrades.  Part 2 runs the halo-exchange/BFS data
plane over an 8-part distributed graph (the parts are a tensor dimension
on one card), then the whole distributed nested dissection.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.baselines import parmetis_like, pt_scotch_like
from repro_torch.core.dgraph import distribute, distributed_bfs
from repro_torch.core.dnd import distributed_nested_dissection
from repro_torch.graphs.generators import grid3d
from repro_torch.sparse.symbolic import nnz_opc


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--side", type=int, default=10)
    args = ap.parse_args(argv)
    dev, P = args.device, 8
    g = grid3d(args.side, args.side, args.side)
    print(f"graph: |V|={g.n} |E|={g.m}  on {dev}")
    print(f"{'p':>4} {'O_PTS':>12} {'O_PM':>12} {'PM/PTS':>7}")
    opc = {}
    for p in (2, 8, 32):
        o_pts = nnz_opc(g, pt_scotch_like(g, seed=0, nproc=p, device=dev))[1]
        o_pm = nnz_opc(g, parmetis_like(g, seed=0, nproc=p, device=dev))[1]
        opc[p] = (o_pts, o_pm)
        print(f"{p:>4} {o_pts:>12.3e} {o_pm:>12.3e} {o_pm/o_pts:>7.2f}")

    print(f"\ndistributed band-BFS over {P} parts (halo exchange):")
    dg = distribute(g, P)
    src = np.zeros((P, dg.n_loc_max), bool)
    src[0, 0] = True
    t0 = time.time()
    dist = distributed_bfs(dg, src, width=3, device=dev)
    n_band = int((dist <= 3).sum())
    print(f"  band(width=3) holds {n_band} vertices "
          f"({time.time()-t0:.2f}s, {dg.nparts} parts, "
          f"ghosts/part max {int(dg.n_ghost.max())})")

    print(f"\nend-to-end distributed nested dissection ({P} parts):")
    t0 = time.time()
    perm = distributed_nested_dissection(dg, seed=0, device=dev)
    o_dnd = nnz_opc(g, perm)[1]
    print(f"  OPC {o_dnd:.3e} in {time.time()-t0:.1f}s "
          f"(host nproc={P} above: {opc[P][0]:.3e})")
    return {"opc": opc, "band": n_band, "dnd_opc": o_dnd, "perm": perm}


if __name__ == "__main__":
    main()
