"""Quickstart: order a 3D FE-mesh-like graph with the PT-Scotch pipeline.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Shows the paper's full flow — multilevel coarsening with fold-dup, greedy
initial separators, band extraction (width 3), multi-sequential FM — on
the card (or the CPU, with ``--device cpu``), and compares OPC/NNZ
against natural order, minimum degree, and the ParMETIS-like
strict-refinement baseline.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core.baselines import (mindeg_ordering, natural,
                                        parmetis_like, pt_scotch_like)
from repro_torch.core.nd import NDConfig
from repro_torch.graphs.generators import grid3d
from repro_torch.sparse.symbolic import nnz_opc


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--side", type=int, default=12)
    ap.add_argument("--nproc", type=int, default=16)
    args = ap.parse_args(argv)
    s, p, dev = args.side, args.nproc, args.device
    g = grid3d(s, s, s)
    print(f"graph: {s}×{s}×{s} grid  |V|={g.n}  |E|={g.m}  on {dev}")
    rows = {}
    for name, fn in [
        ("natural", lambda: natural(g)),
        ("minimum-degree", lambda: mindeg_ordering(g)),
        (f"parmetis-like p={p}",
         lambda: parmetis_like(g, seed=0, nproc=p, device=dev)),
        (f"pt-scotch p={p}",
         lambda: pt_scotch_like(g, seed=0, nproc=p, device=dev)),
        (f"pt-scotch p={p} (no band)",
         lambda: pt_scotch_like(g, seed=0, nproc=p,
                                cfg=NDConfig(use_band=False), device=dev)),
    ]:
        t0 = time.time()
        perm = fn()
        dt = time.time() - t0
        nnz, opc = nnz_opc(g, perm)
        rows[name] = (nnz, opc)
        print(f"{name:28s} NNZ={nnz:>9,}  OPC={opc:.3e}  ({dt:.1f}s)")
    base = rows["natural"][1]
    best = min(opc for name, (_, opc) in rows.items() if name != "natural")
    print(f"\nfill-reducing orderings cut OPC by "
          f"{base / best:.1f}× vs natural order")
    return rows


if __name__ == "__main__":
    main()
