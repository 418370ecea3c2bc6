"""The paper's technique as a framework feature: Scotch static mapping
places MoE experts across pods to cut inter-pod all-to-all traffic.

    PYTHONPATH=src python -m repro_torch.examples.expert_placement \\
        --arch arctic-480b

Expert co-activation (which experts fire together for the same token) is
clustered in practice; recursive-bisection mapping (``core.mapping``)
packs co-firing experts into the same pod, so the expensive inter-pod hop
only carries the residual cross-cluster traffic.  The mapping is host
numpy, as in the reference: the example does no device work and so takes
no ``--device``.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.core.graph import Graph
from repro_torch.core.mapping import (DeviceTier, expert_placement,
                                      traffic_cost)


def synth_coactivation(E: int, n_clusters: int, seed: int = 0) -> np.ndarray:
    """Synthetic clustered co-activation (semantic expert specialization)."""
    rng = np.random.default_rng(seed)
    co = rng.random((E, E)) * 0.05
    sizes = np.full(n_clusters, E // n_clusters)
    sizes[:E % n_clusters] += 1
    lo = 0
    for s in sizes:
        co[lo:lo + s, lo:lo + s] += rng.random((s, s)) * 1.0 + 0.5
        lo += s
    return (co + co.T) / 2


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="arctic-480b")
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--chips-per-pod", type=int, default=8)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    E = cfg.n_experts or 16
    n_dev = args.pods * args.chips_per_pod
    co = synth_coactivation(E, n_clusters=args.pods * 2)
    assign = expert_placement(co, args.pods, args.chips_per_pod,
                              inter_pod_cost=10.0, seed=0)
    # cost accounting
    iu, ju = np.nonzero(np.triu(co, 1))
    w = np.maximum((co[iu, ju] / co.max() * 1000).astype(np.int64), 1)
    g = Graph.from_edges(E, np.stack([iu, ju], 1), ewgt=w)
    tiers = [DeviceTier(args.pods, 10.0),
             DeviceTier(args.chips_per_pod, 1.0)]
    c_scotch = traffic_cost(g, assign, tiers)
    rng = np.random.default_rng(1)
    c_rand = np.mean([traffic_cost(g, rng.integers(0, n_dev, E), tiers)
                      for _ in range(10)])
    c_naive = traffic_cost(g, np.arange(E) % n_dev, tiers)
    print(f"arch={cfg.name}: {E} experts -> "
          f"{args.pods} pods × {args.chips_per_pod} chips")
    print(f"  round-robin placement cost : {c_naive:12.0f}")
    print(f"  random placement cost      : {c_rand:12.0f}")
    print(f"  scotch mapping cost        : {c_scotch:12.0f}  "
          f"({c_rand / c_scotch:.2f}× better than random)")
    per_dev = np.bincount(assign, minlength=n_dev)
    print(f"  experts/device: min={per_dev.min()} max={per_dev.max()}")
    return {"assign": assign, "scotch": c_scotch, "random": c_rand,
            "round_robin": c_naive}


if __name__ == "__main__":
    main()
