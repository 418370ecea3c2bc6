"""Multilevel coarsening with fold-dup (paper §3.2).

The matching runs on the device (``matching.py``); the coarse-graph build
is a host-side reshuffle (sort + segment-accumulate).

Fold-dup: "coarsened graphs are folded and duplicated ... every subgroup of
processes that hold a working copy of the graph being able to perform an
almost-complete independent multi-level computation".  Quality-wise the
mechanism is: once the average number of vertices per process drops below
``fold_threshold`` (paper default 100), the process group splits into two
halves, each holding a *duplicate*, so from that point on independent
multilevel instances run and the best projected separator wins.  We model
the instance tree faithfully: ``n_instances`` doubles at every fold level
until each (simulated) process holds one copy.

The matching stage is *work-yielding*: ``coarsen_multilevel_task`` yields
one ``MatchWork`` per level and the driver sends back the matching.  The
sequential wrapper (``coarsen_multilevel``) executes each work immediately.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Generator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs, prng
from repro_torch.core.graph import Graph
from repro_torch.core.matching import heavy_edge_matching, \
    heavy_edge_matching_multi
from repro_torch.obs.instrument import _note_launch
from repro_torch.util import download, host_tensor, pow2, resolve_device, \
    upload


def match_graph(g: Graph, seed: int, rounds: int = 8,
                device=None) -> np.ndarray:
    """Heavy-edge matching of g on ``device`` (padded ELL)."""
    dev = resolve_device(device)
    dmax = int(g.degrees().max()) if g.n else 1
    nbr, wgt = g.to_ell(dmax)
    n_pad = pow2(g.n)
    d_pad = pow2(dmax, 8)
    nbr_p = -np.ones((n_pad, d_pad), dtype=np.int32)
    wgt_p = np.zeros((n_pad, d_pad), dtype=np.int32)
    nbr_p[:g.n, :dmax] = nbr
    wgt_p[:g.n, :dmax] = wgt
    m = heavy_edge_matching(torch.from_numpy(nbr_p).to(dev),
                            torch.from_numpy(wgt_p).to(dev),
                            prng.PRNGKey(seed, dev), rounds=rounds)
    m = m.cpu().numpy()[:g.n]
    # Mask out-of-range ids (padded lanes) back to self-match: clamping to
    # n-1 would silently merge the vertex onto real vertex n-1.
    bad = (m < 0) | (m >= g.n)
    return np.where(bad, np.arange(g.n, dtype=m.dtype), m)


@dataclasses.dataclass
class MatchWork:
    """One heavy-edge-matching request (unpadded host ELL arrays).

    Yielded by ``coarsen_multilevel_task``; ``execute_match_works`` pads
    each work to its power-of-two ELL bucket and runs every work sharing a
    bucket as one batched matching (one lane per graph).  Per-lane results
    are independent of batch composition.
    """
    nbr: np.ndarray                     # (n, d) int32 ELL ids, -1 pad
    wgt: np.ndarray                     # (n, d) int32 edge weights, 0 pad
    seed: int
    rounds: int = 8

    def bucket_key(self) -> Tuple[int, int, int]:
        n, d = self.nbr.shape
        return (pow2(n), pow2(max(d, 1), 8), self.rounds)


def match_work_for(g: Graph, seed: int, rounds: int = 8) -> MatchWork:
    """Build the MatchWork for one graph (same ELL form as match_graph)."""
    dmax = int(g.degrees().max()) if g.n else 1
    nbr, wgt = g.to_ell(dmax)
    return MatchWork(nbr=nbr, wgt=wgt, seed=seed, rounds=rounds)


def match_parts(buf, L: int, n_pad: int, d_pad: int):
    """The parts of one bucket's staging buffer (``pack_match_bucket``), a
    host numpy array or its tensor on the card: nbr, wgt (L, n_pad, d_pad)
    int32 and the lanes' keys (L, 2) int64."""
    N = L * n_pad * d_pad
    wide = np.int64 if isinstance(buf, np.ndarray) else torch.int64
    return (buf[:N].reshape(L, n_pad, d_pad),
            buf[N:2 * N].reshape(L, n_pad, d_pad),
            buf[2 * N:].view(wide).reshape(L, 2))


def pack_match_bucket(works: Sequence[MatchWork], n_pad: int, d_pad: int,
                      device: torch.device) -> torch.Tensor:
    """One bucket's lanes padded to (L, n_pad, d_pad), with their keys, in
    one host buffer (``match_parts``), pinned when ``device`` is the card."""
    L = len(works)
    buf = host_tensor(2 * L * n_pad * d_pad + 4 * L, device)
    nbr_b, wgt_b, keys = match_parts(buf.numpy(), L, n_pad, d_pad)
    nbr_b.fill(-1)
    wgt_b.fill(0)
    for j, w in enumerate(works):
        n, d = w.nbr.shape
        nbr_b[j, :n, :d] = w.nbr
        wgt_b[j, :n, :d] = w.wgt
        keys[j] = prng.PRNGKey(w.seed).numpy()
    return buf


def execute_match_works(works: Sequence[MatchWork],
                        device=None) -> List[np.ndarray]:
    """Run matching works, one batched matching per (n_pad, d_pad, rounds).

    Each bucket's upload, kernel and download is one
    ``obs.timed_dispatch`` and one launch record (``obs.instrument``);
    the ``match`` stage is billed from the start of the bucket's packing.  Returns, per work in input order, the
    flat (n,) matching with match[v] = v for singletons (out-of-range ids
    from padded lanes are masked back to self, as in ``match_graph``).
    """
    dev = resolve_device(device)
    results: List[Optional[np.ndarray]] = [None] * len(works)
    groups = defaultdict(list)
    for i, w in enumerate(works):
        groups[w.bucket_key()].append(i)
    for (n_pad, d_pad, rounds), idxs in groups.items():
        L = len(idxs)
        t0 = time.perf_counter()
        host = pack_match_bucket([works[i] for i in idxs], n_pad, d_pad,
                                 dev)

        def dispatch(host=host, L=L, n_pad=n_pad, d_pad=d_pad,
                     rounds=rounds):
            buf = upload(host, dev)
            return download(heavy_edge_matching_multi(
                *match_parts(buf, L, n_pad, d_pad), rounds=rounds))

        m = obs.timed_dispatch(
            "match", "match", ("match", dev.type), dispatch, since=t0,
            lanes=L, lanes_pad=L, bucket=(n_pad, d_pad), rounds=rounds)
        _note_launch("match", 0, L, L, (n_pad, d_pad), rounds, 0)
        for j, i in enumerate(idxs):
            n = works[i].nbr.shape[0]
            mi = m[j, :n].astype(np.int64)
            bad = (mi < 0) | (mi >= n)
            results[i] = np.where(bad, np.arange(n, dtype=np.int64), mi)
    return results                                           # type: ignore


def coarsen_once(g: Graph, match: np.ndarray):
    """Build the coarse graph from a matching.

    Returns (coarse_graph, cmap) with cmap[v_fine] = v_coarse.
    """
    rep = np.minimum(np.arange(g.n), match)
    reps = np.unique(rep)
    cmap_tbl = -np.ones(g.n, dtype=np.int64)
    cmap_tbl[reps] = np.arange(len(reps))
    cmap = cmap_tbl[rep]
    nc = len(reps)
    cvwgt = np.zeros(nc, dtype=np.int64)
    np.add.at(cvwgt, cmap, g.vwgt)
    src = np.repeat(np.arange(g.n), g.degrees())
    cs, cd = cmap[src], cmap[g.adjncy]
    keep = cs < cd                      # half-edges, drop collapsed
    cg = Graph.from_edges(nc, np.stack([cs[keep], cd[keep]], 1),
                          vwgt=cvwgt, ewgt=g.adjwgt[keep])
    return cg, cmap


@dataclasses.dataclass
class Level:
    graph: Graph
    cmap: Optional[np.ndarray]          # fine -> coarse map (None at top)
    n_instances: int                    # independent fold-dup copies alive


@dataclasses.dataclass
class MultilevelState:
    levels: List[Level]                 # levels[0] = finest

    @property
    def coarsest(self) -> Graph:
        return self.levels[-1].graph


def coarsen_multilevel_task(g: Graph, seed: int, nproc: int = 1,
                            coarse_target: int = 120,
                            fold_threshold: int = 100,
                            max_instances: int = 16,
                            min_reduction: float = 0.97
                            ) -> Generator[MatchWork, np.ndarray,
                                           MultilevelState]:
    """Coarsen until ``coarse_target`` vertices, tracking fold-dup instances.

    Work-yielding form: yields one ``MatchWork`` per level, receives the
    flat matching back, and returns the ``MultilevelState``.  ``nproc`` is
    the simulated process count p of the paper; folding starts when
    n / p_cur < fold_threshold, and every fold doubles the number of
    independent instances (capped at ``max_instances`` for memory).
    """
    levels = [Level(g, None, 1)]
    p_cur = max(1, nproc)
    n_inst = 1
    lvl_seed = seed
    while levels[-1].graph.n > coarse_target:
        cur = levels[-1].graph
        if p_cur > 1 and cur.n / p_cur < fold_threshold:
            p_cur = (p_cur + 1) // 2                       # fold ...
            n_inst = min(n_inst * 2, max_instances)        # ... with dup
        m = yield match_work_for(cur, lvl_seed)
        lvl_seed += 1
        cg, cmap = coarsen_once(cur, m)
        if cg.n > cur.n * min_reduction:                   # stalled
            break
        levels.append(Level(cg, cmap, n_inst))
    return MultilevelState(levels)


def coarsen_multilevel(g: Graph, seed: int, nproc: int = 1,
                       coarse_target: int = 120, fold_threshold: int = 100,
                       max_instances: int = 16,
                       min_reduction: float = 0.97,
                       device=None) -> MultilevelState:
    """Synchronous driver of ``coarsen_multilevel_task`` (one matching per
    level, run on ``device``)."""
    gen = coarsen_multilevel_task(g, seed, nproc, coarse_target,
                                  fold_threshold, max_instances,
                                  min_reduction)
    try:
        work = next(gen)
        while True:
            work = gen.send(execute_match_works([work], device)[0])
    except StopIteration as stop:
        return stop.value
