"""The FM call's inputs, packed from the works the FM executor was handed.

An FM work is one level's graph to refine: an ELL array of neighbour ids
(``-1`` pads), vertex weights, the starting parts (one, or several tries
``parts_init``), the locked vertices, a seed and its lane parameters.
One FM call refines a bucket of works, each on ``k`` lanes, and reads:

* ``nbr`` (W, n, d): one tile a work, its rows padded with ``-1`` to
  ``n``, a power of two of at least 64 above the works' vertex count,
  and ``d``, one of at least 8 above their degree;
* ``lane_work`` (L,): the work of each lane; a work's ``k`` lanes (its
  ``k_inst`` rounded up to a power of two of at least 2) in a row, in
  the works' order, and the lanes padded to a multiple of 8 by copies
  of the first lane, on work 0, that may make no move;
* per lane: ``vwgt`` (its work's weights, 0 on the padding),
  ``locked`` (its work's locks, padding locked), ``parts`` (its start:
  the work's part, or its ``i``-th try cycled over ``parts_init``; 3 on
  the padding), ``keys`` (the ``i``-th key of ``split(key(seed), k)``),
  ``eps_frac``, ``n_pert``, and ``max_moves``: the work's budget, by
  default twice its largest starting separator plus 16, at most ``n``
  and 4096.

``check`` also holds each work's graph to what a level's graph is:
every id a vertex of it, no vertex its own neighbour or a neighbour
twice, every edge seen from both ends, no weight negative (a shard's
fragment stands the rest of the graph in by two anchor vertices, whose
weight may be 0).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from orderbench.reference import threefry

FIELDS = ("nbr", "lane_work", "vwgt", "parts", "locked", "keys",
          "eps_frac", "max_moves", "n_pert")


def _pow2(x: int, lo: int) -> int:
    v = lo
    while v < x:
        v *= 2
    return v


def sound_graph(nbr: np.ndarray, vwgt: np.ndarray) -> bool:
    """Whether ``nbr`` (n, d) is the ELL of a simple undirected graph of
    non-negative ``vwgt``."""
    n = nbr.shape[0]
    if len(vwgt) != n or (np.asarray(vwgt) < 0).any():
        return False
    rows, cols = np.nonzero(nbr >= 0)
    ids = nbr[rows, cols].astype(np.int64)
    if ((nbr < -1).any() or (ids >= n).any() or (ids == rows).any()):
        return False
    fwd = rows * n + ids
    if len(np.unique(fwd)) != len(fwd):
        return False
    return np.array_equal(np.sort(fwd), np.sort(ids * n + rows))


def pack(works: List[Dict]) -> Dict[str, np.ndarray]:
    """The call's inputs, as ``FIELDS``, from its works in order."""
    n_pad = max(_pow2(w["nbr"].shape[0], 64) for w in works)
    d_pad = max(_pow2(max(w["nbr"].shape[1], 1), 8) for w in works)
    tiles, lanes = [], []
    for i, w in enumerate(works):
        n, d = w["nbr"].shape
        tile = np.full((n_pad, d_pad), -1, np.int64)
        tile[:n, :d] = w["nbr"]
        tiles.append(tile)
        vw = np.zeros(n_pad, np.int64)
        vw[:n] = w["vwgt"]
        lock = np.ones(n_pad, bool)
        lock[:n] = w["locked"]
        k = _pow2(int(w["k_inst"]), 2)
        starts = [w["part"]] if w["parts_init"] is None else \
            list(w["parts_init"])
        budget = w["max_moves"]
        if budget is None:
            budget = 2 * max(int((np.asarray(p) == 2).sum())
                             for p in starts) + 16
        budget = min(int(budget), _pow2(n, 64), 4096)
        keys = threefry.split(threefry.key(int(w["seed"])), k)
        for j in range(k):
            part = np.full(n_pad, 3, np.int64)
            part[:n] = starts[j % len(starts)]
            lanes.append(dict(lane_work=i, vwgt=vw, parts=part, locked=lock,
                              keys=keys[j].astype(np.int64),
                              eps_frac=np.float32(w["eps_frac"]),
                              max_moves=budget, n_pert=int(w["n_pert"])))
    pad = -len(lanes) % 8
    lanes += [dict(lanes[0], lane_work=0, max_moves=0)] * pad
    out = {"nbr": np.stack(tiles)}
    for f in FIELDS[1:]:
        out[f] = np.stack([np.asarray(ln[f]) for ln in lanes])
    return out


def check(args: List[np.ndarray], works) -> bool:
    """Whether an FM call's inputs ``args`` (in ``FIELDS`` order) are the
    packing of ``works``, each work a sound graph."""
    if not works:
        return False
    if not all(sound_graph(np.asarray(w["nbr"]), np.asarray(w["vwgt"]))
               for w in works):
        return False
    want = pack(works)
    for f, got in zip(FIELDS, args):
        got = np.asarray(got)
        w = want[f]
        if got.shape != w.shape:
            return False
        if f == "eps_frac":
            ok = np.array_equal(got.astype(np.float32), w)
        else:
            ok = np.array_equal(got.astype(np.int64), w.astype(np.int64))
        if not ok:
            return False
    return True
