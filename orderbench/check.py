"""The comparison that decides a run's ``correct``.

After the window, with the program's state freed, each number below is
worked out and held against its limit; the run is correct when none is
above it.  Every comparison is exact, so every limit is 0.

* ``not_perm``: the window's permutations that are no bijection of the
  graph's vertices (the benchmark's own check, on every one);
* ``lost``: orderings or requests that never gave a permutation: raised,
  failed, shed, or unresolved a minute past the close;
* ``match_bad``, ``bfs_bad``, ``fm_bad``: lanes of the sampled kernel
  calls whose outputs differ from the plain reference's
  (``reference.kernels``), worked out from the call's own inputs with
  the configuration's matching rounds and band width;
* ``band_bad``, ``band_proj_bad`` (with the band graph on): sampled band
  graphs, anchors, starts, locks and ids that differ from
  ``reference.band``'s, worked out from the level's own graph and part
  with the configuration's band width, and sampled projections of the
  refined band back onto the level that differ from its;
* ``dband_bad`` (distributed, with the band graph on): sampled band
  refinements of a distributed level that differ from its band
  (``_judge_dband``);
* ``fmpack_bad``: sampled FM calls whose inputs are not the benchmark's
  own packing (``reference.pack``) of the works the FM executor was
  handed, whose works are no sound graph, or whose works were not seen;
* ``dmatch_bad``, ``dbfs_bad``, ``dhalo_bad`` (distributed cells): lanes
  of the sampled distributed matchings, BFS and halo exchanges that
  differ from ``reference.dist`` on the call's distributed graphs;
* ``start_bad`` (distributed cells): 1 if the distributed graph that
  set-up made does not hold exactly the graph the benchmark handed over;
* ``unchecked``: kinds of call that the cell's path has to make
  (``required``) or that the window made, of which no call was sampled,
  so that a run that checked nothing, or that reached a kernel by
  another way than the one recorded, is not correct.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from orderbench.reference import band as bref
from orderbench.reference import dist as dref
from orderbench.reference import kernels as ref
from orderbench.reference import pack

Check = Tuple[str, float, float]
KINDS = ("match", "bfs", "fm", "dmatch", "dbfs", "dhalo", "band",
         "band_proj", "dband")
#: kinds only the band graph's refinement calls
BAND_KINDS = ("bfs", "dbfs", "band", "band_proj", "dband")
#: the band graph's own steps, one of each a band BFS work of their path:
#: sampled as that BFS is where the traffic names no number
BAND_GRAPH = {"band": "bfs", "band_proj": "bfs", "dband": "dbfs"}


def sampled(traffic: dict) -> Dict[str, Tuple[float, float]]:
    """The (small, big) calls of each kind a run keeps for the check: the
    traffic's ``check_calls``, and the band graph's as its BFS's."""
    want = {k: tuple(v) for k, v in traffic["check_calls"].items()}
    for k, like in BAND_GRAPH.items():
        if like in want:
            want.setdefault(k, want[like])
    return want


def required(cfg: dict, traffic: dict) -> List[str]:
    """The kinds of call a cell's path has to make: those it samples
    (``sampled``), less the band's where the configuration refines
    without the band graph."""
    band = cfg.get("nd_config", {}).get("use_band", True)
    return [k for k in sampled(traffic) if band or k not in BAND_KINDS]


def _lanes_bad(got: List[np.ndarray], want: List[np.ndarray]) -> int:
    bad = np.zeros(len(want[0]), dtype=bool)
    for g, w in zip(got, want):
        g = np.asarray(g).reshape(len(bad), -1)
        w = np.asarray(w).reshape(len(bad), -1)
        bad |= ~(g == w).all(axis=1)
    return int(bad.sum())


def _judge_dist(s: dict, cfg: dict) -> Tuple[int, int]:
    bad = 0
    for dg, v, got in zip(s["dgs"], s["values"], s["out"]):
        lay = (dg.vtxdist, dg.nbr_gst, dg.ghost_gid, dg.n_loc)
        if s["kind"] == "dhalo":
            want = dref.halo(dg.vtxdist, dg.ghost_gid, v)
        elif s["kind"] == "dbfs":
            want = dref.bfs(*lay, v, int(cfg["band_width"]))
        else:
            want = dref.match(dg.vtxdist, dg.nbr_gst, dg.ewgt_gst,
                              dg.ghost_gid, dg.n_loc, int(v),
                              int(cfg["match_rounds"]))
        bad += not np.array_equal(np.asarray(got), want)
    return bad, len(s["dgs"])


def _judge_dband(s: dict, cfg: dict) -> int:
    """1 if a distributed level's band refinement differs from the band
    of ``reference.band``: centralized, its band FM work, and the level's
    part with FM's answer written back; sharded, its distributed band
    graph, and the level's part outside the band, which it may not move."""
    dg = s["dgs"][0]
    xadj, adjncy, vwgt = bref.level(dg)
    part = bref.gathered(dg.vtxdist, s["part"])
    want = bref.extract(xadj, adjncy, vwgt, part, int(cfg["band_width"]))
    out = bref.gathered(dg.vtxdist, s["out"])
    if s["path"] == "central":
        nbr, w, p, locked = s["work"]
        got = dict(arcs=bref.ell_arcs(nbr), vwgt=w, part=p, locked=locked)
        same = all(np.array_equal(got[k], want[k]) for k in got)
        return int(not (same and np.array_equal(
            out, bref.project(part, s["reply"], want["ids"]))))
    ids = want["ids"][want["ids"] >= 0]
    inner = want["arcs"][(want["arcs"] < len(ids)).all(axis=1)]
    bd = s["dgs"][1]
    outside = np.ones(len(part), dtype=bool)
    outside[ids] = False
    return int(not (
        np.array_equal(dref.to_edges(bd.vtxdist, bd.nbr_gst, bd.ghost_gid,
                                     bd.n_loc), inner)
        and np.array_equal(bref.gathered(bd.vtxdist, bd.vwgt),
                           want["vwgt"][:len(ids)])
        and np.array_equal(out[outside], part[outside])))


def judge_call(s: dict, cfg: dict) -> Tuple[int, int]:
    """(lanes that differ, lanes) of one sampled call ``s``."""
    if s["kind"] == "dband":
        return _judge_dband(s, cfg), 1
    if "dgs" in s:
        return _judge_dist(s, cfg)
    a = s["args"]
    if s["kind"] == "match":
        want = [ref.match(a[0], a[1], a[2], int(cfg["match_rounds"]))]
    elif s["kind"] == "bfs":
        want = [ref.bfs(a[0], a[1], int(cfg["band_width"]))]
    elif s["kind"] == "band":
        want = bref.extract(*a, int(cfg["band_width"]))
        o = s["out"]
        got = dict(arcs=bref.arcs(o[0], o[1]), vwgt=o[2], part=o[3],
                   locked=o[4], ids=o[5])
        return int(any(not np.array_equal(got[k], want[k])
                       for k in want)), 1
    elif s["kind"] == "band_proj":
        return int(not np.array_equal(s["out"][0], bref.project(*a))), 1
    else:
        want = list(ref.fm(*a, passes=int(s["passes"]),
                           pos_only=bool(s["pos_only"])))
    return _lanes_bad(s["out"], want), len(want[0])


def kernel_checks(samples: List[dict], called: Dict[str, int],
                  cfg: dict, must: List[str]
                  ) -> Tuple[List[Check], Dict[str, int]]:
    """The sampled calls' checks, and lanes checked by kind; ``must``
    are the kinds the cell's path has to make."""
    bad = {k: 0 for k in KINDS}
    lanes = {k: 0 for k in bad}
    calls = {k: 0 for k in bad}
    pack_bad = 0
    for s in samples:
        b, n = judge_call(s, cfg)
        bad[s["kind"]] += b
        lanes[s["kind"]] += n
        calls[s["kind"]] += 1
        if s["kind"] == "fm":
            pack_bad += not pack.check(s["args"], s["works"])
    seen = [k for k in bad if called.get(k) or k in must]
    unchecked = sum(1 for k in seen if not calls[k])
    checks = [(f"{k}_bad", bad[k], 0) for k in seen]
    if "fm" in seen:
        checks.append(("fmpack_bad", pack_bad, 0))
    checks.append(("unchecked", unchecked, 0))
    return checks, dict(lanes=lanes, calls=calls)
