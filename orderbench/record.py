"""What the benchmark records of the program's kernel calls while it runs.

``Recorder`` wraps the batched calls an ordering makes where the
program's executors look them up: the matching, the band BFS and the
fused FM pass loop, and the distributed ordering's matching, BFS and
halo exchange (the wave router's ``*_stacked`` calls, on the card or a
group).  For each call it:

* counts it by kind and size (``counts``), the basis of the sampling
  strides the set-up fixes;
* keeps copies of the inputs and outputs of every ``stride[(kind, big)]``
  -th call of its kind and size, from an offset drawn from the run's
  seed, for the reference to judge after the window (``samples``): a
  systematic sample, so a window that makes at least one stride of calls
  of a kind checks at least one;
* keeps, with a sampled FM call, the works that the FM executor packed
  into it (``core.fm.pack_fm_bucket``'s argument), so that the check
  packs them itself and holds the call's inputs to its own packing;
* wraps the band graph's extraction and projection where the sequential
  ordering looks them up (``core.nd.extract_band``, ``project_band``),
  and keeps copies of the sampled calls' host inputs and outputs;
* wraps the distributed levels' band refinement, centralized and
  sharded (``core.dnd._centralize_band_task``, ``_sharded_band_task``;
  counted only with the band graph on, which the task's last argument,
  its configuration, says), and keeps of a sampled task its level and
  starting part, what it returns, and: centralized, the band FM work it
  yields and the part FM hands back; sharded, the distributed band
  graph it first exchanges over;
* when ``shapes`` is on (traced runs), keeps each FM launch's shape and
  the device sum of its row extents, and each band BFS call's shape and
  the device count of its ids (the rows are packed, pads last), from
  which ``roofline`` counts the bytes the launch needs.

Copies are made on the device, in the window, and brought to the host
after it.  A call is "big" when its lanes hold 4096 vertices or more:
the root buckets, few but the largest.  A distributed call's inputs
are the program's distributed graphs (kept by reference: the program
never changes one) and host arrays, copied.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Dict, List, Tuple

import numpy as np

BIG_N = 4096


def _clone(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return x


def _host(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def _work(w) -> dict:
    """Host copies of what an ``FMWork`` hands the FM executor."""
    out = {k: np.array(getattr(w, k), copy=True)
           for k in ("nbr", "vwgt", "part", "locked")}
    out["parts_init"] = None if w.parts_init is None else \
        np.array(w.parts_init, copy=True)
    for k in ("seed", "k_inst", "eps_frac", "passes", "max_moves",
              "n_pert", "pos_only"):
        out[k] = getattr(w, k)
    return out


def _copies(*xs) -> list:
    return [np.array(x, copy=True) for x in xs]


def _watched(task, kept: dict):
    """Step ``task`` as its driver would, keeping the first work it
    yields (``first``), the first reply it gets (``reply``) and what it
    returns (``out``)."""
    try:
        work = next(task)
        kept["first"] = work
        reply = yield work
        kept["reply"] = reply
        while True:
            reply = yield task.send(reply)
    except StopIteration as stop:
        kept["out"] = stop.value
        return stop.value


class Recorder:
    def __init__(self, seed: int):
        self.rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, 0xC4EC])
        self.stride: Dict[Tuple[str, bool], int] = {}
        self.offset: Dict[Tuple[str, bool], int] = {}
        self.counts: Dict[Tuple[str, bool], int] = collections.Counter()
        self.samples: List[dict] = []
        self.shapes = False
        self.fm_launches: List[dict] = []
        self.bfs_launches: List[dict] = []
        self.keep = False
        self.packed = None          # the works of the FM call to come

    # ------------------------------------------------------------------ #
    def _take(self, kind: str, n: int) -> bool:
        key = (kind, n >= BIG_N)
        i = self.counts[key]
        self.counts[key] += 1
        if not self.keep:
            return False
        # a kind and size the warm-up never called: its first call
        stride, offset = self.stride.get(key, 0), self.offset.get(key, 0)
        if not stride:
            return i == 0
        return i >= offset and (i - offset) % stride == 0

    def set_strides(self, per_window: Dict[Tuple[str, bool], float],
                    want: Dict[str, Tuple[float, float]]) -> None:
        """Strides for an expected ``per_window`` count of calls of each
        (kind, big): ``want[kind]`` = (small, big) calls to keep, and an
        offset below each stride drawn from the seed."""
        for key in sorted(per_window):
            kind, big = key
            goal = want.get(kind, (0, 0))[1 if big else 0]
            if goal <= 0:
                continue
            self.stride[key] = max(1, int(per_window[key] // goal))
            self.offset[key] = int(self.rng.integers(0, self.stride[key]))

    # ------------------------------------------------------------------ #
    @contextlib.contextmanager
    def installed(self):
        """Wrap the program's calls while the block runs."""
        from repro_torch.core import band, coarsen, dnd, fm as core_fm, nd
        from repro_torch.kernels import ops
        from repro_torch.service import router
        rec = self

        def wrap_match(fn):
            def match(nbr, wgt, keys, rounds=8):
                out = fn(nbr, wgt, keys, rounds=rounds)
                if rec._take("match", nbr.shape[1]):
                    rec.samples.append(dict(
                        kind="match", rounds=rounds,
                        args=[_clone(t) for t in (nbr, wgt, keys)],
                        out=[_clone(out)]))
                return out
            return match

        def wrap_bfs(fn):
            def bfs(nbr, src, width):
                out = fn(nbr, src, width)
                if rec._take("bfs", nbr.shape[1]):
                    rec.samples.append(dict(
                        kind="bfs", width=width,
                        args=[_clone(t) for t in (nbr, src)],
                        out=[_clone(out)]))
                if rec.shapes:
                    rec.bfs_launches.append(dict(
                        shape=tuple(nbr.shape), slots=(nbr >= 0).sum()))
                return out
            return bfs

        def wrap_band(fn):
            def extract(g, part, width=3, dist=None, device=None):
                out = fn(g, part, width=width, dist=dist, device=device)
                if rec._take("band", g.n):
                    band_g, bpart, locked, ids = out
                    rec.samples.append(dict(
                        kind="band",
                        args=_copies(g.xadj, g.adjncy, g.vwgt, part),
                        out=_copies(band_g.xadj, band_g.adjncy, band_g.vwgt,
                                    bpart, locked, ids)))
                return out
            return extract

        def wrap_project(fn):
            def project(part, band_part, old_ids):
                out = fn(part, band_part, old_ids)
                if rec._take("band_proj", len(part)):
                    rec.samples.append(dict(
                        kind="band_proj",
                        args=_copies(part, band_part, old_ids),
                        out=_copies(out)))
                return out
            return project

        def wrap_dband(path, fn):
            def task(dg, part_sh, *args):
                # without the band, the sharded task refines the whole
                # level: no band to judge, and no call of this kind
                if not args[-1].use_band or \
                        not rec._take("dband", int(dg.n_global)):
                    return (yield from fn(dg, part_sh, *args))
                part0, kept = np.array(part_sh, copy=True), {}
                out = yield from _watched(fn(dg, part_sh, *args), kept)
                s = dict(kind="dband", path=path, part=part0,
                         out=np.array(out, copy=True))
                first = kept["first"]
                if path == "central":
                    s.update(dgs=[dg], reply=np.array(kept["reply"][0],
                                                      copy=True),
                             work=_copies(first.nbr, first.vwgt, first.part,
                                          first.locked))
                else:
                    s["dgs"] = [dg, first.dg]
                rec.samples.append(s)
                return out
            return task

        def wrap_fm(fn):
            def fm(nbr, lane_work, vwgt, parts, locked, keys, eps_frac,
                   max_moves, n_pert, passes=3, pos_only=False,
                   extents=None):
                args = (nbr, lane_work, vwgt, parts, locked, keys, eps_frac,
                        max_moves, n_pert)
                take = rec._take("fm", nbr.shape[1])
                kept = [_clone(t) for t in args] if take else None
                works = [_work(w) for w in rec.packed] \
                    if take and rec.packed is not None else None
                rec.packed = None
                out = fn(*args, passes=passes, pos_only=pos_only,
                         extents=extents)
                if take:
                    rec.samples.append(dict(
                        kind="fm", passes=passes, pos_only=pos_only,
                        args=kept, out=[_clone(t) for t in out],
                        works=works))
                if rec.shapes and extents is not None:
                    rec.fm_launches.append(dict(
                        shape=tuple(nbr.shape), lanes=int(lane_work.shape[0]),
                        row_len_numel=int(extents.row_len.numel()),
                        slots=extents.row_len.sum()))
                return out
            return fm

        def wrap_pack(fn):
            def pack(works):
                rec.packed = list(works)
                return fn(works)
            return pack

        def wrap_dist(kind, fn):
            def call(dgs, values, *args, **kw):
                out = fn(dgs, values, *args, **kw)
                if rec._take(kind, int(dgs[0].n_global)):
                    rec.samples.append(dict(
                        kind=kind, dgs=list(dgs),
                        values=[np.array(v, copy=True) for v in values],
                        args=args, out=[np.array(o, copy=True)
                                        for o in out]))
                return out
            return call

        saved = [(coarsen, "heavy_edge_matching_multi"),
                 (band, "bfs_multi"), (ops, "fm_fused_multi"),
                 (router, "distributed_matching_stacked"),
                 (router, "distributed_bfs_stacked"),
                 (router, "halo_exchange_stacked"),
                 (core_fm, "pack_fm_bucket"), (nd, "extract_band"),
                 (nd, "project_band"), (dnd, "_centralize_band_task"),
                 (dnd, "_sharded_band_task")]
        originals = [getattr(m, a) for m, a in saved]
        wraps = (wrap_match, wrap_bfs, wrap_fm,
                 lambda fn: wrap_dist("dmatch", fn),
                 lambda fn: wrap_dist("dbfs", fn),
                 lambda fn: wrap_dist("dhalo", fn), wrap_pack, wrap_band,
                 wrap_project, lambda fn: wrap_dband("central", fn),
                 lambda fn: wrap_dband("sharded", fn))
        for (m, a), fn, wrap in zip(saved, originals, wraps):
            setattr(m, a, wrap(fn))
        try:
            yield self
        finally:
            self.packed = None
            for (m, a), fn in zip(saved, originals):
                setattr(m, a, fn)

    # ------------------------------------------------------------------ #
    def host_samples(self) -> List[dict]:
        """The kept calls with every array on the host."""
        out = []
        for s in self.samples:
            if "dgs" in s:
                out.append(s)
                continue
            s = dict(s)
            s["args"] = [_host(t) for t in s["args"]]
            s["out"] = [_host(t) for t in s["out"]]
            out.append(s)
        return out

    def fm_launch_shapes(self) -> List[dict]:
        return [dict(d, slots=int(d["slots"])) for d in self.fm_launches]

    def bfs_launch_shapes(self) -> List[dict]:
        return [dict(d, slots=int(d["slots"])) for d in self.bfs_launches]
