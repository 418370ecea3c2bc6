"""The one generator of load: how a traffic mix drives the program.

A traffic file (``traffic/<mix>.json``) names its ``entry`` and its
parameters; ``make`` returns the driver for it.  Each driver sets up what
its requests need (graphs, the service, a distributed graph), warms up on one request of the cell's own shapes, and then
runs ``window(seconds)``: closed-loop clients, each of which sends its
next request when its last one has returned, until the window's time is
up.  A request started in the window runs to its end; the window's wall
ends with the last of them.

Entries:

* ``nested_dissection``: one client, ``core.nd.nested_dissection`` of the
  configuration's graph, a fresh ordering seed each time;
* ``distributed_nested_dissection``: one client,
  ``core.dnd.distributed_nested_dissection`` of the graph distributed
  once in set-up over ``nparts`` parts, on one card; with the optional
  key ``cards`` (an int of at least 2) the parts lie on a group of that
  many distinct cards (``dgraph.make_parts_group(cards, nparts)``, the
  first ``cards`` of the host; on the CPU, tests only, as many CPU
  members), handed to the warm-up and to every call of the window as
  ``group=``; the centralized works run on the group's first member;
* ``service``: ``clients`` closed-loop clients through
  ``OrderingService.submit`` / ``pump``, each request a pattern of the
  configuration's mix (``gen.pattern_stream``); the window's requests are
  made in set-up, ``requests`` of them.
"""
from __future__ import annotations

import sys
import time
import traceback
from typing import Dict, List

import numpy as np

from orderbench import gen

#: seconds past the close that a request may take to resolve
LATE_S = 60.0


def program_graph(g: gen.CSR):
    """The program's ``Graph`` of the benchmark's arrays."""
    from repro_torch.core.graph import Graph
    return Graph(g.xadj.copy(), g.adjncy.copy(), g.vwgt.copy(),
                 g.adjwgt.copy())


class Ordering:
    """Driver of the one-client entries."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device: str):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        self.dist = traffic["entry"] == "distributed_nested_dissection"
        self.cards = traffic.get("cards")
        if self.cards is not None and not (
                self.dist and isinstance(self.cards, int)
                and self.cards >= 2):
            raise ValueError(f"traffic key cards={self.cards!r}: an int of "
                             f"at least 2, with the distributed entry only")
        self.group = None
        self.graph = gen.config_graph(cfg["graph"])
        self.results: List[dict] = []

    def setup(self) -> None:
        from repro_torch.core import dgraph, dnd, nd
        self.prog_graph = program_graph(self.graph)
        if self.dist:
            self.nd_cfg = dnd.DNDConfig(**self.cfg.get("nd_config", {}))
            self.dg = dgraph.distribute(self.prog_graph, self.cfg["nparts"])
            if self.cards is not None:
                self.group = self._parts_group(dgraph)
            self._call = lambda s: dnd.distributed_nested_dissection(
                self.dg, seed=s, cfg=self.nd_cfg, device=self.device,
                group=self.group)
        else:
            self.nd_cfg = nd.NDConfig(**self.cfg.get("nd_config", {}))
            self._call = lambda s: nd.nested_dissection(
                self.prog_graph, seed=s, nproc=self.cfg["nproc"],
                cfg=self.nd_cfg, device=self.device)

    def _parts_group(self, dgraph):
        """The group of ``cards`` members that holds the parts: distinct
        cards, never one card repeated."""
        nparts = self.cfg["nparts"]
        if self.device == "cpu":
            return dgraph.make_parts_group(["cpu"] * self.cards, nparts)
        group = dgraph.make_parts_group(self.cards, nparts)
        if not group.distinct:
            raise RuntimeError(f"{group} repeats a card")
        return group

    def warm_up(self) -> float:
        t0 = time.perf_counter()
        self._call(gen.mix(self.seed, 10 ** 6))
        return time.perf_counter() - t0

    def window(self, seconds: float) -> Dict:
        self.results = []
        t0 = time.perf_counter()
        k = 0
        while time.perf_counter() - t0 < seconds:
            s = gen.mix(self.seed, k)
            t1 = time.perf_counter()
            try:
                perm = np.asarray(self._call(s))
                ok = True
            except Exception:                 # one ordering's failure
                print(f"ordering {k} (seed {s}) raised:", file=sys.stderr)
                traceback.print_exc(file=sys.stderr)
                perm, ok = None, False
            t2 = time.perf_counter()
            self.results.append(dict(order_seed=s, wall_s=t2 - t1, perm=perm,
                                     ok=ok, graph=self.graph))
            k += 1
        return dict(wall_s=time.perf_counter() - t0, attempted=k,
                    failed=sum(not r["ok"] for r in self.results))

    def permutations(self):
        """(graph, perm) of each ordering of the window."""
        return [(r["graph"], r["perm"]) for r in self.results]

    def start_checks(self):
        """The distributed graph set-up made against the graph handed
        over: ``start_bad`` 1 if its arcs differ."""
        if not self.dist:
            return []
        from orderbench.reference import dist as dref
        dg, g = self.dg, self.graph
        got = dref.to_edges(dg.vtxdist, dg.nbr_gst, dg.ghost_gid, dg.n_loc)
        src = np.repeat(np.arange(g.n), np.diff(g.xadj))
        want = np.stack([src, g.adjncy.astype(np.int64)], 1)
        want = want[np.lexsort((want[:, 1], want[:, 0]))]
        return [("start_bad", int(not np.array_equal(got, want)), 0)]

    def release(self) -> None:
        self.dg = self.prog_graph = self._call = self.group = None


class Stream:
    """Driver of the service entry: closed-loop clients."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device: str):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        self.clients = int(traffic["clients"])
        self.requests: List[dict] = []

    def setup(self) -> None:
        from repro_torch.core.nd import NDConfig
        from repro_torch.service import OrderingService
        want = int(self.traffic["requests"])
        stream = gen.pattern_stream(self.cfg, self.seed, want + self.clients)
        made: Dict[tuple, gen.CSR] = {}
        self.patterns = []
        for p in stream:
            key = (p.family, p.n, p.graph_seed)
            if key not in made:
                made[key] = gen.family_graph(p.family, p.n, p.graph_seed)
            self.patterns.append((p, made[key]))
        # the warm-up: one round of the clients, on patterns of their own
        self.warm = self.patterns[:self.clients]
        self.patterns = self.patterns[self.clients:]
        self.prog = {id(g): program_graph(g) for _, g in
                     self.warm + self.patterns}
        self.nd_cfg = NDConfig(**self.cfg.get("nd_config", {}))
        self.svc = OrderingService(cfg=self.nd_cfg, device=self.device)

    def _submit(self, i: int, pats) -> dict:
        p, g = pats[i]
        t = time.perf_counter()
        rid = self.svc.submit(self.prog[id(g)], seed=p.order_seed,
                              nproc=int(self.cfg["nproc"]))
        return dict(rid=rid, index=i, t_submit=t, pattern=p, graph=g,
                    t_done=None, status=None, perm=None, queue_wait_s=None,
                    cached=False)

    def warm_up(self) -> float:
        t0 = time.perf_counter()
        for i in range(len(self.warm)):
            self._submit(i, self.warm)
        self.svc.drain()
        return time.perf_counter() - t0

    def window(self, seconds: float) -> Dict:
        self.requests = []
        live: Dict[int, dict] = {}
        nxt = 0
        t0 = time.perf_counter()

        def send() -> None:
            nonlocal nxt
            if nxt >= len(self.patterns):
                raise RuntimeError(f"the mix ran out: {len(self.patterns)} "
                                   f"requests made in set-up")
            r = self._submit(nxt, self.patterns)
            nxt += 1
            self.requests.append(r)
            live[r["rid"]] = r

        for _ in range(self.clients):
            send()
        close = None
        while live:
            now = time.perf_counter()
            if close is None and now - t0 >= seconds:
                close = now
            if close is not None and now - close > LATE_S:
                break
            for rid in list(live):          # cache hits resolve at submit
                res = self.svc.poll(rid)
                if res is None:
                    continue
                r = live.pop(rid)
                r.update(t_done=time.perf_counter(), status=res.status,
                         perm=res.perm, queue_wait_s=res.queue_wait_s,
                         cached=res.cached)
                if close is None and r["t_done"] - t0 < seconds:
                    send()
            if live:
                self.svc.pump()
        end = close if close is not None else time.perf_counter()
        return dict(wall_s=end - t0, t0=t0,
                    attempted=len(self.requests),
                    failed=sum(r["status"] != "ok" for r in self.requests))

    def permutations(self):
        return [(r["graph"], r["perm"]) for r in self.requests]

    def start_checks(self):
        return []

    def release(self) -> None:
        self.svc = self.prog = None


def make(cfg: Dict, traffic: Dict, seed: int, device: str):
    entry = traffic["entry"]
    if entry in ("nested_dissection", "distributed_nested_dissection"):
        return Ordering(cfg, traffic, seed, device)
    if entry == "service":
        return Stream(cfg, traffic, seed, device)
    raise ValueError(f"unknown entry {entry!r}")


def kinds_called(counts: Dict) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for (kind, _), v in counts.items():
        out[kind] = out.get(kind, 0) + v
    return out

