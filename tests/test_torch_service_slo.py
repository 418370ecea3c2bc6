"""The port's ordering service on the CPU: the SLO control plane and
concurrent use.

Ports of the host cases of ``tests/test_service_slo.py`` and
``tests/test_service_concurrency.py`` (split from
``test_torch_service.py`` to keep each file short on one worker).  The
tolerance is exact everywhere; every entry runs with ``device="cpu"``.
"""
import threading

import numpy as np

from repro_torch.core.nd import nested_dissection, valid_warm_part
from repro_torch.graphs import generators as G
from repro_torch.obs.instrument import instrument
from repro_torch.service import OrderingService
from repro_torch.service.api import size_class
from repro_torch.service.fingerprint import structural_fingerprint
from repro_torch.service.sched_policy import PolicyConfig, SchedPolicy
from repro_torch.sparse.symbolic import nnz_opc

CPU = "cpu"


def _nd(g, seed=0, nproc=1):
    return nested_dissection(g, seed=seed, nproc=nproc, device=CPU)


# ------------------------------------------------------------------ #
# SLO control plane: preempt/resume, warm starts, deadlines
# ------------------------------------------------------------------ #
def test_preempted_ordering_resumes_bit_identically():
    """A long ordering parked at every wave boundary — while new small
    requests are admitted, run and resolved — gives the exact
    permutation of an uninterrupted run."""
    svc = OrderingService(policy=SchedPolicy(PolicyConfig(
        preemptible=("s", "m", "l"))), device=CPU)
    big_g = G.grid2d(20, 20)                    # n=400: class "s"
    smalls = [G.grid2d(6 + i, 7) for i in range(4)]     # class "xs"
    rid_big = svc.submit(big_g, seed=3, nproc=4, deadline_s=1000.0)

    small_rids, order, i = [], [], 0
    for _ in range(500):                        # pump-by-pump drive
        if svc.poll(rid_big) is not None:
            break
        if i < len(smalls):
            small_rids.append(
                svc.submit(smalls[i], seed=i, nproc=1, deadline_s=1000.0))
            i += 1
        order.extend(sorted(svc.pump()))
    assert svc.poll(rid_big) is not None, "pump loop did not terminate"
    assert np.array_equal(svc.poll(rid_big).perm, _nd(big_g, 3, 4))
    for rid, g, seed in zip(small_rids, smalls, range(len(smalls))):
        assert np.array_equal(svc.poll(rid).perm, _nd(g, seed, 1))
    assert small_rids and rid_big in order
    assert max(order.index(r) for r in small_rids) < order.index(rid_big)
    big_exec = svc.poll(rid_big).exec_s
    for rid in small_rids:
        assert svc.poll(rid).exec_s < big_exec


def test_pump_and_drain_on_empty_service():
    svc = OrderingService(device=CPU)
    assert svc.pump() == {}
    assert svc.drain() == {}
    assert svc.queue_depth() == 0


def test_valid_warm_part_topology_checks():
    g = G.grid2d(8, 8)
    part = np.zeros(g.n, dtype=np.int8)
    part[4 * 8:5 * 8] = 2
    part[5 * 8:] = 1
    ok = valid_warm_part(g, part)
    assert ok is not None and ok.dtype == np.int8
    assert valid_warm_part(g, None) is None
    assert valid_warm_part(g, part[:10]) is None        # wrong length
    assert valid_warm_part(g, np.full(g.n, 2, np.int8)) is None
    bad = part.copy()
    bad[0] = 1                                  # creates a 0-1 edge
    assert valid_warm_part(g, bad) is None
    naive = np.zeros(g.n, dtype=np.int8)        # index halves: edges cross
    naive[g.n // 2:] = 1
    assert valid_warm_part(g, naive) is None


def test_warm_start_isomorphic_repeat():
    svc = OrderingService(warm_starts=True, device=CPU)
    g = G.grid2d(14, 14)
    rid_cold = svc.submit(g, seed=0, nproc=2)
    svc.drain()
    cold = svc.poll(rid_cold)
    assert not cold.warm and len(svc.warm) == 1

    rid_warm = svc.submit(g, seed=5, nproc=2)
    svc.drain()
    warm = svc.poll(rid_warm)
    assert np.array_equal(np.sort(warm.perm), np.arange(g.n))
    st = svc.stats()
    assert st["warm_hits"] == 1
    if st["warm_fallbacks"] == 0:
        assert warm.warm
        assert (nnz_opc(g, warm.perm)[1]
                <= svc.warm_opc_ratio_max * nnz_opc(g, cold.perm)[1])
    else:
        assert not warm.warm
        assert np.array_equal(warm.perm, _nd(g, 5, 2))


def test_warm_opc_guard_falls_back_to_exact():
    svc = OrderingService(warm_starts=True, device=CPU)
    g = G.grid2d(12, 12)
    svc.submit(g, seed=0, nproc=2)
    svc.drain()
    sfp = structural_fingerprint(g)
    tree = svc.warm.get(sfp)
    assert tree is not None and tree.opc > 1.0
    # an impossibly good recorded OPC: any replay now "degrades" and
    # must fall back to the exact cold path
    svc.warm.put(sfp, dict(tree.parts), opc=1.0, n=tree.n,
                 source_fp="poison", replace=True)
    rid = svc.submit(g, seed=9, nproc=2)
    svc.drain()
    res = svc.poll(rid)
    assert svc.stats()["warm_fallbacks"] >= 1
    assert not res.warm
    assert np.array_equal(res.perm, _nd(g, 9, 2))


def test_warm_off_by_default_keeps_determinism_contract():
    svc = OrderingService(device=CPU)
    assert svc.warm_starts is False
    g = G.grid2d(10, 10)
    svc.submit(g, seed=0)
    svc.drain()
    assert len(svc.warm) == 0               # not even recording


def test_deadline_accounting_and_per_class_stats():
    svc = OrderingService(policy=SchedPolicy(PolicyConfig(
        shed_infeasible=False)), device=CPU)
    rid_ok = svc.submit(G.grid2d(9, 9), seed=0, deadline_s=1000.0)
    svc.drain()
    assert svc.poll(rid_ok).deadline_missed is False
    rid_late = svc.submit(G.grid2d(9, 10), seed=0, deadline_s=0.0)
    svc.drain()
    assert svc.poll(rid_late).deadline_missed is True
    rid_none = svc.submit(G.grid2d(10, 10), seed=0)
    svc.drain()
    assert svc.poll(rid_none).deadline_missed is None

    st = svc.stats()
    xs = st["by_class"]["xs"]
    assert xs["deadline_total"] == 2 and xs["deadline_misses"] == 1
    assert xs["deadline_miss_rate"] == 0.5
    assert st["deadline_miss_rate"] == 0.5
    assert {"count", "p50_exec_ms", "p95_exec_ms", "p50_queue_wait_ms",
            "p95_queue_wait_ms"} <= set(xs)
    assert st["pumps"] >= 3 and st["inflight"] == 0


# ------------------------------------------------------------------ #
# concurrent submit / drain
# ------------------------------------------------------------------ #
def test_size_class_boundaries():
    assert size_class(0) == "xs" and size_class(255) == "xs"
    assert size_class(256) == "s" and size_class(1023) == "s"
    assert size_class(1024) == "m" and size_class(8191) == "m"
    assert size_class(8192) == "l"


def test_concurrent_submit_drain_resolves_everything():
    """A worker-thread drain loop under caller-thread submits and stats
    readers loses and corrupts no request; ``instrument()`` accumulates
    the drain thread's events atomically."""
    svc = OrderingService(device=CPU)
    graphs = [G.grid2d(5, 5), G.grid2d(6, 4), G.grid2d(4, 7),
              G.grid2d(10, 12)]
    n_req = 30
    stop = threading.Event()
    errors = []

    def drainer():
        try:
            while not stop.is_set() or svc.queue_depth():
                svc.drain()
        except Exception as e:          # surface worker crashes
            errors.append(e)

    worker = threading.Thread(target=drainer)
    worker.start()
    rids = []
    try:
        with instrument() as ins:
            for k in range(n_req):
                g = graphs[k % len(graphs)]
                rids.append((svc.submit(g, seed=k), g, k))
                svc.stats()
    finally:
        stop.set()
        worker.join(timeout=120)
    assert not worker.is_alive(), "drain thread wedged"
    assert errors == [], f"drain thread raised: {errors[0]!r}"
    for rid, g, k in rids:
        res = svc.poll(rid)
        assert res is not None, f"request {rid} never resolved"
        assert res.size_class == "xs"
        assert np.array_equal(res.perm, _nd(g, k))
    st = svc.stats()
    assert st["queue_depth"] == 0
    assert st["requests"] == n_req
    assert st["by_class"]["xs"]["count"] >= 1
    assert all(isinstance(v, float) for v in ins.stage_s.values())


def test_stats_by_class_percentiles_shape():
    svc = OrderingService(device=CPU)
    r1 = svc.submit(G.grid2d(6, 6), seed=0)        # xs
    r2 = svc.submit(G.grid2d(20, 20), seed=1)      # s (400 vertices)
    svc.drain()
    assert svc.poll(r1).size_class == "xs"
    assert svc.poll(r2).size_class == "s"
    by_class = svc.stats()["by_class"]
    assert set(by_class) == {"xs", "s"}
    for cls, d in by_class.items():
        assert d["count"] == 1
        assert d["p95_exec_ms"] >= d["p50_exec_ms"] >= 0.0
