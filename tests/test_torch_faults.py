"""Fault injection + the recovery ladder, on the port's service (CPU).

A port of ``tests/test_faults.py``; every service runs with
``device="cpu"``, where the FM ladder keeps its three rungs (fused,
hoisted, the plain oracle).  The card's two-rung ladder (fused, hoisted)
is checked here on the CPU by giving the router that ladder, and on the
card by ``tests/test_torch_cuda.py``.  Exact equality is the tolerance.

Chaos contract under test: with a seeded ``FaultPlan`` installed,
every submitted request reaches exactly one terminal status (``ok`` /
``shed`` / ``failed`` — no hangs), every ``ok`` permutation is
bit-identical to the fault-free run (retry, degrade, and cold
re-admission are all parity-preserving), and a corrupt result is never
written to the fingerprint cache.  Plans are pure functions of their
seed, so every scenario here is deterministic.
"""
import numpy as np
import pytest

from repro_torch import obs
from repro_torch.graphs import generators as G
from repro_torch.kernels import ops
from repro_torch.service import faults
from repro_torch.service import router as router_mod
from repro_torch.service.api import OrderingService as _Service
from repro_torch.service.cache import FingerprintCache
from repro_torch.service.fingerprint import request_fingerprint
from repro_torch.train.fault import StragglerMonitor


def OrderingService(**kw):
    """The port's service on the CPU."""
    return _Service(device="cpu", **kw)


def _counter_fired(name: str) -> bool:
    counters = obs.REGISTRY.snapshot()["counters"]
    return any(k == name or k.startswith(name + "{") for k in counters)


# ------------------------------------------------------------------ #
# the plan: validation, serialization, determinism
# ------------------------------------------------------------------ #
def test_fault_spec_validation():
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.FaultSpec(site="gpu", kind="transient", at=(0,))
    with pytest.raises(ValueError, match="not valid at site"):
        faults.FaultSpec(site="bfs", kind="nan", at=(0,))     # fm only
    with pytest.raises(ValueError, match="not valid at site"):
        faults.FaultSpec(site="result", kind="transient", at=(0,))
    with pytest.raises(ValueError, match="`at` indices"):
        faults.FaultSpec(site="fm", kind="transient")   # no trigger
    assert not faults.is_transient(faults.PersistentFault("x"))
    assert faults.is_transient(faults.TransientFault("x"))


def test_fault_plan_json_roundtrip_and_env(tmp_path, monkeypatch):
    plan = faults.FaultPlan(seed=7, specs=[
        faults.FaultSpec(site="fm", kind="nan", at=(0, 3), count=2),
        faults.FaultSpec(site="wave", kind="delay", rate=0.25,
                         delay_s=0.02, tag="abc")])
    back = faults.FaultPlan.from_json(plan.to_json())
    assert back.seed == plan.seed and back.specs == plan.specs

    monkeypatch.delenv("REPRO_FAULT_PLAN", raising=False)
    assert faults.FaultPlan.from_env() is None
    p = tmp_path / "plan.json"
    p.write_text(plan.to_json())
    monkeypatch.setenv("REPRO_FAULT_PLAN", f"@{p}")
    assert faults.FaultPlan.from_env().specs == plan.specs
    monkeypatch.setenv("REPRO_FAULT_PLAN", plan.to_json())
    assert faults.FaultPlan.from_env().seed == 7


def test_injection_deterministic_across_injectors():
    """Fire decisions are pure functions of (seed, site, invocation):
    equal plans inject identically; a different seed does not."""
    def pattern(plan, n=64):
        inj = faults.FaultInjector(plan)
        out = []
        for _ in range(n):
            try:
                inj.check("bfs")
                out.append(0)
            except faults.TransientFault:
                out.append(1)
        return out

    plan = faults.FaultPlan(seed=0, specs=[
        faults.FaultSpec(site="bfs", kind="transient", rate=0.3)])
    first = pattern(plan)
    assert 0 < sum(first) < 64          # rate actually draws both ways
    assert pattern(faults.FaultPlan.from_json(plan.to_json())) == first
    assert pattern(faults.FaultPlan(seed=1, specs=plan.specs)) != first


def test_injection_count_cap_and_snapshot():
    plan = faults.FaultPlan(seed=0, specs=[
        faults.FaultSpec(site="bfs", kind="transient", rate=1.0, count=2)])
    inj = faults.FaultInjector(plan)
    fired = 0
    for _ in range(10):
        try:
            inj.check("bfs")
        except faults.TransientFault:
            fired += 1
    assert fired == 2 and inj.injected == 2
    assert inj.snapshot() == {"bfs:transient": 2}


# ------------------------------------------------------------------ #
# rung 1: transient retry — recovered results stay bit-identical
# ------------------------------------------------------------------ #
def test_transient_fm_retry_recovers_bit_identically():
    g = G.grid2d(12, 12)
    svc0 = OrderingService()
    rid0 = svc0.submit(g, seed=3, nproc=2)
    ref = svc0.drain()[rid0].perm

    obs.REGISTRY.reset()
    plan = faults.FaultPlan(seed=1, specs=[
        faults.FaultSpec(site="fm", kind="transient", at=(0,))])
    with faults.fault_injection(plan) as inj:
        svc = OrderingService()
        rid = svc.submit(g, seed=3, nproc=2)
        res = svc.drain()[rid]
    assert inj.injected == 1
    assert res.status == "ok" and not res.degraded
    assert res.retries >= 1
    assert np.array_equal(res.perm, ref), "retry changed the ordering"
    assert svc.stats()["fault_retries"] >= 1
    assert _counter_fired("repro_service_retries_total")
    assert _counter_fired("repro_service_faults_injected_total")


def test_wave_transient_fault_retries_within_pump():
    g = G.grid2d(10, 10)
    svc0 = OrderingService()
    rid0 = svc0.submit(g, seed=0)
    ref = svc0.drain()[rid0].perm

    plan = faults.FaultPlan(seed=0, specs=[
        faults.FaultSpec(site="wave", kind="transient", at=(0,))])
    with faults.fault_injection(plan):
        svc = OrderingService()
        rid = svc.submit(g, seed=0)
        res = svc.drain()[rid]
    assert res.status == "ok" and res.retries >= 1
    assert np.array_equal(res.perm, ref)


# ------------------------------------------------------------------ #
# rung 2: kernel degrade — NaN corruption takes the validation path
# ------------------------------------------------------------------ #
def test_nan_corruption_degrades_and_recovers():
    g = G.grid2d(12, 12)
    svc0 = OrderingService()
    rid0 = svc0.submit(g, seed=3, nproc=2)
    ref = svc0.drain()[rid0].perm

    plan = faults.FaultPlan(seed=1, specs=[
        faults.FaultSpec(site="fm", kind="nan", at=(0,))])
    with faults.fault_injection(plan):
        svc = OrderingService()
        rid = svc.submit(g, seed=3, nproc=2)
        res = svc.drain()[rid]
        # a later clean request must not inherit the degrade (it is
        # per-request-sticky, not process-global)
        g2 = G.grid2d(9, 9)
        rid2 = svc.submit(g2, seed=0)
        res2 = svc.drain()[rid2]
    assert res.status == "ok" and res.degraded
    assert np.array_equal(res.perm, ref), \
        "degraded kernel path lost bit-parity"
    assert svc.stats()["degraded"] == 1
    assert _counter_fired("repro_service_degraded_total")
    assert res2.status == "ok" and not res2.degraded


# ------------------------------------------------------------------ #
# rung 3: excision + cold re-admission
# ------------------------------------------------------------------ #
def test_persistent_fm_excises_and_readmits_cold():
    g = G.grid2d(12, 12)
    svc0 = OrderingService()
    rid0 = svc0.submit(g, seed=3, nproc=2)
    ref = svc0.drain()[rid0].perm

    # the whole first fm chain fails: the group ladder burns fused /
    # hoisted / oracle (fm invocations 0-2), the isolation singleton
    # burns one more (3) — the tree is excised and re-admitted cold,
    # whose dispatches (4+) run clean
    plan = faults.FaultPlan(seed=1, specs=[
        faults.FaultSpec(site="fm", kind="persistent", at=(0, 1, 2, 3))])
    with faults.fault_injection(plan):
        svc = OrderingService()
        rid = svc.submit(g, seed=3, nproc=2)
        res = svc.drain()[rid]
    assert res.status == "ok"
    assert np.array_equal(res.perm, ref), \
        "excise + cold readmit lost bit-parity"
    assert svc._router.recovery.isolations >= 1
    assert _counter_fired("repro_service_readmits_total")


def test_unrecoverable_failure_fans_out_to_all_riders():
    """Satellite: a fingerprint that fails beyond the readmit budget
    resolves EVERY coalesced rider ``status=failed`` — none hang in
    ``poll()`` — while co-riding fingerprints of the same drain stay
    ``ok``, and nothing corrupt reaches the cache."""
    g_bad = G.grid2d(11, 11)
    g_ok = G.grid2d(9, 9)
    svc0 = OrderingService()
    rid0 = svc0.submit(g_ok, seed=0)
    ref_ok = svc0.drain()[rid0].perm

    svc = OrderingService()
    fp_bad = request_fingerprint(g_bad, 0, 1, svc.default_cfg)
    # tag-filtered unbounded corruption: every assembled result of the
    # doomed fingerprint is invalidated, exhausting its readmits
    plan = faults.FaultPlan(seed=0, specs=[
        faults.FaultSpec(site="result", kind="corrupt_perm", rate=1.0,
                         tag=fp_bad)])
    with faults.fault_injection(plan):
        rid_a = svc.submit(g_bad, seed=0)
        rid_b = svc.submit(g_bad, seed=0)       # coalesced duplicate
        rid_c = svc.submit(g_ok, seed=0)        # innocent co-rider
        svc.drain()
    for rid in (rid_a, rid_b, rid_c):
        assert svc.poll(rid) is not None, "rider hung in poll()"
    for rid in (rid_a, rid_b):
        res = svc.poll(rid)
        assert res.status == "failed" and res.perm is None
    assert svc.poll(rid_c).status == "ok"
    assert np.array_equal(svc.poll(rid_c).perm, ref_ok)
    assert fp_bad not in svc.cache, "corrupt fingerprint was cached"
    assert svc.stats()["failed"] == 2
    assert _counter_fired("repro_service_failed_total")


# ------------------------------------------------------------------ #
# rung 4: validation — never cache corrupt
# ------------------------------------------------------------------ #
def test_corrupt_result_readmits_and_never_caches():
    g = G.grid2d(10, 10)
    svc0 = OrderingService()
    rid0 = svc0.submit(g, seed=0)
    ref = svc0.drain()[rid0].perm

    plan = faults.FaultPlan(seed=0, specs=[
        faults.FaultSpec(site="result", kind="corrupt_perm", at=(0,))])
    with faults.fault_injection(plan):
        svc = OrderingService()
        rid = svc.submit(g, seed=0)
        res = svc.drain()[rid]
    assert res.status == "ok"
    assert np.array_equal(res.perm, ref)
    # the cached entry is the VALID re-run, not the corrupted first try
    fp = request_fingerprint(g, 0, 1, svc.default_cfg)
    cached = svc.cache.get(fp)
    assert cached is not None and np.array_equal(cached, ref)


def test_cache_put_rejects_non_permutation():
    cache = FingerprintCache(4)
    with pytest.raises(ValueError, match="refusing to cache"):
        cache.put("fp1", np.array([0, 0, 2]))           # duplicate
    with pytest.raises(ValueError, match="refusing to cache"):
        cache.put("fp2", np.array([0.5, 1.5]))          # not integers
    with pytest.raises(ValueError, match="refusing to cache"):
        cache.put("fp3", np.array([[0, 1]]))            # not 1-d
    assert len(cache) == 0
    cache.put("fp4", np.array([2, 0, 1]))
    assert len(cache) == 1


# ------------------------------------------------------------------ #
# satellite: pump unwind safety (the frontier survives a raise)
# ------------------------------------------------------------------ #
def test_pump_exception_restores_frontier(monkeypatch):
    g = G.grid2d(10, 10)
    svc0 = OrderingService()
    rid0 = svc0.submit(g, seed=1)
    ref = svc0.drain()[rid0].perm

    real = router_mod.execute_wave
    state = {"raised": False}

    def wedged(*args, **kwargs):
        if not state["raised"]:
            state["raised"] = True
            raise RuntimeError("wedged backend")
        return real(*args, **kwargs)

    monkeypatch.setattr(router_mod, "execute_wave", wedged)
    svc = OrderingService()
    rid = svc.submit(g, seed=1)
    with pytest.raises(RuntimeError, match="wedged backend"):
        svc.pump()
    # the frontier was restored on unwind: the suspended generator is
    # still resumable and the next drain completes bit-identically
    # (before the unwind fix this tripped "router finished with live
    # tasks" — the wave's tasks had been popped off the frontier)
    res = svc.drain()[rid]
    assert res.status == "ok"
    assert np.array_equal(res.perm, ref)


# ------------------------------------------------------------------ #
# satellite: straggler waves flagged via the router EWMA
# ------------------------------------------------------------------ #
def test_straggler_wave_flagged_and_counted():
    svc = OrderingService()
    rid0 = svc.submit(G.grid2d(10, 10), seed=0)
    svc.drain()                         # absorb compile-heavy waves
    assert svc.poll(rid0).status == "ok"
    assert svc._router.stats()["waves"] >= 1
    # re-seed the wave EWMA at steady-state scale, then inject one
    # delayed wave: 0.3s against a ~0.1ms EWMA is far beyond any factor
    svc._router._stragglers = StragglerMonitor(
        factor=svc._router.cfg.straggler_factor)
    svc._router._stragglers.observe(1e-4)
    obs.REGISTRY.reset()
    plan = faults.FaultPlan(seed=0, specs=[
        faults.FaultSpec(site="wave", kind="delay", delay_s=0.3,
                         rate=1.0, count=1)])
    with faults.fault_injection(plan):
        rid = svc.submit(G.grid2d(12, 12), seed=0)
        svc.drain()
    assert svc.poll(rid).status == "ok"
    st = svc.stats()["router"]
    assert st["straggler_waves"] >= 1
    assert st["wave_ewma_s"] > 0.0 and st["waves"] > 0
    assert _counter_fired("repro_router_straggler_waves_total")


# ------------------------------------------------------------------ #
# rung 5: deadline-feasibility shedding
# ------------------------------------------------------------------ #
def test_infeasible_deadline_shed_deterministically():
    svc = OrderingService()
    rid0 = svc.submit(G.grid2d(9, 9), seed=0, deadline_s=1000.0)
    svc.drain()                         # xs exec estimate now exists
    assert svc.poll(rid0).status == "ok"
    n_cache = len(svc.cache)

    shed_rids = [svc.submit(G.grid2d(9, 9 + k), seed=0, deadline_s=0.0)
                 for k in range(1, 4)]
    svc.drain()
    for rid in shed_rids:
        res = svc.poll(rid)
        assert res is not None, "shed rider hung in poll()"
        assert res.status == "shed" and res.perm is None
        assert res.deadline_missed is None      # never ran, never missed
        assert res.exec_s == 0.0
    st = svc.stats()
    assert st["shed"] == 3
    assert len(svc.cache) == n_cache, "shed request produced work"
    # shed never pollutes the SLO ledger
    assert st["deadline_miss_rate"] == 0.0
    assert _counter_fired("repro_service_shed_total")
    # feasible work still flows afterwards
    rid = svc.submit(G.grid2d(8, 8), seed=0, deadline_s=1000.0)
    svc.drain()
    assert svc.poll(rid).status == "ok"


def test_shedding_disabled_by_policy_config():
    from repro_torch.service.sched_policy import PolicyConfig, SchedPolicy
    svc = OrderingService(policy=SchedPolicy(PolicyConfig(
        shed_infeasible=False)))
    svc.submit(G.grid2d(9, 9), seed=0, deadline_s=1000.0)
    svc.drain()
    rid = svc.submit(G.grid2d(9, 10), seed=0, deadline_s=0.0)
    svc.drain()
    res = svc.poll(rid)
    assert res.status == "ok" and res.deadline_missed is True


def test_small_class_zero_miss_under_mixed_chaos_and_slo_load():
    """The PR 9 CI invariant, now under chaos: with transient faults
    and stragglers injected, feasible small-class requests still make
    their deadlines (recovery is bounded), infeasible ones shed
    cleanly, and every request reaches a terminal status."""
    # n ≥ 100: small enough to stay class xs, big enough that each
    # ordering rides real router waves the plan can actually hit
    graphs = [G.grid2d(10 + k, 10) for k in range(4)]
    svc0 = OrderingService()
    rids0 = [svc0.submit(g, seed=5) for g in graphs]
    svc0.drain()
    refs = [svc0.poll(r).perm for r in rids0]

    svc = OrderingService()
    svc.submit(G.grid2d(9, 9), seed=0, deadline_s=1000.0)
    svc.drain()                         # estimate for the shed check
    plan = faults.FaultPlan(seed=11, specs=[
        faults.FaultSpec(site="fm", kind="transient", rate=0.1, count=3),
        faults.FaultSpec(site="bfs", kind="delay", rate=0.1,
                         delay_s=0.01, count=5)])
    with faults.fault_injection(plan):
        ok_rids = [svc.submit(g, seed=5, deadline_s=1000.0)
                   for g in graphs]
        bad_rids = [svc.submit(G.grid2d(13, 9 + k), seed=0,
                               deadline_s=0.0) for k in range(2)]
        svc.drain()
    for rid in ok_rids + bad_rids:
        assert svc.poll(rid) is not None, "request hung under chaos"
    for rid, ref in zip(ok_rids, refs):
        res = svc.poll(rid)
        assert res.status == "ok"
        assert res.deadline_missed is False
        assert np.array_equal(res.perm, ref), \
            "chaos-recovered ordering lost bit-parity"
    for rid in bad_rids:
        assert svc.poll(rid).status == "shed"
    st = svc.stats()
    assert st["shed"] == 2 and st["failed"] == 0
    assert st["deadline_miss_rate"] == 0.0, \
        "small-class zero-miss invariant broken under chaos"


# ------------------------------------------------------------------ #
# the card's ladder: fused → hoisted, then isolate and excise
# ------------------------------------------------------------------ #
def test_two_rung_ladder_degrades_to_hoisted_and_never_the_oracle(
        monkeypatch):
    """The router with the card's ladder (fused, hoisted), on the CPU:
    a NaN-corrupted fused dispatch degrades to hoisted; a persistent
    fault at both rungs isolates the group, excises the tree and
    re-admits it cold; no FM dispatch ever runs the oracle, and every
    ``ok`` result is the fault-free one."""
    g = G.grid2d(12, 12)
    svc0 = OrderingService()
    rid0 = svc0.submit(g, seed=3, nproc=2)
    ref = svc0.drain()[rid0].perm

    monkeypatch.setattr(router_mod, "fm_ladder_modes",
                        lambda device: ops.FM_MODES[:2])
    modes = []
    real = ops.fm_refine_batch

    def recorded(*args, mode=None, **kw):
        modes.append(mode)
        return real(*args, mode=mode, **kw)
    monkeypatch.setattr(ops, "fm_refine_batch", recorded)

    nan = faults.FaultPlan(seed=1, specs=[
        faults.FaultSpec(site="fm", kind="nan", at=(0,))])
    with faults.fault_injection(nan):
        svc = OrderingService()
        assert svc._router.recovery.modes == ("fused", "hoisted")
        rid = svc.submit(g, seed=3, nproc=2)
        res = svc.drain()[rid]
    assert res.status == "ok" and res.degraded
    assert np.array_equal(res.perm, ref)
    assert modes[:2] == ["fused", "hoisted"]

    modes.clear()
    persistent = faults.FaultPlan(seed=1, specs=[
        faults.FaultSpec(site="fm", kind="persistent", at=(0, 1, 2))])
    with faults.fault_injection(persistent) as inj:
        svc = OrderingService()
        rid = svc.submit(g, seed=3, nproc=2)
        res = svc.drain()[rid]
    assert inj.injected == 3
    assert res.status == "ok"
    assert np.array_equal(res.perm, ref)
    assert svc._router.recovery.isolations >= 1
    assert set(modes) <= {"fused", "hoisted"} and "hoisted" in modes


def test_oracle_default_is_refused_off_the_ladder(monkeypatch):
    monkeypatch.setattr(router_mod, "fm_ladder_modes",
                        lambda device: ops.FM_MODES[:2])
    monkeypatch.setenv("REPRO_FM_MODE", "oracle")
    with pytest.raises(ValueError):
        OrderingService()


def test_fault_hook_sees_host_arrays():
    """Each executor's dispatch ends in the download: the hook's thunk
    returns host numpy arrays."""
    from repro_torch.core.band import BFSWork, execute_bfs_works
    seen = []

    def hook(kind, thunk):
        out = thunk()
        seen.append((kind, type(out)))
        return out
    prev = obs.set_fault_hook(hook)
    try:
        g = G.grid2d(6, 6)
        nbr, _ = g.to_ell()
        execute_bfs_works([BFSWork(nbr=nbr, src=np.arange(g.n) == 0,
                                   width=3)], "cpu")
    finally:
        obs.set_fault_hook(prev)
    assert seen == [("bfs", np.ndarray)]
