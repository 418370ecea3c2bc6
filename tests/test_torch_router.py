"""The port's wave router and pump policy, on the CPU.

Ports of ``tests/test_router.py``'s host cases and
``tests/test_sched_policy.py``, and a host-graph counterpart of the
reference's cross-request launch-budget test: concurrent orderings
drained through ONE router are bit-identical to single drains, every
wave's launches equal its live buckets, some launch serves lanes of two
requests, and the shared drain needs fewer launches than sequential
drains.  Exact equality is the tolerance throughout.
"""
import numpy as np
import pytest

from repro_torch import obs
from repro_torch.core.band import BFSWork
from repro_torch.core.coarsen import match_work_for
from repro_torch.core.nd import NDConfig, nested_dissection
from repro_torch.core.ordering import Ordering
from repro_torch.graphs import generators as G
from repro_torch.obs.instrument import instrument
from repro_torch.service.api import size_class
from repro_torch.service.batch import drive_tasks, run_works
from repro_torch.service.router import (RouterConfig, WaveRouter,
                                        drive_frontier, execute_wave,
                                        fm_ladder_modes, work_kind)
from repro_torch.service.sched_policy import (CLASS_ORDER, DEFAULT_SLO_S,
                                              PolicyConfig, ReqMeta,
                                              SchedPolicy, class_rank)
from repro_torch.service.scheduler import order_batch, request_task

CPU = "cpu"


# ------------------------------------------------------------------ #
# router surface
# ------------------------------------------------------------------ #
def test_work_kind_rejects_unknown():
    with pytest.raises(TypeError):
        work_kind(object())
    with pytest.raises(TypeError):
        execute_wave([object()], device=CPU)
    with pytest.raises(TypeError):
        execute_wave([[object()]], device=CPU)


def test_router_config_defaults(monkeypatch):
    cfg = RouterConfig()
    assert cfg.straggler_factor > 1
    assert WaveRouter(device=CPU).cfg == cfg
    for gone in ("mesh", "match_compact", "jit_cache_capacity", "apply",
                 "frontier_waves", "max_wave_works", "pump_wave_budget"):
        assert not hasattr(cfg, gone)
    monkeypatch.setenv("REPRO_STRAGGLER_FACTOR", "2.5")
    assert WaveRouter(device=CPU).cfg.straggler_factor == 2.5


def test_fm_ladder_ends_at_hoisted_on_the_card():
    assert fm_ladder_modes(CPU) == ("fused", "hoisted", "oracle")
    try:
        modes = fm_ladder_modes("cuda")
    except RuntimeError:                # no card here: the card's ladder
        return                          # is checked by the cuda tests
    assert modes == ("fused", "hoisted")


def test_run_works_and_drive_tasks_match_singletons():
    gs = [G.grid2d(9, 9), G.grid2d(8, 10), G.grid3d(4, 4, 5)]
    works = []
    for i, g in enumerate(gs):
        nbr, _ = g.to_ell()
        works.append(BFSWork(nbr=nbr, src=np.arange(g.n) == i, width=3))
        works.append(match_work_for(g, i))
    together = run_works(works, CPU)
    for w, got in zip(works, together):
        assert np.array_equal(got, run_works([w], CPU)[0])
    orderings = [Ordering(g.n) for g in gs]
    drive_tasks([request_task(g, i, 2, NDConfig(), o)
                 for i, (g, o) in enumerate(zip(gs, orderings))], CPU)
    for i, (g, o) in enumerate(zip(gs, orderings)):
        assert np.array_equal(o.assemble(),
                              nested_dissection(g, i, 2, device=CPU))


def test_concurrent_orderings_share_launches_within_budget():
    """3 concurrent orderings through one router == 3 single drains, bit
    for bit; launches == live buckets in every wave; some launch serves
    two requests; fewer launches than the sequential drains."""
    graphs = [G.grid2d(16, 20), G.grid2d(16, 18), G.rgg2d(320, seed=4)]
    seeds = [3, 11, 7]
    with instrument() as ins_seq:
        singles = [order_batch([g], s, 4, device=CPU)[0]
                   for g, s in zip(graphs, seeds)]
    with instrument() as ins_con:
        batch = order_batch(graphs, seeds, 4, device=CPU)
    for g, s, a, b in zip(graphs, seeds, singles, batch):
        assert np.array_equal(a, b)
        assert np.array_equal(a, nested_dissection(g, s, 4, device=CPU))
    perm = [2, 0, 1]
    batch_p = order_batch([graphs[i] for i in perm],
                          [seeds[i] for i in perm], 4, device=CPU)
    assert all(np.array_equal(singles[i], p) for i, p in zip(perm, batch_p))

    waves = ins_con.waves
    assert waves and all(
        w["launches"][k] == w["buckets"][k] <= w["works"][k]
        for w in waves for k in w["launches"])
    assert sum(1 for w in waves if w["requests"] >= 2) > 0
    assert sum(w["shared_launches"] for w in waves) > 0
    assert len(ins_con.launches) < len(ins_seq.launches), \
        (len(ins_con.launches), len(ins_seq.launches))
    # the instrument records are the executors' dispatches, one a bucket
    assert sum(sum(w["launches"].values()) for w in waves) == \
        len(ins_con.launches)


def test_pump_parks_unselected_tags_and_resumes_them():
    g = G.grid2d(14, 14)
    want = nested_dissection(g, 2, 2, device=CPU)
    router = WaveRouter(device=CPU)
    o_a, o_b = Ordering(g.n), Ordering(g.n)
    router.submit(request_task(g, 2, 2, NDConfig(), o_a), tag="a")
    router.submit(request_task(g, 2, 2, NDConfig(), o_b), tag="b")
    assert router.pump(max_waves=3, select={"a"}) == 3
    while router.pump(max_waves=1, select={"a"}):
        pass
    assert [t for t, _ in router.pop_completed()] == ["a"]
    assert router.live_tags() == ["b"]
    router.run()
    assert [t for t, _ in router.pop_completed()] == ["b"]
    assert np.array_equal(o_a.assemble(), want)
    assert np.array_equal(o_b.assemble(), want)


def test_tracing_spans_wrap_waves_and_dispatches(tmp_path):
    g = G.grid2d(12, 12)
    ordering = Ordering(g.n)
    with obs.tracing() as tracer:
        root = request_task(g, 1, 2, NDConfig(), ordering)
        assert drive_frontier(root, device=CPU) is None
    assert np.array_equal(ordering.assemble(),
                          nested_dissection(g, 1, 2, device=CPU))
    names = {s.name for s in tracer.spans}
    assert {"router:wave", "dispatch:match", "dispatch:bfs",
            "dispatch:fm"} <= names
    by_id = {s.span_id: s for s in tracer.spans}
    for s in tracer.spans:
        if s.name.startswith("dispatch:"):
            assert by_id[s.parent_id].name == "router:wave"
    path = tmp_path / "trace.json"
    tracer.export_chrome(str(path))
    back = obs.load_chrome(str(path))
    assert sorted(s.name for s in back) == sorted(s.name for s in
                                                  tracer.spans)


def test_first_use_bills_one_compile_per_load_key():
    key = ("test-load-key", id(object()))
    assert obs.first_use(key) and not obs.first_use(key)
    obs.forget_use(key)
    assert obs.first_use(key)
    obs.REGISTRY.inc("repro_test_total", 2, kind="x")
    assert 'repro_test_total{kind="x"} 2' in \
        obs.REGISTRY.render_prometheus()


# ------------------------------------------------------------------ #
# the pump policy (a copy of the reference's; pure host)
# ------------------------------------------------------------------ #
def _m(tag, cls, t=0.0, deadline=None):
    return ReqMeta(tag=tag, size_class=cls, t_enqueue=t, deadline=deadline)


def test_size_class_and_rank():
    assert size_class(1) == "xs" and size_class(8192) == "l"
    assert [class_rank(c) for c in CLASS_ORDER] == [0, 1, 2, 3]
    assert class_rank("weird") == len(CLASS_ORDER)   # sorts last


def test_admit_order_class_then_edf_then_fifo():
    pol = SchedPolicy()
    queued = [
        _m("l1", "l", t=0.0),
        _m("xs_late", "xs", t=2.0),
        _m("xs_early", "xs", t=1.0),
        _m("s_tight", "s", t=3.0, deadline=3.5),
        _m("s_loose", "s", t=0.5),           # SLO deadline 0.5 + 1.0 = 1.5
    ]
    plan = pol.plan(queued, [], now=3.0)
    assert plan.admit == ["xs_early", "xs_late", "s_loose", "s_tight", "l1"]


def test_small_preempts_large():
    pol = SchedPolicy()
    plan = pol.plan([_m("small", "xs", t=10.0)],
                    [_m("big", "l", t=0.0, deadline=1000.0)], now=10.0)
    assert "small" in plan.active
    assert "big" in plan.parked
    plan = pol.plan([], [_m("big", "l", t=0.0, deadline=1000.0)], now=11.0)
    assert plan.active == {"big"}
    assert not plan.parked


def test_non_preemptible_classes_always_run():
    pol = SchedPolicy()
    plan = pol.plan([], [_m("a", "xs", t=0.0), _m("b", "s", t=0.0),
                         _m("c", "m", t=0.0, deadline=1000.0)], now=0.0)
    assert {"a", "b"} <= plan.active
    assert "c" in plan.parked


def test_deadline_rescue():
    pol = SchedPolicy(PolicyConfig(rescue_margin_s=0.25))
    big = _m("big", "l", t=0.0, deadline=10.0)
    small = _m("small", "xs", t=0.0)
    assert "big" in pol.plan([], [big, small], now=5.0).parked
    assert "big" in pol.plan([], [big, small], now=9.8).active


def test_park_aging():
    pol = SchedPolicy(PolicyConfig(max_park_s=2.0))
    big = _m("big", "l", t=0.0, deadline=1e9)
    small = _m("small", "xs", t=0.0, deadline=1e9)
    assert "big" in pol.plan([], [big, small], now=0.0).parked
    assert "big" in pol.plan([], [big, small], now=1.0).parked
    assert "big" in pol.plan([], [big, small], now=2.5).active
    assert "big" in pol.plan([], [big, small], now=3.0).parked


def test_never_empty_active_set():
    pol = SchedPolicy()
    plan = pol.plan([], [_m("a", "m", t=0.0, deadline=1e9),
                         _m("b", "l", t=0.0, deadline=1e9)], now=0.0)
    assert "a" in plan.active
    assert plan.max_waves >= 1


def test_default_slo_effective_deadlines():
    for cls in CLASS_ORDER:
        m = _m("x", cls, t=5.0)
        assert m.effective_deadline() == pytest.approx(
            5.0 + DEFAULT_SLO_S[cls])
    assert _m("x", "xs", t=5.0, deadline=5.1).effective_deadline() == 5.1


def test_active_parked_partition_live_set():
    pol = SchedPolicy()
    queued = [_m(f"q{i}", "xs", t=float(i)) for i in range(3)]
    inflight = [_m(f"f{i}", "l", t=0.0, deadline=1e9) for i in range(2)]
    plan = pol.plan(queued, inflight, now=5.0)
    live = {m.tag for m in queued} | {m.tag for m in inflight}
    assert plan.active | plan.parked == live
    assert not (plan.active & plan.parked)
    assert set(plan.admit) == {m.tag for m in queued}


def test_shed_only_explicit_infeasible_deadlines():
    pol = SchedPolicy(PolicyConfig(shed_infeasible=True, shed_factor=1.0))
    queued = [_m("late", "xs", t=0.0, deadline=0.1),
              _m("slo", "xs", t=0.0),
              _m("fine", "xs", t=0.0, deadline=10.0),
              _m("unmeasured", "m", t=0.0, deadline=0.1)]
    plan = pol.plan(queued, [], now=0.05, exec_est={"xs": 0.2})
    assert plan.shed == ["late"]
    assert set(plan.admit) == {"slo", "fine", "unmeasured"}
