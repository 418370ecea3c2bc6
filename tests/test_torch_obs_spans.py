"""The ordering's program spans: named where the host work happens, their
seconds on the event bus while a tracer is installed, nothing emitted
without one, the orderings unchanged, and one clock with the profiler.

CPU, small graphs: a traced ``nested_dissection`` of grid3d(8, 8, 8), a
``distributed_nested_dissection`` of it over 4 parts (bands of more than
64 vertices refined sharded), and a 3-request ``OrderingService`` drain.
Each runs once traced and once not (module fixtures).  The FM kernel's
tally, which only the card computes, has its test at the end, marked
``cuda``.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import dgraph, dnd
from repro_torch.core.nd import nested_dissection
from repro_torch.graphs.generators import grid2d, grid3d
from repro_torch.obs.instrument import instrument
from repro_torch.scripts import trace_summary
from repro_torch.service import OrderingService

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from orderbench import stages  # noqa: E402

CPU = "cpu"
#: the service's retrospective spans (``Tracer.add_span``), which emit
#: nothing
RETRO = {"request", "queue_wait", "exec"}

ND_SPANS = {
    "nd:ell", "nd:components", "nd:split", "nd:check", "nd:project",
    "nd:initial", "nd:leaf", "nd:assemble", "coarsen:build",
    "coarsen:work", "match:pack", "match:upload", "match:launch",
    "match:download", "fm:pack", "fm:lanes", "fm:keys", "fm:extents",
    "fm:check_spans", "fm:upload", "fm:launch", "fm:download",
    "fm:select", "band:extract", "band:project", "bfs:pack",
    "dispatch:fm", "dispatch:match", "dispatch:bfs"}
DND_SPANS = {
    "dnd", "dnd:split", "dnd:defer", "dnd:induced", "dnd:coarsen",
    "dnd:gather", "dnd:project", "dnd:scatter", "dnd:band", "dnd:assemble",
    "stage:rebuild", "stage:endgame", "router:advance", "router:wave",
    "sched:batch", "nd:initial", "nd:leaf", "fm:pack", "fm:launch"}
SERVICE_SPANS = {
    "sched:pump", "router:advance", "router:wave", "nd:split", "nd:leaf",
    "nd:initial", "nd:assemble", "coarsen:build", "fm:pack", "fm:select"}


class _Events:
    """A collector that keeps every event of the bus, in order."""

    def __init__(self):
        self.events = []

    def on_event(self, kind, payload):
        self.events.append((kind, dict(payload)))


def _run(fn, traced):
    """``fn()`` under an ``instrument()`` block and an event recorder,
    with a tracer installed when ``traced``; returns (value, ins, events,
    tracer or None)."""
    rec = _Events()
    obs.register_collector(rec)
    try:
        with instrument() as ins:
            if traced:
                with obs.tracing() as tracer:
                    out = fn()
            else:
                tracer, out = None, fn()
    finally:
        obs.unregister_collector(rec)
    return out, ins, rec.events, tracer


def _nd():
    return nested_dissection(grid3d(8, 8, 8), seed=3, nproc=8, device=CPU)


def _dnd():
    dg = dgraph.distribute(grid3d(8, 8, 8), 4)
    cfg = dnd.DNDConfig(band_central_threshold=64)
    return dnd.distributed_nested_dissection(dg, seed=5, cfg=cfg,
                                             device=CPU)


def _service():
    svc = OrderingService(device=CPU)
    graphs = [grid3d(6, 6, 6), grid2d(14, 14), grid3d(7, 6, 5)]
    rids = [svc.submit(g, seed=7 + k, nproc=4) for k, g in
            enumerate(graphs)]
    svc.drain()
    return [svc.poll(r).perm for r in rids]


RUNS = {"nd": (_nd, ND_SPANS), "dnd": (_dnd, DND_SPANS),
        "service": (_service, SERVICE_SPANS)}


@pytest.fixture(scope="module", params=sorted(RUNS))
def runs(request):
    fn, want = RUNS[request.param]
    return dict(want=want, plain=_run(fn, False), traced=_run(fn, True))


def test_each_driver_opens_the_named_spans(runs):
    _, ins, _, tracer = runs["traced"]
    opened = {s.name for s in tracer.spans}
    assert runs["want"] <= opened, sorted(runs["want"] - opened)
    assert runs["want"] <= set(ins.span_s)


def test_orderings_bit_identical_with_tracing(runs):
    plain, traced = runs["plain"][0], runs["traced"][0]
    if isinstance(plain, np.ndarray):
        plain, traced = [plain], [traced]
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert a is not None and np.array_equal(a, b)


def test_self_seconds_sum_to_the_roots(runs):
    _, ins, _, tracer = runs["traced"]
    emitted = [s for s in tracer.spans if s.name not in RETRO]
    ids = {s.span_id for s in emitted}
    roots = sum(s.t1 - s.t0 for s in emitted if s.parent_id not in ids)
    total_self = sum(ins.span_self_s.values())
    assert roots > 0
    # the spans' own bookkeeping is billed to no span's self seconds
    assert 0 <= tracer.cost_s
    assert abs(total_self + tracer.cost_s - roots) <= 0.02 * roots
    # a span's self time is its own duration less its children's
    for name, self_s in ins.span_self_s.items():
        assert -1e-9 <= self_s <= ins.span_s[name] + 1e-9, name


def test_one_key_span_a_bucket(runs):
    """The FM lanes' keys are split once a bucket: one ``fm:keys`` a
    ``fm:pack``, its child, counting the bucket's real lanes."""
    _, ins, _, tracer = runs["traced"]
    by_id = {s.span_id: s for s in tracer.spans}
    packs = [s for s in tracer.spans if s.name == "fm:pack"]
    keys = sorted((s for s in tracer.spans if s.name == "fm:keys"),
                  key=lambda s: s.t0)
    assert packs and len(keys) == len(packs)
    assert sorted(s.parent_id for s in keys) == \
        sorted(s.span_id for s in packs)
    assert all(by_id[s.parent_id].name == "fm:pack" for s in keys)
    lanes = [d["lanes"] for d in ins.launches if d["kind"] == "fm"]
    assert [s.attrs["lanes"] for s in keys] == lanes


def test_no_span_event_without_a_tracer(runs):
    _, ins, events, _ = runs["plain"]
    kinds = {k for k, _ in events}
    assert "span" not in kinds and {"stage", "launch"} <= kinds
    assert ins.span_s == {} and ins.span_self_s == {}
    traced_kinds = {k for k, _ in runs["traced"][2]}
    assert "span" in traced_kinds


def _by_kind(events):
    col = stages.ByKind()
    for kind, payload in events:
        col.on_event(kind, payload)
    return col.seconds


def test_by_kind_unmoved_by_span_events(runs):
    """``stages.ByKind`` bills each stage event to the next launch: the
    span events in between bill nothing and move nothing."""
    events = runs["traced"][2]
    with_spans = _by_kind(events)
    assert with_spans == _by_kind([e for e in events if e[0] != "span"])
    assert with_spans.get("fm", 0) > 0 and with_spans.get("match", 0) > 0

    def billing(evs):
        return [(k, p.get("name", p.get("kind"))) for k, p in evs
                if k in ("stage", "launch")]
    assert billing(events) == billing(runs["plain"][2])
    assert set(with_spans) == set(_by_kind(runs["plain"][2]))


def test_fm_launch_records_carry_no_tally_on_the_cpu(runs):
    """The tally is the card kernel's; the plain versions have none."""
    _, ins, _, _ = runs["traced"]
    fm_launches = [d for d in ins.launches if d["kind"] == "fm"]
    assert fm_launches
    assert not any("steps" in d for d in fm_launches)


# ------------------------------------------------------------------ #
# one clock with the profiler
# ------------------------------------------------------------------ #
def test_spans_share_the_profilers_clock(tmp_path):
    a = torch.randn(384, 384)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof, \
            obs.tracing() as tracer:
        with obs.span("mm"):
            torch.mm(a, a)
    sp = next(s for s in tracer.spans if s.name == "mm")
    lo, hi = tracer.profiler_ns(sp.t0), tracer.profiler_ns(sp.t1)
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert mm
    a0, a1 = mm[0].start_ns(), mm[0].start_ns() + mm[0].duration_ns()
    assert lo - 10 ** 6 <= a0 <= a1 <= hi + 10 ** 6

    # both exported traces on one clock, with one base: the op under
    # its span
    theirs = tmp_path / "profile.json"
    prof.export_chrome_trace(str(theirs))
    doc = json.loads(theirs.read_text())
    op = next(ev for ev in doc["traceEvents"] if ev.get("name") == "aten::mm")
    mine = tmp_path / "spans.json"
    tracer.export_chrome(str(mine))
    ours = json.loads(mine.read_text())
    assert ours["baseTimeNanoseconds"] == int(doc["baseTimeNanoseconds"])
    ev = next(e for e in ours["traceEvents"] if e["name"] == "mm")
    assert ev["ts"] - 1e3 <= op["ts"]
    assert op["ts"] + op["dur"] <= ev["ts"] + ev["dur"] + 1e3

    # the file reads back, and trace_summary still reads it
    back = obs.load_chrome(str(mine))
    assert [s.name for s in back] == ["mm"]
    assert abs(back[0].t0 * 1e9 + ours["baseTimeNanoseconds"] - lo) < 1e3
    assert trace_summary.main([str(mine)]) == 0


def test_traced_decorator_opens_its_span_inside_a_wrapper():
    """A caller that wraps the function by name finds the span inside
    its wrapper, and an untraced call opens nothing."""
    @obs.traced("test:inner")
    def inner(x):
        return x + 1

    def outer(x):
        with obs.span("test:outer"):
            return inner(x)

    assert inner(1) == 2
    with obs.tracing() as tracer:
        assert outer(2) == 3
    by_name = {s.name: s for s in tracer.spans}
    assert by_name["test:inner"].parent_id == by_name["test:outer"].span_id
    assert inner.__name__ == "inner"


def test_traced_generator_spans_each_resumption():
    """On a generator function the span covers the host work between
    yields, opened in the resumer's context; sends, throws and the
    return value pass through, and untraced it is the bare generator."""
    @obs.traced("test:task")
    def task(x):
        got = yield x + 1
        try:
            yield got * 2
        except KeyError as e:
            yield str(e.args[0])
        return got + 10

    def drive(gen):
        seen = [next(gen), gen.send(5), gen.throw(KeyError("k"))]
        try:
            gen.send(None)
        except StopIteration as stop:
            return seen, stop.value

    assert drive(task(1)) == ([2, 10, "k"], 15)
    with obs.tracing() as tracer:
        with obs.span("test:driver"):
            assert drive(task(1)) == ([2, 10, "k"], 15)
    driver = next(s for s in tracer.spans if s.name == "test:driver")
    inner = [s for s in tracer.spans if s.name == "test:task"]
    assert len(inner) == 4              # three yields and the return
    assert all(s.parent_id == driver.span_id for s in inner)

    # closing the wrapper closes the generator it wraps
    closed = []

    @obs.traced("test:closing")
    def closing():
        try:
            yield 1
            yield 2
        finally:
            closed.append(True)
    with obs.tracing():
        gen = closing()
        next(gen)
        gen.close()
    assert closed == [True]


# ------------------------------------------------------------------ #
# on the card: the FM kernel's tally in the launch records
# ------------------------------------------------------------------ #
@pytest.mark.cuda
def test_traced_fm_launches_carry_the_kernels_tally():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the FM kernel's tally is "
                    "computed on the card only")
    g = grid3d(8, 8, 8)
    with instrument() as plain:
        want = nested_dissection(g, seed=3, nproc=8, device="cuda")
    with instrument() as ins, obs.tracing():
        got = nested_dissection(g, seed=3, nproc=8, device="cuda")
    assert np.array_equal(got, want)
    fm_launches = [d for d in ins.launches if d["kind"] == "fm"]
    assert fm_launches
    assert all(d["steps"] >= 0 and d["ops"] >= 0 for d in fm_launches)
    assert all(0 <= d["steps_max"] <= d["steps"] for d in fm_launches)
    assert all(d["steps_max"] * d["lanes"] >= d["steps"]
               for d in fm_launches)
    assert sum(d["steps_max"] for d in fm_launches) > 0
    assert sum(d["ops"] for d in fm_launches) > \
        sum(d["steps"] for d in fm_launches)
    assert not any("steps" in d for d in plain.launches)
