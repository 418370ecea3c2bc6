"""The readers of the program's spans and of the FM kernel's tally, on
synthetic windows: each reads its span (or tally) per ordering or per
resolved request, and gives None where the program opened nothing for it
to read, as a program without these spans does."""
from __future__ import annotations

import types

import pytest

from orderbench import harness

SPAN_S = {"fm:pack": 3.0, "nd:initial": 1.5, "router:advance": 8.0,
          "nd:ell": 0.9, "dnd:band": 0.6}
SELF_S = {"fm:pack": 1.0, "nd:initial": 1.5, "nd:ell": 0.9,
          "coarsen:build": 0.4, "band:extract": 0.2, "dnd:band": 0.5,
          "router:advance": 2.0, "stage:rebuild": 7.0, "fm:lanes": 2.0}


def window(span_s=None, span_self_s=None, orderings=(True, True, False),
           requests=("ok", "ok", "ok", "failed"), launches=(),
           profile=None, ins=True):
    w = harness.Window()
    w.orderings = [{"ok": ok} for ok in orderings]
    w.requests = [{"status": s} for s in requests]
    if ins:
        w.ins = types.SimpleNamespace(launches=list(launches))
        if span_s is not None:
            w.ins.span_s, w.ins.span_self_s = span_s, span_self_s
    w.profile = profile
    return w


def read(name, w):
    return harness.reader(name)(w)


def test_per_ordering_span_seconds():
    w = window(SPAN_S, SELF_S)
    assert read("fm_pack_s.order", w) == pytest.approx(1.5)
    assert read("initsep_s.order", w) == pytest.approx(0.75)
    # self seconds of nd:*, coarsen:*, band:*, dnd:* but nd:initial
    assert read("nd_host_s.order", w) == pytest.approx(
        (0.9 + 0.4 + 0.2 + 0.5) / 2)


def test_per_request_span_seconds():
    w = window(SPAN_S, SELF_S)
    assert read("task_host_s.stream", w) == pytest.approx(8.0 / 3)
    assert read("fm_pack_s.stream", w) == pytest.approx(1.0)


@pytest.mark.parametrize("name", [
    "fm_pack_s.order", "initsep_s.order", "nd_host_s.order",
    "task_host_s.stream", "fm_pack_s.stream"])
def test_span_readers_none_without_their_span(name):
    # a program whose instrument record has no span sums (the parent's)
    assert read(name, window()) is None
    # a traced run in which the span never opened
    assert read(name, window({"other": 1.0}, {"other": 1.0})) is None
    # nothing resolved or ordered to divide by
    empty = window(SPAN_S, SELF_S, orderings=(False,), requests=("shed",))
    assert read(name, empty) is None


def test_fm_step_ns_reads_kernel_time_over_the_tally():
    """Kernel time over each launch's longest lane, summed: the sum over
    lanes run side by side is not the yardstick."""
    profile = {"kernel_s": {"ns::fm_fused_kernel<3>": 0.002,
                            "ns::fm_fused_kernel<4>": 0.001,
                            "ns::match_lanes<true>": 5.0}}
    launches = [{"kind": "fm", "steps": 1000, "ops": 9000,
                 "steps_max": 400},
                {"kind": "fm", "steps": 500, "ops": 4000, "steps_max": 200},
                {"kind": "match"}]
    w = window(launches=launches, profile=profile)
    assert read("fm_step_ns.order", w) == pytest.approx(0.003 / 600 * 1e9)
    # the same launches cut into more lanes: the same critical path
    split = [dict(d, steps=2 * d["steps"]) if d["kind"] == "fm" else d
             for d in launches]
    assert read("fm_step_ns.order", window(launches=split,
                                           profile=profile)) == \
        read("fm_step_ns.order", w)


@pytest.mark.parametrize("case", ["no_profile", "no_tally", "no_kernel",
                                  "no_ins"])
def test_fm_step_ns_none_without_trace_or_tally(case):
    profile = {"kernel_s": {"ns::fm_fused_kernel<3>": 0.002}}
    launches = [{"kind": "fm", "steps": 1000, "ops": 9000,
                 "steps_max": 400}]
    if case == "no_profile":
        w = window(launches=launches)
    elif case == "no_tally":
        w = window(launches=[{"kind": "fm"}], profile=profile)
    elif case == "no_kernel":
        w = window(launches=launches, profile={"kernel_s": {"x": 1.0}})
    else:
        w = window(profile=profile, ins=False)
    assert read("fm_step_ns.order", w) is None
