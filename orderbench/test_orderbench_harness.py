"""The harness finds its parts by name, its mix is a function of the seed,
and a run's last line has the contract's keys (on the CPU, small)."""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from orderbench import check, gen, harness, testing

ROOT = Path(__file__).resolve().parents[1]
BENCH = harness.bench_file()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_parts_found_by_name(cell):
    found, cfg, traffic = harness.find(BENCH, cell)
    assert cfg["name"] == found["config"]
    assert traffic["entry"] in ("nested_dissection", "service",
                                "distributed_nested_dissection")
    for traced in (False, True):
        metrics = harness.metrics_of(BENCH, cell, traced)
        assert metrics, (cell, traced)
        for m in metrics:
            assert callable(harness.reader(m["name"]))


def test_every_metric_has_a_reader_and_each_reader_a_metric():
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {p.name[:-3] for p in (ROOT / "orderbench/metrics").glob("*.py")}
    assert names == files


def test_benchmark_file_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200
        reports = [m for m in BENCH["end_to_end"]
                   if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reports) >= 2
        assert harness.metrics_of(BENCH, w["name"], True)
    for x in (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
              + BENCH["per_layer"]):
        assert NAME.match(x["name"]), x["name"]


def test_mix_is_a_function_of_the_seed():
    cfg = json.loads((ROOT / "orderbench/configs/patterns-mix-noband.json")
                     .read_text())
    a = gen.pattern_stream(cfg, 2 ** 31 + 17, 200)
    assert a == gen.pattern_stream(cfg, 2 ** 31 + 17, 200)
    b = gen.pattern_stream(cfg, 2 ** 31 + 18, 200)
    assert a != b
    deck = len(cfg["families"]) * cfg["sizes"]
    # every seed deals the same (family, size) slots, in another order,
    # and each block of a size per family and bin carries the same work
    block = len(cfg["families"]) * cfg["bins"]
    sizes = sorted({p.n for p in a})
    assert len(sizes) == cfg["sizes"]
    bin_of = {n: i // (cfg["sizes"] // cfg["bins"])
              for i, n in enumerate(sizes)}
    for s in (a, b):
        for start in range(0, deck, block):
            got = sorted((p.family, bin_of[p.n]) for p in s[start:start + block])
            assert got == sorted((f, k) for f in cfg["families"]
                                 for k in range(cfg["bins"]))
    assert sorted((p.family, p.n) for p in a[:deck]) == \
        sorted((p.family, p.n) for p in b[:deck])
    assert all(cfg["n_min"] <= p.n <= cfg["n_max"] for p in a)
    assert len({(p.family, p.n, p.graph_seed, p.order_seed) for p in a}) \
        == len(a)
    ga = gen.family_graph(a[0].family, a[0].n, a[0].graph_seed)
    gb = gen.family_graph(a[0].family, a[0].n, a[0].graph_seed)
    assert all((getattr(ga, k) == getattr(gb, k)).all()
               for k in ("xadj", "adjncy", "adjwgt"))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_requires_the_kinds_its_path_calls(cell):
    """A cell has to make every sampled kind of call but the band's when
    its configuration refines without the band graph."""
    _, cfg, traffic = harness.find(BENCH, cell)
    must = check.required(cfg, traffic)
    assert {"match", "fm"} <= set(must)
    assert ("dmatch" in must) == (traffic["entry"] ==
                                  "distributed_nested_dissection")
    band = dict(cfg, nd_config=dict(cfg["nd_config"], use_band=True))
    assert set(must) == set(check.required(band, traffic)) - \
        set(check.BAND_KINDS)
    assert cfg["nd_config"]["use_band"] is False
    assert "use_band" in cfg["reduced"]


def test_a_required_kind_never_called_is_unchecked():
    checks, _ = check.kernel_checks([], {"match": 3}, {}, ["match", "fm"])
    got = {name: v for name, v, _ in checks}
    assert got["unchecked"] == 2 and got["fmpack_bad"] == 0


@pytest.mark.parametrize("family", gen.FAMILIES)
def test_generated_graphs_are_symmetric_and_connected(family):
    g = gen.family_graph(family, 700, 3)
    src = np.repeat(np.arange(g.n), np.diff(g.xadj))
    fwd = set(zip(src.tolist(), g.adjncy.tolist()))
    assert fwd == {(b, a) for a, b in fwd}
    assert all(a != b for a, b in fwd)


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_keys(traced):
    out = testing.cpu_run("m3d-30-noband.single", traced=traced)
    res = out["result"]
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    want = {m["name"] for m in harness.metrics_of(
        BENCH, "m3d-30-noband.single", traced)}
    # a CPU run has no device trace: those metrics stay out of the line
    traced_only = {m["name"] for m in BENCH["per_layer"]
                   if m["source"] == "device_trace"}
    assert set(res["metrics"]) == want - traced_only
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    json.dumps(res, allow_nan=False)


def test_run_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, "orderbench/run.py", "--workload", "m3d-30-noband.single",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


