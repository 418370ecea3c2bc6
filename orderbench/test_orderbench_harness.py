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


def band_contract(cfg: dict, traffic: dict) -> list:
    """The rules a configuration and its cell's traffic keep about the
    band graph, whichever way the configuration sets it; returns the
    rules broken.  ``use_band`` is off exactly where ``reduced`` names it
    (the published strategy refines on the band graph), the stated
    guarantee and the file's own ``use_band`` are the one run, and the
    cell has to make the band's kinds of call (the band BFS, its graph
    and its projection, and on the distributed entry the distributed BFS
    and levels' band) exactly where the band is on."""
    band = cfg["nd_config"].get("use_band", True)
    dist = traffic["entry"] == "distributed_nested_dissection"
    must = set(check.required(cfg, traffic))
    want = {"bfs", "band", "band_proj"} | ({"dbfs", "dband"} if dist
                                             else set())
    broken = []
    if band == ("use_band" in cfg["reduced"]):
        broken.append("use_band is off where reduced names it")
    if cfg["guarantees"].get("use_band") != band or \
            cfg.get("use_band", band) != band:
        broken.append("guarantees.use_band is nd_config.use_band")
    if must & set(check.BAND_KINDS) != (want if band else set()):
        broken.append(f"the band's kinds required: {sorted(want)}")
    return broken


def requires_the_kinds_its_path_calls(cfg: dict, traffic: dict) -> None:
    """A cell has to make every sampled kind of call, the band's only
    where its configuration refines on the band graph."""
    must = check.required(cfg, traffic)
    assert {"match", "fm"} <= set(must)
    assert ("dmatch" in must) == (traffic["entry"] ==
                                  "distributed_nested_dissection")
    noband = dict(cfg, nd_config=dict(cfg["nd_config"], use_band=False))
    assert set(must) - set(check.BAND_KINDS) == \
        set(check.required(noband, traffic))
    assert band_contract(cfg, traffic) == []


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_requires_the_kinds_its_path_calls(cell):
    _, cfg, traffic = harness.find(BENCH, cell)
    requires_the_kinds_its_path_calls(cfg, traffic)


def band_labelled(cfg: dict) -> dict:
    """A configuration with the band graph on, labelled as such."""
    return dict(cfg, nd_config=dict(cfg["nd_config"], use_band=True),
                guarantees=dict(cfg["guarantees"], use_band=True),
                use_band=True,
                reduced=[k for k in cfg["reduced"] if k != "use_band"])


@pytest.mark.parametrize("traffic", ["single", "dist8"])
def test_a_band_cell_requires_the_band_kinds(traffic):
    """A band configuration's cells on the existing traffic files keep the
    same rule as the no-band cells do."""
    cfg = json.loads((ROOT / "orderbench/configs/m3d-30-noband.json")
                     .read_text())
    traffic = json.loads((ROOT / f"orderbench/traffic/{traffic}.json")
                         .read_text())
    requires_the_kinds_its_path_calls(band_labelled(cfg), traffic)
    with pytest.raises(AssertionError):
        requires_the_kinds_its_path_calls(
            dict(band_labelled(cfg), reduced=cfg["reduced"]), traffic)


def _labelled(band: bool, reduced: list, guarantee=None) -> dict:
    return {"nd_config": {"band_width": 3, "use_band": band},
            "reduced": reduced,
            "guarantees": {"use_band": band if guarantee is None
                           else guarantee}}


SINGLE_CALLS = {"entry": "nested_dissection",
                "check_calls": {"match": [6, 1], "bfs": [6, 1],
                                "fm": [5, 1]}}
DIST_CALLS = {"entry": "distributed_nested_dissection",
              "check_calls": {k: [4, 1] for k in check.KINDS}}
CONTRACT = [
    ("band", _labelled(True, []), SINGLE_CALLS, True),
    ("band-dist", _labelled(True, ["nparts"]), DIST_CALLS, True),
    ("noband", _labelled(False, ["use_band"]), SINGLE_CALLS, True),
    ("noband-dist", _labelled(False, ["use_band"]), DIST_CALLS, True),
    ("noband-not-reduced", _labelled(False, []), SINGLE_CALLS, False),
    ("band-reduced", _labelled(True, ["use_band"]), SINGLE_CALLS, False),
    ("band-guarantee-off", _labelled(True, [], False), SINGLE_CALLS, False),
    ("band-bfs-unsampled", _labelled(True, []),
     dict(SINGLE_CALLS, check_calls={"match": [6, 1], "fm": [5, 1]}), False),
    ("band-dist-dbfs-unsampled", _labelled(True, []),
     dict(DIST_CALLS, check_calls={k: [4, 1] for k in check.KINDS
                                   if k != "dbfs"}), False),
]


@pytest.mark.parametrize("cfg,traffic,keeps", [c[1:] for c in CONTRACT],
                         ids=[c[0] for c in CONTRACT])
def test_band_contract_on_plain_configurations(cfg, traffic, keeps):
    assert (band_contract(cfg, traffic) == []) is keeps


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


