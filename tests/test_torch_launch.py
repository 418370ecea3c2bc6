"""The port's launch tools (``repro_torch.launch``: mesh, specs, dryrun,
enrich, report, hillclimb) on the CPU, on fake meshes.

* ``run_cell`` on ``reduced()`` configs over fake (2, 2) and (2, 2, 2)
  CPU meshes: OK for a train, a prefill and a decode shape, each cell's
  argument bytes per card equal to the local shard bytes its specs give.
* On a 1 × 1 mesh the dry run's FLOPs per card equal
  ``FlopCounterMode``'s over the plain (``NO_SHARD``) step, so the count
  is the card's shard of each op and DTensor's global-shape metadata runs
  are not counted; on (2, 2) they are the 1 × 1 count split four ways
  where every product splits.
* ``depth_extrapolated_costs`` equals the full-depth count.
* ``enrich`` / ``report`` on a fixed records list give the reference's
  tables, apart from the peak constant and the mesh headings.
* ``hillclimb``'s ``moeshard`` sets the MoE dispatch hook for its run and
  restores it after.
* ``NO_SHARD`` steps are bit-equal with the MoE dispatch hook set and
  unset (it touches only DTensors).

The fake process group is global to a process: each test releases it.
"""
import copy
import dataclasses
import json
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.launch import enrich as JEN  # noqa: E402
from repro.launch import report as JREP  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import enrich as EN  # noqa: E402
from repro_torch.launch import hillclimb as H  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import report as REP  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import sharding as shd  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402


def small(kind, B=8, Sq=32):
    return {"kind": kind, "seq_len": Sq, "global_batch": B}


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    M.release()
    assert not dist.is_initialized()


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 2, 2)])
@pytest.mark.parametrize("arch,shape", [("yi-6b", "train_4k"),
                                        ("deepseek-v2-lite-16b",
                                         "prefill_32k"),
                                        ("jamba-v0.1-52b", "decode_32k")])
def test_run_cell_ok_on_fake_meshes(arch, shape, mesh_shape):
    rec = D.run_cell(arch, shape, len(mesh_shape) == 3,
                     cfg=get_config(arch).reduced(), mesh_shape=mesh_shape,
                     device="cpu")
    assert rec["status"] == "OK", rec.get("error")
    assert rec["n_devices"] == (4 if len(mesh_shape) == 2 else 8)
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == rec["spec_argument_bytes"] > 0
    assert mem["temp_size_in_bytes"] > 0
    r = rec["roofline"]
    assert r["flops_per_chip"] > 0 and r["bytes_per_chip"] > 0
    assert r["coll_counts"] and r["t_collective_s"] > 0
    if shape == "decode_32k":               # the caches, written in place
        assert mem["alias_size_in_bytes"] > 0


def test_skip_and_fail_records():
    rec = D.run_cell("yi-6b", "long_500k", False, device="cpu")
    assert rec["status"] == "SKIP" and "500k" in rec["reason"]
    bad = dataclasses.replace(get_config("yi-6b").reduced(), n_heads=3)
    rec = D.run_cell("yi-6b", "decode_32k", False, cfg=bad,
                     mesh_shape=(2, 2), device="cpu")
    assert rec["status"] == "FAIL" and rec["error"] and rec["trace"]


def test_per_card_flops_equal_flop_counter_on_one_card():
    cfg = get_config("arctic-480b").reduced()
    low = D.lower_cell_cfg(cfg, small("train"), False, mesh_shape=(1, 1),
                           device="cpu")
    params = lm.init_params(lm.generator(0, "cpu"), cfg)
    opt = adamw.init(params)
    batch = {"tokens": torch.zeros((8, 32), dtype=torch.int32),
             "labels": torch.zeros((8, 32), dtype=torch.int32)}
    step = make_train_step(cfg, adamw.AdamWConfig())
    with FlopCounterMode(display=False) as fc:
        step(params, opt, batch)
    assert low.roofline.flops_per_chip == fc.get_total_flops()
    assert low.roofline.coll_counts == {}
    state = sum(t.numel() * t.element_size()
                for t in tree.leaves((params, opt, batch)))
    assert low.roofline.memory["argument_size_in_bytes"] == state
    # four cards: every product splits four ways here (batch 8 on data,
    # heads / hidden / experts / vocab on model)
    yi = get_config("yi-6b").reduced()
    one = D.lower_cell_cfg(yi, small("prefill"), False, mesh_shape=(1, 1),
                           device="cpu").roofline
    four = D.lower_cell_cfg(yi, small("prefill"), False, mesh_shape=(2, 2),
                            device="cpu").roofline
    assert four.flops_per_chip == pytest.approx(one.flops_per_chip / 4,
                                                rel=1e-3)


@pytest.mark.parametrize("arch,shape", [("yi-6b", "prefill"),
                                        ("deepseek-v2-lite-16b", "decode")])
def test_depth_slope_equals_full_depth(arch, shape):
    # deepseek: a dense first layer, then 5 repetitions of a MoE layer
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=6)
    sh = small(shape)
    full = D.lower_cell_cfg(cfg, sh, False, mesh_shape=(2, 2),
                            device="cpu").roofline
    extr = D.depth_extrapolated_costs(arch, sh, False, True, cfg=cfg,
                                      mesh_shape=(2, 2), device="cpu")
    for field in ("flops_per_chip", "bytes_per_chip", "coll_bytes_per_chip",
                  "coll_host_bytes_per_chip"):
        assert extr[field] == pytest.approx(getattr(full, field),
                                            rel=1e-9), field
    assert extr["coll_detail_slope"] == pytest.approx(full.coll_detail)


def _records():
    roof = {"flops_per_chip": 1e12, "bytes_per_chip": 2e11,
            "coll_bytes_per_chip": 3e9, "coll_detail": {"all-gather": 3e9},
            "coll_counts": {"all-gather": 12, "reduce-scatter": 4},
            "peak_mem_bytes": 5e10, "t_compute_s": 0.5,
            "t_memory_s": 0.06, "t_collective_s": 0.06,
            "bottleneck": "compute"}
    mem = {"argument_size_in_bytes": 2 ** 33,
           "temp_size_in_bytes": 2 ** 34}
    recs = []
    for mesh, n in (("single", 256), ("multi", 512)):
        for arch, shape in (("yi-6b", "train_4k"),
                            ("deepseek-v2-lite-16b", "prefill_32k"),
                            ("mamba2-130m", "long_500k")):
            recs.append({"arch": arch, "shape": shape, "mesh": mesh,
                         "status": "OK", "compile_s": 1.5, "n_devices": n,
                         "model_flops_global": 2e14,
                         "roofline": dict(roof, coll_detail=dict(
                             roof["coll_detail"])),
                         "memory_analysis": dict(mem)})
        recs.append({"arch": "yi-6b", "shape": "long_500k", "mesh": mesh,
                     "status": "SKIP", "reason": "pure full-attention"})
        recs.append({"arch": "granite-34b", "shape": "decode_32k",
                     "mesh": mesh, "status": "FAIL", "compile_s": 0.1,
                     "error": "RuntimeError: nope"})
    return recs


def test_enrich_and_report_equal_the_references():
    port = EN.enrich(copy.deepcopy(_records()))
    ref = JEN.enrich(copy.deepcopy(_records()))
    scale = JEN.PEAK_FLOPS / EN.PEAK_FLOPS            # 197 / 989 TFLOP/s
    for p, r in zip(port, ref):
        if p["status"] != "OK":
            assert p == r
            continue
        assert p["analytic_flops_global"] == r["analytic_flops_global"]
        assert p["useful_flops_ratio_analytic"] == \
            r["useful_flops_ratio_analytic"]
        assert p["roofline"]["t_compute_analytic_s"] == pytest.approx(
            r["roofline"]["t_compute_analytic_s"] * scale)
    # the tables, each side from its own enrich: equal once the reference
    # is given the port's peak
    ref_same = copy.deepcopy(_records())
    old = JEN.PEAK_FLOPS
    try:
        JEN.PEAK_FLOPS = EN.PEAK_FLOPS
        JEN.enrich(ref_same)
    finally:
        JEN.PEAK_FLOPS = old
    for mesh in ("single", "multi"):
        assert REP.roofline_table(port, mesh) == \
            JREP.roofline_table(ref_same, mesh)
    ours, theirs = (REP.dryrun_table(port).split("\n"),
                    JREP.dryrun_table(ref_same).split("\n"))
    assert ours[1:] == theirs[1:]
    assert "32×8 = 256 H100s" in ours[0] and "16×16" not in ours[0]


def test_report_and_enrich_entry_points(tmp_path, capsys):
    path = tmp_path / "dryrun_report.json"
    path.write_text(json.dumps(_records()))
    EN.main([str(path)])
    REP.main([str(path)])
    out = capsys.readouterr().out
    assert "enriched 6 OK records" in out
    assert "## §Roofline (two pods (2×32×8 = 512 H100s))" in out
    assert json.loads(path.read_text())[0]["roofline"]["bottleneck_analytic"]


def test_hillclimb_moeshard_restores_the_hook(monkeypatch):
    seen = []
    orig = L._expert_placements

    def spy(mesh, shape):
        if L.MOE_SHARD_DISPATCH and L.MOE_DISPATCH_SPEC is not None:
            seen.append(orig(mesh, shape))
        return orig(mesh, shape)
    monkeypatch.setattr(L, "_expert_placements", spy)
    cfg = dataclasses.replace(get_config("arctic-480b").reduced(),
                              n_experts=8, top_k=1)    # auto rule: off
    out = H.run_variant("arctic-480b", "decode_32k", False, "base",
                        H.VARIANTS["base"], cfg=cfg, mesh_shape=(2, 2),
                        device="cpu")
    assert "error" not in out and not seen
    out = H.run_variant("arctic-480b", "decode_32k", False, "moeshard",
                        H.VARIANTS["moeshard"], cfg=cfg, mesh_shape=(2, 2),
                        device="cpu")
    # capacity split over the data axis as well as experts over the model
    assert "error" not in out and seen
    assert all(pl == (shd.Shard(1), shd.Shard(0)) for pl in seen)
    assert set(out) >= {"t_compute", "t_memory", "t_collective", "bound",
                        "peak_gib", "coll_detail"}
    assert L.MOE_SHARD_DISPATCH is False and L.MOE_DISPATCH_SPEC is None
    assert H.VARIANTS["moeshard"] == {"moe_shard": True}


def test_no_shard_steps_bit_equal_with_the_moe_hook():
    cfg = get_config("arctic-480b").reduced()
    params = lm.init_params(lm.generator(3, "cpu"), cfg)
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, 8), generator=g),
             "labels": torch.randint(0, cfg.vocab, (1, 8), generator=g)}
    step = make_train_step(cfg, adamw.AdamWConfig())

    def run():
        logits, aux = lm.forward(params, cfg, batch)
        p, o, m = step(params, adamw.init(params), batch)
        return [logits, aux, m["loss"], m["grad_norm"]] + tree.leaves(p)
    plain = run()
    try:
        L.MOE_SHARD_DISPATCH = True
        L.MOE_DISPATCH_SPEC = shd.NamedSharding(None, ())
        hooked = run()
    finally:
        L.MOE_SHARD_DISPATCH, L.MOE_DISPATCH_SPEC = False, None
    assert all(torch.equal(a, b) for a, b in zip(plain, hooked))


def test_meshes(tmp_path):
    mesh = M.make_production_mesh(device="cpu")
    assert tuple(mesh.shape) == (32, 8) and mesh.size() == 256
    assert M.dp_axes(mesh) == ("data",)
    mesh = M.make_production_mesh(multi_pod=True, device="cpu")
    assert tuple(mesh.mesh_dim_names) == ("pod", "data", "model")
    assert M.dp_axes(mesh) == ("pod", "data")
    assert dist.get_world_size() == 512
    M.release()
    assert not dist.is_initialized()
    assert tuple(M.make_host_mesh("cpu").shape) == (1, 1)
    M.release()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError):
            M.fake_mesh((2, 2), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()
