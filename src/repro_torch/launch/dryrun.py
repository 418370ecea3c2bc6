"""Multi-pod dry run: run every (arch × shape × mesh) cell on fake cards.

The port of the reference's ``launch.dryrun``.  Where the reference
lowers and compiles each cell for a TPU pod, the port runs its own step
once on stand-ins: fake tensors (``launch.specs``), placed as DTensors
by the spec functions (``models.sharding``) over a fake H100 mesh
(``launch.mesh``: 32 hosts of 8 cards, or two such pods), under
``roofline.analyze``.  That proves the distribution config coherent
without the cards, and gives each cell's per-card roofline terms (FLOPs,
bytes, collectives) and memory analysis (does it fit in 80 GB?).

  * train: ``train.step.make_train_step`` with AdamW, the optimizer state
    on ZeRO-1 specs;
  * prefill: ``serve.engine.prefill``;
  * decode: ``models.lm.decode_step`` at the cache's last position.

Plain tensors the model makes (RoPE tables, masks, scalars) join the
DTensors as replicated (``implicit_replication``).

Usage:
  python -m repro_torch.launch.dryrun [--arch yi-6b] [--shape train_4k]
      [--mesh single|multi|both] [--out report.json] [--seq-shard 0|1]
      [--zero1 0|1] [--remat full|dots] [--fsdp 0|1] [--append]
      [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import tree
from repro_torch.configs.base import (ARCH_IDS, SHAPES, cell_is_runnable,
                                      get_config)
from repro_torch.launch import mesh as M
from repro_torch.launch import specs as S
from repro_torch.models import layers as layers_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models import sharding as shd
from repro_torch.models.lm import decode_step
from repro_torch.optim import adamw
from repro_torch.roofline import Roofline, analyze, model_flops
from repro_torch.serve.engine import prefill
from repro_torch.train.step import make_train_step

_NAMES = {2: ("data", "model"), 3: ("pod", "data", "model")}


@contextlib.contextmanager
def cell_mesh(multi_pod: bool, mesh_shape: Optional[Sequence[int]] = None,
              device: str = "cuda"):
    """The production mesh (or a fake mesh of ``mesh_shape``) for the
    ``with`` block, its fake group released after."""
    mesh = M.fake_mesh(mesh_shape, _NAMES[len(mesh_shape)], device) \
        if mesh_shape else M.make_production_mesh(multi_pod=multi_pod,
                                                  device=device)
    try:
        yield mesh
    finally:
        M.release()


def place(structs, specs, shard: shd.ShardCfg, mode: FakeTensorMode):
    """Each stand-in leaf as a DTensor over ``shard.mesh`` holding only its
    local shard (a fresh fake tensor of the shard's shape).  Every split
    dim must divide evenly, as the spec rules ensure."""
    mesh = shard.mesh

    def one(t, spec):
        pl = shd.placements(spec, mesh)
        local = list(t.shape)
        for mdim, p in enumerate(pl):
            if isinstance(p, shd.Shard):
                n = mesh.shape[mdim]
                if local[p.dim] % n:
                    raise ValueError(f"dim {p.dim} of {tuple(t.shape)} "
                                     f"does not split over {n}")
                local[p.dim] //= n
        with mode:
            lt = torch.empty(local, dtype=t.dtype, device=t.device)
        return DTensor.from_local(lt, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return tree.map(one, structs, specs)


def local_bytes(structs, specs, mesh) -> int:
    """Bytes of the local shards of ``structs`` under ``specs``."""
    total = 0
    for t, spec in zip(tree.leaves(structs), tree.leaves(specs)):
        n = t.numel() * t.element_size()
        for mdim, p in enumerate(shd.placements(spec, mesh)):
            if isinstance(p, shd.Shard):
                n //= mesh.shape[mdim]
        total += n
    return total


@contextlib.contextmanager
def _knobs(cfg, shard: shd.ShardCfg, remat: str):
    """The cell's remat policy and MoE dispatch constraint, restored
    after.  Dispatch-capacity sharding helps when capacity per expert is
    large (top_k/E above ~1/tp), hurts when experts are many and capacity
    small: on by that rule, or when ``layers.MOE_SHARD_DISPATCH`` is
    already set (``hillclimb``'s ``moeshard``)."""
    old = (lm_mod.REMAT_POLICY, layers_mod.MOE_SHARD_DISPATCH,
           layers_mod.MOE_DISPATCH_SPEC)
    auto_moe = bool(cfg.moe and cfg.n_experts
                    and cfg.top_k / cfg.n_experts > 1.0 / shard.tp_size)
    try:
        lm_mod.REMAT_POLICY = remat
        if layers_mod.MOE_SHARD_DISPATCH or auto_moe:
            layers_mod.MOE_DISPATCH_SPEC = shard.named(
                shd.P(shard.tp, shard.dp, None))
            layers_mod.MOE_SHARD_DISPATCH = True
        else:
            layers_mod.MOE_DISPATCH_SPEC = None
        yield
    finally:
        (lm_mod.REMAT_POLICY, layers_mod.MOE_SHARD_DISPATCH,
         layers_mod.MOE_DISPATCH_SPEC) = old


@dataclasses.dataclass
class Lowered:
    """One cell's run on fake cards: its roofline (with the memory
    analysis), the bytes of its arguments' local shards under the specs,
    the seconds the run took and the mesh's shape."""
    roofline: Roofline
    spec_argument_bytes: int
    seconds: float
    mesh_shape: tuple


def _lower(cfg, shape, mesh, seq_shard, zero1, remat, fsdp, device):
    t0 = time.time()
    sh = S.shape_of(shape)
    shard = shd.ShardCfg(mesh=mesh, dp=M.dp_axes(mesh), seq_shard=seq_shard)
    mode = FakeTensorMode()
    ins = S.input_specs(cfg, sh, mode, device)
    pspecs = shd.param_specs(ins["params"], shard)
    if fsdp:   # ZeRO-3-ish: shard a replicated weight dim over data axes
        pspecs = shd.zero1_specs(ins["params"], pspecs, shard)
    bspecs = shd.batch_specs(ins["batch"], shard)
    args, specs = [ins["params"]], [pspecs]
    with _knobs(cfg, shard, remat):
        if sh["kind"] == "train":
            # opt state follows param specs, upgraded with dp (ZeRO-1)
            opt_pspecs = adamw.OptState(master=pspecs, m=pspecs, v=pspecs,
                                        count=shd.P())
            ospecs = shd.zero1_specs(ins["opt"], opt_pspecs, shard) \
                if zero1 else opt_pspecs
            fn = make_train_step(cfg, adamw.AdamWConfig(), shard)
            args += [ins["opt"], ins["batch"]]
            specs += [ospecs, bspecs]
        elif sh["kind"] == "prefill":
            def fn(params, batch):
                return prefill(params, cfg, batch, shard, device=device)
            args.append(ins["batch"])
            specs.append(bspecs)
        else:                                   # decode
            cspecs = shd.cache_specs(ins["caches"], shard)
            pos = ins["pos"]

            def fn(params, token, caches):
                return decode_step(params, cfg, token, caches, pos, shard)
            args += [ins["batch"]["tokens"], ins["caches"]]
            specs += [bspecs["tokens"], cspecs]
        placed = [place(a, s, shard, mode) for a, s in zip(args, specs)]
        with mode, implicit_replication():
            roof = analyze(fn, *placed, mesh=mesh)
    return Lowered(roof, local_bytes(args, specs, mesh), time.time() - t0,
                   tuple(mesh.shape))


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               seq_shard: bool = True, device: str = "cuda") -> Lowered:
    """One cell of the production mesh."""
    return lower_cell_cfg(get_config(arch), shape_name, multi_pod, seq_shard,
                          device=device)


def lower_cell_cfg(cfg, shape_name, multi_pod: bool,
                   seq_shard: bool = True, zero1: bool = True,
                   remat: str = "full", fsdp: bool = False, *,
                   mesh_shape=None, device: str = "cuda") -> Lowered:
    """Run ``cfg``'s step of ``shape_name`` (a name of ``SHAPES`` or such
    a dict) once on fake cards: on a fake mesh of ``mesh_shape``, or the
    production mesh, made and released here."""
    with cell_mesh(multi_pod, mesh_shape, device) as m:
        return _lower(cfg, shape_name, m, seq_shard, zero1, remat, fsdp,
                      device)


def _with_depth(cfg, n_periods: int):
    """Same-family config with `n_periods` repetitions of the layer pattern
    (plus any non-repeating prefix), for the depth slope."""
    from repro_torch.models.lm import group_descs, layer_descs
    groups = group_descs(layer_descs(cfg))
    period = len(groups[-1][1])
    prefix = cfg.n_layers - groups[-1][0] * period
    kw = dict(n_layers=prefix + n_periods * period)
    if cfg.enc_dec:
        kw["n_enc_layers"] = n_periods
    return dataclasses.replace(cfg, **kw), prefix, period


def depth_extrapolated_costs(arch: str, shape_name, multi_pod: bool,
                             seq_shard: bool, zero1: bool = True,
                             remat: str = "full", fsdp: bool = False, *,
                             cfg=None, mesh_shape=None,
                             device: str = "cuda") -> Dict[str, Any]:
    """flops/bytes/collective-bytes per card at full depth via the slope
    of two shallow runs.  Eager PyTorch runs every layer, so a full-depth
    run already counts them all; the slope gives the same numbers from
    two cheap runs.  The runs take 2 and 3 periods (the reference's 1
    and 2 would leave the one-period run without remat, which only a
    repeated group gets)."""
    cfg = cfg or get_config(arch)
    vals = []
    for k in (2, 3):
        cfg_k, prefix, period = _with_depth(cfg, k)
        vals.append(lower_cell_cfg(cfg_k, shape_name, multi_pod, seq_shard,
                                   zero1, remat, fsdp, mesh_shape=mesh_shape,
                                   device=device).roofline)
    n_periods = (cfg.n_layers - prefix) // period
    out: Dict[str, Any] = {}
    for field in ("flops_per_chip", "bytes_per_chip", "coll_bytes_per_chip",
                  "coll_host_bytes_per_chip"):
        c2, c3 = getattr(vals[0], field), getattr(vals[1], field)
        out[field] = c2 + (c3 - c2) * (n_periods - 2)
    out["coll_detail_slope"] = {
        k2: vals[0].coll_detail.get(k2, 0.0)
        + (vals[1].coll_detail.get(k2, 0.0)
           - vals[0].coll_detail.get(k2, 0.0)) * (n_periods - 2)
        for k2 in set(vals[0].coll_detail) | set(vals[1].coll_detail)}
    return out


def _mesh_label(multi_pod: bool) -> str:
    return "multi" if multi_pod else "single"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             seq_shard: bool = True, zero1: bool = True,
             remat: str = "full", fsdp: bool = False, *, cfg=None,
             mesh_shape=None, extrapolate: bool = False,
             device: str = "cuda") -> Dict[str, Any]:
    """One cell's record: OK (roofline, memory analysis, model FLOPs),
    SKIP (``cell_is_runnable``) or FAIL (the error).  ``cfg`` replaces
    ``get_config(arch)`` (a reduced config), ``mesh_shape`` the
    production mesh.  The full-depth run counts every layer, so its
    costs are the record's; with ``extrapolate`` the depth slope's are
    recorded beside them (``depth_slope``), where the reference takes
    the larger of the two because XLA counts a scan's body once."""
    t0 = time.time()
    label = _mesh_label(multi_pod)
    ok, why = cell_is_runnable(arch, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": label,
                "status": "SKIP", "reason": why}
    cfg = cfg or get_config(arch)
    try:
        low = lower_cell_cfg(cfg, shape_name, multi_pod, seq_shard, zero1,
                             remat, fsdp, mesh_shape=mesh_shape,
                             device=device)
        roof = low.roofline
        n_dev = math.prod(low.mesh_shape)
        mf = model_flops(cfg, SHAPES[shape_name])
        rec = {
            "arch": arch, "shape": shape_name, "mesh": label,
            "status": "OK",
            "compile_s": round(time.time() - t0, 1),
            "extrap_compile_s": 0.0,
            "n_devices": n_dev,
            "mesh_shape": list(low.mesh_shape),
            "model_flops_global": mf,
            "useful_flops_ratio": mf / max(roof.flops_per_chip * n_dev, 1),
            "roofline": roof.as_dict(),
            "memory_analysis": dict(roof.memory),
            "spec_argument_bytes": low.spec_argument_bytes,
        }
        if extrapolate:
            t1 = time.time()
            rec["depth_slope"] = depth_extrapolated_costs(
                arch, shape_name, multi_pod, seq_shard, zero1, remat, fsdp,
                cfg=cfg, mesh_shape=mesh_shape, device=device)
            rec["extrap_compile_s"] = round(time.time() - t1, 1)
        return rec
    except Exception as e:  # noqa: BLE001 — failures are the signal here
        return {"arch": arch, "shape": shape_name, "mesh": label,
                "status": "FAIL", "compile_s": round(time.time() - t0, 1),
                "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="dryrun_report.json")
    ap.add_argument("--seq-shard", type=int, default=1)
    ap.add_argument("--zero1", type=int, default=1)
    ap.add_argument("--remat", default="full", choices=["full", "dots"])
    ap.add_argument("--fsdp", type=int, default=0)
    ap.add_argument("--append", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    records = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            records = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in records}
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                key = (arch, shape_name, _mesh_label(mp))
                if key in done:
                    continue
                rec = run_cell(arch, shape_name, mp, bool(args.seq_shard),
                               bool(args.zero1), args.remat,
                               bool(args.fsdp), device=args.device)
                status = rec["status"]
                extra = ""
                if status == "OK":
                    r = rec["roofline"]
                    extra = (f"bottleneck={r['bottleneck']} "
                             f"tc={r['t_compute_s']:.4f}s "
                             f"tm={r['t_memory_s']:.4f}s "
                             f"tx={r['t_collective_s']:.4f}s "
                             f"run={rec['compile_s']}s")
                elif status == "FAIL":
                    extra = rec["error"][:200]
                print(f"[{status}] {arch} × {shape_name} × {key[2]}  {extra}",
                      flush=True)
                records.append(rec)
                with open(args.out, "w") as f:
                    json.dump(records, f, indent=1)
    n_ok = sum(r["status"] == "OK" for r in records)
    n_skip = sum(r["status"] == "SKIP" for r in records)
    n_fail = sum(r["status"] == "FAIL" for r in records)
    print(f"dry-run complete: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL")
    return records


if __name__ == "__main__":
    main()
