"""Perf-iteration runner: run one cell under knob variants on fake cards,
print the three roofline terms per variant.

The port of the reference's ``launch.hillclimb``, over the port's dry
run (``launch.dryrun``) and the H100's roofline constants.

  python -m repro_torch.launch.hillclimb --arch deepseek-v2-lite-16b \\
      --shape train_4k --variants base,nosp,dots,nozero1,fsdp,moeshard
"""
from __future__ import annotations

import argparse
import json
import math
import time

from repro_torch.configs.base import get_config
from repro_torch.flopcount import cell_flops
from repro_torch.roofline import PEAK_FLOPS

VARIANTS = {
    "base":     dict(),
    "nosp":     dict(seq_shard=False),
    "dots":     dict(remat="dots"),
    "nozero1":  dict(zero1=False),
    "fsdp":     dict(fsdp=True),
    "fsdp_dots": dict(fsdp=True, remat="dots"),
    "moeshard": dict(moe_shard=True),
    "moeshard_nosp": dict(moe_shard=True, seq_shard=False),
}


def run_variant(arch, shape, multi_pod, name, knobs, *, cfg=None,
                mesh_shape=None, device="cuda"):
    """One variant's terms.  ``moe_shard`` sets ``layers.
    MOE_SHARD_DISPATCH`` for the run and clears it after."""
    from repro_torch.launch import dryrun as D
    from repro_torch.models import layers as Lmod
    knobs = dict(knobs)
    moe_shard = knobs.pop("moe_shard", False)
    cfg = cfg or get_config(arch)
    Lmod.MOE_SHARD_DISPATCH = moe_shard
    t0 = time.time()
    try:
        low = D.lower_cell_cfg(cfg, shape, multi_pod, mesh_shape=mesh_shape,
                               device=device, **knobs)
        r = low.roofline
        extr = D.depth_extrapolated_costs(arch, shape, multi_pod,
                                          knobs.get("seq_shard", True),
                                          knobs.get("zero1", True),
                                          knobs.get("remat", "full"),
                                          knobs.get("fsdp", False),
                                          cfg=cfg, mesh_shape=mesh_shape,
                                          device=device)
        r.bytes_per_chip = max(extr["bytes_per_chip"], r.bytes_per_chip)
        r.coll_bytes_per_chip = max(extr["coll_bytes_per_chip"],
                                    r.coll_bytes_per_chip)
        n_dev = math.prod(low.mesh_shape)
        remat = knobs.get("remat", "full")
        tc = cell_flops(cfg, shape, remat=remat) / n_dev / PEAK_FLOPS
        mem = r.memory
        peak = (mem["argument_size_in_bytes"]
                + mem["temp_size_in_bytes"]) / 2**30
        out = {
            "variant": name, "t_compute": round(tc, 3),
            "t_memory": round(r.t_memory, 3),
            "t_collective": round(r.t_collective, 3),
            "bound": round(max(tc, r.t_memory, r.t_collective), 3),
            "peak_gib": round(peak, 1),
            "coll_detail": {k: f"{v:.2e}" for k, v in
                            sorted(r.coll_detail.items())},
            "compile_s": round(time.time() - t0, 1),
        }
    finally:
        Lmod.MOE_SHARD_DISPATCH = False
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--variants", default="base")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    outs = []
    for name in args.variants.split(","):
        try:
            out = run_variant(args.arch, args.shape, args.multi, name,
                              VARIANTS[name], device=args.device)
        except Exception as e:  # noqa: BLE001
            out = {"variant": name, "error": f"{type(e).__name__}: {e}"[:300]}
        print(json.dumps(out), flush=True)
        outs.append(out)
    return outs


if __name__ == "__main__":
    main()
