"""Runnable trainer, sharded over the host's process group.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --reduced --steps 50 --batch 8 --seq 128 --ckpt build/ck \\
        [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.train ...

The port of the reference's ``launch.train``, step for step: config
selection, the host mesh and its ``ShardCfg``, the data pipeline, AdamW,
checkpoint/restart (``--resume``), the straggler monitor and a simulated
failure (``--fail-at``) restarted from the checkpoint through
``RestartPolicy``, which replays the steps since the checkpoint.

The mesh is the reference's ``make_host_mesh``: every rank of the
process group (``launch.mesh.init_host_group``: NCCL between cards,
gloo on the CPU; a world of one without ``torchrun``) as a (1, n)
data×model mesh.  Where the reference leaves placement to XLA, the port
places explicitly, as the dry run does: the parameters (drawn from a
seeded generator on each rank; the reference's draws differ) by
``param_specs``, the optimizer state by ``zero1_specs``, each batch by
``batch_specs`` (each rank reads the rows of its data coordinate), and a
checkpoint restores onto the mesh.  On a world of one the (1, 1) mesh
places every leaf whole on the one card, so the state stays in plain
tensors and the step is ``NO_SHARD``'s: the mesh's step bit for bit
without DTensor's dispatch on the host.  Only rank 0 prints.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

from repro_torch import tree
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.launch import mesh as M
from repro_torch.models import sharding as shd
from repro_torch.models.lm import generator, init_params
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import RestartPolicy, StragglerMonitor
from repro_torch.train.step import batch_rows, make_train_step, place_batch


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a simulated failure at this step")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None,
                    help="write the run's summary (each step's loss "
                    "unrounded) to this JSON file (rank 0)")
    return ap


def _named(specs, like, shard: shd.ShardCfg):
    return tree.map(lambda sp, x: shd.NamedSharding(
        shard.mesh, shd.even(shd.placements(sp, shard.mesh), x.shape,
                             shard.mesh)), specs, like)


def param_shardings(params, shard: shd.ShardCfg):
    """The ``NamedSharding``s of ``params`` over ``shard.mesh`` by
    ``param_specs`` (each dim its axes do not split evenly whole): the
    placement of the trainer's parameters and of the served model's."""
    return _named(shd.param_specs(params, shard), params, shard)


def shardings(params, shard: shd.ShardCfg):
    """The ``NamedSharding``s of (params, optimizer state) over
    ``shard.mesh``: the parameters by ``param_specs``, the master weights
    and moments by ``zero1_specs``, the step count replicated (the
    placement of the dry run's train cell)."""
    pspecs = shd.param_specs(params, shard)
    ospecs = shd.zero1_specs(adamw.init(params),
                             adamw.OptState(pspecs, pspecs, pspecs, shd.P()),
                             shard)
    opt_like = adamw.OptState(params, params, params, torch.zeros(()))
    return (param_shardings(params, shard),
            _named(ospecs, opt_like, shard))


def place(tree_, named):
    """Each leaf of ``tree_`` (alike on every rank) as a DTensor placed
    by its ``NamedSharding`` (``named`` has ``tree_``'s structure), each
    rank keeping its own shard."""
    return tree.unflatten(tree_, [
        distribute_tensor(x, n.mesh, n.placements, src_data_rank=None)
        for x, n in zip(tree.leaves(tree_),
                        ckpt.sharding_leaves(tree_, named))])


def main(argv=None) -> dict:
    """Train; returns the number of steps run, the mean loss of the first
    and last fifth of them, each step's index, loss and host-clock ms in
    the order run (a step replayed after a restart twice), the stragglers
    flagged, the restarts and the mesh's shape (alike on every rank)."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.fail_at >= 0 and not args.ckpt:
        ap.error("--fail-at needs --ckpt")

    made = not dist.is_initialized()
    dev = M.init_host_group(args.device)
    try:
        return _train(args, dev)
    finally:
        if made:
            M.release()


def _train(args, dev: torch.device) -> dict:
    mesh = M.make_host_mesh(args.device)
    # a mesh of one rank: every placement is the whole tensor on the one
    # card, so plain tensors (NO_SHARD) run the same step bit for bit
    shard = shd.ShardCfg(mesh=mesh, dp=M.dp_axes(mesh)) \
        if mesh.size() > 1 else shd.NO_SHARD
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    say(f"arch={cfg.name} params≈{cfg.param_count():,} mesh={shape} "
        f"device={args.device}"
        + (" (one rank: plain tensors)" if shard.mesh is None else ""))

    params = init_params(generator(0, dev), cfg)
    opt = adamw.init(params)
    named = None
    if shard.mesh is not None:
        named = shardings(params, shard)
        params, opt = place((params, opt), named)
    start = 0
    if args.resume and args.ckpt and ckpt.latest_step(args.ckpt) is not None:
        start, (params, opt) = ckpt.restore(args.ckpt, (params, opt),
                                            device=dev, shardings=named)
        say(f"resumed from step {start}")

    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup=20)
    step_fn = make_train_step(cfg, opt_cfg, shard)
    # each rank reads the rows of its data coordinate (``batch_specs``)
    hosts, host_id = batch_rows(args.batch, shard)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, n_hosts=hosts,
                      host_id=host_id)
    pipe = Pipeline(dcfg, start_step=start)
    mon = StragglerMonitor()
    policy = RestartPolicy()

    losses, ran, step_ms = [], [], []
    t_start = time.time()
    try:
        while True:
            # ``next(pipe)``, not ``for ... in pipe``: a restart replaces
            # the pipeline, and the loop must read the new one (the
            # reference's ``for`` loop keeps reading the closed one, so it
            # skips the replay and blocks once its prefetch runs out)
            step, batch = next(pipe)
            if step >= args.steps:
                break
            if step == args.fail_at and not policy.restarts and \
                    policy.should_restart():
                # one simulated failure: the replay passes the step
                say(f"[fault] simulated host failure at step {step}; "
                    f"restarting from checkpoint")
                policy.record()
                start, (params, opt) = ckpt.restore(
                    args.ckpt, (params, opt), device=dev, shardings=named)
                pipe.close()
                pipe = Pipeline(dcfg, start_step=start)
                continue
            t0 = time.time()
            local = {k: torch.from_numpy(v).to(dev)
                     for k, v in batch.items()}
            rows = local["tokens"].shape[0]
            if cfg.enc_dec:
                local["frames"] = torch.zeros(
                    (rows, cfg.enc_len, cfg.d_model), dtype=torch.bfloat16,
                    device=dev)
            if cfg.frontend == "patches":
                local["patches"] = torch.zeros(
                    (rows, cfg.n_patches, cfg.d_model), dtype=torch.bfloat16,
                    device=dev)
            params, opt, metrics = step_fn(
                params, opt, place_batch(local, shard, rows=args.batch))
            loss = float(metrics["loss"])          # waits for the step
            dt = time.time() - t0
            straggle = mon.observe(dt)
            losses.append(loss)
            ran.append(step)
            step_ms.append(dt * 1e3)
            if step % args.log_every == 0:
                say(f"step {step:5d} loss {loss:.4f} "
                    f"xent {float(metrics['xent']):.4f} {dt*1e3:.0f}ms"
                    + (" [straggler]" if straggle else ""), flush=True)
            if args.ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(args.ckpt, step + 1, (params, opt),
                          extra={"arch": cfg.name})
    finally:
        pipe.close()
    n = max(len(losses) // 5, 1)
    first, last = float(np.mean(losses[:n])), float(np.mean(losses[-n:]))
    say(f"done: steps={len(losses)} loss {first:.4f} -> {last:.4f}  "
        f"wall {time.time()-t_start:.0f}s stragglers={mon.flagged}")
    run = {"steps": len(losses), "first_loss": first, "last_loss": last,
           "step_ids": ran, "losses": losses, "step_ms": step_ms,
           "stragglers": mon.flagged,
           "restarts": policy.restarts, "mesh": shape}
    if args.out and dist.get_rank() == 0:
        with open(args.out, "w") as f:
            json.dump(run, f)
    return run


if __name__ == "__main__":
    main()
