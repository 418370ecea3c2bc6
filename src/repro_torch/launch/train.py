"""Runnable trainer, on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --reduced --steps 50 --batch 8 --seq 128 --ckpt build/ck \\
        [--device cpu]

The port of the reference's ``launch.train``, step for step: config
selection, the data pipeline, AdamW, checkpoint/restart (``--resume``),
the straggler monitor and a simulated failure (``--fail-at``) restarted
from the checkpoint through ``RestartPolicy``, which replays the steps
since the checkpoint.  One card: the mesh is
{data: 1, model: 1} and the sharding ``NO_SHARD``.  Parameters are drawn
from a seeded generator on the device (the reference's draws differ).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.models.lm import generator, init_params
from repro_torch.models.sharding import NO_SHARD
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import RestartPolicy, StragglerMonitor
from repro_torch.train.step import make_train_step


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
    return ap


def main(argv=None) -> dict:
    """Train; returns the number of steps run, the mean loss of the first
    and last fifth of them, each step's index and loss in the order run
    (a step replayed after a restart twice), the stragglers flagged and
    the restarts."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.fail_at >= 0 and not args.ckpt:
        ap.error("--fail-at needs --ckpt")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"arch={cfg.name} params≈{cfg.param_count():,} "
          f"mesh={{'data': 1, 'model': 1}} device={args.device}")

    params = init_params(generator(0, args.device), cfg)
    opt = adamw.init(params)
    start = 0
    if args.resume and args.ckpt and ckpt.latest_step(args.ckpt) is not None:
        start, (params, opt) = ckpt.restore(args.ckpt, (params, opt),
                                            device=args.device)
        print(f"resumed from step {start}")

    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup=20)
    step_fn = make_train_step(cfg, opt_cfg, NO_SHARD)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    pipe = Pipeline(dcfg, start_step=start)
    mon = StragglerMonitor()
    policy = RestartPolicy()
    dev = params["embed"].device

    losses, ran = [], []
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
                print(f"[fault] simulated host failure at step {step}; "
                      f"restarting from checkpoint")
                policy.record()
                start, (params, opt) = ckpt.restore(
                    args.ckpt, (params, opt), device=args.device)
                pipe.close()
                pipe = Pipeline(dcfg, start_step=start)
                continue
            t0 = time.time()
            batch_t = {k: torch.from_numpy(v).to(dev)
                       for k, v in batch.items()}
            if cfg.enc_dec:
                batch_t["frames"] = torch.zeros(
                    (args.batch, cfg.enc_len, cfg.d_model),
                    dtype=torch.bfloat16, device=dev)
            if cfg.frontend == "patches":
                batch_t["patches"] = torch.zeros(
                    (args.batch, cfg.n_patches, cfg.d_model),
                    dtype=torch.bfloat16, device=dev)
            params, opt, metrics = step_fn(params, opt, batch_t)
            loss = float(metrics["loss"])          # waits for the step
            dt = time.time() - t0
            straggle = mon.observe(dt)
            losses.append(loss)
            ran.append(step)
            if step % args.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"xent {float(metrics['xent']):.4f} {dt*1e3:.0f}ms"
                      + (" [straggler]" if straggle else ""), flush=True)
            if args.ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(args.ckpt, step + 1, (params, opt),
                          extra={"arch": cfg.name})
    finally:
        pipe.close()
    n = max(len(losses) // 5, 1)
    first, last = float(np.mean(losses[:n])), float(np.mean(losses[-n:]))
    print(f"done: steps={len(losses)} loss {first:.4f} -> {last:.4f}  "
          f"wall {time.time()-t_start:.0f}s stragglers={mon.flagged}")
    return {"steps": len(losses), "first_loss": first, "last_loss": last,
            "step_ids": ran, "losses": losses, "stragglers": mon.flagged,
            "restarts": policy.restarts}


if __name__ == "__main__":
    main()
