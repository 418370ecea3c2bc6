"""End-to-end training example: train an LM on synthetic data with
checkpoint/restart, through ``repro_torch.launch.train`` in-process.

Quick demo (reduced mamba2-130m, 60 steps):
    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]

Full mamba2-130m (24 layers, d 768, batch 8 × 512, lr 3e-4, 300 steps):
    PYTHONPATH=src python -m repro_torch.examples.train_lm --full

``--steps`` overrides the step count, ``--ckpt DIR`` the checkpoint
directory (by default a new temporary directory); any other argument
(``--fail-at``, ``--resume``, ``--ckpt-every``, ...) goes to the trainer.
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.launch import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt", default=None)
    args, rest = ap.parse_known_args(argv)
    ckpt = args.ckpt or tempfile.mkdtemp(prefix="train_lm_ckpt_")
    targs = ["--arch", "mamba2-130m", "--ckpt", ckpt, "--ckpt-every", "50",
             "--device", args.device]
    if args.full:
        # full mamba2-130m config (~130M params), a few hundred steps
        targs += ["--steps", "300", "--batch", "8", "--seq", "512",
                  "--lr", "3e-4", "--log-every", "10"]
    else:
        targs += ["--reduced", "--steps", "60", "--batch", "8",
                  "--seq", "128", "--lr", "1e-3", "--log-every", "5"]
    if args.steps is not None:
        targs += ["--steps", str(args.steps)]
    targs += rest                       # later flags win in argparse
    print("+ repro_torch.launch.train", " ".join(targs))
    return dict(train.main(targs), ckpt=ckpt)


if __name__ == "__main__":
    main()
