"""Batched serving demo: prefill + greedy decode with per-layer caches.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
        --arch jamba-v0.1-52b [--device cpu]

Random weights from a seeded generator on the device, in the
``reduced()`` configuration of the architecture.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.models.lm import generator, init_params
from repro_torch.serve.engine import greedy_generate


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    params = init_params(generator(0, args.device), cfg)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    t0 = time.time()
    out = greedy_generate(params, cfg, prompt, args.new_tokens,
                          s_max=args.prompt_len + args.new_tokens,
                          device=args.device)
    if out.is_cuda:
        torch.cuda.synchronize()
    dt = time.time() - t0
    toks = args.batch * args.new_tokens
    print(f"arch={cfg.name} (reduced) batch={args.batch} on {out.device}")
    print(f"generated {toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s, "
          f"first call included)")
    print("sample continuation ids:", out[0, :12].tolist())
    return {"tokens": out.cpu().numpy(), "seconds": dt}


if __name__ == "__main__":
    main()
