#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which must pass:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once) and print the build time;
2. the threefry PRNG on the card equals the PRNG on the CPU for the
   ordering's key and shape sequence;
3. each kernel equals its plain PyTorch version on the card, exactly, at
   the main path's shapes (the altr4-scale band of ``grid3d(30, 30, 30)``,
   dummy lanes included, and FM on the whole graph at ``n_pad`` 32768),
   with CUDA-event times of both;
4. ``nested_dissection(grid3d(12, 12, 12), seed=0, nproc=4)`` gives the
   same permutation on the card as on the CPU;
5. the main path: ``nested_dissection(grid3d(30, 30, 30), seed=0,
   nproc=8)`` on the card, with the kernel launch counts set to 0 just
   before and read just after; both kernels must have launched;
6. a ``{"kernels": [...]}`` line with each kernel's launches, error, times
   and bound, the card's name and power limit, and as the last line
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without that last line.  Imports neither jax
nor the reference package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM rate, and float32 outside the
# tensor cores, used for the integer and float scalar work of both kernels
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn()`` over ``reps`` runs after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def once_ms(fn):
    """CUDA-event time of one run of ``fn()`` and its result (for runs of
    many seconds, where a warm-up would double the cost)."""
    import torch
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1), out


def plane_problem(side: int = 30):
    """``grid3d(side³)`` with the plane separator x = side/2, and its band.

    Returns (graph, part, band, band part, band locks): the root band of
    the main path's graph, built as the pipeline builds it.
    """
    import numpy as np
    from repro_torch.core.band import extract_band
    from repro_torch.graphs.generators import grid3d
    g = grid3d(side, side, side)
    x = np.arange(g.n) // (side * side)
    part = np.where(x < side // 2, 0, np.where(x == side // 2, 2, 1))
    part = part.astype(np.int8)
    band, bpart, locked, _ = extract_band(g, part, width=3, device="cuda")
    return g, part, band, bpart, locked


# ---------------------------------------------------------------- phases
def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    dt = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
    log(f"phase 1 build: {sorted(build.SOURCES)} in {dt:.1f} s")


def phase_prng() -> None:
    import torch
    from repro_torch import prng
    from repro_torch.kernels.fm_fused import fm_noise
    for seed in (0, 1, 12345, 2 ** 31 - 1):
        per_device = []
        for dev in ("cpu", "cuda"):
            keys = prng.split(prng.PRNGKey(seed, dev), 8)
            per_device.append([keys, fm_noise(keys, 8192, 3),
                               prng.bernoulli(keys, 0.5, (32768,)),
                               prng.uniform(keys[:2], (32768, 8)),
                               prng.uniform(keys, (8192,)),
                               prng.split(keys, 8)])
        for a, b in zip(*per_device):
            if not torch.equal(a, b.cpu()):
                raise AssertionError(f"prng differs on the card, seed {seed}")
    log("phase 2 prng: card == cpu for keys, fm_noise (8, 3, 2, 8192), "
        "bernoulli (32768,), uniform (32768, 8) and (8192,)")


def _bfs_case(nbr, src, width=3) -> dict:
    import torch
    from repro_torch.kernels import band_batch as bb
    nbr_c = torch.from_numpy(nbr).cuda()
    src_c = torch.from_numpy(src).cuda()
    ms = cuda_ms(lambda: bb.bfs_multi_kernel(nbr_c, src_c, width), reps=20)
    plain_ms = cuda_ms(lambda: bb.bfs_multi_plain(nbr_c, src_c, width),
                       reps=5)
    want = bb.bfs_multi_plain(nbr_c, src_c, width)
    got = bb.bfs_multi_kernel(nbr_c, src_c, width)
    err = int((got.long() - want.long()).abs().max())
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"bfs_multi differs from its plain version "
                             f"at {tuple(nbr.shape)}: max |diff| {err}")
    valid = int((nbr >= 0).sum())
    L, n, _ = nbr.shape
    nbytes = 4 * valid + 4 * L * n + 4 * L * n     # ids, src, dist
    ops = 2 * width * valid                        # compare + add per slot
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S)
    return dict(shape=list(nbr.shape), ms=ms, plain_ms=plain_ms,
                max_abs_err=err, bound_ms=bound_ms,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S >=
                ops / SCALAR_OPS_PER_S else "operations")


def _fm_case(works) -> dict:
    """``fm_fused_multi`` on the card against ``fm_fused_plain`` fed by the
    same keys, with the balance slack and the noise formed on the CPU."""
    import torch
    from repro_torch.core.fm import pack_fm_bucket
    from repro_torch.kernels import fm_fused as ff
    assert len({w.bucket_key() for w in works}) == 1
    passes, pos_only = works[0].passes, works[0].pos_only
    host, counts = pack_fm_bucket(works)
    t = {k: v.cuda() for k, v in host.items()}
    got = ff.fm_fused_multi(**t, passes=passes, pos_only=pos_only)
    vwgt_f = host["vwgt"].float()
    eps_abs = host["eps_frac"] * vwgt_f.sum(1)
    noise = ff.fm_noise(host["keys"], host["nbr"].shape[1], passes)
    args = (t["nbr"], t["lane_work"], vwgt_f.cuda(), t["parts"], t["locked"],
            noise.cuda(), eps_abs.cuda(), t["max_moves"], t["n_pert"])
    plain_ms, want = once_ms(lambda: ff.fm_fused_plain(
        *args, passes=passes, pos_only=pos_only))
    err = max(float((got[0].int() - want[0].int()).abs().max()),
              float((got[1] - want[1]).abs().max()),
              float((got[2] - want[2]).abs().max()))
    if err != 0 or not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"fm_fused_multi differs from its plain version "
                             f"at {tuple(t['nbr'].shape)}: max |diff| {err}")
    # the kernel alone: its time, and its tally of the work the moves needed

    def kernel():
        return ff.fm_fused_kernel(*args, passes=passes, pos_only=pos_only)
    ms = cuda_ms(kernel, reps=3)
    res = kernel()
    if not all(torch.equal(a, b) for a, b in zip(res[:3], want)):
        raise AssertionError("fm_fused_kernel differs from fm_fused_multi")
    L = t["lane_work"].shape[0]
    W, n, d = t["nbr"].shape
    steps, ops, noise_reads = (int(x) for x in res[3].sum(0))
    # each input read once: the tiles' real ids, the lanes' state, the
    # noise entries the moves scored; each output written once
    nbytes = 4 * int((t["nbr"] >= 0).sum()) + L * n * (4 + 1 + 1 + 1) + \
        4 * noise_reads + L * (4 * 4 + 4 + 4)
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S)
    return dict(shape=[L, n, d], works=W, lanes_real=sum(counts),
                steps=steps, ops=ops, noise_reads=noise_reads, bytes=nbytes,
                state_bytes=ff.state_bytes(n, d), ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bound_ms,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S >=
                ops / SCALAR_OPS_PER_S else "operations")


def phase_kernels() -> dict:
    import numpy as np
    from repro_torch.core.fm import FMWork
    from repro_torch.util import pow2
    g, part, band, bpart, locked = plane_problem(30)
    nbr_g, _ = g.to_ell()
    nbr_b, _ = band.to_ell()
    n_b = pow2(band.n)
    d_b = pow2(nbr_b.shape[1], 8)
    out = {}

    # bfs: the root level's fine graph (L=1, 32768, 8) ...
    nb1 = -np.ones((1, pow2(g.n), 8), np.int32)
    nb1[0, :g.n, :nbr_g.shape[1]] = nbr_g
    src1 = np.zeros((1, pow2(g.n)), np.int32)
    src1[0, :g.n] = part == 2
    out["bfs_root"] = _bfs_case(nb1, src1)
    # ... and eight lanes of the altr4-scale band tile (8, 8192, 1024)
    rng = np.random.default_rng(0)
    nb8 = -np.ones((8, n_b, d_b), np.int32)
    nb8[:, :band.n, :nbr_b.shape[1]] = nbr_b
    src8 = np.zeros((8, n_b), np.int32)
    src8[:, :band.n] = bpart == 2
    src8[1:, :band.n] |= rng.random((7, band.n)) < 0.01
    out["bfs_band"] = _bfs_case(nb8, src8)
    log(f"phase 3 bfs_multi == plain: root {out['bfs_root']}")
    log(f"phase 3 bfs_multi == plain: band {out['bfs_band']}")

    # fm: two band works (4 + 2 lanes, mixed budgets) and 2 dummy lanes
    works = [FMWork(nbr=nbr_b, vwgt=band.vwgt, part=bpart, locked=locked,
                    seed=7, k_inst=4, eps_frac=0.12, passes=3, n_pert=8),
             FMWork(nbr=nbr_b, vwgt=band.vwgt, part=bpart, locked=locked,
                    seed=8, k_inst=2, eps_frac=0.12, passes=3, n_pert=8,
                    max_moves=300)]
    out["fm_band"] = _fm_case(works)
    if out["fm_band"]["shape"] != [8, 8192, 1024]:
        raise AssertionError(f"band bucket is {out['fm_band']['shape']}")
    log(f"phase 3 fm_fused_multi == plain: band {out['fm_band']}")
    # fm on the whole graph: n_pad 32768, the largest the main path pads to
    whole = [FMWork(nbr=nbr_g, vwgt=g.vwgt, part=part,
                    locked=np.zeros(g.n, bool), seed=9, k_inst=2,
                    eps_frac=0.12, passes=3, n_pert=8)]
    out["fm_whole"] = _fm_case(whole)
    log(f"phase 3 fm_fused_multi == plain: whole graph {out['fm_whole']}")
    return out


def phase_small_parity() -> None:
    import numpy as np
    from repro_torch.core.nd import nested_dissection
    from repro_torch.graphs.generators import grid3d
    g = grid3d(12, 12, 12)
    t0 = time.perf_counter()
    p_gpu = nested_dissection(g, seed=0, nproc=4, device="cuda")
    t1 = time.perf_counter()
    p_cpu = nested_dissection(g, seed=0, nproc=4, device="cpu")
    t2 = time.perf_counter()
    if not np.array_equal(p_gpu, p_cpu):
        raise AssertionError("grid3d(12,12,12): card and cpu permutations "
                             "differ")
    log(f"phase 4 grid3d(12,12,12) nproc=4: card == cpu permutation "
        f"(card {t1 - t0:.1f} s, cpu {t2 - t1:.1f} s)")


def phase_main() -> dict:
    import numpy as np
    import torch
    from repro_torch.core.nd import nested_dissection
    from repro_torch.graphs.generators import grid3d
    from repro_torch.kernels import band_batch, fm_fused
    from repro_torch.sparse.symbolic import nnz_opc
    g = grid3d(30, 30, 30)
    stage_s = {}
    torch.cuda.synchronize()
    band_batch.launches = 0
    fm_fused.launches = 0
    t0 = time.perf_counter()
    perm = nested_dissection(g, seed=0, nproc=8, device="cuda",
                             stage_s=stage_s)
    wall = time.perf_counter() - t0
    launches = {"bfs_multi": band_batch.launches,
                "fm_fused_multi": fm_fused.launches}
    if not np.array_equal(np.sort(perm), np.arange(g.n)):
        raise AssertionError("main path: not a permutation")
    if min(launches.values()) <= 0:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    nnz, opc = nnz_opc(g, perm)
    stages = {k: stage_s.get(k, 0.0) for k in ("match", "bfs", "fm")}
    stages["host"] = wall - sum(stages.values())
    res = {"graph": "grid3d(30,30,30)", "n": g.n, "m": g.m, "nproc": 8,
           "seed": 0, "wall_s": wall, "stage_s": stages,
           "launches": launches, "nnz": nnz, "opc": opc}
    log(f"phase 5 main path: {json.dumps(res)}")
    return res


def gpu_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs the card",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"the port's package is missing under {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_build()
    phase_prng()
    kern = phase_kernels()
    phase_small_parity()
    main_run = phase_main()
    src = "src/repro_torch/kernels/csrc"
    rows = [
        {"name": "bfs_multi", "route": "cuda", "source": f"{src}/bfs_multi.cu",
         "replaces": "src/repro/kernels/band_batch.py:49",
         "launches": main_run["launches"]["bfs_multi"],
         "max_abs_err": max(kern["bfs_root"]["max_abs_err"],
                            kern["bfs_band"]["max_abs_err"]),
         "ms": kern["bfs_root"]["ms"],
         "plain_ms": kern["bfs_root"]["plain_ms"],
         "bound_ms": kern["bfs_root"]["bound_ms"],
         "bound_by": kern["bfs_root"]["bound_by"], "library_ms": None},
        {"name": "fm_fused_multi", "route": "cuda",
         "source": f"{src}/fm_fused.cu",
         "replaces": "src/repro/kernels/fm_fused.py:209",
         "launches": main_run["launches"]["fm_fused_multi"],
         "max_abs_err": max(kern["fm_band"]["max_abs_err"],
                            kern["fm_whole"]["max_abs_err"]),
         "ms": kern["fm_band"]["ms"], "plain_ms": kern["fm_band"]["plain_ms"],
         "bound_ms": kern["fm_band"]["bound_ms"],
         "bound_by": kern["fm_band"]["bound_by"], "library_ms": None},
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
