#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which must pass:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once) and print the build time;
2. the threefry PRNG on the card equals the PRNG on the CPU for the
   ordering's key and shape sequence (the FM noise of ``fm_noise_plain``
   at (8, 3, 2, 8192) among them, timed on the card), and the matching
   kernel's own threefry (``csrc/threefry.cuh``: the round, coin, tie and
   grant keys derived from each lane's key) gives, in a one-round
   matching, the matching the plain version draws with the CPU PRNG;
3. each kernel equals its plain PyTorch version on the card at the paths'
   shapes, with CUDA-event times of both (the matching, BFS, FM, gain and
   ELL kernels also through their C entries alone, without the wrappers'
   checks and allocations): exactly for the FM, gain and
   BFS kernels (the altr4-scale band of ``grid3d(30, 30, 30)``, dummy lanes
   included, and the whole graph at ``n_pad`` 32768), where the FM kernels
   draw their noise from the lanes' keys and the plain versions with
   ``fm_noise_plain``, each FM kernel is timed through its wrapper and
   its C entry (both results checked), the hoisted
   pass loop must also equal the fused kernel, whose tally at the band
   bucket must be the one PERF.md records for the kernel before its
   redesign (23,440 steps, 241,888,561 operations), and
   ``torch.sparse.mm`` must equal the gains; within 1e-5 (float32), 5e-2
   (bfloat16) and 1e-4 (diffusion, in its vector path and, on copies not
   on 16 bytes, its group path) for the ELL kernels, up to
   ``grid3d(100, 100, 100)``, and
   exactly for the bfloat16 SpMV's rounding of each product.  The
   matching and BFS kernels equal their plain versions exactly in both
   designs (one launch on a cluster per lane, and a launch a phase over
   the card) at the root bucket of ``grid3d(30, 30, 30)`` (1, 32768, 8),
   the widest coarse-level bucket of its root separator's hierarchy, two
   small buckets of ``grid3d(12, 12, 12)``'s, (1, 2048, 8) and (1, 512,
   16), and the threshold shapes (1, 2^15 / 2^17 / 2^20, 8), each timed
   alone in the grid design and on clusters of 1, 2, 4, 8 and 16 CTAs,
   the evidence for ``band_batch.lane_plan``; the gain kernel reads the
   tiles' row extents (``band_batch.row_extents``), as the hoisted path
   gives them.  The ELL
   entries ``ops.spmv`` / ``ops.diffuse`` are then driven once at that
   size with their launch counts set to 0 just before and read just after;
4. ``nested_dissection(grid3d(12, 12, 12), seed=0, nproc=4)`` gives the
   same permutation fused on the card, fused on the CPU, hoisted on the
   card and hoisted on the CPU; the plain gains (``REPRO_FM_GAIN=jnp``)
   and the oracle (``REPRO_FM_MODE=oracle``) raise on the card;
5. the main path: ``nested_dissection(grid3d(30, 30, 30), seed=0,
   nproc=8)`` on the card, with the kernel launch counts set to 0 just
   before and read just after; the matching, BFS and FM kernels must
   have launched, and no noise tensor may have been drawn (``fm_noise``
   and ``fm_noise_plain`` never called: the FM kernels draw it); the fm
   stage's split (``fm_split``: packing, row extents, upload, the
   kernels' device time, download) and the match and bfs stages'
   (``stage_split``: packing, upload, the kernel's device time, download,
   launches a call);
6. the hoisted path at the same width (``REPRO_FM_MODE=hoisted``): the
   same permutation as phase 5, the matching, gain and move-loop kernels
   launched and the fused kernel not, no noise tensor drawn, and the same
   split;
7. the ordering service on the card (``OrderingService()``, the port's
   ``service`` package): the reference service bench's full stream (8
   graphs, 24 requests at nproc 4, three arrival waves of 8 with a
   ``drain()`` after each) and two ``grid3d(30, 30, 30)`` requests at
   nproc 8, seeds 0 and 1, with the first wave; the kernel launch counts
   set to 0 just before and read just after.  Every result equals the
   looped ``nested_dissection`` on the card; 10 orderings computed and 16
   served from the cache; some launch shared by two requests; launches
   == live buckets in every wave; no degrade and no isolation.  Prints
   both paths' walls, per stage (match, bfs, fm) the calls, kernel
   launches and split, the waves, the multi-request waves, the exec
   percentiles by size class, and every bucket the waves produced;
8. the matching, BFS and FM kernels on the bucket groups phase 7's waves
   gave them (``PINNED``: the root buckets of the two grid3d(30³)
   requests together, and the buckets with the most lanes), as the
   executors pack them: each equals its plain version exactly (the
   matching and BFS in both designs, each timed alone, and through the
   wrapper), and each lane equals its work's singleton call; then both
   designs of the matching and BFS at 2^18 slots a lane, d 8, 16 and 32,
   at L = 1 and at the service's most lanes (``band_batch.lane_plan``'s
   threshold);
9. the reference bench's chaos run (its ``chaos_plan``, its 6 graphs at
   nproc 2) on the card: every ``ok`` result bit-identical to the
   fault-free run, the cache clean, an FM group degraded to hoisted, no
   call of the oracle or of a plain version, every FM call on the card;
10. the distributed ordering (``core.dnd``, ``core.dgraph``) on the
   card: (b) ``distributed_nested_dissection(distribute(grid3d(30, 30,
   30), 8), seed=0)`` with the default ``DNDConfig``, with every kernel
   launch count set to 0 just before and read just after — a
   permutation, the same under the depth-first driver, every gather of a
   graph spread over two parts or more within the gather-free tests'
   bound (one-part subtrees, already on one process, are handed to the
   sequential orderer whole, as in the reference), alternating-colour band
   refinements with 0 conflicts and 0 repairs, launches == buckets in
   every wave, the halo, BFS and matching kernels and the FM, BFS and
   matching kernels of the endgame launched, the distributed kernels'
   launches, as the C entries report what they enqueued, equal to what
   ``dgraph_ops.planned_launches`` gives the run's launch records (one
   launch a BFS and a matching call on the cluster design, no
   relaxation), every halo call one launch of the halo kernel (CUDA
   events around its C entry), one ghost slot table resolved a distinct
   DGraph exchanged, no plain version called; its NNZ and
   OPC beside
   phase 5's host ND, its wall split by stage (dmatch, dbfs, dhalo,
   fm, match, bfs, rebuild, endgame, host), and the dhalo stage's split
   (``dhalo_split``: staging, upload, slot tables, device, download,
   calls); (c) ``distributed_order_batch``
   of that graph at seeds 0 and 1 and ``grid2d(28, 28)`` at P 8 equals
   each ordered alone, and ``OrderingService().submit_distributed`` of it
   returns the same permutation, then a cache hit; (d) ``grid2d(28, 28)``
   at P 8 with the gather-free configuration gives the same permutation
   on the card and on the CPU; (a) the four kernels (``csrc/dgraph.cu``:
   the ELL relaxation, the halo exchange, the distributed BFS at width 3,
   the matching at 8 rounds at the path's cap, dense, at its lossless cap
   and at a cap that drops proposals) equal their plain versions exactly
   at the root bucket of ``distribute(grid3d(30, 30, 30), 8)`` (8, 4096,
   8, 2048), at ``distribute(grid3d(100, 100, 100), 8)`` (8, 131072, 8,
   32768) and at the buckets with the most lanes (b)'s waves gave the BFS
   and the matching, each lane equal to its singleton call, each timed
   alone (its C entry; the halo and the relaxation back to back and
   queued behind a device sleep, beside the launch floor, an empty
   kernel of ``dgraph.cu``) and through its wrapper; the BFS and the matching
   in the design ``dgraph_ops.plan`` picks (with where its state lay),
   and at the root bucket (2^18 slots, where the plan switches) and the
   many-lane buckets also on 8 CTAs and in the other design, each held
   to its plain version;
11. the LM serving path (``serve.engine``) at full width and depth:
   ``yi-6b`` (32 layers, d 4096, 32 / 4 heads, vocab 64000, about 6.06 B
   parameters in bfloat16) initialised on the card from a seeded
   generator; 4 prompts of 128 seeded tokens, prefill padded to 160
   positions, then 32 greedy decode steps (after a warm-up of 2).  The
   prefill and every step's logits equal the port's own ``forward`` over
   the same teacher-forced tokens within 0.15 (the reference test's
   tolerance), and a float32 copy of the weights run through the same
   modules (no TF32) within ``LM_F32_MAX`` / ``LM_F32_RMS``;
   ``greedy_generate`` gives the loop's tokens.  Prints the prefill ms,
   its ``flopcount.forward_flops`` as a share of the dense bfloat16 peak,
   the decode ms a step beside its bound (the bytes a step reads over
   the HBM rate), the card's name and power limit.  Then the ten
   ``reduced()`` architectures (MoE ones at capacity factor 8): prefill
   and teacher-forced decode equal their own forward within 0.15, a
   MoE's up to its first routing difference, which must be a near tie;
12. every example of the port (``repro_torch.examples``: quickstart,
   serve_orderings, order_mesh, expert_placement, serve_lm, train_lm) on
   the card with small arguments, the service example traced and the
   trace summarised by ``repro_torch.scripts.trace_summary``; train_lm
   with a checkpoint every 2 steps and a simulated failure at step 3
   (restarted through the trainer's own loop, step 2 replayed bit for
   bit), then resumed from step 6;
13. the LM training path (``train.step``, ``optim.adamw``, remat,
   ``train.checkpoint``, ``data.pipeline``) at full width and depth:
   ``mamba2-130m`` (24 layers, d 768, vocab 50280) in bfloat16 from
   seed 0 on the card, AdamW lr 3e-4 with a warm-up of 20, batches of
   8 × 512 from the port's pipeline (seed 0), remat "full"; 2 warm-up
   and 10 timed steps, every loss and grad norm finite and the
   parameters changed; the first step's loss and grad norm against a
   float32 copy of the weights through the same modules (no TF32) within
   ``TRAIN_F32_*``; a checkpoint after step 12, two more steps, a
   restore into a fresh tree and the same two steps replayed: the losses
   and every leaf bit-equal.  Prints the step ms (CUDA events), tokens/s,
   model FLOPs (3 × ``flopcount.forward_flops``) as a share of the
   bfloat16 peak, kernels a step, the card's busy ms and idle share and
   the aten ops of the most device time (``torch.profiler`` over one
   step), peak memory with remat "full" and off.  Then the ten
   ``reduced()`` architectures one train step each (finite, parameters
   changed; the float32 step card == CPU within ``REDUCED_STEP_RTOL``, a
   MoE's routing recorded on both sides, any difference a near tie) and
   the reference's ``test_loss_decreases`` (reduced yi-6b, 30 steps);
14. the roofline (``roofline.analyze``: FLOPs by ``FlopCounterMode``'s
   formulas, bytes as each op's inputs read and outputs written, the
   ring model over collectives, live bytes; H100 constants) and the dry
   run (``launch.dryrun``): (a) phase 11's yi-6b prefill and one step of
   phase 13's mamba2-130m training (remat "full"), real tensors on the
   card, ``NO_SHARD``: each term, the bound and its term beside the
   CUDA-event time of this run and the profiler's busy time; the bound
   at most ``ROOF_BOUND_SLACK`` × the measured time and the counted
   FLOPs within ``ROOF_FLOPS_RTOL`` of ``flopcount`` (the prefill's
   ``forward_flops``, 4 × for the step: remat recomputes the forward);
   (b) the dry run of phase 13's step on a 1 × 1 mesh of fake card
   tensors, remat "full" and off: its peak within ``ROOF_MEM_RTOL`` of
   ``torch.cuda.max_memory_allocated`` of the real step, its argument
   bytes equal to the real state's; (c) ``ROOF_CELLS`` at full width on
   the fake H100 meshes (32 × 8 cards, 2 × 32 × 8), with the depth
   slope: each OK, its argument bytes equal to its specs' local shard
   bytes, the slope's FLOPs equal to the full-depth count; each cell's
   three terms, bottleneck, peak a card (and whether it fits in 80 GB)
   and collective counts;
15. the distributed ordering on a group (``dgraph.make_parts_group``, the
   counterpart of the reference's ``make_parts_mesh``): a line says
   whether the groups are distinct cards (where
   ``torch.cuda.device_count()`` allows) or ``cuda:0`` repeated (the same
   code path, the rows crossing inside the card).  On groups of 2, 4 and
   8: ``distribute(grid3d(30, 30, 30), 8)`` ordered under both drivers,
   each permutation's sha256 equal to phase 10's one-card permutation's,
   the distributed kernels' launches equal to what
   ``dgraph_ops.planned_launches`` gives the run's records (each member's
   own), no plain version called, the wall and its split by stage, the
   bytes copied between members; then the halo, the BFS (width 3) and
   the matching (8 rounds) at each of phase 10's kernel buckets (the
   root bucket, ``grid3d(100, 100, 100)`` over 8 parts and the frontier
   waves' many-lane buckets of the BFS and of the matching) on each
   group, each equal to the one-card call, and the members' kernels
   (their part ranges' lane offsets included) to their plain versions on
   the card (the matching at the path's cap, dense, at its lossless cap
   and at a cap that drops proposals), with the call's CUDA-event time,
   the members' kernels' alone, the one-card call's, launches a call and
   the bytes copied between members;
16. training on a real process group (``launch.mesh.init_host_group``:
   NCCL, a world of one rank on the card; ``make_host_mesh`` → (1, 1)):
   (a) a line with the world size and whether the ranks are distinct
   cards; (b) phase 13's model at full width and depth, 8 × 512, remat
   "full", 3 steps at the trainer's settings on the mesh (parameters by
   ``param_specs``, optimizer state by ``zero1_specs``, batches by
   ``batch_specs``) and 3 ``NO_SHARD`` steps from the same parameters and
   batches: losses, grad norms and every leaf bit-equal; each one's step
   ms (CUDA events), kernels a step, busy ms and idle share
   (``torch.profiler``); with ``--train-group`` (phase 16 alone) also
   ``adamw.update`` over the DTensors, on each card's shards and through
   DTensor dispatch (both results checked); (c) a checkpoint under the
   mesh, ``restore(shardings)`` onto it, 2 steps replayed: losses and
   leaves bit-equal; (d) ``python -m repro_torch.launch.train`` (5 steps,
   one checkpoint at step 3, a failure at step 4) on the card: exit 0,
   the mesh, its plain tensors on one rank and the restart printed, each
   loss equal to (b)'s and (c)'s, its warm step ms; (e) only with two cards or more,
   ``min(4, count)`` NCCL ranks on distinct cards on a (1, n) mesh,
   reduced yi-6b and mamba2-130m in float32 within ``GROUP_LOSS_RTOL`` of
   one card.  The group is destroyed before (d);
17. serving on a real process group (NCCL, a world of one rank on the
   card; ``make_host_mesh`` → (1, 1)): (a) a line with the world size and
   whether the ranks are distinct cards; (b) phase 11's model, parameters
   and prompts at full width and depth (yi-6b in bfloat16, 4 × 128
   tokens padded to 160), ``SERVE_STEPS`` decode steps on the mesh
   (parameters by ``param_specs``, prompts and tokens by
   ``batch_specs``, the caches as ``prefill`` places them, by
   ``cache_specs``) and ``NO_SHARD``, the mesh fed ``NO_SHARD``'s greedy
   tokens: the prefill logits, every step's and every cache leaf after
   the last step bit-equal; each one's prefill ms and decode ms a step
   (CUDA events), kernels a step, busy ms and idle share
   (``torch.profiler``, one step); (c) the ten ``reduced()``
   architectures (bfloat16) the same way, prefill and 3 decode steps,
   with the caches' placements (deepseek-v2-lite's latent caches split
   on the sequence, so ``sharding.write_at`` writes through its DTensor
   branch); (d) only with two cards or more, ``min(4, count)`` NCCL
   ranks on distinct cards on a (1, n) mesh, reduced deepseek-v2-lite,
   granite-34b and yi-6b in float32, every logit within
   ``SERVE_GROUP_TOL`` of the largest of one card's.  The group is
   destroyed at the end of the phase;
18. a ``{"kernels": [...]}`` line with each kernel's launches, error,
   times, bound and library time (rows 0-2 also with their phase 7
   launches and phase 8 multi-lane times, rows 7-10 with their launches
   on phase 10's distributed main path, row 7 marked off that path when
   it launched 0 times there, rows 9-10 with their designs' times, and
   their times at the other two places; rows 7-10 also with phase 15's
   launches a call on each group, times and bytes), the card's name and
   power limit, and as the last
   line ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without that last line.  Imports neither jax
nor the reference package.

    python3 chip_smoke.py --dist-rows SRC

times rows 7-10 alone at phase 10's three buckets in the package under
SRC (``src``, or a parent commit's unpacked under a directory that
``.gitignore`` lists), each held to its plain version (rows 7-8 also
queued behind a device sleep, beside the launch floor), and a warm
distributed ordering of grid3d(30³) over 8 parts (wall, stage split,
the dhalo stage's split, launches, the permutation's hash), and prints
one JSON line and the card's name and power limit: run it for the
parent and the change in one call, in the order parent, change, change,
parent.  With ``--groups D`` the same run also times the halo, BFS and
matching at those buckets and the ordering with their parts on a group
of D (phase 15's layout), in a tree that has groups.

    python3 chip_smoke.py --train-group

runs phase 16 alone, and ``--serve-group`` phase 17 alone.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
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
# integer operations of one threefry2x32 draw (20 add-rotate-xor rounds,
# key injections, the uniform's shift and subtract)
OPS_PER_DRAW = 100


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


def queued_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn()`` over ``reps`` runs queued behind a
    device sleep long enough to hide the host's enqueue time: the card's
    time alone, without the gaps a host slower than the kernels leaves."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6) * reps // 10 + int(2e7))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def entry_ms(source: str, entry: str, *args, reps: int = 50,
             queued: bool = False) -> float:
    """Mean CUDA-event time of a kernel's C entry alone: the launch without
    its wrapper's checks, allocations and host syncs (tensors are passed
    as pointers, in the entry's order; outputs are overwritten)."""
    import torch
    from repro_torch.kernels import build
    fn = getattr(build.load(source), entry)
    vals = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        build.check(fn(*vals, stream), entry)
    return (queued_ms if queued else cuda_ms)(launch, reps)


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


def bound(nbytes: float, ops: float) -> dict:
    """The least time for ``nbytes`` moved once and ``ops`` operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return dict(bytes=nbytes, ops=ops, bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


@contextlib.contextmanager
def env(**values):
    """Set (or, for None, unset) environment variables; restore after."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


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


def phase_prng() -> dict:
    import torch
    from repro_torch import prng
    from repro_torch.kernels import fm_fused as ff
    for seed in (0, 1, 12345, 2 ** 31 - 1):
        per_device = []
        for dev in ("cpu", "cuda"):
            keys = prng.split(prng.PRNGKey(seed, dev), 8)
            per_device.append([keys, ff.fm_noise_plain(keys, 8192, 3),
                               prng.bernoulli(keys, 0.5, (32768,)),
                               prng.uniform(keys[:2], (32768, 8)),
                               prng.uniform(keys, (8192,)),
                               prng.split(keys, 8)])
        for a, b in zip(*per_device):
            if not torch.equal(a, b.cpu()):
                raise AssertionError(f"prng differs on the card, seed {seed}")
    # threefry.cuh's key schedule, through a one-round matching: the kernel
    # derives every key and draw itself; the plain version on the CPU draws
    # them with the CPU PRNG
    from repro_torch.kernels import matching
    nbr, wgt = _match_inputs(8, 4096, 8, seed=3)
    for seed in (0, 1, 12345, 2 ** 31 - 1):
        keys = prng.split(prng.PRNGKey(seed), 8)
        got = matching.heavy_edge_matching_multi_kernel(
            nbr.cuda(), wgt.cuda(), keys.cuda(), rounds=1)
        want = matching.heavy_edge_matching_multi_plain(nbr, wgt, keys, 1)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"threefry.cuh: the one-round matching on "
                                 f"the card differs from the CPU's, seed "
                                 f"{seed}")
    log("phase 2 prng: card == cpu for keys, fm_noise_plain (8, 3, 2, 8192), "
        "bernoulli (32768,), uniform (32768, 8) and (8192,); threefry.cuh "
        "one-round matching (8, 4096, 8) == cpu for 4 seeds")
    # the noise as a tensor, the plain version's draw of the band bucket's
    # (L, passes, 2, n), which the FM kernels now draw in place
    keys = prng.split(prng.PRNGKey(3, "cuda"), 8)
    return dict(shape=[8, 3, 2, 8192], plain_ms=cuda_ms(
        lambda: ff.fm_noise_plain(keys, 8192, 3), reps=5))


def _match_inputs(L, n, d, seed):
    """A random ELL bucket (-1 slots anywhere, weights 1-3) as CPU tensors."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n, (L, n, d)).astype(np.int32)
    nbr[rng.random((L, n, d)) < 0.4] = -1
    wgt = np.where(nbr >= 0, rng.integers(1, 4, (L, n, d)), 0)
    return torch.from_numpy(nbr), torch.from_numpy(wgt.astype(np.int32))


def _design_key(plan) -> str:
    """The name of the design ``lane_plan`` gives, as ``_designs`` names it."""
    return "grid" if plan[0] == "grid" else f"cluster_{plan[1]}"


def _designs(grid, cluster, args, out, n, d):
    """A kernel's designs as name → (C entry, arguments, output): the grid
    entry, and the cluster entry at the cluster sizes 1, 2, 4, 8, 16 and
    ``cluster_size(n, d)``, whatever the lane's size; the output is
    overwritten by each launch of an entry."""
    from repro_torch.kernels.band_batch import cluster_size
    named = {"grid": (grid, args, out)}
    for C in sorted({1, 2, 4, 8, 16, cluster_size(n, d)}):
        named[f"cluster_{C}"] = (cluster, args + (C,), out)
    return named


def _bfs_designs(nbr, src, width):
    import torch
    L, n, d = nbr.shape
    dist = torch.empty((L, n), dtype=torch.int32, device="cuda")
    return _designs("bfs_multi_launch", "bfs_cluster_launch",
                    (nbr, src, dist, torch.empty_like(dist), L, n, d, width),
                    dist, n, d)


def _bfs_case(nbr, src, width=3) -> dict:
    """``bfs_multi`` on one bucket: each design's C entry alone and the
    wrapper, all held exactly to the plain version on the card."""
    import torch
    from repro_torch.kernels import band_batch as bb
    nbr_c = torch.from_numpy(nbr).cuda()
    src_c = torch.from_numpy(src).cuda()
    want = bb.bfs_multi_plain(nbr_c, src_c, width)
    got = bb.bfs_multi_kernel(nbr_c, src_c, width)
    err = int((got.long() - want.long()).abs().max())
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"bfs_multi differs from its plain version "
                             f"at {tuple(nbr.shape)}: max |diff| {err}")
    designs = {}
    for name, (entry, args, out) in _bfs_designs(nbr_c, src_c,
                                                 width).items():
        designs[name] = entry_ms("bfs_multi", entry, *args, reps=20)
        if not torch.equal(out, want):
            raise AssertionError(f"bfs_multi's {name} design differs from "
                                 f"its plain version at {tuple(nbr.shape)}")
    call_ms = cuda_ms(lambda: bb.bfs_multi_kernel(nbr_c, src_c, width),
                      reps=20)
    plain_ms = cuda_ms(lambda: bb.bfs_multi_plain(nbr_c, src_c, width),
                       reps=5)
    valid = int((nbr >= 0).sum())
    L, n, _ = nbr.shape
    nbytes = 4 * valid + 4 * L * n + 4 * L * n     # ids, src, dist
    ops = 2 * width * valid                        # compare + add per slot
    planned = bb.lane_plan(n, nbr.shape[2])
    return dict(shape=list(nbr.shape), plan=planned,
                ms=designs[_design_key(planned)], designs_ms=designs,
                call_ms=call_ms, plain_ms=plain_ms,
                max_abs_err=err, **bound(nbytes, ops))


def _plane_bfs(g, side):
    """The BFS bucket (L=1) of ``g = grid3d(side³)`` from the plane x =
    side/2, padded as ``execute_bfs_works`` pads it."""
    import numpy as np
    from repro_torch.util import pow2
    nbr_g, _ = g.to_ell()
    n_pad = pow2(g.n)
    nb = -np.ones((1, n_pad, pow2(nbr_g.shape[1], 8)), np.int32)
    nb[0, :g.n, :nbr_g.shape[1]] = nbr_g
    src = np.zeros((1, n_pad), np.int32)
    src[0, :g.n] = np.arange(g.n) // (side * side) == side // 2
    return nb, src


def _fm_entry_args(args, extents, passes, pos_only, p=None):
    """The C entry's arguments of ``fm_fused_launch`` (``p`` None) or
    ``fm_move_loop_launch`` (pass ``p``) for the wrapper's ``args``, and
    the fresh outputs among them (parts, sep_w, imb, tally, scratch)."""
    from repro_torch.kernels import fm_fused as ff
    nbr, lane_work = args[0], args[1]
    L = lane_work.shape[0]
    W, n, d = nbr.shape
    outs = ff._lane_outputs(L, n, d, nbr.device)
    head = (nbr, extents.row_len) + tuple(args[1:]) + outs + (L, W, n, d)
    if p is None:
        return head + (extents.group, passes, int(pos_only)), outs
    return head + (p, int(pos_only)), outs


def _timed_fm(wrapper, entry, entry_args, outs, want, name):
    """An FM kernel's time through its wrapper (``call_ms``) and through its
    C entry alone (``ms``), each result held to the plain version's
    ``want`` and the two tallies to each other; returns the times and the
    tally summed over lanes."""
    import torch
    call_ms = cuda_ms(wrapper, reps=3)
    res = wrapper()
    ms = entry_ms("fm_fused", entry, *entry_args, reps=3)
    for got in (res, outs):
        if not all(torch.equal(a, b) for a, b in zip(got[:3], want)):
            raise AssertionError(f"{name} (wrapper or C entry) differs from "
                                 f"its plain version")
    if not torch.equal(res[3], outs[3]):
        raise AssertionError(f"{name}: the wrapper's and the C entry's "
                             f"tallies differ")
    return ms, call_ms, tuple(int(x) for x in res[3].sum(0))


def _fm_case(works) -> dict:
    """``fm_fused_multi`` on the card against ``fm_fused_plain`` fed by the
    same keys, with the balance slack formed on the CPU; the hoisted pass
    loop (gain kernel + move-loop kernel) against both; the fused and the
    move-loop kernels timed through their wrappers and their C entries."""
    import torch
    from repro_torch.core.fm import fm_refine_multi, pack_fm_bucket
    from repro_torch.kernels import fm_fused as ff
    assert len({w.bucket_key() for w in works}) == 1
    passes, pos_only = works[0].passes, works[0].pos_only
    host, counts = pack_fm_bucket(works)
    t = {k: v.to("cuda") for k, v in host.items()}
    extents = t["extents"]
    vwgt_f = host["vwgt"].float()
    eps_abs = host["eps_frac"] * vwgt_f.sum(1)
    args = (t["nbr"], t["lane_work"], vwgt_f.cuda(), t["parts"], t["locked"],
            t["keys"], eps_abs.cuda(), t["max_moves"], t["n_pert"])
    L = t["lane_work"].shape[0]
    W, n, d = t["nbr"].shape
    got = ff.fm_fused_multi(**t, passes=passes, pos_only=pos_only)
    plain_ms, want = once_ms(lambda: ff.fm_fused_plain(
        *args, passes=passes, pos_only=pos_only))
    err = max(max_err(g, w) for g, w in zip(got, want))
    if err != 0 or not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"fm_fused_multi differs from its plain version "
                             f"at {tuple(t['nbr'].shape)}: max |diff| {err}")
    # the hoisted pass loop: per pass the gain kernel (reading the tiles'
    # row extents) and the move loop
    hoisted_ms = cuda_ms(lambda: fm_refine_multi(
        **t, passes=passes, pos_only=pos_only, gain_mode="pallas"), reps=3)
    hoisted = fm_refine_multi(**t, passes=passes, pos_only=pos_only,
                              gain_mode="pallas")
    if not all(torch.equal(a, b) for a, b in zip(hoisted, want)):
        raise AssertionError("the hoisted pass loop differs from "
                             "fm_fused_multi and fm_fused_plain")
    # the kernel alone: its times, and its tally of the work the moves
    # needed
    ms, call_ms, (steps, ops, draws) = _timed_fm(
        lambda: ff.fm_fused_kernel(*args, passes=passes, pos_only=pos_only,
                                   extents=extents),
        "fm_fused_launch", *_fm_entry_args(args, extents, passes, pos_only),
        want, "fm_fused_kernel")
    real_ids = int((t["nbr"] >= 0).sum())
    # each input read once: the tiles' real ids, the lanes' state and keys;
    # each output written once; the operations the moves need, the noise
    # entries they need drawn and each pass's key schedule (p + 1 splits)
    nbytes = 4 * real_ids + L * n * (4 + 1 + 1 + 1) + 16 * L + \
        L * (4 * 4 + 4 + 4)
    splits = L * passes * (passes + 1) // 2
    out = dict(shape=[L, n, d], works=W, lanes_real=sum(counts),
               steps=steps, move_ops=ops, draws=draws,
               state_bytes=ff.state_bytes(n, d), ms=ms, call_ms=call_ms,
               plain_ms=plain_ms, hoisted_ms=hoisted_ms, max_abs_err=err,
               **bound(nbytes, ops + OPS_PER_DRAW * (draws + splits)))
    out["move_loop"] = _move_loop_case(args, extents, pos_only)
    return out


def _move_loop_case(args, extents, pos_only) -> dict:
    """The first pass of the hoisted path: ``fm_move_loop``'s kernel
    against its plain version, with the gains from the gain kernel."""
    from repro_torch.kernels import band_batch as bb
    from repro_torch.kernels import fm_fused as ff
    nbr, lane_work, vw, parts, locked, keys, eps_abs, max_moves, n_pert = \
        args
    pulled0, pulled1 = bb.sep_gain_multi_kernel(nbr, lane_work, vw, parts,
                                                extents)
    bws = (vw * (parts == 2)).sum(1)
    bimb = ((vw * (parts == 0)).sum(1) - (vw * (parts == 1)).sum(1)).abs()
    pass_args = (nbr, lane_work, vw, parts, locked, pulled0, pulled1, keys,
                 0, n_pert, eps_abs, max_moves, bws, bimb)
    plain_ms, want = once_ms(lambda: ff.fm_move_loop_plain(
        *pass_args, pos_only=pos_only))
    res = ff.fm_move_loop_kernel(*pass_args, pos_only=pos_only,
                                 extents=extents)
    err = max(max_err(g, w) for g, w in zip(res[:3], want))
    if err != 0:
        raise AssertionError(f"fm_move_loop differs from its plain version: "
                             f"max |diff| {err}")
    ms, call_ms, (steps, ops, draws) = _timed_fm(
        lambda: ff.fm_move_loop_kernel(*pass_args, pos_only=pos_only,
                                       extents=extents),
        "fm_move_loop_launch", *_fm_entry_args(
            pass_args[:8] + pass_args[9:], extents, 1, pos_only, p=0),
        want, "fm_move_loop_kernel")
    L, n = parts.shape
    # each input read once: the lanes' weights, states, locks, pulled
    # weights and keys; each output written once; the operations, the
    # draws and the pass's key schedule
    nbytes = L * n * (4 + 1 + 1 + 8 + 1) + 16 * L + L * 4 * 5
    return dict(steps=steps, draws=draws, ms=ms, call_ms=call_ms,
                plain_ms=plain_ms, max_abs_err=err,
                **bound(nbytes, ops + OPS_PER_DRAW * (draws + L)))


def _lanes_csr(nbr, lane_work):
    """The lanes' ELL tiles as one block-diagonal CSR matrix (L·n, L·n):
    an entry counts the slots of row v that name u (duplicates summed)."""
    import torch
    W, n, d = nbr.shape
    L = lane_work.shape[0]
    tiles = nbr.index_select(0, lane_work.long())
    valid = tiles >= 0
    base = (torch.arange(L, device=nbr.device) * n)[:, None, None]
    rows = (base + torch.arange(n, device=nbr.device)[None, :, None]
            ).expand(L, n, d)[valid]
    cols = (tiles.long() + base)[valid]
    coo = torch.sparse_coo_tensor(
        torch.stack([rows, cols]), torch.ones_like(cols, dtype=torch.float32),
        (L * n, L * n)).coalesce()
    return coo.to_sparse_csr()


def _gain_case(nbr, lane_work, vwgt, part, extents) -> dict:
    """``sep_gain_multi`` on the card, reading the tiles' row extents as
    the hoisted path gives them, against its plain version and against
    ``torch.sparse.mm`` of the tiles with the side weights."""
    import torch
    from repro_torch.kernels import band_batch as bb
    args = (nbr, lane_work, vwgt, part)
    got = bb.sep_gain_multi_kernel(*args, extents)
    want = bb.sep_gain_multi_plain(*args)
    err = max(max_err(g, w) for g, w in zip(got, want))
    if err != 0 or not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"sep_gain_multi differs from its plain version "
                             f"at {tuple(nbr.shape)}: max |diff| {err}")
    L, n = part.shape
    d = nbr.shape[2]
    outs = [torch.empty_like(g) for g in got]
    group = extents.group
    ms = entry_ms("sep_gain", "sep_gain_launch", nbr, lane_work,
                  extents.row_len, vwgt, part, *outs, L, nbr.shape[0], n, d,
                  group)
    call_ms = cuda_ms(lambda: bb.sep_gain_multi_kernel(*args, extents),
                      reps=20)
    plain_ms = cuda_ms(lambda: bb.sep_gain_multi_plain(*args), reps=3)
    A = _lanes_csr(nbr, lane_work)
    Y = torch.stack([vwgt * (part == 1), vwgt * (part == 0)], dim=-1) \
        .reshape(L * n, 2)
    library_ms = cuda_ms(lambda: torch.sparse.mm(A, Y), reps=20)
    lib = torch.sparse.mm(A, Y).reshape(L, n, 2)
    lib_err = max(max_err(lib[..., 0], got[0]), max_err(lib[..., 1], got[1]))
    if lib_err != 0:
        raise AssertionError(f"torch.sparse.mm differs from sep_gain_multi: "
                             f"max |diff| {lib_err}")
    tile_ids = (nbr >= 0).sum((1, 2))
    slots = int(tile_ids.index_select(0, lane_work.long()).sum())
    # the tiles' real ids once, each lane's part and vwgt once, the two
    # outputs once; a compare and an add per real slot of every lane
    nbytes = 4 * int(tile_ids.sum()) + L * n * (1 + 4) + 2 * 4 * L * n
    return dict(shape=[L, n, d], tiles=nbr.shape[0], group=group, ms=ms,
                call_ms=call_ms, plain_ms=plain_ms,
                library_ms=library_ms, max_abs_err=err,
                library_err=lib_err, **bound(nbytes, 2 * slots))


def _match_designs(nbr, wgt, keys, rounds):
    import torch
    L, n, d = nbr.shape
    match = torch.empty((L, n), dtype=torch.int32, device="cuda")
    scratch = torch.empty(2 * L * n + (5 * L * n + 7) // 8,
                          dtype=torch.int64, device="cuda")
    return _designs("matching_grid_launch", "matching_cluster_launch",
                    (nbr, wgt, keys, match, scratch, L, n, d, rounds), match,
                    n, d)


def _match_case(work) -> dict:
    """The matching kernel on one ``MatchWork``'s bucket, padded as
    ``execute_match_works`` pads it: each design's C entry alone and the
    wrapper, all held exactly to the plain version on the card; the bound
    counts the draws this run's rounds need (the plain version's tally)
    and the tile's real slots."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.kernels import matching
    from repro_torch.kernels.band_batch import lane_plan
    n_pad, d_pad, rounds = work.bucket_key()
    n, d = work.nbr.shape
    nbr = -np.ones((1, n_pad, d_pad), np.int32)
    wgt = np.zeros((1, n_pad, d_pad), np.int32)
    nbr[0, :n, :d], wgt[0, :n, :d] = work.nbr, work.wgt
    nbr, wgt = torch.from_numpy(nbr).cuda(), torch.from_numpy(wgt).cuda()
    keys = prng.PRNGKey(work.seed, "cuda")[None]
    got = matching.heavy_edge_matching_multi_kernel(nbr, wgt, keys, rounds)
    tally = []
    want = matching.heavy_edge_matching_multi_plain(nbr, wgt, keys, rounds,
                                                    tally=tally)
    err = int((got.long() - want.long()).abs().max())
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"the matching kernel differs from its plain "
                             f"version at (1, {n_pad}, {d_pad}): max |diff| "
                             f"{err}")
    m = got[0, :n].long().cpu()
    if not torch.equal(m[m], torch.arange(n)):
        raise AssertionError("the matching kernel's matching is no involution")
    designs = {}
    for name, (entry, args, out) in _match_designs(nbr, wgt, keys,
                                                   rounds).items():
        designs[name] = entry_ms("matching", entry, *args)
        if not torch.equal(out, want):
            raise AssertionError(f"the matching's {name} design differs from "
                                 f"its plain version at (1, {n_pad}, "
                                 f"{d_pad})")
    call_ms = cuda_ms(lambda: matching.heavy_edge_matching_multi_kernel(
        nbr, wgt, keys, rounds), reps=20)
    plain_ms = cuda_ms(lambda: matching.heavy_edge_matching_multi_plain(
        nbr, wgt, keys, rounds), reps=3)
    # the draws the rounds need (coins of unmatched vertices, ties of the
    # slots proposers score, grant keys of proposals) and 4 key-schedule
    # draws a round; ids and weights of the real slots, the key and the
    # output once
    draws = sum(sum(t) for t in tally) + 4 * rounds
    nbytes = 8 * int((nbr >= 0).sum()) + 16 + 4 * n_pad
    planned = lane_plan(n_pad, d_pad)
    return dict(shape=[1, n_pad, d_pad], n=n, rounds=rounds, draws=draws,
                matched=int((m != torch.arange(n)).sum()), plan=planned,
                ms=designs[_design_key(planned)], designs_ms=designs,
                call_ms=call_ms, plain_ms=plain_ms, max_abs_err=err,
                **bound(nbytes, OPS_PER_DRAW * draws))


def _band_works(nbr_b, band, bpart, locked):
    """Two FM works on one band (4 + 2 lanes, mixed budgets), which pack
    with 2 dummy lanes into a bucket of 8."""
    from repro_torch.core.fm import FMWork
    return [FMWork(nbr=nbr_b, vwgt=band.vwgt, part=bpart, locked=locked,
                   seed=7, k_inst=4, eps_frac=0.12, passes=3, n_pert=8),
            FMWork(nbr=nbr_b, vwgt=band.vwgt, part=bpart, locked=locked,
                   seed=8, k_inst=2, eps_frac=0.12, passes=3, n_pert=8,
                   max_moves=300)]


def coarse_levels(side: int):
    """The levels of ``grid3d(side³)``'s root hierarchy (seed 0, nproc 8,
    the default ``NDConfig``), coarsened on the card."""
    from repro_torch.core.coarsen import coarsen_multilevel
    from repro_torch.core.nd import NDConfig
    from repro_torch.graphs.generators import grid3d
    cfg = NDConfig()
    return coarsen_multilevel(grid3d(side, side, side), seed=0, nproc=8,
                              coarse_target=cfg.coarse_target,
                              fold_threshold=cfg.fold_threshold,
                              max_instances=cfg.k_fm_cap,
                              device="cuda").levels


def phase_kernels() -> dict:
    import numpy as np
    import torch
    from repro_torch.core.coarsen import match_work_for
    from repro_torch.core.fm import FMWork, pack_fm_bucket
    from repro_torch.graphs.generators import grid3d
    from repro_torch.kernels.band_batch import row_extents
    from repro_torch.util import pow2
    g, part, band, bpart, locked = plane_problem(30)
    nbr_g, _ = g.to_ell()
    nbr_b, _ = band.to_ell()
    n_b = pow2(band.n)
    d_b = pow2(nbr_b.shape[1], 8)
    out = {}

    # bfs: the root level's fine graph (L=1, 32768, 8) ...
    nb1, src1 = _plane_bfs(g, 30)
    out["bfs_root"] = _bfs_case(nb1, src1)
    # ... eight lanes of the altr4-scale band tile (8, 8192, 1024) ...
    rng = np.random.default_rng(0)
    nb8 = -np.ones((8, n_b, d_b), np.int32)
    nb8[:, :band.n, :nbr_b.shape[1]] = nbr_b
    src8 = np.zeros((8, n_b), np.int32)
    src8[:, :band.n] = bpart == 2
    src8[1:, :band.n] |= rng.random((7, band.n)) < 0.01
    out["bfs_band"] = _bfs_case(nb8, src8)
    # ... two small buckets of the kind most calls have: grid3d(12³)
    # (1, 2048, 8) and its second coarse level (1, 512, 16), with 5% of
    # its vertices as sources ...
    small = coarse_levels(12)
    nb_s, src_s = _plane_bfs(grid3d(12, 12, 12), 12)
    out["bfs_small_2048"] = _bfs_case(nb_s, src_s)
    c2 = small[2].graph
    nb_c, _ = c2.to_ell()
    nb_s = -np.ones((1, pow2(c2.n), pow2(nb_c.shape[1], 8)), np.int32)
    nb_s[0, :c2.n, :nb_c.shape[1]] = nb_c
    src_s = np.zeros((1, nb_s.shape[1]), np.int32)
    src_s[0, :c2.n] = rng.random(c2.n) < 0.05
    out["bfs_small_512"] = _bfs_case(nb_s, src_s)
    # ... and the designs at the threshold shapes (1, 2^15 / 2^17 / 2^20, 8)
    for side in (30, 50, 100):
        case = _bfs_case(*_plane_bfs(grid3d(side, side, side), side))
        out[f"bfs_threshold_{case['shape'][1]}"] = case
    for key, case in out.items():
        log(f"phase 3 bfs_multi == plain: {key} {case}")

    # fm: two band works (4 + 2 lanes, mixed budgets) and 2 dummy lanes
    works = _band_works(nbr_b, band, bpart, locked)
    out["fm_band"] = _fm_case(works)
    if out["fm_band"]["shape"] != [8, 8192, 1024]:
        raise AssertionError(f"band bucket is {out['fm_band']['shape']}")
    # the work the moves need is the kernel design's invariant: the kernel
    # before its redesign tallied these at this bucket (PERF.md)
    tally = (out["fm_band"]["steps"], out["fm_band"]["move_ops"])
    if tally != (23440, 241888561):
        raise AssertionError(f"the band bucket's FM tally (steps, "
                             f"operations) is {tally}, not (23440, "
                             f"241888561)")
    log(f"phase 3 fm_fused_multi == plain == hoisted: band {out['fm_band']}")
    # fm on the whole graph: n_pad 32768, the largest the main path pads to
    whole = [FMWork(nbr=nbr_g, vwgt=g.vwgt, part=part,
                    locked=np.zeros(g.n, bool), seed=9, k_inst=2,
                    eps_frac=0.12, passes=3, n_pert=8)]
    out["fm_whole"] = _fm_case(whole)
    log(f"phase 3 fm_fused_multi == plain == hoisted: whole graph "
        f"{out['fm_whole']}")

    # gains: the band bucket's lanes on its two works' tiles ...
    host, _ = pack_fm_bucket(works)
    t = {k: v.to("cuda") for k, v in host.items()}
    out["gain_band"] = _gain_case(t["nbr"], t["lane_work"],
                                  t["vwgt"].float(), t["parts"],
                                  t["extents"])
    log(f"phase 3 sep_gain_multi == plain == sparse.mm: band "
        f"{out['gain_band']}")
    # ... and two lanes on the whole graph's tile (2, 32768, 8)
    n_g = pow2(g.n)
    vw1 = np.zeros((2, n_g), np.float32)
    vw1[:, :g.n] = g.vwgt
    pt1 = np.full((2, n_g), 3, np.int8)
    pt1[:, :g.n] = part
    pt1[1, :g.n][rng.random(g.n) < 0.1] = 2
    out["gain_whole"] = _gain_case(
        torch.from_numpy(nb1).cuda(),
        torch.zeros(2, dtype=torch.int32).cuda(),
        torch.from_numpy(vw1).cuda(), torch.from_numpy(pt1).cuda(),
        row_extents(nb1).to("cuda"))
    log(f"phase 3 sep_gain_multi == plain == sparse.mm: whole graph "
        f"{out['gain_whole']}")

    # matching: the root bucket (1, 32768, 8) and the widest coarse-level
    # bucket of the root separator's hierarchy (seed 0, nproc 8) ...
    levels = coarse_levels(30)
    works = [match_work_for(lv.graph, i) for i, lv in enumerate(levels)]
    out["match_root"] = _match_case(works[0])
    if out["match_root"]["shape"] != [1, 32768, 8]:
        raise AssertionError(f"root bucket is {out['match_root']['shape']}")
    level = max(range(1, len(works)),
                key=lambda i: works[i].bucket_key()[1::-1])
    out["match_coarse"] = _match_case(works[level])
    # ... two small buckets of grid3d(12³)'s hierarchy, (1, 2048, 8) and
    # (1, 512, 16) ...
    for i in (0, 2):
        case = _match_case(match_work_for(small[i].graph, i))
        out[f"match_small_{case['shape'][1]}"] = case
    # ... and the designs at the threshold shapes (1, 2^15 / 2^17 / 2^20, 8)
    for side in (30, 50, 100):
        case = _match_case(match_work_for(grid3d(side, side, side), 0))
        out[f"match_threshold_{case['shape'][1]}"] = case
    for key, case in out.items():
        if key.startswith("match_"):
            log(f"phase 3 heavy_edge_matching_multi == plain: {key} {case}")
    log(f"phase 3 the coarse matching bucket is level {level} of "
        f"{len(works)}")
    return out


def _ell_inputs(nbr, seed: int):
    """Card tensors of one ELL case: ids, values, |values|, x, injection."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    n, d = nbr.shape
    val = rng.standard_normal((n, d)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    x[::97] = 0.0                                       # sign(0) = 0
    inj = np.zeros(n, np.float32)
    inj[:3], inj[-3:] = 0.5, -0.5
    return [torch.from_numpy(a).cuda()
            for a in (nbr, val, np.abs(val), x, inj)]


def _off16(t):
    """A copy of ``t`` whose storage starts 4 bytes past 16: the kernels'
    vector paths need 16 bytes, so the copy takes the group path."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    if out.data_ptr() % 16 == 0:
        raise AssertionError("the group path's copy lies on 16 bytes")
    return out


def _ell_case(name: str, nbr) -> dict:
    """``ell_spmv`` (float32, bfloat16) and ``diffusion_step`` on the card
    against their plain versions; SpMV against ``torch.sparse.mm``."""
    import torch
    from repro_torch.kernels import diffusion as df
    from repro_torch.kernels import ell_spmv as sp
    ids, val, wgt, x, inj = _ell_inputs(nbr, seed=len(nbr))
    n, d = nbr.shape
    valid = int((ids >= 0).sum())
    # spmv, float32: within 1e-5 of the plain version (sums in another order)
    got, want = sp.ell_spmv_kernel(ids, val, x), sp.ell_spmv_plain(ids, val, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    err = max_err(got, want)
    ms = entry_ms("ell_spmv", "ell_spmv_launch", ids, val, x,
                  torch.empty_like(x), n, d, 0)
    call_ms = cuda_ms(lambda: sp.ell_spmv_kernel(ids, val, x), reps=20)
    plain_ms = cuda_ms(lambda: sp.ell_spmv_plain(ids, val, x), reps=5)
    # bfloat16: within 5e-2
    vb, xb = val.to(torch.bfloat16), x.to(torch.bfloat16)
    got_b = sp.ell_spmv_kernel(ids, vb, xb)
    torch.testing.assert_close(got_b.float(), sp.ell_spmv_plain(
        ids, vb, xb).float(), rtol=5e-2, atol=5e-2)
    err_b = max_err(got_b, sp.ell_spmv_plain(ids, vb, xb))
    # the library call: the ELL matrix as CSR times x
    rows = torch.arange(n, device=ids.device)[:, None].expand(n, d)[ids >= 0]
    A = torch.sparse_coo_tensor(
        torch.stack([rows, ids[ids >= 0].long()]), val[ids >= 0],
        (n, n)).coalesce().to_sparse_csr()
    library_ms = cuda_ms(lambda: torch.sparse.mm(A, x[:, None]), reps=20)
    library_err = max_err(torch.sparse.mm(A, x[:, None])[:, 0], want)
    # ids and values of the real slots, x and y once; a multiply and an add
    spmv = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, max_abs_err=err,
                bf16_max_abs_err=err_b, library_ms=library_ms,
                library_err=library_err,
                **bound(8 * valid + 4 * n + 4 * n, 2 * valid))
    # diffusion: one step timed in each path, three steps within 1e-4; the
    # vector path on the arrays as they are (16-byte aligned, d of 4-16),
    # the group path on copies of ids and values 4 bytes off 16
    ids_g, wgt_g = (_off16(a) for a in (ids, wgt))
    paths = {}
    for path, (a, w) in (("vector", (ids, wgt)), ("group", (ids_g, wgt_g))):
        step_ms = entry_ms("diffusion", "diffusion_launch", a, w, x, inj,
                           torch.empty_like(x), n, d, 0.25, 0.25 * 0.1)
        yk = yp = x
        for _ in range(3):
            yk = df.diffusion_step_kernel(a, w, yk, inj)
            yp = df.diffusion_step_plain(ids, wgt, yp, inj)
        torch.testing.assert_close(yk, yp, rtol=1e-4, atol=1e-4)
        paths[path] = (step_ms, max_err(yk, yp))
    step_call_ms = cuda_ms(lambda: df.diffusion_step_kernel(
        ids, wgt, x, inj), reps=20)
    step_plain_ms = cuda_ms(lambda: df.diffusion_step_plain(
        ids, wgt, x, inj), reps=5)
    # one step: ids and values of the real slots, x, inj and y once; per
    # slot a multiply and two adds, per row eight operations
    diff = dict(ms=paths["vector"][0], group_ms=paths["group"][0],
                call_ms=step_call_ms, plain_ms=step_plain_ms,
                max_abs_err=max(e for _, e in paths.values()),
                **bound(8 * valid + 3 * 4 * n, 3 * valid + 8 * n))
    return dict(name=name, shape=[n, d], spmv=spmv, diffusion=diff)


def phase_ell() -> dict:
    """The ELL kernels at the reference bench's shapes and two graphs,
    then the public entries driven once at the largest."""
    import numpy as np
    import torch
    from repro_torch.graphs.generators import grid3d
    from repro_torch.kernels import diffusion, ell_spmv, ops
    # bfloat16 rounds each product before the float32 sum, exactly: rows
    # whose exact sum is 2^-14 and whose sum of rounded products is 0
    nb = torch.tensor([[0, 1, -1]] * 2, dtype=torch.int32, device="cuda")
    vb = torch.tensor([[1.0 + 2 ** -7, -1.0, 5.0]] * 2, device="cuda")
    xb = torch.tensor([1.0 + 2 ** -7, 1.0 + 2 ** -6], device="cuda")
    rounded = ell_spmv.ell_spmv_kernel(nb, vb.to(torch.bfloat16),
                                       xb.to(torch.bfloat16)).tolist()
    exact = ell_spmv.ell_spmv_kernel(nb, vb, xb).tolist()
    if rounded != [0.0, 0.0] or exact != [2 ** -14] * 2:
        raise AssertionError(f"ell_spmv's bfloat16 rounding: {rounded}, "
                             f"float32 {exact}")
    cases = []
    for n, d in ((4096, 8), (16384, 16)):               # kernel_bench shapes
        rng = np.random.default_rng(n + d)
        nbr = rng.integers(0, n, (n, d)).astype(np.int32)
        nbr[rng.random((n, d)) < 0.3] = -1
        cases.append(_ell_case(f"random({n},{d})", nbr))
    for side in (30, 100):
        nbr, _ = grid3d(side, side, side).to_ell(8)
        cases.append(_ell_case(f"grid3d({side},{side},{side})", nbr))
    for c in cases:
        log(f"phase 3 ell_spmv / diffusion_step == plain: {c}")
    # the public entries at grid3d(100, 100, 100), counted
    ids, val, wgt, x, inj = _ell_inputs(nbr, seed=1)
    torch.cuda.synchronize()
    ell_spmv.launches = diffusion.launches = 0
    y = ops.spmv(ids, val, x)
    z = ops.diffuse(ids, wgt, x, inj, steps=3)
    torch.cuda.synchronize()
    launches = {"ell_spmv": ell_spmv.launches,
                "diffusion_step": diffusion.launches}
    if min(launches.values()) <= 0:
        raise AssertionError(f"the ELL entries skipped a kernel: {launches}")
    torch.testing.assert_close(y, ell_spmv.ell_spmv_plain(ids, val, x),
                               rtol=1e-5, atol=1e-5)
    zp = x
    for _ in range(3):
        zp = diffusion.diffusion_step_plain(ids, wgt, zp, inj)
    torch.testing.assert_close(z, zp, rtol=1e-4, atol=1e-4)
    if not (bool(torch.isfinite(y).all()) and bool(torch.isfinite(z).all())):
        raise AssertionError("the ELL entries returned non-finite values")
    log(f"phase 3 ops.spmv + ops.diffuse(steps=3) at grid3d(100,100,100): "
        f"launches {launches}")
    return dict(cases=cases, launches=launches)


def phase_small_parity() -> None:
    import numpy as np
    from repro_torch.core.nd import nested_dissection
    from repro_torch.graphs.generators import grid3d
    from repro_torch.kernels import band_batch, fm_fused
    g = grid3d(12, 12, 12)
    secs = {}

    def run(name, device):
        t0 = time.perf_counter()
        perm = nested_dissection(g, seed=0, nproc=4, device=device)
        secs[name] = round(time.perf_counter() - t0, 1)
        return perm

    with env(REPRO_FM_MODE=None, REPRO_FM_GAIN=None):
        p_gpu = run("fused card", "cuda")
        perms = {"fused cpu": run("fused cpu", "cpu")}
    with env(REPRO_FM_MODE="hoisted", REPRO_FM_GAIN="pallas"):
        band_batch.gain_launches = fm_fused.move_loop_launches = 0
        fm_fused.launches = 0
        perms["hoisted card"] = run("hoisted card", "cuda")
        if fm_fused.launches or not fm_fused.move_loop_launches or \
                not band_batch.gain_launches:
            raise AssertionError(
                f"hoisted: launches fused {fm_fused.launches}, move loop "
                f"{fm_fused.move_loop_launches}, gains "
                f"{band_batch.gain_launches}")
    with env(REPRO_FM_MODE="hoisted", REPRO_FM_GAIN=None):
        perms["hoisted cpu"] = run("hoisted cpu", "cpu")
    for name, perm in perms.items():
        if not np.array_equal(p_gpu, perm):
            raise AssertionError(f"grid3d(12,12,12): the fused card "
                                 f"permutation differs from {name}")
    # the plain gains and the oracle have no kernel: on the card they must
    # raise, not run plain torch there
    refused = []
    for mode, gain in (("hoisted", "jnp"), ("oracle", None)):
        with env(REPRO_FM_MODE=mode, REPRO_FM_GAIN=gain):
            try:
                nested_dissection(g, seed=0, nproc=4, device="cuda")
            except ValueError:
                refused.append(f"{mode}/{gain}")
                continue
        raise AssertionError(f"REPRO_FM_MODE={mode} REPRO_FM_GAIN={gain} "
                             f"ran on the card without a kernel")
    log(f"phase 4 grid3d(12,12,12) nproc=4: fused card == fused cpu == "
        f"hoisted card == hoisted cpu permutation; refused on the card: "
        f"{refused}; seconds {secs}")


def _ordering(phase: str, counters: dict) -> dict:
    """One full-size ordering of grid3d(30, 30, 30) at nproc 8 on the card,
    with the launch counts of ``counters`` (name → (module, attribute))
    set to 0 just before and read just after."""
    import numpy as np
    import torch
    from repro_torch.core.nd import nested_dissection
    from repro_torch.graphs.generators import grid3d
    from repro_torch.obs.instrument import instrument
    from repro_torch.sparse.symbolic import nnz_opc
    g = grid3d(30, 30, 30)
    torch.cuda.synchronize()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    with instrument() as ins:
        perm = nested_dissection(g, seed=0, nproc=8, device="cuda")
    wall = time.perf_counter() - t0
    stage_s = ins.stage_s
    launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    if not np.array_equal(np.sort(perm), np.arange(g.n)):
        raise AssertionError(f"{phase}: not a permutation")
    nnz, opc = nnz_opc(g, perm)
    stages = {k: stage_s.get(k, 0.0) for k in ("match", "bfs", "fm")}
    stages["host"] = wall - sum(stages.values())
    res = {"graph": "grid3d(30,30,30)", "n": g.n, "m": g.m, "nproc": 8,
           "seed": 0, "wall_s": wall, "stage_s": stages,
           "launches": launches, "nnz": nnz, "opc": opc}
    log(f"{phase}: {json.dumps(res)}")
    res["perm"] = perm
    return res


@contextlib.contextmanager
def noise_draws(calls: list):
    """Count into ``calls[0]`` every call of ``fm_noise`` and
    ``fm_noise_plain`` (a noise tensor drawn) while the block runs."""
    from repro_torch.kernels import fm_fused, ops
    with contextlib.ExitStack() as stack:
        for module, name in ((fm_fused, "fm_noise"), (ops, "fm_noise"),
                             (fm_fused, "fm_noise_plain")):
            fn = getattr(module, name)

            def counted(*args, _fn=fn, **kw):
                calls[0] += 1
                return _fn(*args, **kw)
            setattr(module, name, counted)
            stack.callback(setattr, module, name, fn)
        yield


def phase_main() -> dict:
    from repro_torch.kernels import band_batch, fm_fused, matching
    split, stages, drawn = {}, {}, [0]
    with env(REPRO_FM_MODE=None, REPRO_FM_GAIN=None), fm_split(split), \
            stage_split(stages), noise_draws(drawn):
        res = _ordering("phase 5 main path", {
            "heavy_edge_matching_multi": (matching, "launches"),
            "bfs_multi": (band_batch, "launches"),
            "fm_fused_multi": (fm_fused, "launches")})
    if min(res["launches"].values()) <= 0:
        raise AssertionError(f"main path skipped a kernel: {res['launches']}")
    if drawn[0]:
        raise AssertionError(f"main path drew {drawn[0]} noise tensors: the "
                             f"FM kernels draw the noise")
    res["noise_tensors"] = drawn[0]
    res["fm_split_s"], res["stage_split_s"] = split, stages
    per_call(res)
    log(f"phase 5 fm stage split (s): {json.dumps(split)}")
    log(f"phase 5 match and bfs stage split (s): {json.dumps(stages)}")
    return res


def phase_hoisted(fused: dict) -> dict:
    import numpy as np
    from repro_torch.kernels import band_batch, fm_fused, matching
    split, stages, drawn = {}, {}, [0]
    with env(REPRO_FM_MODE="hoisted", REPRO_FM_GAIN=None), \
            fm_split(split), stage_split(stages), noise_draws(drawn):
        res = _ordering("phase 6 hoisted path", {
            "heavy_edge_matching_multi": (matching, "launches"),
            "bfs_multi": (band_batch, "launches"),
            "sep_gain_multi": (band_batch, "gain_launches"),
            "fm_move_loop": (fm_fused, "move_loop_launches"),
            "fm_fused_multi": (fm_fused, "launches")})
    n = res["launches"]
    if n["sep_gain_multi"] <= 0 or n["fm_move_loop"] <= 0 or \
            n["heavy_edge_matching_multi"] <= 0 or \
            n["fm_fused_multi"] != 0 or drawn[0]:
        raise AssertionError(f"hoisted path: launches {n}, noise tensors "
                             f"drawn {drawn[0]}")
    res["noise_tensors"] = drawn[0]
    if not np.array_equal(res["perm"], fused["perm"]):
        raise AssertionError("hoisted path: the permutation differs from "
                             "the fused one")
    log("phase 6 hoisted path: same permutation (and OPC) as phase 5")
    res["fm_split_s"], res["stage_split_s"] = split, stages
    per_call(res)
    log(f"phase 6 fm stage split (s): {json.dumps(split)}")
    log(f"phase 6 match and bfs stage split (s): {json.dumps(stages)}")
    return res


@contextlib.contextmanager
def host_seconds(module, name: str, spent: list):
    """Add the host seconds of every call of ``module.name`` to
    ``spent[0]`` while the block runs; restore the function after."""
    fn = getattr(module, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            spent[0] += time.perf_counter() - t0
    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def on_card(module, name: str, where: list):
    """Record CUDA events around every call of ``module.name`` into
    ``where`` while the block runs (read after it, so no sync is added);
    restore the function after."""
    import torch
    fn = getattr(module, name)

    def timed(*args, **kw):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = fn(*args, **kw)
        t1.record()
        where.append((t0, t1))
        return out
    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, fn)


def device_s(pairs) -> float:
    return sum(a.elapsed_time(b) for a, b in pairs) / 1e3


@contextlib.contextmanager
def fm_split(split: dict):
    """Split the fm stage while the block runs: host seconds packing the
    buckets (``pack_fm_bucket``; of which ``extents``, building the tiles'
    row extents), uploading (``ops._on``) and downloading
    (``core.fm.download``, which ends each work with its sync), and the
    device seconds of the FM kernels (CUDA events around each launch),
    which draw the noise themselves.  Fills ``split`` when the block
    ends."""
    import torch
    from repro_torch.core import fm as core_fm
    from repro_torch.kernels import band_batch, fm_fused, ops
    host = {k: [0.0] for k in ("pack", "extents", "upload", "download")}
    events = {"kernels": []}
    with contextlib.ExitStack() as stack:
        for module, name, key in (
                (core_fm, "pack_fm_bucket", "pack"),
                (core_fm, "row_extents", "extents"),
                (ops, "_on", "upload"), (core_fm, "download", "download")):
            stack.enter_context(host_seconds(module, name, host[key]))
        for module, name in ((fm_fused, "fm_fused_kernel"),
                             (fm_fused, "fm_move_loop_kernel"),
                             (band_batch, "sep_gain_multi_kernel")):
            stack.enter_context(on_card(module, name, events["kernels"]))
        yield
    torch.cuda.synchronize()
    split.update({k: v[0] for k, v in host.items()})
    for key, pairs in events.items():
        split[f"{key}_device"] = device_s(pairs)
        split[f"{key}_launches"] = len(pairs)


@contextlib.contextmanager
def stage_split(split: dict):
    """Split the match and bfs stages while the block runs: for each, the
    host seconds of packing its buckets (``pack_match_bucket`` /
    ``pack_bfs_bucket``), of the upload and of the download (which waits
    for the kernel), the device seconds of the kernel (CUDA events around
    each call of ``heavy_edge_matching_multi_kernel`` / ``bfs_multi_kernel``)
    and the calls.  Fills ``split`` when the block ends."""
    import torch
    from repro_torch.core import band, coarsen
    from repro_torch.kernels import band_batch, matching
    stages = {"match": (coarsen, "pack_match_bucket", matching,
                        "heavy_edge_matching_multi_kernel"),
              "bfs": (band, "pack_bfs_bucket", band_batch,
                      "bfs_multi_kernel")}
    host = {stage: {k: [0.0] for k in ("pack", "upload", "download")}
            for stage in stages}
    events = {stage: [] for stage in stages}
    with contextlib.ExitStack() as stack:
        for stage, (core, pack, kern, entry) in stages.items():
            for name, key in ((pack, "pack"), ("upload", "upload"),
                              ("download", "download")):
                stack.enter_context(host_seconds(core, name,
                                                 host[stage][key]))
            stack.enter_context(on_card(kern, entry, events[stage]))
        yield
    torch.cuda.synchronize()
    for stage in stages:
        split[stage] = dict({k: v[0] for k, v in host[stage].items()},
                            device=device_s(events[stage]),
                            calls=len(events[stage]))


def per_call(res: dict) -> None:
    """Add the stage's seconds and kernel launches a call to the match and
    bfs splits of an ordering ``res``."""
    for stage, kernel in (("match", "heavy_edge_matching_multi"),
                          ("bfs", "bfs_multi")):
        split = res["stage_split_s"][stage]
        split["stage"] = res["stage_s"][stage]
        split["launches_per_call"] = \
            res["launches"][kernel] / max(split["calls"], 1)


# ---------------------------------------------------------------- service
def bench_graphs():
    """The reference service bench's full stream's 8 unique graphs
    (``benchmarks/service_bench.py``, its ``REPRO_BENCH_FULL`` branch)."""
    from repro_torch.graphs import generators as G
    return [G.grid3d(12, 12, 12), G.grid2d(48, 48), G.circuit(4000, seed=3),
            G.rgg2d(3000, seed=2), G.grid3d(10, 10, 14),
            G.cage_like(2500, seed=5), G.grid2d(40, 52),
            G.grid3d(11, 11, 11)]


#: the service phase's problems beyond the bench stream: grid3d(30³) at
#: nproc 8, seeds 0 and 1, submitted with the stream's first arrival wave
BIG_SEEDS = (0, 1)

#: the buckets the service phase's waves produce, as (kind, n_pad, d_pad,
#: lanes), logged from its first card run and pinned: ``root`` is the
#: largest bucket (by n_pad, then d_pad) holding lanes of both
#: grid3d(30³) requests, ``wide`` the bucket with the most lanes (ties:
#: the first seen).  The waves are a function of the requests and the
#: pump policy; the policy's clocks (30 s park aging, deadline rescue)
#: do not fire in a run of this length.
PINNED = {"bfs_root": ("bfs", 32768, 8, 2),
          "fm_root": ("fm", 8192, 1024, 16),
          "match_root": ("match", 32768, 8, 2),
          "bfs_wide": ("bfs", 256, 8, 52),
          "fm_wide": ("fm", 128, 16, 456),
          "match_wide": ("match", 256, 8, 58)}


def _lanes_of(kind: str, works) -> int:
    """Lanes of one bucket's call: a work each for match and bfs, the
    works' instances padded to 8 for fm (``pack_fm_bucket``)."""
    if kind != "fm":
        return len(works)
    from repro_torch.util import pow2
    real = sum(pow2(w.k_inst, 2) for w in works)
    return -(-real // 8) * 8


@contextlib.contextmanager
def wave_groups(log: list, keep: dict, big_tags):
    """While the block runs, log every router wave's bucket groups into
    ``log`` (one dict per wave: kind → [(n_pad, d_pad, lanes, requests)])
    and keep, per kind, the works of two groups for the multi-lane
    checks: ``root``, the largest (by n_pad, then d_pad) holding lanes
    of both ``big_tags``, and
    ``wide``, the one with the most lanes.  Works are held by
    reference, not copied."""
    from collections import defaultdict
    from repro_torch.service import router
    real = router.execute_wave

    def logged(works, level=None, tags=None, recovery=None, device=None,
               **kw):
        groups = defaultdict(list)
        for w, tag in zip(works, tags):
            for item in (w if isinstance(w, list) else [w]):
                groups[(router.work_kind(item), item.bucket_key())].append(
                    (tag, item))
        wave = defaultdict(list)
        for (kind, bucket), items in groups.items():
            ws = [w for _, w in items]
            tags_g = {t for t, _ in items}
            lanes = _lanes_of(kind, ws)
            wave[kind].append((bucket[0], bucket[1], lanes, len(tags_g)))
            if set(big_tags) <= tags_g and bucket[:2] > keep.get(
                    ("root", kind), ((0, 0), None))[0]:
                keep[("root", kind)] = (bucket[:2], ws)
            if lanes > keep.get(("wide", kind), (0, None))[0]:
                keep[("wide", kind)] = (lanes, ws)
        log.append(dict(wave))
        return real(works, level, tags, recovery, device, **kw)
    router.execute_wave = logged
    try:
        yield
    finally:
        router.execute_wave = real


def _kernel_counts():
    """name → (module, attribute) of every launch count of the ordering's
    kernels."""
    from repro_torch.kernels import band_batch, fm_fused, matching
    return {"heavy_edge_matching_multi": (matching, "launches"),
            "bfs_multi": (band_batch, "launches"),
            "fm_fused_multi": (fm_fused, "launches"),
            "sep_gain_multi": (band_batch, "gain_launches"),
            "fm_move_loop": (fm_fused, "move_loop_launches")}


@contextlib.contextmanager
def counted(counts: dict):
    """Set every kernel launch count to 0 as the block starts and read
    them into ``counts`` as it ends."""
    import torch
    table = _kernel_counts()
    torch.cuda.synchronize()
    for mod, attr in table.values():
        setattr(mod, attr, 0)
    yield
    counts.update({k: getattr(mod, attr) for k, (mod, attr) in table.items()})


def _exec_by_class(stats: dict) -> dict:
    return {cls: {k: d[k] for k in ("count", "p50_exec_ms", "p95_exec_ms")}
            for cls, d in stats["by_class"].items()}


def phase_service(device: str = "cuda", big_side: int = 30) -> dict:
    """Phase 7: the ordering service on the card at the bench's full
    stream plus two grid3d(30³) requests, against the looped driver on
    the same 10 problems."""
    import numpy as np
    from repro_torch.core.nd import NDConfig, nested_dissection
    from repro_torch.graphs.generators import grid3d
    from repro_torch.obs.instrument import instrument
    from repro_torch.service import OrderingService
    from repro_torch.service.fingerprint import request_fingerprint
    uniq = bench_graphs()
    big = grid3d(big_side, big_side, big_side)
    problems = [(g, i, 4) for i, g in enumerate(uniq)] + \
        [(big, s, 8) for s in BIG_SEEDS]
    big_tags = [request_fingerprint(big, s, 8, NDConfig()) for s in BIG_SEEDS]
    svc = OrderingService(device=device)
    wave_log, keep, counts, splits, stages = [], {}, {}, {}, {}
    rids = []
    with env(REPRO_FM_MODE=None, REPRO_FM_GAIN=None), \
            instrument() as ins, wave_groups(wave_log, keep, big_tags), \
            fm_split(splits), stage_split(stages), counted(counts):
        t0 = time.perf_counter()
        for k in range(3):              # three arrival waves of 8
            for i, g in enumerate(uniq):
                rids.append(svc.submit(g, seed=i, nproc=4))
            if k == 0:
                rids += [svc.submit(big, seed=s, nproc=8)
                         for s in BIG_SEEDS]
            svc.drain()
        wall = time.perf_counter() - t0
    st = svc.stats()
    if min(counts[k] for k in ("heavy_edge_matching_multi", "bfs_multi",
                               "fm_fused_multi")) <= 0:
        raise AssertionError(f"service phase skipped a kernel: {counts}")
    if st["computed"] != 10 or st["cache_hits"] != 16:
        raise AssertionError(f"service phase: computed {st['computed']}, "
                             f"cache hits {st['cache_hits']} (want 10, 16)")
    if st["degraded"] or st["router"]["isolations"] or st["failed"]:
        raise AssertionError(f"service phase degraded or isolated work "
                             f"without a fault: {st}")
    waves = ins.waves
    bad = [w for w in waves for k in w["launches"]
           if w["launches"][k] != w["buckets"][k]]
    if bad or sum(len(w["launches"]) for w in waves) == 0:
        raise AssertionError(f"service phase: launches != buckets in "
                             f"{len(bad)} waves")
    shared = sum(w["shared_launches"] for w in waves)
    if shared <= 0:
        raise AssertionError("service phase: no launch served two requests")

    # the looped driver on the same 10 problems, with the same splits
    loop_counts, loop_splits, loop_stages = {}, {}, {}
    with env(REPRO_FM_MODE=None, REPRO_FM_GAIN=None), \
            fm_split(loop_splits), stage_split(loop_stages), \
            counted(loop_counts):
        t0 = time.perf_counter()
        refs = [nested_dissection(g, seed=s, nproc=p, device=device)
                for g, s, p in problems]
        loop_wall = time.perf_counter() - t0
    perms = {}
    for rid in rids:
        res = svc.poll(rid)
        if res is None or res.status != "ok":
            raise AssertionError(f"service request {rid} did not resolve ok")
        perms.setdefault(res.fingerprint, res.perm)
    for (g, s, p), ref in zip(problems, refs):
        fp = request_fingerprint(g, s, p, NDConfig())
        if not np.array_equal(perms[fp], ref):
            raise AssertionError(f"service != looped nested_dissection for "
                                 f"n={g.n} seed={s} nproc={p}")
    res = {"requests": len(rids), "computed": st["computed"],
           "cache_hits": st["cache_hits"], "wall_s": wall,
           "looped_wall_s": loop_wall, "waves": len(waves),
           "multi_request_waves": sum(1 for w in waves
                                      if w["requests"] >= 2),
           "shared_launches": shared,
           "exec_by_class": _exec_by_class(st),
           "launches": counts, "looped_launches": loop_counts}
    for name, split, stage in (("service", splits, stages),
                               ("looped", loop_splits, loop_stages)):
        res[f"{name}_split"] = {
            "match": stage["match"], "bfs": stage["bfs"],
            "fm": {k: v for k, v in split.items()}}
    res["dispatches"] = {
        kind: sum(w["launches"].get(kind, 0) for w in waves)
        for kind in ("match", "bfs", "fm")}
    buckets = {}
    for wave in wave_log:
        for kind, groups in wave.items():
            for n_pad, d_pad, lanes, reqs in groups:
                key = f"{kind} {n_pad}x{d_pad}"
                b = buckets.setdefault(key, [0, 0, 0])
                b[0] += 1
                b[1] = max(b[1], lanes)
                b[2] = max(b[2], reqs)
    log(f"phase 7 service == looped nested_dissection on the card for 10 "
        f"problems (8 bench graphs nproc 4, grid3d(30³) nproc 8 seeds "
        f"{list(BIG_SEEDS)}): {json.dumps(res)}")
    log(f"phase 7 service buckets (kind n_pad x d_pad: calls, most lanes, "
        f"most requests): {json.dumps(buckets)}")
    res["buckets"] = buckets
    res["keep"] = keep
    return res


# ---------------------------------------------------------------- lanes
def _lane_case(kind: str, works) -> dict:
    """One bucket group of the service's waves as the executor packs it:
    the kernel through its wrapper == its plain version on the card ==
    each design's C entry, and each lane == that work's singleton call,
    all exactly; CUDA-event times of the designs alone and the wrapper."""
    import torch
    from repro_torch.core import band, coarsen
    from repro_torch.kernels import band_batch as bb
    from repro_torch.kernels import matching
    from repro_torch.kernels.band_batch import lane_plan
    card = torch.device("cuda")
    L = len(works)
    if kind == "match":
        n_pad, d_pad, rounds = works[0].bucket_key()
        buf = coarsen.pack_match_bucket(works, n_pad, d_pad, card).cuda()
        args = coarsen.match_parts(buf, L, n_pad, d_pad)
        extra, source = (rounds,), "matching"
        kernel = matching.heavy_edge_matching_multi_kernel
        plain = matching.heavy_edge_matching_multi_plain
        designs = _match_designs(*args, rounds)
    else:
        n_pad, d_pad, width = works[0].bucket_key()
        buf = band.pack_bfs_bucket(works, n_pad, d_pad, card).cuda()
        args = band.bfs_parts(buf, L, n_pad, d_pad)
        extra, source = (width,), "bfs_multi"
        kernel, plain = bb.bfs_multi_kernel, bb.bfs_multi_plain
        designs = _bfs_designs(*args, width)
    got = kernel(*args, *extra)
    want = plain(*args, *extra)
    if not torch.equal(got, want):
        raise AssertionError(f"{kind} kernel differs from its plain version "
                             f"at {(L, n_pad, d_pad)}")
    for j in range(L):
        one = kernel(*(a[j:j + 1] for a in args), *extra)
        if not torch.equal(one[0], got[j]):
            raise AssertionError(f"{kind} lane {j} of {(L, n_pad, d_pad)} "
                                 f"differs from its singleton call")
    plan = lane_plan(n_pad, d_pad)
    ms = {}
    for name, (entry, e_args, out) in designs.items():
        if name not in ("grid", _design_key(plan)):
            continue
        ms[name] = entry_ms(source, entry, *e_args, reps=20)
        if not torch.equal(out, want):
            raise AssertionError(f"{kind}'s {name} design differs from its "
                                 f"plain version at {(L, n_pad, d_pad)}")
    return dict(shape=[L, n_pad, d_pad], plan=plan, ms=ms[_design_key(plan)],
                designs_ms=ms, call_ms=cuda_ms(lambda: kernel(*args, *extra),
                                               reps=20),
                plain_ms=cuda_ms(lambda: plain(*args, *extra), reps=2),
                max_abs_err=0)


def _fm_lane_case(works) -> dict:
    """``_fm_case`` on one FM bucket group of the service's waves, and
    each work's lanes of the group's call == that work's own call."""
    import torch
    from repro_torch.core.fm import pack_fm_bucket
    from repro_torch.kernels import fm_fused as ff
    passes, pos_only = works[0].passes, works[0].pos_only

    def call(ws):
        host, counts = pack_fm_bucket(ws)
        t = {k: v.to("cuda") for k, v in host.items()}
        return ff.fm_fused_multi(**t, passes=passes,
                                 pos_only=pos_only), counts
    out = _fm_case(works)
    group, counts = call(works)
    off = 0
    for w, k in zip(works, counts):
        one, _ = call([w])
        for a, b in zip(group, one):
            if not torch.equal(a[off:off + k], b[:k]):
                raise AssertionError(f"fm lanes {off}-{off + k} of "
                                     f"{out['shape']} differ from the "
                                     f"work's own call")
        off += k
    return out


def _pinned(service: dict) -> list:
    """(case name, kind, works) of the groups the service phase kept,
    with their (kind, n_pad, d_pad, lanes) held to ``PINNED``."""
    cases = []
    for (which, kind), (_, works) in sorted(service["keep"].items()):
        n_pad, d_pad = works[0].bucket_key()[:2]
        cases.append((f"{kind}_{which}", kind, works,
                      (kind, n_pad, d_pad, _lanes_of(kind, works))))
    shapes = {name: pin for name, _, _, pin in cases}
    log(f"phase 8 service groups (kind, n_pad, d_pad, lanes): "
        f"{json.dumps(shapes)}")
    if shapes != PINNED:
        raise AssertionError(f"the service's buckets moved: {shapes}, "
                             f"pinned {PINNED}")
    return cases


def _plan_cases(lanes_max: dict) -> dict:
    """Both designs of the matching and the BFS at 2^18 slots a lane,
    d 8, 16 and 32, at L = 1 and at the service's most lanes for the
    kernel: random buckets, each design held to the plain version."""
    import torch
    from repro_torch import prng
    out = {}
    for kind in ("match", "bfs"):
        for d in (8, 16, 32):
            n = 2 ** 18 // d
            for L in sorted({1, lanes_max[kind]}):
                nbr, wgt = (t.cuda() for t in _match_inputs(L, n, d, L + d))
                if kind == "match":
                    keys = prng.split(prng.PRNGKey(d, "cuda"), L)
                    from repro_torch.kernels import matching
                    want = matching.heavy_edge_matching_multi_plain(
                        nbr, wgt, keys, 8)
                    designs, source = _match_designs(nbr, wgt, keys, 8), \
                        "matching"
                else:
                    import numpy as np
                    from repro_torch.kernels import band_batch as bb
                    rng = np.random.default_rng(L + d)
                    src = torch.from_numpy(
                        (rng.random((L, n)) < 0.01).astype(np.int32)).cuda()
                    want = bb.bfs_multi_plain(nbr, src, 3)
                    designs, source = _bfs_designs(nbr, src, 3), "bfs_multi"
                ms = {}
                for name, (entry, e_args, res) in designs.items():
                    if name not in ("grid", "cluster_8", "cluster_16"):
                        continue
                    ms[name] = entry_ms(source, entry, *e_args, reps=10)
                    if not torch.equal(res, want):
                        raise AssertionError(f"{kind} {name} differs from "
                                             f"its plain version at "
                                             f"{(L, n, d)}")
                out[f"{kind} L{L} {n}x{d}"] = ms
    return out


def phase_lanes(service: dict) -> dict:
    """Phase 8: the matching, BFS and FM kernels on the bucket groups the
    service phase's waves gave them (many lanes, lanes of two requests),
    and ``lane_plan``'s two designs at 2^18 slots."""
    out = {}
    for name, kind, works, _ in _pinned(service):
        out[name] = _fm_lane_case(works) if kind == "fm" else \
            _lane_case(kind, works)
        shown = {k: v for k, v in out[name].items() if k != "move_loop"}
        log(f"phase 8 {name} == plain, each lane == its singleton: "
            f"{json.dumps(shown)}")
    lanes_max = {kind: max(most for key, (_, most, _) in
                           service["buckets"].items()
                           if key.startswith(kind + " "))
                 for kind in ("match", "bfs")}
    out["plan"] = _plan_cases(lanes_max)
    log(f"phase 8 lane_plan at 2^18 slots (ms alone, L 1 and the "
        f"service's most lanes {lanes_max}): {json.dumps(out['plan'])}")
    return out


# ---------------------------------------------------------------- chaos
def chaos_plan():
    """The reference service bench's seeded chaos schedule
    (``benchmarks/service_bench.py``'s ``chaos_plan``)."""
    from repro_torch.service import faults
    return faults.FaultPlan(seed=11, specs=[
        faults.FaultSpec(site="fm", kind="transient", rate=0.15, count=4),
        faults.FaultSpec(site="fm", kind="nan", at=(2,)),
        faults.FaultSpec(site="bfs", kind="delay", rate=0.1,
                         delay_s=0.01, count=6),
        faults.FaultSpec(site="wave", kind="transient", at=(1,)),
        faults.FaultSpec(site="result", kind="corrupt_perm", at=(0,)),
    ])


@contextlib.contextmanager
def plain_calls(calls: list, modes: list):
    """Count into ``calls[0]`` every call of a kernel's plain version or
    the oracle, and record each FM call's (mode, device) into ``modes``,
    while the block runs."""
    from repro_torch.kernels import band_batch, fm_fused, matching, ops, ref
    with contextlib.ExitStack() as stack:
        for module, name in (
                (matching, "heavy_edge_matching_multi_plain"),
                (band_batch, "bfs_multi_plain"),
                (band_batch, "sep_gain_multi_plain"),
                (fm_fused, "fm_fused_plain"),
                (fm_fused, "fm_move_loop_plain"), (ref, "fm_fused_ref")):
            fn = getattr(module, name)

            def counted_fn(*args, _fn=fn, **kw):
                calls[0] += 1
                return _fn(*args, **kw)
            setattr(module, name, counted_fn)
            stack.callback(setattr, module, name, fn)
        batch = ops.fm_refine_batch

        def recorded(*args, mode=None, device=None, **kw):
            modes.append((mode, str(device)))
            return batch(*args, mode=mode, device=device, **kw)
        ops.fm_refine_batch = recorded
        stack.callback(setattr, ops, "fm_refine_batch", batch)
        yield


def phase_chaos(device: str = "cuda") -> dict:
    """Phase 9: the reference bench's chaos run (its ``chaos_plan``, its
    six graphs at nproc 2, a coalesced duplicate pair and two
    infeasible-deadline requests) on the card.  Every ``ok`` result is
    the fault-free looped ordering, the cache holds no faulted entry, an
    FM group degrades to hoisted, and no work reaches the oracle, a
    plain version or the CPU."""
    import numpy as np
    from repro_torch.core.nd import nested_dissection
    from repro_torch.graphs import generators as G
    from repro_torch.service import OrderingService, faults
    from repro_torch.service.fingerprint import request_fingerprint
    graphs = [G.grid2d(14, 14), G.grid3d(6, 6, 6), G.grid2d(16, 12),
              G.grid2d(13, 11), G.grid2d(12, 12), G.grid3d(5, 5, 6)]
    seeds = [100 + k for k in range(len(graphs))]
    with env(REPRO_FM_MODE=None, REPRO_FM_GAIN=None):
        refs = [nested_dissection(g, seed=s, nproc=2, device=device)
                for g, s in zip(graphs, seeds)]
        svc = OrderingService(device=device)
        for g in (G.grid2d(10, 10), G.grid2d(18, 15)):
            svc.submit(g, seed=0, nproc=2)
        svc.drain()
        calls, modes = [0], []
        t0 = time.perf_counter()
        with faults.fault_injection(chaos_plan()) as inj, \
                plain_calls(calls, modes):
            rids = [svc.submit(g, seed=s, nproc=2)
                    for g, s in zip(graphs, seeds)]
            dup_rids = [svc.submit(graphs[0], seed=seeds[0], nproc=2)
                        for _ in range(2)]
            shed_rids = [svc.submit(G.grid2d(15, 13 + k), seed=0, nproc=2,
                                    deadline_s=0.0) for k in range(2)]
            svc.drain()
        wall = time.perf_counter() - t0
    results = [svc.poll(r) for r in rids + dup_rids + shed_rids]
    if any(r is None for r in results):
        raise AssertionError("chaos: a request hung without a status")
    statuses = [r.status for r in results]
    for res, ref in zip(results, refs + [refs[0]] * 2):
        if res.status == "ok" and not np.array_equal(res.perm, ref):
            raise AssertionError("chaos: an ok result differs from the "
                                 "fault-free run")
    for g, s, ref in zip(graphs, seeds, refs):
        cached = svc.cache.get(request_fingerprint(g, s, 2, svc.default_cfg))
        if cached is not None and not np.array_equal(cached, ref):
            raise AssertionError("chaos: a faulted entry reached the cache")
    if any(svc.poll(r).status != "shed" for r in shed_rids):
        raise AssertionError("chaos: infeasible requests were not shed")
    st = svc.stats()
    fm_modes = sorted({m for m, _ in modes})
    devices = sorted({d for _, d in modes})
    out = {"requests": len(results), "wall_s": wall,
           "injected": inj.snapshot(),
           "terminal": {k: statuses.count(k)
                        for k in ("ok", "shed", "failed")},
           "retries": st["fault_retries"], "degraded": st["degraded"],
           "isolations": st["router"]["isolations"],
           "fm_modes": fm_modes, "fm_devices": devices,
           "plain_or_oracle_calls": calls[0]}
    log(f"phase 9 chaos on {device}: {json.dumps(out)}")
    if inj.injected == 0:
        raise AssertionError("chaos: the plan injected nothing")
    if st["degraded"] < 1 or "hoisted" not in fm_modes:
        raise AssertionError(f"chaos: no FM group degraded to hoisted: "
                             f"{out}")
    if device == "cuda" and ("oracle" in fm_modes or calls[0] or
                             devices != ["cuda"]):
        raise AssertionError(f"chaos: card work reached the oracle, a "
                             f"plain version or the CPU: {out}")
    return out


# ---------------------------------------------------------------- distributed
#: the distributed kernels' launch counts (kernels.dgraph_ops)
DIST_COUNTS = {"ell_relax_step": "relax_launches",
               "halo_exchange_stacked": "halo_launches",
               "distributed_bfs_stacked": "dbfs_launches",
               "distributed_matching_stacked": "dmatch_launches"}
#: the distributed kernels the main path must launch: the halo, and the
#: BFS and matching in their planned designs (the ELL relaxation only as
#: the grid BFS's steps)
PATH_DIST_KERNELS = ("halo_exchange_stacked", "distributed_bfs_stacked",
                     "distributed_matching_stacked")
#: the phase's configuration of the gather-free tests (DNDConfig)
GATHER_FREE = dict(centralize_threshold=256, band_central_threshold=128)
#: OPS of one hash_mix of three values (three mix steps of a multiply, an
#: add and a xor around lowbias32's two multiplies, three xors and three
#: shifts) and its float conversion
OPS_PER_HASH = 35


class StageByKind:
    """An event-bus collector that bills each dispatch's stage seconds to
    the kind of the launch record that follows it (``dmatch`` apart from
    ``match``, ``dbfs`` from ``bfs``, ``dhalo``), and the host stages
    ``rebuild`` and ``endgame`` by name."""

    def __init__(self):
        self.seconds, self._pending = {}, 0.0

    def on_event(self, kind: str, payload: dict) -> None:
        if kind == "stage":
            if payload["name"] in ("rebuild", "endgame"):
                self._add(payload["name"], payload["seconds"])
            else:
                self._pending = payload["seconds"]
        elif kind == "launch":
            self._add(payload["kind"], self._pending)
            self._pending = 0.0

    def _add(self, name, sec):
        self.seconds[name] = self.seconds.get(name, 0.0) + float(sec)


@contextlib.contextmanager
def dhalo_split(split: dict):
    """Split the dhalo stage while the block runs, each host clock counted
    only inside ``halo_exchange_stacked``: seconds staging the payload
    (``pack``: a pinned buffer, filled), uploading, resolving ghost slot
    tables and downloading (which waits for the kernel); the device seconds of the halo kernel (CUDA events
    around each call of its C entry, the enqueue included); the calls;
    the distinct DGraphs exchanged and the slot tables resolved.  A tree
    before resident slot tables packs and uploads its payload inline and
    uploads the ghost ids and ranges with ``_lanes`` (``upload``): what
    no clock sees is ``rest``, the stage less the others.  Fills
    ``split`` (without ``stage`` and ``rest``, which ``dhalo_rest`` adds
    from the stage's seconds) when the block ends."""
    import torch
    from repro_torch.core import dgraph
    from repro_torch.kernels import build
    from repro_torch.service import router
    inside = [False]
    host = {k: [0.0] for k in ("pack", "upload", "tables", "download")}
    events, seen = [], {}

    def gated(fn, spent):
        def timed(*args, **kw):
            if not inside[0]:
                return fn(*args, **kw)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[0] += time.perf_counter() - t0
        return timed

    def flagged(fn):
        def call(dgs, *args, **kw):
            seen.update((id(d), d) for d in dgs)
            inside[0] = True
            try:
                return fn(dgs, *args, **kw)
            finally:
                inside[0] = False
        return call
    resolved = getattr(dgraph, "slot_resolutions", None)
    with contextlib.ExitStack() as stack:
        for name, key in (("stage_halo", "pack"), ("upload", "upload"),
                          ("_lanes", "upload"), ("ghost_slots", "tables"),
                          ("download", "download"),
                          ("download_into", "download")):
            if hasattr(dgraph, name):
                fn = getattr(dgraph, name)
                stack.callback(setattr, dgraph, name, fn)
                setattr(dgraph, name, gated(fn, host[key]))
        for module in (dgraph, router):
            fn = module.halo_exchange_stacked
            stack.callback(setattr, module, "halo_exchange_stacked", fn)
            module.halo_exchange_stacked = flagged(fn)
        # the wrapper's C entry: the part-range one, or in a tree before
        # part ranges the whole-lane one
        lib = build.load("dgraph")
        stack.enter_context(on_card(
            lib, "halo_parts_launch" if hasattr(lib, "halo_parts_launch")
            else "halo_launch", events))
        yield
    torch.cuda.synchronize()
    split.update({k: v[0] for k, v in host.items()})
    split.update(device=device_s(events), calls=len(events),
                 dgraphs=len(seen),
                 resolutions=None if resolved is None
                 else dgraph.slot_resolutions - resolved)


def dhalo_rest(split: dict, stage_s: float) -> dict:
    """``split`` with the dhalo stage's seconds and what no clock saw."""
    return dict(split, stage=stage_s, rest=stage_s - sum(
        split[k] for k in ("pack", "upload", "tables", "device",
                           "download")))


@contextlib.contextmanager
def dist_calls(largest: dict, calls: list, gathers: list):
    """Keep, per distributed collective, the arguments of its call with the
    most lanes; count into ``calls[0]`` every call of a plain version of
    any kernel of the ordering; and record into ``gathers`` each
    centralizing gather of ``core.dnd`` as (kind, parts of the gathered
    graph, vertices), while the block runs."""
    from repro_torch.core import dgraph, dnd
    from repro_torch.kernels import dgraph_ops
    from repro_torch.service import router
    with contextlib.ExitStack() as stack:
        for name in ("to_host", "unshard_vector"):
            fn = getattr(dnd, name)

            def noted(dg, *args, _fn=fn, _name=name, **kw):
                gathers.append((_name, dg.nparts, dg.n_global))
                return _fn(dg, *args, **kw)
            stack.callback(setattr, dnd, name, fn)
            setattr(dnd, name, noted)
        for name in ("halo_exchange_stacked", "distributed_bfs_stacked",
                     "distributed_matching_stacked"):
            fn = getattr(dgraph, name)

            def kept(dgs, *args, _fn=fn, _name=name, **kw):
                if len(dgs) > len(largest.get(_name, ((),))[0]):
                    largest[_name] = (list(dgs), args)
                return _fn(dgs, *args, **kw)
            stack.callback(setattr, router, name, getattr(router, name))
            setattr(router, name, kept)
        for name in ("ell_relax_plain", "halo_plain", "dbfs_plain",
                     "dmatch_plain"):
            fn = getattr(dgraph_ops, name)

            def counted_fn(*args, _fn=fn, **kw):
                calls[0] += 1
                return _fn(*args, **kw)
            stack.callback(setattr, dgraph_ops, name, fn)
            setattr(dgraph_ops, name, counted_fn)
        stack.enter_context(plain_calls(calls, []))
        yield


def _dnd(dg, seed=0, cfg=None, device="cuda"):
    from repro_torch.core.dnd import distributed_nested_dissection
    return distributed_nested_dissection(dg, seed, cfg, device=device)


def _dist_main(main_run: dict) -> dict:
    """(b): the full-width distributed ordering of grid3d(30³) at P 8 with
    the default DNDConfig, both drivers, with its checks and split."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core import dgraph
    from repro_torch.core.dnd import DNDConfig
    from repro_torch.graphs.generators import grid3d
    from repro_torch.kernels import dgraph_ops
    from repro_torch.sparse.symbolic import nnz_opc
    g = grid3d(30, 30, 30)
    dg = dgraph.distribute(g, 8)
    cfg = DNDConfig()
    counters = {**{k: (dgraph_ops, a) for k, a in DIST_COUNTS.items()},
                **_kernel_counts()}
    largest, calls, by_kind, gathers = {}, [0], StageByKind(), []
    halo_split = {}
    with env(REPRO_FM_MODE=None, REPRO_FM_GAIN=None), \
            dist_calls(largest, calls, gathers):
        with dhalo_split(halo_split):
            torch.cuda.synchronize()
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            obs.register_collector(by_kind)
            t0 = time.perf_counter()
            try:
                with dgraph.instrument() as ins:
                    perm = _dnd(dg, 0, cfg)
            finally:
                obs.unregister_collector(by_kind)
            wall = time.perf_counter() - t0
        launches = {k: getattr(m, a) for k, (m, a) in counters.items()}
        n_gathers = len(gathers)
        t1 = time.perf_counter()
        perm_dfs = _dnd(dg, 0, DNDConfig(frontier=False))
        wall_dfs = time.perf_counter() - t1
    if not np.array_equal(np.sort(perm), np.arange(g.n)):
        raise AssertionError("distributed: not a permutation")
    if not np.array_equal(perm, perm_dfs):
        raise AssertionError("distributed: frontier != depth-first")
    # the gather-free tests' bound.  A subtree whose process group is one
    # part lives on one process already: its gather is the hand-off to the
    # sequential orderer (§3.1), outside the bound, which holds for every
    # gather of a graph spread over two parts or more
    bound = max(cfg.centralize_threshold, cfg.band_central_threshold,
                2 * cfg.fold_threshold, cfg.coarse_target)
    max_gather = max(s for _, s in ins.gathers)
    mine = gathers[:n_gathers]
    if sorted((k, n) for k, _, n in mine) != sorted(ins.gathers):
        raise AssertionError("distributed: the gathers seen by core.dnd "
                             "differ from track_gathers'")
    spread = max([n for _, p, n in mine if p > 1], default=0)
    one_part = max([n for _, p, n in mine if p == 1], default=0)
    alt = [s for s in ins.band_stats if s["schedule"] == "alt"]
    conflicts = sum(sum(s["conflicts"]) for s in ins.band_stats)
    repairs = sum(sum(s["repairs"]) for s in ins.band_stats)
    over = [w for w in ins.waves for k in w["launches"]
            if w["launches"][k] != w["buckets"][k]]
    nnz, opc = nnz_opc(g, perm)
    planned = dgraph_ops.planned_launches(ins.launches)
    want_launches = {k: planned[a] for k, a in DIST_COUNTS.items()}
    split = {k: by_kind.seconds.get(k, 0.0) for k in (
        "dmatch", "dbfs", "dhalo", "fm", "match", "bfs", "rebuild",
        "endgame")}
    split["host"] = wall - sum(v for k, v in split.items()
                               if k != "endgame")
    halo_split = dhalo_rest(halo_split, split["dhalo"])
    res = {"graph": "grid3d(30,30,30)", "nparts": 8, "seed": 0,
           "bucket": list(dgraph.dgraph_bucket(dg)), "wall_s": wall,
           "wall_dfs_s": wall_dfs, "split_s": split,
           "dhalo_split_s": halo_split,
           "waves": len(ins.waves), "launches": launches,
           "max_gather": max_gather, "max_gather_of_parts": spread,
           "max_gather_of_one_part": one_part, "gather_bound": bound,
           "alt_refines": len(alt), "conflicts": conflicts,
           "repairs": repairs, "plain_calls": calls[0],
           "largest_sharded_band": max((s["n"] for s in alt), default=0),
           "nnz": int(nnz), "opc": int(opc),
           "opc_ratio_vs_host_nd": opc / main_run["opc"],
           "nnz_ratio_vs_host_nd": nnz / main_run["nnz"],
           "largest_lanes": {k: len(v[0]) for k, v in largest.items()},
           "calls": {k: sum(r["kind"] == k for r in ins.launches)
                     for k in ("dhalo", "dbfs", "dmatch")}}
    log(f"phase 10 distributed main path: {json.dumps(res)}")
    if spread > bound:
        raise AssertionError(f"distributed: a gather of {spread} vertices "
                             f"spread over parts, over the bound {bound}")
    if not alt or conflicts or repairs:
        raise AssertionError(f"distributed: {len(alt)} alternating-colour "
                             f"refinements, {conflicts} conflicts, "
                             f"{repairs} repairs")
    if over:
        raise AssertionError(f"distributed: launches != buckets in {over}")
    if min(launches[k] for k in ("heavy_edge_matching_multi", "bfs_multi",
                                 "fm_fused_multi",
                                 *PATH_DIST_KERNELS)) <= 0:
        raise AssertionError(f"distributed: a kernel never launched: "
                             f"{launches}")
    if want_launches != {k: launches[k] for k in want_launches}:
        raise AssertionError(f"distributed: launches {launches}, the plan "
                             f"gives {want_launches}")
    if calls[0]:
        raise AssertionError(f"distributed: {calls[0]} plain calls on the "
                             f"card")
    if halo_split["calls"] != launches["halo_exchange_stacked"]:
        raise AssertionError(f"distributed: {halo_split['calls']} calls of "
                             f"the halo's C entry, {launches} counted")
    if halo_split["resolutions"] not in (None, halo_split["dgraphs"]):
        raise AssertionError(f"distributed: {halo_split['resolutions']} "
                             f"slot tables resolved for "
                             f"{halo_split['dgraphs']} DGraphs exchanged")
    res.update(perm=perm, dg=dg, largest=largest)
    return res


def _dist_requests(main: dict) -> dict:
    """(c) a batch of three requests and the service; (d) card == cpu."""
    import numpy as np
    from repro_torch.core import dgraph
    from repro_torch.core.dnd import DNDConfig, distributed_order_batch
    from repro_torch.graphs.generators import grid2d
    from repro_torch.service import OrderingService
    dg, cfg = main["dg"], DNDConfig()
    small = dgraph.distribute(grid2d(28, 28), 8)
    t0 = time.perf_counter()
    batch = distributed_order_batch([dg, dg, small], [0, 1, 0], device="cuda")
    t_batch = time.perf_counter() - t0
    alone = [main["perm"], _dnd(dg, 1, cfg), _dnd(small, 0, cfg)]
    if not all(np.array_equal(a, b) for a, b in zip(batch, alone)):
        raise AssertionError("distributed_order_batch != each request alone")
    svc = OrderingService(device="cuda")
    t0 = time.perf_counter()
    rid = svc.submit_distributed(dg, seed=0)
    svc.drain()
    t_svc = time.perf_counter() - t0
    rid2 = svc.submit_distributed(dg, seed=0)
    r1, r2 = svc.poll(rid), svc.poll(rid2)
    if r1.status != "ok" or not np.array_equal(r1.perm, main["perm"]):
        raise AssertionError("submit_distributed != the ordering alone")
    if not (r2 is not None and r2.cached and
            np.array_equal(r2.perm, r1.perm)):
        raise AssertionError("the second submit_distributed was no hit")
    gf = DNDConfig(**GATHER_FREE)
    t0 = time.perf_counter()
    with dgraph.instrument() as ins:
        on_card = _dnd(small, 0, gf, "cuda")
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = _dnd(small, 0, gf, "cpu")
    t_cpu = time.perf_counter() - t0
    if not np.array_equal(on_card, on_cpu):
        raise AssertionError("grid2d(28,28) P 8: card != cpu")
    # the reference's gather-free checks (test_dnd_gatherfree.py
    # ::_check_nd) on the card's run: every gather within the bound
    bound = max(gf.centralize_threshold, gf.band_central_threshold,
                2 * gf.fold_threshold, gf.coarse_target)
    max_gather = max(s for _, s in ins.gathers)
    alt = sum(1 for s in ins.band_stats if s["schedule"] == "alt")
    conflicts = sum(sum(s["conflicts"]) for s in ins.band_stats)
    repairs = sum(sum(s["repairs"]) for s in ins.band_stats)
    out = {"batch_s": t_batch, "service_s": t_svc, "cache_hit": r2.cached,
           "grid2d28_card_s": t_card, "grid2d28_cpu_s": t_cpu,
           "grid2d28_max_gather": max_gather, "grid2d28_gather_bound": bound,
           "grid2d28_alt_refines": alt, "grid2d28_conflicts": conflicts,
           "grid2d28_repairs": repairs}
    log(f"phase 10 requests: batch of 3 == each alone, service == alone "
        f"then a hit, grid2d(28,28) card == cpu: {json.dumps(out)}")
    if not (max_gather <= bound and max_gather < small.n_global // 2):
        raise AssertionError(f"grid2d(28,28) P 8: a gather of {max_gather} "
                             f"vertices, over the bound {bound}")
    if not alt or conflicts or repairs:
        raise AssertionError(f"grid2d(28,28) P 8: {alt} alternating-colour "
                             f"refinements, {conflicts} conflicts, "
                             f"{repairs} repairs")
    return out


def _dlanes_of(dgs, device="cuda"):
    import numpy as np
    import torch

    def st(arrs):
        return torch.from_numpy(np.stack([np.asarray(a, np.int32)
                                          for a in arrs])).to(device)
    return {"nbr": st([d.nbr_gst for d in dgs]),
            "ew": st([d.ewgt_gst for d in dgs]),
            "gg": st([d.ghost_gid for d in dgs]),
            "vd": st([d.vtxdist for d in dgs]),
            "nl": st([d.n_loc for d in dgs])}


def _exact(name, got, want, where):
    import torch
    if not torch.equal(got, want):
        raise AssertionError(f"{name} differs from its plain version at "
                             f"{where}")


def _path_cap(dgs, nlm) -> int:
    """The matching's cap on the path (``distributed_matching_stacked``)."""
    from repro_torch.core import dgraph
    cap = dgraph._match_proposal_cap(dgs, nlm)
    return 0 if 3 * cap >= 2 * nlm else cap


def _dist_layouts(K, P, nlm, d, both):
    """The designs of rows 9-10 to time at (P, nlm, d), as (design, C):
    the plan's, and with ``both`` a cluster of 8 CTAs and the other
    design; a tree without ``plan`` (before the cluster designs) has the
    grid design alone."""
    if not hasattr(K, "plan"):
        return [("grid", None)]
    design, C = K.plan(P, nlm, d)
    if not both:
        return [(design, C)]
    C = C or 16
    eight = [("cluster", 8)] if C != 8 else []
    return [(design, C), *eight,
            ("grid" if design == "cluster" else "cluster", C)]


def _layout_key(design, C) -> str:
    return "grid" if design == "grid" else f"cluster{C}"


def _entry(K, design, C, grid, cluster, args):
    """A design's C entry and its arguments in the tree on ``sys.path``:
    with ``plan`` (the cluster designs) the entries take C and a host
    int32[3] for what they enqueued; before, the grid entry alone."""
    import torch
    if not hasattr(K, "plan"):
        return (grid, *args)
    counts = torch.zeros(3, dtype=torch.int32)
    if design == "cluster":
        return (cluster, *args, C, counts)
    return (grid, *args, counts)


def _rows_9_10(t, src, sd, caps, width, rounds, both) -> dict:
    """Rows 9-10 at one bucket, in the tree on ``sys.path``: each design
    (``_dist_layouts``) through its C entry, held to the plain version
    exactly (the matching at every cap of ``caps``) and timed alone at
    the path's cap ``caps[0]``; the wrapper's time; the plain versions'
    times; the bounds of the work these inputs need."""
    import torch
    from repro_torch.kernels import dgraph_ops as K
    L, P, nlm, d = t["nbr"].shape
    G = t["gg"].shape[2]
    where = (L, P, nlm, d, G)
    cells, real = L * P * nlm, int((t["nbr"] >= 0).sum())
    layouts = _dist_layouts(K, P, nlm, d, both)
    out = {}
    # --- row 9, the distributed BFS
    want = K.dbfs_plain(t["nbr"], src, t["gg"], t["vd"], width)
    bufs = torch.empty((2, L, P, nlm), dtype=torch.int32, device="cuda")
    gidx = torch.empty((L, P, G), dtype=torch.int64, device="cuda")
    args = (t["nbr"], src, t["gg"], t["vd"], bufs[0], bufs[1], gidx, L, P,
            nlm, d, G, width)
    designs = {}
    for design, C in layouts:
        entry = _entry(K, design, C, "dbfs_launch", "dbfs_cluster_launch",
                       args)
        ms = entry_ms("dgraph", *entry, reps=20)
        _exact(f"dbfs {design}", bufs[0], want, where)
        designs[_layout_key(design, C)] = ms
    entry = _entry(K, *layouts[0], "dbfs_launch", "dbfs_cluster_launch",
                   args)
    queued = entry_ms("dgraph", *entry, reps=20, queued=True)
    got = K.dbfs(t["nbr"], src, t["gg"], t["vd"], width)
    _exact("dbfs", got, want, where)
    out["dbfs"] = dict(
        design=_layout_key(*layouts[0]), ms=designs[_layout_key(*layouts[0])],
        place=getattr(K, "state_place", None), designs=designs,
        queued_ms=queued,
        call_ms=cuda_ms(lambda: K.dbfs(t["nbr"], src, t["gg"], t["vd"],
                                       width), reps=20),
        plain_ms=cuda_ms(lambda: K.dbfs_plain(t["nbr"], src, t["gg"],
                                              t["vd"], width), 3),
        library_ms=None, max_abs_err=0, width=width,
        **bound(4 * (L * P * nlm * d + 2 * cells + L * P * G + L * (P + 1)),
                width * (real + 2 * cells)))
    # --- row 10, the matching: every design at every cap
    margs = (t["nbr"], t["ew"], t["gg"], t["vd"], t["nl"], sd)
    tally = []
    wants = {cap: K.dmatch_plain(*margs, rounds, cap,
                                 tally=tally if cap == caps[0] else None)
             for cap in dict.fromkeys(caps)}
    mbuf = torch.empty((L, P, nlm), dtype=torch.int32, device="cuda")
    designs = {}
    for design, C in layouts:
        if design == "cluster":
            words = K.dmatch_scratch(design, L, P, nlm, G, C)
        else:                           # the grid layouts, before and now
            words = L * P * G + 4 * cells + -(-nlm // 256) * L * P
        scratch = torch.empty(words, dtype=torch.int64, device="cuda")
        for cap in (*caps[1:], caps[0]):
            head = _entry(K, design, C, "dmatch_launch",
                          "dmatch_cluster_launch",
                          (*margs, mbuf, scratch, L, P, nlm, d, G, rounds,
                           cap))
            ms = entry_ms("dgraph", *head, reps=1 if cap != caps[0] else 10)
            _exact(f"dmatch {design} cap {cap}", mbuf, wants[cap], where)
        designs[_layout_key(design, C)] = ms
        if (design, C) == layouts[0]:
            queued = entry_ms("dgraph", *head, reps=10, queued=True)
    for cap in caps:
        _exact(f"dmatch cap {cap}", K.dmatch(*margs, rounds, cap),
               wants[cap], where)
    place = getattr(K, "state_place", None)
    hashes = sum(2 * rows + 2 * scanned + props
                 for rows, scanned, props in tally)
    out["dmatch"] = dict(
        design=_layout_key(*layouts[0]),
        ms=designs[_layout_key(*layouts[0])], place=place, designs=designs,
        queued_ms=queued,
        call_ms=cuda_ms(lambda: K.dmatch(*margs, rounds, caps[0]), reps=10),
        plain_ms=cuda_ms(lambda: K.dmatch_plain(*margs, rounds, caps[0]), 2),
        library_ms=None, max_abs_err=0, rounds=rounds, caps=list(caps),
        matched=int((wants[caps[0]] >= 0).sum()),
        **bound(4 * (2 * L * P * nlm * d + L * P * G + L * (P + 1) + L * P
                     + L + cells), OPS_PER_HASH * hashes))
    out["want"] = (want, wants[caps[0]])
    return out


def _dist_inputs(dgs, srcs, seeds):
    import numpy as np
    import torch
    t = _dlanes_of(dgs)
    src = torch.from_numpy(np.stack([np.asarray(s, np.int32)
                                     for s in srcs])).cuda()
    sd = torch.tensor([s & 0x7FFFFFFF for s in seeds], dtype=torch.int32,
                      device="cuda")
    return t, src, sd


def _dist_caps(dgs, nlm):
    """The path's cap first, then the lossless cap and a quarter of it,
    which drops proposals."""
    from repro_torch.core import dgraph
    lossless = dgraph._match_proposal_cap(dgs, nlm)
    return (_path_cap(dgs, nlm), 0, lossless, max(1, lossless // 4))


def _halo_entry(K, x, gg, vd, out):
    """Row 8's C entry with its arguments, and its wrapper's call, in the
    tree on ``sys.path``: with resident slot tables (``K.lane_slots``) a
    host array of each lane's table pointer (and, with part ranges, the
    whole range [0, P)); before them, the ghost ids and ranges, which the
    kernel searched."""
    import torch
    L, P, nlm = x.shape
    G = gg.shape[2]
    if not hasattr(K, "lane_slots"):
        return (("halo_launch", x, gg, vd, out, L, P, nlm, G),
                lambda: K.halo(x, gg, vd))
    tables = list(K.lane_slots(gg.cpu(), vd.cpu(), nlm).to(x.device))
    ptrs = torch.tensor([tb.data_ptr() for tb in tables], dtype=torch.int64)
    if hasattr(K, "part_range"):        # the entry takes a part range
        return (("halo_parts_launch", x, ptrs, out, L, P, nlm, G, 0, P),
                lambda: K.halo(x, tables))
    return (("halo_launch", x, ptrs, out, L, P, nlm, G),
            lambda: K.halo(x, tables))


def _times(entry, call, plain, reps, plain_reps) -> dict:
    """A C entry's times: back to back (``ms``, what a caller sees) and
    queued behind a device sleep (``queued_ms``, the card's own); the
    wrapper's and the plain version's."""
    return dict(ms=entry_ms("dgraph", *entry, reps=reps),
                queued_ms=entry_ms("dgraph", *entry, reps=reps, queued=True),
                call_ms=cuda_ms(call, reps=reps),
                plain_ms=cuda_ms(plain, plain_reps))


def launch_floor_ms():
    """The card's time for an empty kernel of ``dgraph.cu``, back to back
    and queued behind a device sleep; None in a tree without one."""
    from repro_torch.kernels import build
    if not hasattr(build.load("dgraph"), "empty_launch"):
        return None
    return {"ms": entry_ms("dgraph", "empty_launch", reps=50),
            "queued_ms": entry_ms("dgraph", "empty_launch", reps=50,
                                  queued=True)}


def _rows_7_8(t, x) -> dict:
    """Rows 7-8 at one bucket, in the tree on ``sys.path``: the halo of
    ``x`` and the relaxation of each part against its halo-extended
    vector, each held to its plain version exactly; back-to-back and
    queued times of the C entry, the wrapper's and the plain version's;
    bounds; the halo's library call (``index_select`` of the ghosts' flat
    slots)."""
    import torch
    from repro_torch.kernels import dgraph_ops as K
    L, P, nlm, d = t["nbr"].shape
    G = t["gg"].shape[2]
    where = (L, P, nlm, d, G)
    cells, real = L * P * nlm, int((t["nbr"] >= 0).sum())
    out = {}
    # --- row 8, halo
    hbuf = torch.empty((L, P, nlm + G), dtype=torch.int32, device="cuda")
    entry, call = _halo_entry(K, x, t["gg"], t["vd"], hbuf)
    halo = call()
    want = _halo_oracle(K, x, t["gg"], t["vd"])
    _exact("halo", halo, want, where)
    flat_idx = (K.owner_slots(t["gg"].reshape(L, P * G), t["vd"], nlm)
                + torch.arange(L, device="cuda")[:, None] * P * nlm)
    gok = t["gg"].reshape(L, P * G) >= 0
    flat_idx = torch.where(gok, flat_idx, 0).reshape(-1)
    xf = x.reshape(-1)
    nbytes = 4 * (2 * cells + 2 * L * P * G + L * (P + 1))
    out["halo"] = dict(
        **_times(entry, call, lambda: _halo_oracle(K, x, t["gg"], t["vd"]),
                 50, 5),
        library_ms=cuda_ms(lambda: torch.index_select(xf, 0, flat_idx), 20),
        max_abs_err=0, **bound(nbytes, L * P * G * 2 * max(1, P.bit_length())))
    _exact("halo", hbuf, want, where)
    # --- row 7, relax: each part against its halo-extended vector
    ext = halo.reshape(L * P, nlm + G)
    nbr2 = t["nbr"].reshape(L * P, nlm, d)
    rel = K.ell_relax(nbr2, ext, K.BIG)
    _exact("ell_relax", rel, K.ell_relax_plain(nbr2, ext, K.BIG), where)
    rbuf = torch.empty_like(rel)
    out["relax"] = dict(
        **_times(("ell_relax_launch", nbr2, ext, rbuf, L * P, nlm, d,
                  nlm + G, K.BIG), lambda: K.ell_relax(nbr2, ext, K.BIG),
                 lambda: K.ell_relax_plain(nbr2, ext, K.BIG), 50, 5),
        library_ms=None, max_abs_err=0,
        **bound(4 * (L * P * nlm * d + L * P * (nlm + G) + cells),
                real + 2 * cells))
    _exact("ell_relax", rbuf, rel, where)
    out["ext"] = halo
    return out


def _halo_oracle(K, x, gg, vd):
    """Row 8's plain version in the tree on ``sys.path``: on the resolved
    slot tables, or (before them) on the ghost ids and ranges."""
    if hasattr(K, "lane_slots"):
        return K.halo_plain(x, K.lane_slots(gg, vd, x.shape[2]))
    return K.halo_plain(x, gg, vd)


def _dist_kernel_case(dgs, srcs, seeds, width=3, rounds=8,
                      both=False) -> dict:
    """(a) at one bucket: rows 7-10 == their plain versions on the card,
    exactly, each lane == its singleton call, the matching dense and at
    its caps, rows 9-10 in the plan's design (and with ``both`` the other
    one); CUDA-event times alone (C entry; rows 7-8 also queued behind a
    device sleep) and through the wrapper; the plain versions' times;
    bounds; the halo's library call."""
    import torch
    from repro_torch.kernels import dgraph_ops as K
    t, src, sd = _dist_inputs(dgs, srcs, seeds)
    L, P, nlm, d = t["nbr"].shape
    G = t["gg"].shape[2]
    where = (L, P, nlm, d, G)
    x = _halo_payload(t)
    out = {"shape": list(where), "plan": list(K.plan(P, nlm, d))}
    rows = _rows_7_8(t, x)
    halo = rows.pop("ext")
    out.update(rows)
    # --- rows 9-10
    rows = _rows_9_10(t, src, sd, _dist_caps(dgs, nlm), width, rounds, both)
    dist, want = rows.pop("want")
    out.update(rows)
    # each lane == its singleton call
    if L > 1:
        for j in range(L):
            one = {k: v[j:j + 1] for k, v in t.items()}
            s1 = src[j:j + 1]
            if not (torch.equal(_halo_entry(K, x[j:j + 1], one["gg"],
                                            one["vd"], None)[1]()[0],
                                halo[j]) and
                    torch.equal(K.dbfs(one["nbr"], s1, one["gg"], one["vd"],
                                       width)[0], dist[j]) and
                    torch.equal(K.dmatch(one["nbr"], one["ew"], one["gg"],
                                         one["vd"], one["nl"], sd[j:j + 1],
                                         rounds, out["dmatch"]["caps"][0])[0],
                                want[j])):
                raise AssertionError(f"lane {j} of {where} differs from its "
                                     f"singleton call")
    return out


def _halo_payload(t):
    """A random (L, P, nlm) int32 payload for the halo, seeded by L."""
    import numpy as np
    import torch
    L, P, nlm = t["nbr"].shape[:3]
    rng = np.random.default_rng(L)
    return torch.from_numpy(rng.integers(0, 1 << 20, (L, P, nlm)).astype(
        np.int32)).cuda()


def _dist_order(dg) -> dict:
    """A warm distributed ordering of ``dg`` (seed 0, default DNDConfig):
    its wall, the dmatch / dbfs / dhalo / endgame seconds, the dhalo
    stage's split (``dhalo_split``), the distributed kernels' launches and
    the permutation's sha256."""
    import hashlib
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core.dnd import DNDConfig
    from repro_torch.kernels import dgraph_ops
    _dnd(dg, 0, DNDConfig())
    by_kind, halo_split = StageByKind(), {}
    with dhalo_split(halo_split):
        for attr in DIST_COUNTS.values():
            setattr(dgraph_ops, attr, 0)
        obs.register_collector(by_kind)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            perm = _dnd(dg, 0, DNDConfig())
        finally:
            obs.unregister_collector(by_kind)
        wall = time.perf_counter() - t0
    return {"wall_s": wall,
            "split_s": {k: by_kind.seconds.get(k, 0.0)
                        for k in ("dmatch", "dbfs", "dhalo", "endgame")},
            "dhalo_split_s": dhalo_rest(halo_split,
                                        by_kind.seconds.get("dhalo", 0.0)),
            "launches": {k: getattr(dgraph_ops, a)
                         for k, a in DIST_COUNTS.items()},
            "perm_sha256": hashlib.sha256(
                np.asarray(perm, np.int64).tobytes()).hexdigest()}


def _dist_buckets(main_largest=None):
    """("order", the distributed root of grid3d(30³) over 8 parts), then
    the three buckets of rows 9-10: that root bucket, grid3d(100³) over
    8 parts, and the frontier waves' calls with the most lanes
    (``main_largest``, or an ordering's own capture), as (name, dgs,
    srcs, seeds, width, rounds) for each kernel."""
    import numpy as np
    from repro_torch.core import dgraph
    from repro_torch.core.dnd import DNDConfig
    from repro_torch.graphs.generators import grid3d
    root = dgraph.distribute(grid3d(30, 30, 30), 8)
    g100 = dgraph.distribute(grid3d(100, 100, 100), 8)
    if main_largest is None:
        main_largest = {}
        with dist_calls(main_largest, [0], []):
            _dnd(root, 0, DNDConfig())
    out = [("order", root)]
    for name, dg in (("root_30", root), ("grid3d_100", g100)):
        rng = np.random.default_rng(dg.n_loc_max)
        src = (rng.random((dg.nparts, dg.n_loc_max)) < 0.01).astype(
            np.int32)
        out.append((name, [dg], [src], [5], 3, 8))
    dgs_b, (srcs, width) = main_largest["distributed_bfs_stacked"]
    dgs_m, (seeds, rounds) = main_largest["distributed_matching_stacked"]
    out.append(("many_lanes", dgs_b, srcs, [7] * len(dgs_b), width, rounds))
    out.append(("many_lanes_match", dgs_m,
                [np.zeros((d.nparts, d.n_loc_max), np.int32) for d in dgs_m],
                seeds, width, rounds))
    return out


def dist_rows_bench(groups=None) -> dict:
    """``chip_smoke.py --dist-rows SRC [--groups D]``: rows 7-10 alone (C
    entries; rows 7-8 also queued behind a device sleep, beside the launch
    floor) and through their wrappers at the three buckets, in the package
    under SRC (this tree's ``src`` or a parent commit's), each held to its
    plain version, and a warm ordering with its dhalo split; with a group
    size D also the ordering under both drivers and the halo, BFS and
    matching at each bucket with their parts on a group of D (phase 15);
    one JSON line."""
    from repro_torch.kernels import build
    build.build_all()
    buckets = _dist_buckets()
    root = buckets.pop(0)[1]
    out = {"order_grid3d_30": _dist_order(root),
           "launch_floor": launch_floor_ms()}
    if groups:
        group, distinct = parts_group(groups)
        want = out["order_grid3d_30"]["perm_sha256"]
        out["groups"] = {"size": groups, "distinct": distinct, **{
            name: _group_kernel_case(group, dgs, srcs, seeds, width, rounds)
            for name, dgs, srcs, seeds, width, rounds in buckets}}
        for frontier in (True, False):
            res = _group_order(root, group, frontier, want)
            out["groups"][f"order_{res['driver']}"] = res
    for name, dgs, srcs, seeds, width, rounds in buckets:
        t, src, sd = _dist_inputs(dgs, srcs, seeds)
        nlm = t["nbr"].shape[2]
        rows = _rows_7_8(t, _halo_payload(t))
        rows.pop("ext")
        more = _rows_9_10(t, src, sd, _dist_caps(dgs, nlm), width, rounds,
                          name != "grid3d_100")
        more.pop("want")
        rows.update(more)
        out[name] = {"shape": list(t["nbr"].shape) + [t["gg"].shape[2]],
                     **{k: {f: v.get(f) for f in (
                         "design", "ms", "designs", "queued_ms", "call_ms",
                         "plain_ms", "library_ms", "bound_ms")}
                        for k, v in rows.items()}}
    return out


def phase_dist(main_run: dict) -> dict:
    """Phase 10: the distributed ordering (``core.dnd``) on the card."""
    main = _dist_main(main_run)
    reqs = _dist_requests(main)
    cases, buckets = {}, _dist_buckets(main["largest"])[1:]
    for name, dgs, srcs, seeds, width, rounds in buckets:
        cases[name] = _dist_kernel_case(dgs, srcs, seeds, width, rounds,
                                        both=name != "grid3d_100")
        log(f"phase 10 {name}: {json.dumps(cases[name])}")
    # the frontier waves' many-lane buckets: the BFS's case, with the
    # matching's at its own bucket
    m_case = cases.pop("many_lanes_match")
    cases["many_lanes"]["dmatch_lanes"] = dict(m_case["dmatch"],
                                               shape=m_case["shape"],
                                               plan=m_case["plan"])
    floor = launch_floor_ms()
    log(f"phase 10 launch floor (an empty kernel of dgraph.cu, ms): "
        f"{json.dumps(floor)}")
    return {"main": {k: v for k, v in main.items()
                     if k not in ("perm", "dg", "largest")},
            "requests": reqs, "cases": cases, "launch_floor": floor,
            "perm_sha256": perm_sha(main["perm"]), "dg": main["dg"],
            "buckets": buckets}


def perm_sha(perm) -> str:
    import hashlib
    import numpy as np
    return hashlib.sha256(np.asarray(perm, np.int64).tobytes()).hexdigest()


# ---------------------------------------------------------------- groups
#: phase 15's group sizes
GROUP_SIZES = (2, 4, 8)
#: the C entries of a group member's kernels (csrc/dgraph.cu)
GROUP_ENTRIES = ("halo_parts_launch", "dbfs_parts_init_launch",
                 "dbfs_parts_step_launch", "dmatch_parts_launch")


def parts_group(size: int, nparts: int = 8):
    """A group of ``size`` members for ``nparts`` parts and whether its
    members are distinct cards: the host's first cards where it has as
    many, else ``cuda:0`` repeated."""
    import torch
    from repro_torch.core import dgraph
    if torch.cuda.device_count() >= size:
        group = dgraph.make_parts_group(size, nparts)
    else:
        group = dgraph.make_parts_group(["cuda:0"] * size, nparts)
    return group, group.distinct


@contextlib.contextmanager
def group_plain_calls(calls: list):
    """Count into ``calls[0]`` every call of a plain version of the
    distributed kernels, the group members' phases included, and of the
    centralized kernels (``plain_calls``), while the block runs."""
    from repro_torch.kernels import dgraph_ops
    with contextlib.ExitStack() as stack:
        for name in ("ell_relax_plain", "halo_plain", "dbfs_plain",
                     "dmatch_plain", "dbfs_init_plain", "dbfs_step_plain",
                     "_PlainMatch"):
            fn = getattr(dgraph_ops, name)

            def counted_fn(*args, _fn=fn, **kw):
                calls[0] += 1
                return _fn(*args, **kw)
            stack.callback(setattr, dgraph_ops, name, fn)
            setattr(dgraph_ops, name, counted_fn)
        stack.enter_context(plain_calls(calls, []))
        yield


@contextlib.contextmanager
def member_kernels(events: list):
    """CUDA events around every call of a group member's C entries, on the
    member's stream (``on_card``), while the block runs."""
    from repro_torch.kernels import build
    lib = build.load("dgraph")
    with contextlib.ExitStack() as stack:
        for name in GROUP_ENTRIES:
            stack.enter_context(on_card(lib, name, events))
        yield


def _group_order(dg, group, frontier: bool, want_sha: str) -> dict:
    """One ordering of ``dg`` (seed 0, default DNDConfig, one driver) with
    its parts on ``group``: wall, split by stage, launches against the
    plan, bytes copied between members, the permutation's hash, which
    must be ``want_sha``."""
    import torch
    from repro_torch import obs
    from repro_torch.core import dgraph
    from repro_torch.core.dnd import (DNDConfig,
                                      distributed_nested_dissection)
    from repro_torch.kernels import dgraph_ops
    by_kind, calls = StageByKind(), [0]
    with group_plain_calls(calls):
        torch.cuda.synchronize()
        for attr in DIST_COUNTS.values():
            setattr(dgraph_ops, attr, 0)
        obs.register_collector(by_kind)
        t0 = time.perf_counter()
        try:
            with dgraph.instrument() as ins:
                perm = distributed_nested_dissection(
                    dg, 0, DNDConfig(frontier=frontier), group=group)
        finally:
            obs.unregister_collector(by_kind)
        wall = time.perf_counter() - t0
    launches = {k: getattr(dgraph_ops, a) for k, a in DIST_COUNTS.items()}
    planned = dgraph_ops.planned_launches(ins.launches)
    want = {k: planned[a] for k, a in DIST_COUNTS.items()}
    split = {k: by_kind.seconds.get(k, 0.0) for k in (
        "dmatch", "dbfs", "dhalo", "fm", "match", "bfs", "rebuild",
        "endgame")}
    split["host"] = wall - sum(v for k, v in split.items()
                               if k != "endgame")
    dist = [r for r in ins.launches
            if r["kind"] in ("dhalo", "dbfs", "dmatch")]
    sizes = sorted({r.get("group", 1) for r in dist})
    res = {"driver": "frontier" if frontier else "dfs", "wall_s": wall,
           "split_s": split, "launches": launches,
           "calls": {k: sum(r["kind"] == k for r in dist)
                     for k in ("dhalo", "dbfs", "dmatch")},
           "calls_on_group": sum(r.get("group", 1) == group.size
                                 for r in dist),
           "group_sizes": sizes,
           "xbytes": sum(r.get("xbytes", 0) for r in dist),
           "plain_calls": calls[0], "perm_sha256": perm_sha(perm)}
    if res["perm_sha256"] != want_sha:
        raise AssertionError(f"group of {group.size}: the permutation "
                             f"differs from the one card's: {res}")
    if launches != want:
        raise AssertionError(f"group of {group.size}: launches {launches}, "
                             f"the plan gives {want}")
    if calls[0] or not res["calls_on_group"] or sizes[-1] != group.size:
        raise AssertionError(f"group of {group.size}: plain calls, or no "
                             f"call on the whole group: {res}")
    return res


def _group_kernel_case(group, dgs, srcs, seeds, width=3,
                       rounds=8) -> dict:
    """The halo, BFS and matching at one bucket with their parts on
    ``group``: each equal to the one-card call, and the raw kernels'
    results to their plain versions on the card (the matching at the
    path's cap, then dense, at the lossless cap and at a cap that drops
    proposals); the call's CUDA-event time (upload to download), the
    members' kernels' alone, the one-card call's, launches a call and
    bytes copied between members a call."""
    import numpy as np
    import torch
    from repro_torch.core import dgraph
    from repro_torch.kernels import dgraph_ops as K
    t, src, sd = _dist_inputs(dgs, srcs, seeds)
    L, P, nlm, d = t["nbr"].shape
    where = (L, P, nlm, d, t["gg"].shape[2], group.size)
    x = _halo_payload(t)
    xs = list(x.cpu().numpy())
    caps = _dist_caps(dgs, nlm)
    ranges = group.layout(P)
    calls = {
        "halo": lambda grp: dgraph.halo_exchange_stacked(dgs, xs, group=grp),
        "dbfs": lambda grp: dgraph.distributed_bfs_stacked(
            dgs, srcs, width, group=grp),
        "dmatch": lambda grp: dgraph.distributed_matching_stacked(
            dgs, seeds, rounds, group=grp)}
    counts = {"halo": ("halo_launches",),
              "dbfs": ("dbfs_launches", "relax_launches"),
              "dmatch": ("dmatch_launches",)}
    out = {"shape": list(where)}
    for name, call in calls.items():
        one = call(None)
        before = {c: getattr(K, c) for c in counts[name]}
        events = []
        with dgraph.instrument() as ins, member_kernels(events):
            got = call(group)
        torch.cuda.synchronize()
        rec, = ins.launches
        launched = sum(getattr(K, c) - before[c] for c in counts[name])
        planned = sum(K.planned_launches([rec])[c] for c in counts[name])
        if not all(np.array_equal(a, b) for a, b in zip(got, one)):
            raise AssertionError(f"{name} on a group of {group.size} "
                                 f"differs from one card at {where}")
        if launched != planned or rec["group"] != len(ranges):
            raise AssertionError(f"{name} on a group of {group.size}: "
                                 f"{launched} launches, the plan gives "
                                 f"{planned}")
        out[name] = {"ms": cuda_ms(lambda: call(group), 3),
                     "one_card_ms": cuda_ms(lambda: call(None), 3),
                     "kernel_ms": device_s(events) * 1e3,
                     "launches_per_call": launched,
                     "xbytes_per_call": rec["xbytes"]}
    # the raw kernels against their plain versions on the card: the halo
    # and the BFS through the group's own schedule, the matching at every
    # cap (the path's first)
    moved = []
    halo = dgraph._halo_group(group, ranges, dgs, xs, t["gg"].shape[2],
                              moved)
    _exact("halo on a group", torch.from_numpy(halo).cuda(),
           K.halo_plain(x, K.lane_slots(t["gg"], t["vd"], nlm)), where)
    dist = dgraph._dbfs_group(group, ranges, dgs, srcs, width, moved)
    _exact("dbfs on a group", torch.from_numpy(dist).cuda(),
           K.dbfs_plain(t["nbr"], src, t["gg"], t["vd"], width), where)
    margs = (t["nbr"], t["ew"], t["gg"], t["vd"], t["nl"], sd)
    for cap in caps:
        got = dgraph._dmatch_group(group, ranges, dgs, seeds, rounds, cap,
                                   moved)
        _exact(f"dmatch on a group, cap {cap}", torch.from_numpy(got).cuda(),
               K.dmatch_plain(*margs, rounds, cap), where)
    out["dmatch"]["caps"] = list(caps)
    return out


def phase_groups(dist: dict) -> dict:
    """Phase 15: the distributed ordering and its collectives on groups of
    2, 4 and 8 (distinct cards where the host has them)."""
    import torch
    cards = torch.cuda.device_count()
    groups = {size: parts_group(size) for size in GROUP_SIZES}
    log(f"phase 15 groups: {cards} card(s) on this host; " + ", ".join(
        f"{size} members on " + ("distinct cards" if distinct
                                 else "cuda:0 repeated")
        for size, (_, distinct) in groups.items()))
    dg, want = dist.pop("dg"), dist["perm_sha256"]
    orders, cases = {}, {}
    for size, (group, distinct) in groups.items():
        orders[size] = {"distinct": distinct, **{
            res["driver"]: res for res in (
                _group_order(dg, group, frontier, want)
                for frontier in (True, False))}}
        log(f"phase 15 grid3d(30,30,30) over 8 parts on a group of {size}: "
            f"{json.dumps(orders[size])}")
    # every bucket of phase 10's kernel cases: one lane of 131,072 rows a
    # part at 100³, and lanes of several parts at the others, where the
    # part ranges' lane offsets are not zero
    for name, *bucket in dist.pop("buckets"):
        cases[name] = {}
        for size, (group, distinct) in groups.items():
            cases[name][size] = dict(_group_kernel_case(group, *bucket),
                                     distinct=distinct)
            log(f"phase 15 {name} bucket on a group of {size}: "
                f"{json.dumps(cases[name][size])}")
    return {"orders": orders, "buckets": cases, "cards": cards}


# ---------------------------------------------------------------- LM
#: phase 11's model, served at its published width and depth: a batch of
#: LM_BATCH prompts of LM_PROMPT tokens, prefill padded to LM_PAD
#: positions, then LM_STEPS greedy decode steps
LM_ARCH, LM_BATCH, LM_PROMPT, LM_PAD, LM_STEPS = "yi-6b", 4, 128, 160, 32
#: bfloat16 serving logits against the port's own bfloat16 forward over
#: the same tokens: the reference test's tolerance (tests/test_models.py)
LM_SELF_TOL = 0.15
#: bfloat16 serving logits against a float32 copy of the weights: the
#: largest difference and the RMS difference over the RMS logit.  A few
#: bfloat16 roundings (relative 2^-9) a layer, adding up over 32 layers
#: as a random walk, give an RMS difference near 2% of the RMS logit
#: (about 1.0 with these random weights); the largest of 4.1e7 logits
#: lies near 6 RMS (about 0.12).  Both bounds leave about 2x for the
#: card's other summation order.
LM_F32_MAX, LM_F32_RMS = 0.25, 0.03
#: H100 SXM dense bfloat16 tensor-core peak (NVIDIA data sheet)
BF16_PEAK = 989e12
#: the reduced MoE architectures' capacity factor on the card, as in the
#: reference test: no token dropped, so a routing difference stays in its
#: row
MOE_CF = 8.0
#: the widest gap between a token's k-th and (k+1)-th router
#: probabilities that bfloat16 rounding may swap
NEAR_TIE = 2.0 ** -8


def _logit_errs(got, want) -> dict:
    """Largest difference, RMS difference over the RMS of ``want``, and
    whether every logit lies within ``LM_SELF_TOL`` (abs and rel)."""
    d = (got.float() - want.float()).abs()
    w = want.float()
    return {"max_abs_err": float(d.max()),
            "rms_rel_err": float(d.pow(2).mean().sqrt() /
                                 w.pow(2).mean().sqrt()),
            "within_tol": bool((d <= LM_SELF_TOL * (1 + w.abs())).all())}


def _serve(params, cfg, prompt, pad_to, steps):
    """Prefill ``prompt`` then ``steps`` greedy decode steps through
    ``serve.engine``; (prefill logits, decode logits (B, steps, V), the
    generated tokens (B, steps + 1), the steps' times)."""
    import torch
    from repro_torch.serve import engine
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * steps)]
    logits_p, caches = engine.prefill(params, cfg, {"tokens": prompt},
                                      pad_to=pad_to)
    step = engine.make_decode_step(cfg)
    tok = logits_p[:, -1:].argmax(-1)
    toks, dec = [tok], []
    S0 = prompt.shape[1]
    t0 = time.perf_counter()
    for t in range(steps):
        ev[2 * t].record()
        lg, caches = step(params, tok, caches, S0 + t)
        ev[2 * t + 1].record()
        dec.append(lg[:, 0])
        tok = lg[:, -1:].argmax(-1)
        toks.append(tok)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    times = {"step_ms": [ev[2 * t].elapsed_time(ev[2 * t + 1])
                         for t in range(steps)],
             "decode_wall_ms_per_step": 1e3 * wall / max(steps, 1)}
    return logits_p, torch.stack(dec, 1), torch.cat(toks, 1), times


def _device_busy(fn, top: int = 0) -> dict:
    """One run of ``fn()`` under ``torch.profiler``: its CUDA kernels'
    count and summed device time (one stream, so no overlap), and with
    ``top`` the ``top`` aten ops of the most device time launched
    directly by them (name, calls, ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError("torch.profiler saw no kernel on the card")
    out = {"kernels": len(kernels),
           "busy_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3}
    if top:
        ops = sorted((a for a in prof.key_averages()
                      if a.key.startswith("aten::")
                      and a.self_device_time_total > 0),
                     key=lambda a: -a.self_device_time_total)[:top]
        out["top_ops"] = [[a.key, a.count, a.self_device_time_total / 1e3]
                          for a in ops]
    return out


class _Routing:
    """Each MoE call's router probabilities (T, E) on the card, recorded
    around ``layers.moe_apply`` while installed."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch
        from repro_torch.models import layers
        self.mod, self.orig = layers, layers.moe_apply

        def rec(p, x, cfg):
            logits = x.reshape(-1, x.shape[-1]) @ p["router"]
            self.calls.append(torch.softmax(logits.float(), -1).cpu())
            return self.orig(p, x, cfg)
        layers.moe_apply = rec
        return self

    def __exit__(self, *exc):
        self.mod.moe_apply = self.orig


def _first_differences(full, served, B, S, half, K):
    """Per row, the first position whose routing in the served path
    (prefill on ``half`` positions, then one decode step a position)
    differs from the full forward's; fails unless every difference with
    none before it at or before its position in its row is a near tie in
    the forward."""
    import torch
    n_moe = len(full)
    first = {}
    for c, pr in enumerate(served):
        layer = c % n_moe
        if c < n_moe:
            t = torch.arange(B * half)
            rows, pos = t // half, t % half
        else:
            rows = torch.arange(B)
            pos = torch.full((B,), half + (c - n_moe) // n_moe)
        ref = full[layer][rows * S + pos]
        srt = ref.sort(dim=-1, descending=True, stable=True)
        gap = srt.values[:, K - 1] - srt.values[:, K]
        top_r = srt.indices[:, :K].sort(-1).values
        top_s = pr.sort(dim=-1, descending=True, stable=True).indices[:, :K]
        diff = (top_r != top_s.sort(-1).values).any(-1)
        seen = dict(first)
        for i in torch.nonzero(diff).flatten().tolist():
            b, s = int(rows[i]), int(pos[i])
            if s < seen.get(b, S) and float(gap[i]) > NEAR_TIE:
                raise AssertionError(
                    f"routing differs at row {b}, position {s} with a gap "
                    f"of {float(gap[i])}")
            first[b] = min(first.get(b, S), s)
    return first


def _reduced_case(arch: str, seed: int) -> dict:
    """One reduced architecture on the card: prefill on the first half
    of a sequence, teacher-forced decode over the rest, held to its own
    forward (a MoE's at a routing difference and after it excepted, each
    first difference a near tie)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    from repro_torch.serve import engine
    cfg = get_config(arch).reduced()
    if cfg.moe:
        cfg = dataclasses.replace(cfg, capacity_factor=MOE_CF)
    params = lm.init_params(lm.generator(seed), cfg)
    B, S, S_max = 2, 8, 16
    if cfg.frontend == "patches":
        S = 2 * cfg.n_patches
    half = S // 2
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                             device="cuda")
    gen, extra = lm.generator(seed + 1), {}
    if cfg.enc_dec:
        extra["frames"] = torch.randn(
            (B, cfg.enc_len, cfg.d_model), generator=gen, device="cuda")
    if cfg.frontend == "patches":
        extra["patches"] = torch.randn(
            (B, cfg.n_patches, cfg.d_model), generator=gen, device="cuda")
    with _Routing() as full_route:
        full, _ = lm.forward(params, cfg, dict(extra, tokens=tokens))
    with _Routing() as served:
        lp, caches = engine.prefill(
            params, cfg, dict(extra, tokens=tokens[:, :half]), pad_to=S_max)
        step = engine.make_decode_step(cfg)
        dec = []
        for t in range(half, S):
            lg, caches = step(params, tokens[:, t:t + 1], caches, t)
            dec.append(lg[:, 0])
    got = torch.cat([lp, torch.stack(dec, 1)], 1)
    if not torch.isfinite(got.float()).all() or got.shape != full.shape:
        raise AssertionError(f"{arch}: {got.shape} logits, not finite or "
                             f"not {tuple(full.shape)}")
    first = _first_differences(full_route.calls, served.calls, B, S, half,
                               cfg.top_k) if cfg.moe else {}
    worst, compared = 0.0, 0
    for b in range(B):
        end = first.get(b, S)
        e = _logit_errs(got[b, :end], full[b, :end]) if end else None
        if e and not e["within_tol"]:
            raise AssertionError(f"{arch} row {b}: {e}")
        worst = max(worst, e["max_abs_err"] if e else 0.0)
        compared += end
    if compared < B * S // 2:
        raise AssertionError(f"{arch}: compared {compared} of {B * S}")
    return {"max_abs_err": worst, "compared": compared, "of": B * S,
            "routing_differs_from": first}


def phase_lm(gpu: str) -> dict:
    """Phase 11: the LM serving path (``serve.engine``) on the card."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs.base import ARCH_IDS, get_config
    from repro_torch.flopcount import forward_flops
    from repro_torch.models import lm
    from repro_torch.serve import engine
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = lm.init_params(lm.generator(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree.leaves(params)
    n_params = sum(t.numel() for t in leaves)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT)), device="cuda")
    _serve(params, cfg, prompt, LM_PAD, 2)          # warm-up
    logits_p, logits_d, toks, times = _serve(params, cfg, prompt, LM_PAD,
                                             LM_STEPS)
    batch = {"tokens": prompt}
    prefill_ms = cuda_ms(lambda: engine.prefill(params, cfg, batch,
                                                pad_to=LM_PAD), 3)
    pre_busy = _device_busy(lambda: engine.prefill(params, cfg, batch,
                                                   pad_to=LM_PAD))
    _, caches = engine.prefill(params, cfg, batch, pad_to=LM_PAD)
    step = engine.make_decode_step(cfg)
    dec_busy = _device_busy(lambda: step(params, toks[:, :1], caches,
                                         LM_PROMPT))
    del caches
    served = torch.cat([logits_p, logits_d], 1)
    want_shape = (LM_BATCH, LM_PROMPT + LM_STEPS, cfg.vocab)
    if tuple(served.shape) != want_shape or \
            not torch.isfinite(served.float()).all():
        raise AssertionError(f"served logits {tuple(served.shape)}, "
                             f"want {want_shape}, finite")
    gen = engine.greedy_generate(params, cfg, prompt, LM_STEPS + 1, LM_PAD)
    if not torch.equal(gen, toks):
        raise AssertionError("greedy_generate differs from the served loop")
    seq = torch.cat([prompt, toks[:, :-1]], 1)      # teacher-forced tokens
    full, _ = lm.forward(params, cfg, {"tokens": seq})
    self_err = _logit_errs(served, full)
    if not self_err["within_tol"]:
        raise AssertionError(f"serving != forward: {self_err}")
    p32 = tree.map(torch.Tensor.float, params)
    full32, _ = lm.forward(p32, cfg, {"tokens": seq})
    del p32
    f32_err = _logit_errs(served, full32)
    fwd_f32_err = _logit_errs(full, full32)
    del full32
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if f32_err["max_abs_err"] > LM_F32_MAX or \
            f32_err["rms_rel_err"] > LM_F32_RMS:
        raise AssertionError(f"bfloat16 serving vs float32: {f32_err} "
                             f"(bounds {LM_F32_MAX}, {LM_F32_RMS})")
    flops = forward_flops(cfg, LM_BATCH * LM_PROMPT, LM_PROMPT)
    steps = times["step_ms"][1:]
    embed = params["embed"]
    kv_bytes = 2 * cfg.n_layers * LM_BATCH * LM_PAD * cfg.n_kv_heads * \
        cfg.hd * 2
    dec_bytes = weight_bytes - embed.numel() * embed.element_size() + \
        LM_BATCH * cfg.d_model * embed.element_size() + kv_bytes
    res = {
        "arch": LM_ARCH, "params": n_params, "weight_bytes": weight_bytes,
        "batch": LM_BATCH, "prompt": LM_PROMPT, "pad_to": LM_PAD,
        "decode_steps": LM_STEPS, "init_s": init_s, "peak_gb": peak_gb,
        "prefill_ms": prefill_ms,
        "prefill_flops": flops,
        "prefill_peak_share": flops / (prefill_ms / 1e3) / BF16_PEAK,
        "prefill_kernels": pre_busy["kernels"],
        "prefill_device_busy_ms": pre_busy["busy_ms"],
        "prefill_idle_share": 1 - pre_busy["busy_ms"] / prefill_ms,
        "decode_ms_per_step": sum(steps) / len(steps),
        "decode_ms_first_step": times["step_ms"][0],
        "decode_ms_min_max": [min(steps), max(steps)],
        "decode_wall_ms_per_step": times["decode_wall_ms_per_step"],
        "decode_kernels_per_step": dec_busy["kernels"],
        "decode_device_busy_ms": dec_busy["busy_ms"],
        "decode_idle_share": 1 - dec_busy["busy_ms"] / (
            sum(steps) / len(steps)),
        "decode_bound_bytes": dec_bytes,
        "decode_bound_ms": 1e3 * dec_bytes / HBM_BYTES_PER_S,
        "serve_vs_forward": self_err, "serve_vs_f32": f32_err,
        "forward_vs_f32": fwd_f32_err,
        "tolerances": {"self": LM_SELF_TOL, "f32_max": LM_F32_MAX,
                       "f32_rms": LM_F32_RMS},
        "gpu": gpu}
    del params, full, served
    torch.cuda.empty_cache()
    log(f"phase 11 LM serving {LM_ARCH} (full width and depth): "
        f"{json.dumps(res)}")
    reduced = {arch: _reduced_case(arch, seed=1) for arch in ARCH_IDS}
    log(f"phase 11 reduced architectures, prefill + decode == forward: "
        f"{json.dumps(reduced)}")
    return {"serve": res, "reduced": reduced}


def phase_examples() -> dict:
    """Phase 12: every example of the port on the card with small
    arguments, the service example traced and its trace summarised."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.examples import (expert_placement, order_mesh,
                                      quickstart, serve_lm, serve_orderings,
                                      train_lm)
    from repro_torch.scripts import trace_summary
    out, secs = {}, {}

    def run(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t0

    def perm_ok(perm, n):
        return np.array_equal(np.sort(np.asarray(perm)), np.arange(n))
    run("quickstart", lambda: quickstart.main(["--side", "10",
                                               "--nproc", "8"]))
    qs = out["quickstart"]
    if min(o for name, (_, o) in qs.items() if name != "natural") >= \
            qs["natural"][1]:
        raise AssertionError(f"quickstart: no ordering beat natural: {qs}")
    trace = ROOT / "build" / "examples_trace.json"
    trace.parent.mkdir(exist_ok=True)
    with obs.tracing() as tracer:
        run("serve_orderings", lambda: serve_orderings.main([]))
    tracer.export_chrome(str(trace))
    if len(out["serve_orderings"]) != 4:
        raise AssertionError("serve_orderings: not 4 results")
    run("trace_summary", lambda: trace_summary.main([str(trace)]))
    if out["trace_summary"] != 0 or not obs.load_chrome(str(trace)):
        raise AssertionError("trace_summary failed or the trace is empty")
    run("order_mesh", lambda: order_mesh.main(["--side", "8"]))
    om = out["order_mesh"]
    if not perm_ok(om["perm"], 512) or om["band"] <= 0:
        raise AssertionError(f"order_mesh: band {om['band']}, or the "
                             "distributed ordering is no permutation")
    run("expert_placement", lambda: expert_placement.main([]))
    ep = out["expert_placement"]
    if not ep["scotch"] < ep["random"]:
        raise AssertionError(f"expert_placement: {ep}")
    for arch in ("yi-6b", "jamba-v0.1-52b"):
        run(f"serve_lm {arch}", lambda a=arch: serve_lm.main(
            ["--arch", a, "--new-tokens", "8"]))
        if out[f"serve_lm {arch}"]["tokens"].shape != (4, 8):
            raise AssertionError(f"serve_lm {arch}: not 4 × 8 tokens")
    # the trainer: a simulated failure at step 3 restarts from the step-2
    # checkpoint through the trainer's own loop (step 2 replayed, bit for
    # bit), then a resume from step 6 to 8
    ck = ROOT / "build" / "train_lm_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    targs = ["--batch", "4", "--seq", "64", "--ckpt", str(ck),
             "--ckpt-every", "2", "--log-every", "1"]
    run("train_lm", lambda: train_lm.main(targs + ["--steps", "6",
                                                   "--fail-at", "3"]))
    run("train_lm resume", lambda: train_lm.main(targs + ["--steps", "8",
                                                          "--resume"]))
    shutil.rmtree(ck, ignore_errors=True)
    tl, tr = out["train_lm"], out["train_lm resume"]
    if tl["restarts"] != 1 or tl["step_ids"] != [0, 1, 2, 2, 3, 4, 5] or \
            tl["losses"][2] != tl["losses"][3] or \
            tr["step_ids"] != [6, 7] or \
            not all(map(math.isfinite, tl["losses"] + tr["losses"])):
        raise AssertionError(f"train_lm: {tl}, resumed {tr}")
    res = {"seconds": secs,
           "train_lm_losses": tl["losses"] + tr["losses"],
           "quickstart_opc": {k: v[1] for k, v in qs.items()},
           "order_mesh_dnd_opc": om["dnd_opc"],
           "expert_placement": {k: float(ep[k]) for k in
                                ("scotch", "random", "round_robin")},
           "trace": str(trace.relative_to(ROOT))}
    log(f"phase 12 examples on the card: {json.dumps(res)}")
    return res


# ---------------------------------------------------------------- training
#: phase 13's model, trained at its published width and depth (the
#: reference trainer's ``--full`` run): TRAIN_BATCH × TRAIN_SEQ tokens a
#: step from the port's data pipeline (seed 0), AdamW at TRAIN_LR with a
#: warm-up of TRAIN_WARMUP steps, remat "full"; TRAIN_WARM untimed steps,
#: then TRAIN_TIMED timed ones, then the checkpoint's two
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = "mamba2-130m", 8, 512
TRAIN_LR, TRAIN_WARMUP, TRAIN_WARM, TRAIN_TIMED = 3e-4, 20, 2, 10
#: the first bfloat16 step against a float32 copy of its weights (no
#: TF32), relative.  Predicted on the CPU (mamba2-130m at full width, 1-16
#: layers, batch 2 × 512, two seeds each): the loss within 7e-6 - 8e-5,
#: the grad norm within 1.4e-3 - 2.1e-3 (bfloat16 low), neither growing
#: with depth; bounds about 10x and 5x above those
TRAIN_F32_LOSS_RTOL, TRAIN_F32_GNORM_RTOL = 1e-3, 1e-2
#: a reduced architecture's float32 step, card against CPU (no TF32):
#: the same math summed in other orders (about 1e-6 on the CPU between
#: the two packages), relative, loss and grad norm
REDUCED_STEP_RTOL = 1e-4


def _pipeline_batches(cfg, B: int, S: int, n: int, device="cuda") -> list:
    """The first ``n`` batches of the port's data pipeline (seed 0) on
    ``device``, the pipeline's thread closed after."""
    import torch
    from repro_torch.data.pipeline import DataConfig, Pipeline
    pipe = Pipeline(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B))
    out = []
    try:
        for i in range(n):
            step, b = next(pipe)
            if step != i:
                raise AssertionError(f"pipeline gave step {step}, not {i}")
            out.append({k: torch.from_numpy(v).to(device)
                        for k, v in b.items()})
    finally:
        pipe.close()
    return out


def _peak_gb(fn) -> float:
    """Peak device memory (GB) during ``fn()``."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def _restart_case(cfg, step, params, opt, batches, k: int) -> dict:
    """Save (params, opt) after step k, run steps k and k + 1; restore
    into a fresh tree and replay them: the losses and every leaf of the
    parameters and the optimizer state must be bit-equal."""
    import torch
    from repro_torch import tree
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as ckpt
    path = ROOT / "build" / "train_ckpt"
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    ckpt.save(str(path), k, (params, opt), extra={"arch": TRAIN_ARCH})
    save_s = time.perf_counter() - t0

    def two(p, o):
        losses = []
        for i in (k, k + 1):
            p, o, m = step(p, o, batches[i])
            losses.append(float(m["loss"]))
        return p, o, losses
    pa, oa, la = two(params, opt)
    fresh = lm.init_params(lm.generator(1), cfg)
    t0 = time.perf_counter()
    st, (pb, ob) = ckpt.restore(str(path), (fresh, adamw.init(fresh)))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del fresh
    pb, ob, lb = two(pb, ob)
    shutil.rmtree(path, ignore_errors=True)
    leaves = tree.leaves((pa, oa))
    differ = [i for i, (a, b) in enumerate(zip(leaves, tree.leaves((pb, ob))))
              if not torch.equal(a, b)]
    if st != k or la != lb or differ:
        raise AssertionError(f"restart not bit-exact: step {st} (want {k}),"
                             f" losses {la} then {lb}, leaves {differ} of "
                             f"{len(leaves)} differ")
    return {"at_step": k, "losses": la, "leaves": len(leaves),
            "save_s": save_s, "restore_s": restore_s}


def _full_width_train(gpu: str) -> dict:
    """Phase 13 (a): mamba2-130m at full width and depth on the card."""
    import torch
    from repro_torch import tree
    from repro_torch.configs.base import get_config
    from repro_torch.flopcount import forward_flops
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step, value_and_grad
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    params = lm.init_params(lm.generator(0), cfg)
    n_params = sum(t.numel() for t in tree.leaves(params))
    opt = adamw.init(params)
    step = make_train_step(cfg, adamw.AdamWConfig(lr=TRAIN_LR,
                                                  warmup=TRAIN_WARMUP))
    n_run = TRAIN_WARM + TRAIN_TIMED
    batches = _pipeline_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, n_run + 2)
    # the first step's loss and grad norm in float32 (no TF32)
    p32 = tree.map(torch.Tensor.float, params)
    (loss32, _), g32 = value_and_grad(p32, cfg, batches[0])
    gnorm32 = float(adamw.global_norm(g32))
    loss32 = float(loss32)
    del p32, g32
    master0 = [t.clone() for t in tree.leaves(opt.master)]
    p0 = tree.leaves(params)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * n_run)]
    metrics = []
    t0 = time.perf_counter()
    for i in range(n_run):
        ev[2 * i].record()
        params, opt, m = step(params, opt, batches[i])
        ev[2 * i + 1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n_run
    ms = [ev[2 * i].elapsed_time(ev[2 * i + 1]) for i in range(n_run)]
    timed = ms[TRAIN_WARM:]
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    if not all(map(math.isfinite, losses + gnorms)):
        raise AssertionError(f"not finite: losses {losses}, grad norms "
                             f"{gnorms}")
    moved = [not torch.equal(a, b) for a, b in zip(
        master0, tree.leaves(opt.master))]
    moved_bf16 = sum(not torch.equal(a, b) for a, b in zip(
        p0, tree.leaves(params)))
    if not all(moved) or not moved_bf16:
        raise AssertionError(f"parameters unchanged: master {moved}, "
                             f"{moved_bf16} bfloat16 leaves moved")
    del master0, p0
    f32 = {"loss": losses[0], "loss_f32": loss32,
           "loss_rel": abs(losses[0] - loss32) / abs(loss32),
           "grad_norm": gnorms[0], "grad_norm_f32": gnorm32,
           "grad_norm_rel": abs(gnorms[0] - gnorm32) / gnorm32}
    if f32["loss_rel"] > TRAIN_F32_LOSS_RTOL or \
            f32["grad_norm_rel"] > TRAIN_F32_GNORM_RTOL:
        raise AssertionError(f"bfloat16 step vs float32: {f32} (bounds "
                             f"{TRAIN_F32_LOSS_RTOL}, {TRAIN_F32_GNORM_RTOL})")
    restart = _restart_case(cfg, step, params, opt, batches, n_run)
    busy = _device_busy(lambda: step(params, opt, batches[0]), top=15)
    mem = {"state_gb": torch.cuda.memory_allocated() / 1e9,
           "peak_gb_remat_full": _peak_gb(
               lambda: step(params, opt, batches[0]))}
    old = lm.REMAT_POLICY
    try:
        lm.REMAT_POLICY = "none"
        mem["peak_gb_remat_none"] = _peak_gb(
            lambda: step(params, opt, batches[0]))
    finally:
        lm.REMAT_POLICY = old
    step_ms = sum(timed) / len(timed)
    flops = 3 * forward_flops(cfg, TRAIN_BATCH * TRAIN_SEQ, TRAIN_SEQ)
    res = {"arch": TRAIN_ARCH, "params": n_params,
           "param_count": cfg.param_count(), "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "lr": TRAIN_LR, "warmup": TRAIN_WARMUP,
           "remat": old,
           "step_ms": step_ms, "step_ms_min_max": [min(timed), max(timed)],
           "warm_step_ms": ms[:TRAIN_WARM], "wall_ms_per_step": wall_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
           "model_flops": flops,
           "peak_share": flops / (step_ms / 1e3) / BF16_PEAK,
           "kernels_per_step": busy["kernels"],
           "device_busy_ms": busy["busy_ms"],
           "idle_share": 1 - busy["busy_ms"] / step_ms,
           "top_ops_device_ms": busy["top_ops"],
           "memory": mem, "losses": losses, "grad_norms": gnorms,
           "vs_f32": f32, "tolerances": {"loss": TRAIN_F32_LOSS_RTOL,
                                         "grad_norm": TRAIN_F32_GNORM_RTOL},
           "restart": restart, "gpu": gpu}
    del params, opt, batches
    torch.cuda.empty_cache()
    return res


def _reduced_train_case(arch: str) -> dict:
    """Phase 13 (b): one train step of a reduced architecture on the card
    (bfloat16: finite, parameters changed), and its float32 step on the
    card against the same step on the CPU (no TF32); a MoE's routing is
    recorded on both sides, and a difference must be a near tie (then
    the losses are not compared)."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    cfg = get_config(arch).reduced()
    B, S = 2, 16
    rng = np.random.default_rng(0)
    host = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S))),
            "labels": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)))}
    if cfg.enc_dec:
        host["frames"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.enc_len, cfg.d_model)), dtype=torch.bfloat16)
    if cfg.frontend == "patches":
        host["patches"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)), dtype=torch.bfloat16)
    card = {k: v.cuda() for k, v in host.items()}
    step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-3))
    params = lm.init_params(lm.generator(42), cfg)
    p1, _, m = step(params, adamw.init(params), card)
    first = tree.leaves(params)[0]
    if not math.isfinite(float(m["loss"])) or \
            torch.equal(first, tree.leaves(p1)[0]):
        raise AssertionError(f"{arch}: loss {float(m['loss'])}, or the "
                             "parameters did not change")
    p32 = tree.map(torch.Tensor.float, params)
    cpu32 = tree.map(lambda t: t.cpu(), p32)
    with _Routing() as r_card:
        _, _, mc = step(p32, adamw.init(p32), card)
    with _Routing() as r_cpu:
        _, _, mh = step(cpu32, adamw.init(cpu32), host)
    if len(r_card.calls) != len(r_cpu.calls):
        raise AssertionError(f"{arch}: {len(r_card.calls)} MoE calls on the "
                             f"card, {len(r_cpu.calls)} on the CPU")
    swaps, K = 0, cfg.top_k
    for pc, ph in zip(r_card.calls, r_cpu.calls):
        srt = ph.sort(dim=-1, descending=True, stable=True)
        top_h = srt.indices[:, :K].sort(-1).values
        top_c = pc.sort(dim=-1, descending=True,
                        stable=True).indices[:, :K].sort(-1).values
        gap = srt.values[:, K - 1] - srt.values[:, K]
        diff = (top_h != top_c).any(-1)
        if bool((gap[diff] > NEAR_TIE).any()):
            raise AssertionError(f"{arch}: routing differs beyond a near "
                                 "tie")
        swaps += int(diff.sum())
    out = {"loss_bf16": float(m["loss"]), "loss_f32_card": float(mc["loss"]),
           "loss_f32_cpu": float(mh["loss"]), "routing_swaps": swaps}
    for k in ("loss", "grad_norm"):
        out[f"{k}_rel"] = abs(float(mc[k]) - float(mh[k])) / \
            abs(float(mh[k]))
        if not swaps and out[f"{k}_rel"] > REDUCED_STEP_RTOL:
            raise AssertionError(f"{arch}: float32 step card vs cpu: {out}")
    return out


def _loss_decreases() -> dict:
    """Phase 13 (c): the reference's ``test_loss_decreases`` on the card:
    reduced yi-6b, lr 3e-3, warm-up 5, 30 steps of 4 × 32 tokens."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, _batch_at
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    cfg = get_config("yi-6b").reduced()
    params = lm.init_params(lm.generator(0), cfg)
    opt = adamw.init(params)
    step = make_train_step(cfg, adamw.AdamWConfig(lr=3e-3, warmup=5))
    d = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    losses = []
    for i in range(30):
        b = {k: torch.from_numpy(v).cuda() for k, v in _batch_at(d, i).items()}
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first - 0.2:
        raise AssertionError(f"loss did not fall: {losses}")
    return {"first5": first, "last5": last}


def phase_train(gpu: str) -> dict:
    """Phase 13: the LM training path on the card."""
    t0 = time.perf_counter()
    full = _full_width_train(gpu)
    log(f"phase 13 LM training {TRAIN_ARCH} (full width and depth): "
        f"{json.dumps(full)}")
    from repro_torch.configs.base import ARCH_IDS
    reduced = {arch: _reduced_train_case(arch) for arch in ARCH_IDS}
    log(f"phase 13 reduced architectures, a train step, float32 card == "
        f"cpu: {json.dumps(reduced)}")
    falls = _loss_decreases()
    log(f"phase 13 loss decreases (reduced yi-6b, 30 steps on the card): "
        f"{json.dumps(falls)}; phase 13 took "
        f"{time.perf_counter() - t0:.1f} s")
    return {"full": full, "reduced": reduced, "loss_decreases": falls}


# ---------------------------------------------------------------- roofline
#: phase 14's tolerances: a roofline bound is a least time, so it may not
#: pass the measured time (5% for the timer); the counted FLOPs against
#: ``flopcount`` and the dry run's peak memory against the card's, the
#: reference test's 25%
ROOF_BOUND_SLACK, ROOF_FLOPS_RTOL, ROOF_MEM_RTOL = 1.05, 0.25, 0.25
#: phase 14 (c): full-width cells on the fake H100 meshes, with the slope
ROOF_CELLS = (("yi-6b", "train_4k", False),
              ("deepseek-v2-lite-16b", "prefill_32k", True),
              ("mamba2-130m", "long_500k", False),
              ("jamba-v0.1-52b", "decode_32k", True))
CARD_BYTES = 80e9


def _terms(roof) -> dict:
    return {"flops": roof.flops_per_chip, "bytes": roof.bytes_per_chip,
            "coll_bytes": roof.coll_bytes_per_chip,
            "t_compute_ms": 1e3 * roof.t_compute,
            "t_memory_ms": 1e3 * roof.t_memory,
            "t_collective_ms": 1e3 * roof.t_collective,
            "bound_ms": 1e3 * roof.t_bound, "bound_by": roof.bottleneck}


def _real_roofline(name, fn, args, kwargs, flops_want, reps) -> dict:
    """``roofline.analyze`` over one real run of ``fn`` on the card,
    against ``reps`` CUDA-event-timed runs and the profiler's busy time;
    fails if the bound passes the measured time or the counted FLOPs
    miss ``flops_want`` by more than ``ROOF_FLOPS_RTOL``."""
    from repro_torch import roofline
    c = roofline.Counter()
    roof = roofline.analyze(fn, *args, counter=c, **kwargs)
    ms = cuda_ms(lambda: fn(*args, **kwargs), reps)
    busy = _device_busy(lambda: fn(*args, **kwargs))
    res = dict(_terms(roof), measured_ms=ms, busy_ms=busy["busy_ms"],
               bound_share=1e3 * roof.t_bound / ms,
               bound_over_busy=1e3 * roof.t_bound / busy["busy_ms"],
               flops_flopcount=flops_want,
               flops_rel=roof.flops_per_chip / flops_want - 1,
               memory=roof.memory,
               top_bytes=sorted(([k, v[0], v[2]] for k, v in c.by_op.items()),
                                key=lambda r: -r[2])[:8])
    if 1e3 * roof.t_bound > ROOF_BOUND_SLACK * ms:
        raise AssertionError(f"{name}: bound {1e3 * roof.t_bound} ms above "
                             f"the measured {ms} ms")
    if abs(res["flops_rel"]) > ROOF_FLOPS_RTOL:
        raise AssertionError(f"{name}: counted {roof.flops_per_chip} FLOPs, "
                             f"flopcount {flops_want}")
    return res


def _roof_prefill() -> dict:
    """Phase 14 (a): phase 11's yi-6b prefill, real tensors, NO_SHARD."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.flopcount import forward_flops
    from repro_torch.models import lm
    from repro_torch.serve import engine
    cfg = get_config(LM_ARCH)
    params = lm.init_params(lm.generator(0), cfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT)), device="cuda")}
    engine.prefill(params, cfg, batch, pad_to=LM_PAD)       # warm-up
    res = _real_roofline(
        f"{LM_ARCH} prefill", engine.prefill, (params, cfg, batch),
        {"pad_to": LM_PAD},
        forward_flops(cfg, LM_BATCH * LM_PROMPT, LM_PROMPT), 3)
    del params
    torch.cuda.empty_cache()
    return res


def _roof_train() -> tuple:
    """Phase 14 (a) and (b): phase 13's mamba2-130m step, real tensors,
    remat "full"; and the dry run's memory analysis of that step on a
    1 × 1 mesh of fake card tensors (remat "full" and off) against the
    card's peak, the argument bytes against the real state's."""
    import torch
    from repro_torch import tree
    from repro_torch.configs.base import get_config
    from repro_torch.flopcount import forward_flops
    from repro_torch.launch import dryrun
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    cfg = get_config(TRAIN_ARCH)
    params = lm.init_params(lm.generator(0), cfg)
    opt = adamw.init(params)
    step = make_train_step(cfg, adamw.AdamWConfig(lr=TRAIN_LR,
                                                  warmup=TRAIN_WARMUP))
    batch = _pipeline_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 1)[0]
    step(params, opt, batch)                                # warm-up
    real = _real_roofline(
        f"{TRAIN_ARCH} train step", step, (params, opt, batch), {},
        4 * forward_flops(cfg, TRAIN_BATCH * TRAIN_SEQ, TRAIN_SEQ), 5)
    state = sum(t.numel() * t.element_size()
                for t in tree.leaves((params, opt, batch)))
    shape = {"kind": "train", "seq_len": TRAIN_SEQ,
             "global_batch": TRAIN_BATCH}
    mem = {"state_bytes": state}
    old = lm.REMAT_POLICY
    try:
        for remat in ("full", "none"):
            lm.REMAT_POLICY = remat
            peak = _peak_gb(lambda: step(params, opt, batch)) * 1e9
            low = dryrun.lower_cell_cfg(cfg, shape, False, remat=remat,
                                        mesh_shape=(1, 1), device="cuda")
            m = low.roofline.memory
            pred = low.roofline.peak_mem_bytes
            mem[remat] = {"card_peak_bytes": peak,
                          "predicted_peak_bytes": pred,
                          "rel": pred / peak - 1, "memory_analysis": m,
                          "dryrun_s": low.seconds}
            if m["argument_size_in_bytes"] != state:
                raise AssertionError(f"dry-run arguments "
                                     f"{m['argument_size_in_bytes']} B, the "
                                     f"real state {state} B")
            if abs(pred / peak - 1) > ROOF_MEM_RTOL:
                raise AssertionError(f"remat {remat}: predicted peak {pred} "
                                     f"B, the card's {peak} B")
    finally:
        lm.REMAT_POLICY = old
    del params, opt
    torch.cuda.empty_cache()
    return real, mem


#: one dry-run cell with its depth slope, as a JSON line (phase 14 (c)
#: runs the cells side by side, one process each: they use only the host)
ROOF_CELL_SCRIPT = (
    "import json, sys\n"
    "from repro_torch.launch import dryrun\n"
    "rec = dryrun.run_cell(sys.argv[1], sys.argv[2], sys.argv[3] == 'multi',"
    " extrapolate=True)\n"
    "print(json.dumps(rec))\n")


def _dry_cells(cells, timeout: float = 300) -> list:
    """``run_cell`` of each (arch, shape, multi) with its depth slope,
    each in a process of its own, all at once; the records in order."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = [subprocess.Popen(
        [sys.executable, "-c", ROOF_CELL_SCRIPT, arch, shape,
         "multi" if multi else "single"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
        for arch, shape, multi in cells]
    recs = []
    try:
        for p, cell in zip(procs, cells):
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise AssertionError(f"dry run of {cell} exited "
                                     f"{p.returncode}: {err[-2000:]}")
            recs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return recs


def _roof_cells() -> dict:
    """Phase 14 (c): the dry run at full width on the fake H100 meshes,
    with the depth slope beside the full-depth count."""
    out = {}
    for (arch, shape, multi), rec in zip(ROOF_CELLS, _dry_cells(ROOF_CELLS)):
        key = f"{arch} × {shape} × {rec['mesh']}"
        if rec["status"] != "OK":
            raise AssertionError(f"{key}: {rec['status']} "
                                 f"{rec.get('error', rec.get('reason'))}")
        mem, r = rec["memory_analysis"], rec["roofline"]
        if mem["argument_size_in_bytes"] != rec["spec_argument_bytes"]:
            raise AssertionError(f"{key}: arguments "
                                 f"{mem['argument_size_in_bytes']} B, specs "
                                 f"{rec['spec_argument_bytes']} B")
        slope = rec["depth_slope"]
        rel = {f: slope[f] / r[f] - 1 if r[f] else slope[f]
               for f in ("flops_per_chip", "bytes_per_chip",
                         "coll_bytes_per_chip")}
        if abs(rel["flops_per_chip"]) > 1e-6:
            raise AssertionError(f"{key}: slope FLOPs off by {rel}")
        peak = r["peak_mem_bytes"]
        out[key] = {"t_compute_ms": 1e3 * r["t_compute_s"],
                    "t_memory_ms": 1e3 * r["t_memory_s"],
                    "t_collective_ms": 1e3 * r["t_collective_s"],
                    "bottleneck": r["bottleneck"],
                    "peak_gb_per_card": peak / 1e9,
                    "fits_80gb": peak <= CARD_BYTES,
                    "coll_counts": r["coll_counts"],
                    "argument_bytes": mem["argument_size_in_bytes"],
                    "slope_rel": rel, "run_s": rec["compile_s"],
                    "slope_s": rec["extrap_compile_s"]}
    return out


def phase_roofline(gpu: str) -> dict:
    """Phase 14: the roofline of the real program and the dry run."""
    t0 = time.perf_counter()
    prefill = _roof_prefill()
    log(f"phase 14 (a) roofline of {LM_ARCH} prefill ({LM_BATCH} x "
        f"{LM_PROMPT}, full width and depth): {json.dumps(prefill)}")
    train, mem = _roof_train()
    log(f"phase 14 (a) roofline of a {TRAIN_ARCH} train step "
        f"({TRAIN_BATCH} x {TRAIN_SEQ}, remat full): {json.dumps(train)}")
    log(f"phase 14 (b) dry-run memory vs the card: {json.dumps(mem)}")
    cells = _roof_cells()
    log(f"phase 14 (c) dry run at full width on fake H100 meshes: "
        f"{json.dumps(cells)}")
    log(f"phase 14 took {time.perf_counter() - t0:.1f} s ({gpu})")
    return {"prefill": prefill, "train": train, "memory": mem,
            "cells": cells}


# ---------------------------------------------------------------- group
#: phase 16: the trainer's own settings (``launch.train``'s defaults, lr
#: 1e-3 with a warm-up of 20) on phase 13's model and batch; GROUP_STEPS
#: steps on the mesh and without one, then the checkpoint's two
GROUP_LR, GROUP_WARMUP, GROUP_STEPS = 1e-3, 20, 3
#: (e): the sharded steps on distinct cards against one card's, relative
#: (float32, reduced architectures: the tests' ``LOSS_RTOL_3``)
GROUP_LOSS_RTOL = 1e-4
GROUP_ARCHS = ("yi-6b", "mamba2-130m")


def _steps(step, params, opt, batches) -> tuple:
    """``step`` over ``batches``: (params, opt, losses, grad norms, each
    step's CUDA-event ms)."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(2 * len(batches))]
    out = []
    for i, b in enumerate(batches):
        ev[2 * i].record()
        params, opt, m = step(params, opt, b)
        ev[2 * i + 1].record()
        out.append(m)
    torch.cuda.synchronize()
    ms = [ev[2 * i].elapsed_time(ev[2 * i + 1]) for i in range(len(batches))]
    return (params, opt, [float(m["loss"]) for m in out],
            [float(m["grad_norm"]) for m in out], ms)


def _whole(t) -> list:
    from torch.distributed.tensor import DTensor
    from repro_torch import tree
    return [x.full_tensor() if isinstance(x, DTensor) else x
            for x in tree.leaves(t)]


def _differing(a, b, names=None) -> list:
    """(name or index, largest difference) of each leaf pair that is not
    equal."""
    import torch
    return [(n, float((x.double() - y.double()).abs().max()))
            for n, x, y in zip(names or range(len(a)), a, b)
            if not torch.equal(x, y)]


def _update_through_dtensor(grads, state, params, cfg):
    """``adamw.update`` as written before this slice (each op on the
    DTensors themselves, so each dispatches through DTensor), for the
    timing beside the port's update on each card's shards."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import tree
    from repro_torch.optim import adamw
    with implicit_replication():
        total = None
        for x in tree.leaves(grads):
            s_ = torch.sum(torch.square(x.float()))
            total = s_ if total is None else total + s_
        gnorm = torch.sqrt(total).full_tensor()
        dev = gnorm.device
        one = adamw._f32(1.0, dev)
        scale = torch.minimum(one, adamw._f32(cfg.clip_norm, dev) /
                              (gnorm + 1e-9))
        count = state.count + 1
        lr = adamw._schedule(cfg, count.full_tensor())
        cf = count.full_tensor().float()
        b1c = one - torch.pow(adamw._f32(cfg.b1, dev), cf)
        b2c = one - torch.pow(adamw._f32(cfg.b2, dev), cf)
        gs = tree.map(lambda g: g.float() * scale, grads)
        m = tree.map(lambda m_, g: cfg.b1 * m_ + (1 - cfg.b1) * g,
                     state.m, gs)
        v = tree.map(lambda v_, g: cfg.b2 * v_ + (1 - cfg.b2) * g * g,
                     state.v, gs)
        master = tree.map(
            lambda p, m_, v_: p - lr * ((m_ / b1c) / (torch.sqrt(v_ / b2c)
                                                      + cfg.eps)
                                        + cfg.weight_decay * p),
            state.master, m, v)
        new = tree.map(lambda mp, old: mp.to(old.dtype), master, params)
    return new, adamw.OptState(master, m, v, count), gnorm


def _update_times(cfg, shard, placed, batch, ocfg) -> dict:
    """The AdamW update over the mesh's DTensors, the port's (each card's
    shards, one reduction for the norm) and the DTensor-dispatched one,
    CUDA-event ms on the same gradients; their results bit-equal."""
    import torch
    from repro_torch.optim import adamw
    from repro_torch.train.step import place_batch, value_and_grad
    params, opt = placed
    _, grads = value_and_grad(params, cfg, place_batch(batch, shard), shard)
    with torch.no_grad():
        mine = adamw.update(grads, opt, params, ocfg)
        theirs = _update_through_dtensor(grads, opt, params, ocfg)
        differ = _differing(_whole(mine[:2]), _whole(theirs[:2]))
        out = {"port_ms": cuda_ms(
            lambda: adamw.update(grads, opt, params, ocfg), 5),
            "dtensor_ms": cuda_ms(
            lambda: _update_through_dtensor(grads, opt, params, ocfg), 5),
            "results_bit_equal": not differ and
            float(mine[2]) == float(theirs[2])}
    del grads, mine, theirs
    return out


def _group_restart(cfg, step, state, named, batches, k: int) -> dict:
    """(c): save the mesh's (params, opt) after step ``k``, run steps k
    and k + 1; ``restore(shardings)`` onto the mesh into a fresh tree and
    replay them: the losses and every leaf bit-equal."""
    import torch
    from repro_torch import tree
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as ckpt
    path = ROOT / "build" / "group_ckpt"
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    ckpt.save(str(path), k, state, extra={"arch": TRAIN_ARCH})
    save_s = time.perf_counter() - t0
    pa, oa, la, _, _ = _steps(step, *state, batches[k:k + 2])
    fresh = lm.init_params(lm.generator(1), cfg)
    t0 = time.perf_counter()
    st, restored = ckpt.restore(str(path), (fresh, adamw.init(fresh)),
                                shardings=named)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del fresh
    placed = all(tuple(x.placements) == tuple(n.placements)
                 for x, n in zip(tree.leaves(restored),
                                 ckpt.sharding_leaves(restored, named)))
    pb, ob, lb, _, _ = _steps(step, *restored, batches[k:k + 2])
    shutil.rmtree(path, ignore_errors=True)
    differ = _differing(_whole((pa, oa)), _whole((pb, ob)))
    if st != k or la != lb or differ or not placed:
        raise AssertionError(f"phase 16 (c): restore(shardings) not "
                             f"bit-exact: step {st} (want {k}), losses {la} "
                             f"then {lb}, leaves {differ[:5]}, placements "
                             f"kept {placed}")
    return {"at_step": k, "losses": la, "save_s": save_s,
            "restore_s": restore_s, "state": (pa, oa)}


def _group_trainer(want: list) -> dict:
    """(d): ``python -m repro_torch.launch.train`` on the card, 5 steps of
    phase 16's model and batch, one checkpoint (at step 3) and a failure
    at step 4: exit 0, the mesh (a world of one: plain tensors) and the
    restart printed, each step's loss equal to (b)'s and (c)'s steps
    (``want``, steps 0-4); the trainer's own step ms (host clock)."""
    path = ROOT / "build" / "group_trainer"
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    out = path / "run.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           TRAIN_ARCH, "--steps", "5", "--batch", str(TRAIN_BATCH), "--seq",
           str(TRAIN_SEQ), "--ckpt", str(path / "ck"), "--ckpt-every", "3",
           "--fail-at", "4", "--log-every", "1", "--out", str(out)]
    environ = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "LOCAL_RANK")}
    environ["PYTHONPATH"] = str(SRC)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          env=environ, cwd=str(ROOT))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 16 (d): the trainer exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    text = proc.stdout
    run = json.loads(out.read_text())
    shutil.rmtree(path, ignore_errors=True)
    # steps 0-4 in the order run (step 3 again after the restart)
    expect = [want[i] for i in (0, 1, 2, 3, 3, 4)]
    bad = [i for i, (g, w) in enumerate(zip(run["losses"], expect))
           if g != w]
    if "mesh={'data': 1, 'model': 1}" not in text or \
            "(one rank: plain tensors)" not in text or \
            "[fault] simulated host failure at step 4" not in text or \
            run["step_ids"] != [0, 1, 2, 3, 3, 4] or bad:
        raise AssertionError(f"phase 16 (d): trainer {run}, steps {bad} "
                             f"differ from {want}; stdout {text[-2000:]}")
    return {"wall_s": wall, "step_ids": run["step_ids"],
            "losses": run["losses"], "step_ms": run["step_ms"],
            "warm_step_ms": sum(run["step_ms"][1:]) /
            (len(run["step_ms"]) - 1), "mesh": run["mesh"],
            "stdout_head": text.splitlines()[0]}


def _multi_card_rank(rank: int, n: int, store: str, device: str,
                     out: str) -> None:
    """(e), one rank: reduced ``GROUP_ARCHS`` in float32, 3 steps on the
    (1, n) mesh of the group's cards; rank 0 also without a mesh, and
    writes both."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, _batch_at
    from repro_torch import tree
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as T
    from repro_torch.models import lm
    from repro_torch.models import sharding as shd
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = {"timeout": datetime.timedelta(seconds=120)}
    if device == "cuda":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=dist.FileStore(store, n), rank=rank,
                            world_size=n, **kw)
    try:
        dev = torch.device("cuda", rank) if device == "cuda" else \
            torch.device("cpu")
        mesh = M.make_host_mesh(device)
        shard = shd.ShardCfg(mesh=mesh, dp=M.dp_axes(mesh))
        res = {"distinct": M.distinct_cards(mesh),
               "mesh": list(mesh.shape)}
        for arch in GROUP_ARCHS:
            cfg = get_config(arch).reduced()
            params = tree.map(lambda t: t.float(), lm.init_params(
                lm.generator(0, dev), cfg))
            d = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
            bs = [{k: torch.from_numpy(v).to(dev)
                   for k, v in _batch_at(d, i).items()} for i in range(3)]
            ocfg = adamw.AdamWConfig(lr=1e-3, warmup=2)
            got = []
            p, o = T.place((params, adamw.init(params)),
                           T.shardings(params, shard))
            step = make_train_step(cfg, ocfg, shard)
            for b in bs:
                p, o, m = step(p, o, b)
                got.append([float(m["loss"]), float(m["grad_norm"])])
            want = []
            if rank == 0:
                p, o = params, adamw.init(params)
                step = make_train_step(cfg, ocfg)
                for b in bs:
                    p, o, m = step(p, o, b)
                    want.append([float(m["loss"]), float(m["grad_norm"])])
            res[arch] = {"mesh": got, "one_card": want}
        if rank == 0:
            Path(out).write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _multi_card(n: int, device: str = "cuda") -> dict:
    """(e): ``_multi_card_rank`` on ``n`` spawned ranks, each on its own
    card (``device`` "cpu": gloo ranks, to try the code without cards);
    each step's loss and grad norm within ``GROUP_LOSS_RTOL``."""
    import tempfile
    import torch.multiprocessing as mp
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        out = Path(tmp) / "multi.json"
        mp.start_processes(_multi_card_rank,
                           args=(n, str(Path(tmp) / "store"), device,
                                 str(out)),
                           nprocs=n, join=True, start_method="spawn")
        res = json.loads(out.read_text())
    for arch in GROUP_ARCHS:
        for got, want in zip(res[arch]["mesh"], res[arch]["one_card"]):
            for g, w in zip(got, want):
                if abs(g - w) > GROUP_LOSS_RTOL * abs(w):
                    raise AssertionError(f"phase 16 (e) {arch}: {res[arch]}")
    return res


def phase_train_group(gpu: str, adamw_times: bool = False) -> dict:
    """Phase 16: training on a real process group (``adamw_times``: also
    the AdamW update's two designs timed)."""
    import torch
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.configs.base import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as T
    from repro_torch.models import lm
    from repro_torch.models import sharding as shd
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    t_start = time.perf_counter()
    torch.cuda.empty_cache()
    mesh = M.make_host_mesh("cuda")
    try:
        world, distinct = dist.get_world_size(), M.distinct_cards(mesh)
        log(f"phase 16 (a) process group: world size {world} "
            f"({dist.get_backend()}), mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
            + ("one rank on one card" if world == 1 else
               f"ranks on distinct cards: {distinct}")
            + f" (torch.cuda.device_count() {torch.cuda.device_count()})")
        cfg = get_config(TRAIN_ARCH)
        shard = shd.ShardCfg(mesh=mesh, dp=M.dp_axes(mesh))
        params = lm.init_params(lm.generator(0), cfg)
        opt = adamw.init(params)
        named = T.shardings(params, shard)
        placed = T.place((params, opt), named)
        batches = _pipeline_batches(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                    GROUP_STEPS + 2)
        ocfg = adamw.AdamWConfig(lr=GROUP_LR, warmup=GROUP_WARMUP)
        plain = make_train_step(cfg, ocfg)
        sharded = make_train_step(cfg, ocfg, shard)
        n = GROUP_STEPS
        pa, oa, la, ga, msa = _steps(plain, params, opt, batches[:n])
        pb, ob, lb, gb, msb = _steps(sharded, *placed, batches[:n])
        del params, opt
        names = [p for p, _ in tree.leaves_with_paths((pa, oa))]
        differ = _differing(_whole((pb, ob)), tree.leaves((pa, oa)), names)
        if la != lb or ga != gb or differ:
            raise AssertionError(f"phase 16 (b): the (1, 1) mesh's steps "
                                 f"differ from NO_SHARD's: losses {lb} vs "
                                 f"{la}, grad norms {gb} vs {ga}, leaves "
                                 f"{differ[:8]} ({len(differ)} differ)")
        busy = {"no_shard": _device_busy(
            lambda: plain(pa, oa, batches[n])),
            "mesh": _device_busy(lambda: sharded(pb, ob, batches[n]))}
        warm = {k: sum(v[1:]) / (n - 1) for k, v in
                (("no_shard", msa), ("mesh", msb))}
        steps = {k: {"step_ms": ms, "warm_step_ms": warm[k],
                     "kernels_per_step": busy[k]["kernels"],
                     "device_busy_ms": busy[k]["busy_ms"],
                     "idle_share": 1 - busy[k]["busy_ms"] / warm[k]}
                 for k, ms in (("no_shard", msa), ("mesh", msb))}
        res = {"arch": TRAIN_ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
               "remat": lm.REMAT_POLICY, "losses": lb, "grad_norms": gb,
               "bit_equal": True, "steps": steps,
               "mesh_over_no_shard": warm["mesh"] / warm["no_shard"],
               "gpu": gpu}
        log(f"phase 16 (b) {TRAIN_ARCH} at full width and depth "
            f"({TRAIN_BATCH} x {TRAIN_SEQ}, remat {lm.REMAT_POLICY}), "
            f"{n} steps on the (1, 1) mesh == NO_SHARD bit for bit: "
            f"{json.dumps(res)}")
        if adamw_times:
            res["adamw"] = _update_times(cfg, shard, (pb, ob), batches[0],
                                         ocfg)
            log(f"phase 16 (b) adamw.update over the mesh's DTensors, on "
                f"each card's shards (the port) vs through DTensor "
                f"dispatch: {json.dumps(res['adamw'])} ({gpu})")
        del pa, oa
        restart = _group_restart(cfg, sharded, (pb, ob), named, batches, n)
        del pb, ob, restart["state"]
        res["restart"] = restart
        log(f"phase 16 (c) save under the mesh, restore(shardings) onto "
            f"it, 2 steps replayed bit for bit: {json.dumps(restart)}")
    finally:
        M.release()
    torch.cuda.empty_cache()
    res["trainer"] = _group_trainer(lb + restart["losses"])
    log(f"phase 16 (d) python -m repro_torch.launch.train on the card: "
        f"{json.dumps(res['trainer'])}")
    cards = torch.cuda.device_count()
    if cards >= 2:
        res["multi_card"] = _multi_card(min(4, cards))
        log(f"phase 16 (e) {min(4, cards)} NCCL ranks on distinct cards, "
            f"(1, n) mesh == one card within {GROUP_LOSS_RTOL}: "
            f"{json.dumps(res['multi_card'])}")
    else:
        log("phase 16 (e) one card on this machine: no run on distinct "
            "cards (the multi-rank checks run over gloo in "
            "tests/test_torch_dist_train.py)")
    res["seconds"] = time.perf_counter() - t_start
    log(f"phase 16 took {res['seconds']:.1f} s ({gpu})")
    return res


# ---------------------------------------------------------------- serving
#: phase 17 (b): phase 11's model, prompts and padding, SERVE_STEPS decode
#: steps on the (1, 1) mesh and without one, after SERVE_WARM
SERVE_STEPS, SERVE_WARM = 8, 2
#: (c), (d): the reduced architectures' prompts, their length, the caches'
#: length and the decode steps (as ``tests/test_torch_dist_serve.py``)
SERVE_B, SERVE_PROMPT, SERVE_PAD, SERVE_RED_STEPS = 4, 16, 32, 3
#: (d): on distinct cards in float32, every logit within this share of
#: the largest of one card's (the CPU test's ``TOL``)
SERVE_GROUP_TOL = 1e-5
SERVE_GROUP_ARCHS = ("deepseek-v2-lite-16b", "granite-34b", "yi-6b")


def _serve_on(params, cfg, shard, batch, pad_to, steps, tokens=None,
              timed=False, device="cuda") -> dict:
    """``serve.engine`` on ``shard``: ``prefill`` of ``batch`` (padded to
    ``pad_to``) and ``steps`` decode steps, fed ``tokens`` (B, steps) or,
    without them, greedy.  The prefill and decode logits and the cache
    leaves, gathered; the tokens fed; the caches themselves and the last
    token; with ``timed`` the prefill's and each step's CUDA-event ms."""
    import torch
    from repro_torch.serve import engine
    from repro_torch.train.step import place_batch
    S0 = batch["tokens"].shape[1]
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(2 * steps + 2)] if timed else None
    placed = place_batch(batch, shard)
    fed = None if tokens is None else [
        place_batch({"tokens": tokens[:, t:t + 1]}, shard)["tokens"]
        for t in range(steps)]
    if timed:
        ev[0].record()
    logits, caches = engine.prefill(params, cfg, placed, shard,
                                    pad_to=pad_to, device=device)
    if timed:
        ev[1].record()
    step = engine.make_decode_step(cfg, shard, device)
    tok = logits[:, -1:].argmax(-1)
    dec, toks = [], []
    for t in range(steps):
        if fed is not None:
            tok = fed[t]
        toks.append(tok)
        if timed:
            ev[2 * t + 2].record()
        lg, caches = step(params, tok, caches, S0 + t)
        if timed:
            ev[2 * t + 3].record()
        dec.append(lg)
        tok = lg[:, -1:].argmax(-1)
    if timed:
        torch.cuda.synchronize()
    out = {"prefill": _whole([logits])[0],
           "decode": torch.cat(_whole(dec), 1),
           "leaves": _whole(caches), "caches": caches,
           "tokens": torch.cat(_whole(toks), 1), "next": tok}
    if timed:
        out["prefill_ms"] = ev[0].elapsed_time(ev[1])
        out["step_ms"] = [ev[2 * t + 2].elapsed_time(ev[2 * t + 3])
                          for t in range(steps)]
    return out


def _serve_differences(a: dict, b: dict, names) -> list:
    """(what, largest difference) of each of the two runs' outputs that
    is not bit-equal: the prefill logits, each decode step's, each cache
    leaf."""
    out = _differing([a["prefill"]], [b["prefill"]], ["prefill"])
    out += _differing(list(a["decode"].unbind(1)),
                      list(b["decode"].unbind(1)),
                      [f"decode step {t}" for t in range(a["decode"].shape[1])])
    return out + _differing(a["leaves"], b["leaves"], names)


#: the caches a decode step writes at the token's position, by name: their
#: sequence dim counted from the end
SEQ_DIM = {"k": -3, "v": -3, "c": -2, "kr": -2}


def _cache_placements(caches) -> dict:
    from repro_torch import tree
    return {path: str(tuple(x.placements))
            for path, x in tree.leaves_with_paths(caches)
            if path.rsplit("/", 1)[-1] in SEQ_DIM}


def _seq_placed(caches, cards: int = 1) -> list:
    """The paths of the caches whose sequence dim is split over a mesh
    dim of at least ``cards`` cards (the writes ``sharding.write_at``
    makes on a local shard)."""
    from torch.distributed.tensor import Shard
    from repro_torch import tree
    out = []
    for path, x in tree.leaves_with_paths(caches):
        seq = SEQ_DIM.get(path.rsplit("/", 1)[-1])
        if seq is not None and any(
                isinstance(p, Shard) and p.dim == x.ndim + seq
                and x.device_mesh.shape[i] >= cards
                for i, p in enumerate(x.placements)):
            out.append(path)
    return out


def _serve_full_width(gpu: str, shard) -> dict:
    """(b): phase 11's yi-6b at full width and depth, the same
    parameters and prompts, on the mesh and ``NO_SHARD``: bit-equal, and
    each one's times."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train as T
    from repro_torch.models import lm
    from repro_torch.models.sharding import NO_SHARD
    cfg = get_config(LM_ARCH)
    params = lm.init_params(lm.generator(0), cfg)
    placed = T.place(params, T.param_shardings(params, shard))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT)), device="cuda")}
    runs = {"no_shard": (params, NO_SHARD), "mesh": (placed, shard)}
    for p, s in runs.values():                          # warm-up
        _serve_on(p, cfg, s, batch, LM_PAD, SERVE_WARM)
    got = {"no_shard": _serve_on(params, cfg, NO_SHARD, batch, LM_PAD,
                                 SERVE_STEPS, timed=True)}
    got["mesh"] = _serve_on(placed, cfg, shard, batch, LM_PAD, SERVE_STEPS,
                            tokens=got["no_shard"]["tokens"], timed=True)
    names = [p for p, _ in tree.leaves_with_paths(got["mesh"]["caches"])]
    differ = _serve_differences(got["mesh"], got["no_shard"], names)
    if differ:
        raise AssertionError(f"phase 17 (b): the (1, 1) mesh's serving "
                             f"differs from NO_SHARD's: {differ[:8]} "
                             f"({len(differ)} differ)")
    out = {}
    for k, (p, s) in runs.items():
        r = got[k]
        steps = r["step_ms"][1:]
        busy = _device_busy(lambda: _decode_once(p, cfg, s, r))
        mean = sum(steps) / len(steps)
        out[k] = {"prefill_ms": r["prefill_ms"], "step_ms": r["step_ms"],
                  "decode_ms_per_step": mean,
                  "decode_ms_min_max": [min(steps), max(steps)],
                  "kernels_per_step": busy["kernels"],
                  "device_busy_ms": busy["busy_ms"],
                  "idle_share": 1 - busy["busy_ms"] / mean}
    res = {"arch": LM_ARCH, "batch": LM_BATCH, "prompt": LM_PROMPT,
           "pad_to": LM_PAD, "decode_steps": SERVE_STEPS, "bit_equal": True,
           "cache_placements": sorted(set(_cache_placements(
               got["mesh"]["caches"]).values())),
           **out, "mesh_over_no_shard": {
               "prefill": out["mesh"]["prefill_ms"] /
               out["no_shard"]["prefill_ms"],
               "decode": out["mesh"]["decode_ms_per_step"] /
               out["no_shard"]["decode_ms_per_step"]},
           "gpu": gpu}
    del params, placed, got
    torch.cuda.empty_cache()
    return res


def _decode_once(params, cfg, shard, run):
    """One more decode step of ``run`` (its next token, at the next
    position), for the profiler."""
    from repro_torch.serve import engine
    pos = LM_PROMPT + run["tokens"].shape[1]
    return engine.make_decode_step(cfg, shard)(params, run["next"],
                                               run["caches"], pos)


def _reduced_batch(cfg, seed: int, device="cuda") -> tuple:
    """Seeded prompts (SERVE_B, SERVE_PROMPT) with the frontend's inputs,
    and the teacher-forced tokens (SERVE_B, SERVE_RED_STEPS)."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(
        0, cfg.vocab, (SERVE_B, SERVE_PROMPT + SERVE_RED_STEPS)),
        device=device)
    gen, batch = lm.generator(seed + 1, device), {
        "tokens": toks[:, :SERVE_PROMPT]}
    if cfg.enc_dec:
        batch["frames"] = torch.randn((SERVE_B, cfg.enc_len, cfg.d_model),
                                      generator=gen, device=device)
    if cfg.frontend == "patches":
        batch["patches"] = torch.randn((SERVE_B, cfg.n_patches, cfg.d_model),
                                       generator=gen, device=device)
    return batch, toks[:, SERVE_PROMPT:]


def _serve_reduced(shard) -> dict:
    """(c): the ten reduced architectures (bfloat16) on the mesh,
    bit-equal to ``NO_SHARD``: prefill and SERVE_RED_STEPS decode steps,
    with the caches' placements on the mesh."""
    from repro_torch import tree
    from repro_torch.configs.base import ARCH_IDS, get_config
    from repro_torch.launch import train as T
    from repro_torch.models import lm
    from repro_torch.models.sharding import NO_SHARD
    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced()
        params = lm.init_params(lm.generator(1), cfg)
        placed = T.place(params, T.param_shardings(params, shard))
        batch, toks = _reduced_batch(cfg, 1)
        want = _serve_on(params, cfg, NO_SHARD, batch, SERVE_PAD,
                         SERVE_RED_STEPS, tokens=toks)
        got = _serve_on(placed, cfg, shard, batch, SERVE_PAD,
                        SERVE_RED_STEPS, tokens=toks)
        names = [p for p, _ in tree.leaves_with_paths(got["caches"])]
        differ = _serve_differences(got, want, names)
        if differ:
            raise AssertionError(f"phase 17 (c) {arch}: the (1, 1) mesh "
                                 f"differs from NO_SHARD: {differ[:8]}")
        if cfg.mla and not _seq_placed(got["caches"]):
            raise AssertionError(f"phase 17 (c) {arch}: no latent cache "
                                 f"on the sequence")
        out[arch] = {"bit_equal": True,
                     "cache_placements": sorted(set(_cache_placements(
                         got["caches"]).values())),
                     "seq_split": _seq_placed(got["caches"])}
    return out


def _serve_card_rank(rank: int, n: int, store: str, device: str,
                     out: str) -> None:
    """(d), one rank: reduced ``SERVE_GROUP_ARCHS`` in float32 served on
    the (1, n) mesh of the group's cards, the logits gathered; rank 0
    also without a mesh, and writes the largest differences."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.configs.base import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as T
    from repro_torch.models import lm
    from repro_torch.models import sharding as shd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = {"timeout": datetime.timedelta(seconds=120)}
    if device == "cuda":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=dist.FileStore(store, n), rank=rank,
                            world_size=n, **kw)
    try:
        dev = torch.device("cuda", rank) if device == "cuda" else \
            torch.device("cpu")
        mesh = M.make_host_mesh(device)
        shard = shd.ShardCfg(mesh=mesh, dp=M.dp_axes(mesh))
        res = {"distinct": M.distinct_cards(mesh), "mesh": list(mesh.shape)}
        for arch in SERVE_GROUP_ARCHS:
            cfg = get_config(arch).reduced()
            params = tree.map(torch.Tensor.float, lm.init_params(
                lm.generator(0, dev), cfg))
            batch, toks = _reduced_batch(cfg, 0, dev)
            placed = T.place(params, T.param_shardings(params, shard))
            got = _serve_on(placed, cfg, shard, batch, SERVE_PAD,
                            SERVE_RED_STEPS, tokens=toks, device=device)
            if rank == 0:
                want = _serve_on(params, cfg, shd.NO_SHARD, batch,
                                 SERVE_PAD, SERVE_RED_STEPS, tokens=toks,
                                 device=device)
                g = torch.cat([got["prefill"], got["decode"]], 1)
                w = torch.cat([want["prefill"], want["decode"]], 1)
                res[arch] = {"max_abs_err": float((g - w).abs().max()),
                             "max_logit": float(w.abs().max()),
                             "seq_split": _seq_placed(got["caches"], 2)}
        if rank == 0:
            Path(out).write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _serve_cards(n: int, device: str = "cuda") -> dict:
    """(d): ``_serve_card_rank`` on ``n`` spawned ranks, each on its own
    card (``device`` "cpu": gloo ranks, to try the code without cards);
    every logit within ``SERVE_GROUP_TOL`` of the largest."""
    import tempfile
    import torch.multiprocessing as mp
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        out = Path(tmp) / "serve.json"
        mp.start_processes(_serve_card_rank,
                           args=(n, str(Path(tmp) / "store"), device,
                                 str(out)),
                           nprocs=n, join=True, start_method="spawn")
        res = json.loads(out.read_text())
    for arch in SERVE_GROUP_ARCHS:
        r = res[arch]
        if not r["max_abs_err"] <= SERVE_GROUP_TOL * r["max_logit"]:
            raise AssertionError(f"phase 17 (d) {arch}: {r}")
    return res


def phase_serve_group(gpu: str) -> dict:
    """Phase 17: serving on a real process group."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    from repro_torch.models import sharding as shd
    t_start = time.perf_counter()
    torch.cuda.empty_cache()
    mesh = M.make_host_mesh("cuda")
    try:
        world, distinct = dist.get_world_size(), M.distinct_cards(mesh)
        log(f"phase 17 (a) process group: world size {world} "
            f"({dist.get_backend()}), mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
            + ("one rank on one card" if world == 1 else
               f"ranks on distinct cards: {distinct}")
            + f" (torch.cuda.device_count() {torch.cuda.device_count()})")
        shard = shd.ShardCfg(mesh=mesh, dp=M.dp_axes(mesh))
        res = {"full_width": _serve_full_width(gpu, shard)}
        log(f"phase 17 (b) {LM_ARCH} at full width and depth "
            f"({LM_BATCH} x {LM_PROMPT}, pad {LM_PAD}, {SERVE_STEPS} decode "
            f"steps) on the (1, 1) mesh == NO_SHARD bit for bit: "
            f"{json.dumps(res['full_width'])}")
        res["reduced"] = _serve_reduced(shard)
        log(f"phase 17 (c) the reduced architectures on the (1, 1) mesh == "
            f"NO_SHARD bit for bit (prefill, {SERVE_RED_STEPS} decode steps, "
            f"every cache leaf): {json.dumps(res['reduced'])}")
    finally:
        M.release()
    cards = torch.cuda.device_count()
    if cards >= 2:
        res["cards"] = _serve_cards(min(4, cards))
        log(f"phase 17 (d) {min(4, cards)} NCCL ranks on distinct cards, "
            f"(1, n) mesh == one card within {SERVE_GROUP_TOL} of the "
            f"largest logit: {json.dumps(res['cards'])}")
    else:
        log("phase 17 (d) one card on this machine: no run on distinct "
            "cards (the multi-rank checks run over gloo in "
            "tests/test_torch_dist_serve.py)")
    res["seconds"] = time.perf_counter() - t_start
    log(f"phase 17 took {res['seconds']:.1f} s ({gpu})")
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
    # --dist-rows SRC [--groups D]: rows 7-10 alone, in the package under
    # SRC (and on a group of D)
    rows_only = sys.argv[1:2] == ["--dist-rows"]
    src_root = Path(sys.argv[2]).resolve() if rows_only else SRC
    groups = (int(sys.argv[sys.argv.index("--groups") + 1])
              if rows_only and "--groups" in sys.argv else None)
    if not (src_root / "repro_torch").is_dir():
        print(f"the port's package is missing under {src_root}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src_root))
    if sys.argv[1:] in (["--train-group"], ["--serve-group"]):
        # phase 16 or phase 17 alone
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if sys.argv[1] == "--train-group":
            phase_train_group(gpu_line(), adamw_times=True)
        else:
            phase_serve_group(gpu_line())
        print(gpu_line(), flush=True)
        return 0
    if rows_only:
        rows = dist_rows_bench(groups)
        print(json.dumps({"dist_rows": rows, "src": str(src_root)}))
        print(gpu_line(), flush=True)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_build()
    noise = phase_prng()
    kern = phase_kernels()
    ell = phase_ell()
    phase_small_parity()
    main_run = phase_main()
    hoisted = phase_hoisted(main_run)
    service = phase_service()
    lanes = phase_lanes(service)
    phase_chaos()
    dist = phase_dist(main_run)
    gpu = gpu_line()
    phase_lm(gpu)
    phase_examples()
    phase_train(gpu)
    phase_roofline(gpu)
    grouped = phase_groups(dist)
    phase_train_group(gpu)
    phase_serve_group(gpu)
    src = "src/repro_torch/kernels/csrc"
    big = ell["cases"][-1]                      # grid3d(100, 100, 100)

    def worst(prefix):
        return max(c["max_abs_err"] for k, c in kern.items()
                   if k.startswith(prefix))

    def row(name, source, replaces, launches, case, err, library_ms):
        return {"name": name, "route": "cuda", "source": f"{src}/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"], "library_ms": library_ms}
    # the noise is drawn inside fm_fused.cu: no launch of its own and no
    # time or bound apart from rows fm_fused_multi and fm_move_loop, whose
    # times and bounds include the draws; its plain version is the tensor
    # draw, its parity that of those two rows
    noise.update(ms=None, bound_ms=None, bound_by=None)
    fm_err = max(kern[k][m]["max_abs_err"] if m else kern[k]["max_abs_err"]
                 for k in ("fm_band", "fm_whole") for m in (None, "move_loop"))
    rows = [
        row("heavy_edge_matching_multi", "matching.cu",
            "src/repro/core/matching.py:124",
            main_run["launches"]["heavy_edge_matching_multi"],
            kern["match_root"], worst("match_"), None),
        row("bfs_multi", "bfs_multi.cu", "src/repro/kernels/band_batch.py:49",
            main_run["launches"]["bfs_multi"], kern["bfs_root"],
            worst("bfs_"), None),
        row("fm_fused_multi", "fm_fused.cu",
            "src/repro/kernels/fm_fused.py:209",
            main_run["launches"]["fm_fused_multi"], kern["fm_band"],
            max(kern["fm_band"]["max_abs_err"],
                kern["fm_whole"]["max_abs_err"]), None),
        row("sep_gain_multi", "sep_gain.cu",
            "src/repro/kernels/band_batch.py:88",
            hoisted["launches"]["sep_gain_multi"], kern["gain_band"],
            max(kern["gain_band"]["max_abs_err"],
                kern["gain_whole"]["max_abs_err"]),
            kern["gain_band"]["library_ms"]),
        row("fm_move_loop", "fm_fused.cu", "src/repro/kernels/fm_fused.py:48",
            hoisted["launches"]["fm_move_loop"], kern["fm_band"]["move_loop"],
            max(kern["fm_band"]["move_loop"]["max_abs_err"],
                kern["fm_whole"]["move_loop"]["max_abs_err"]), None),
        dict(row("fm_noise", "fm_fused.cu",
                 "src/repro/kernels/fm_fused.py:139", 0, noise, fm_err,
                 None),
             inside="fm_fused_multi, fm_move_loop",
             noise_tensors=main_run["noise_tensors"] +
             hoisted["noise_tensors"]),
        row("ell_spmv", "ell_spmv.cu", "src/repro/kernels/ell_spmv.py:36",
            ell["launches"]["ell_spmv"], big["spmv"],
            max(c["spmv"]["max_abs_err"] for c in ell["cases"]),
            big["spmv"]["library_ms"]),
        row("diffusion_step", "diffusion.cu",
            "src/repro/kernels/diffusion.py:44",
            ell["launches"]["diffusion_step"], big["diffusion"],
            max(c["diffusion"]["max_abs_err"] for c in ell["cases"]), None),
    ]
    # rows 7-10 (phase 10): launches on the distributed main path (row 7
    # is off it where the cluster design serves every BFS call, and is
    # held to its plain version in _dist_kernel_case), times at its root
    # bucket, and at grid3d(100³) and the many-lane buckets, back to back
    # and queued behind a device sleep (beside the launch floor); rows 9-10
    # with their designs (both timed at the root bucket)
    dlaunch, dcases = dist["main"]["launches"], dist["cases"]
    for name, case, replaces in (
            ("ell_relax_step", "relax", "src/repro/kernels/ops.py:93"),
            ("halo_exchange_stacked", "halo",
             "src/repro/core/dgraph.py:857"),
            ("distributed_bfs_stacked", "dbfs",
             "src/repro/core/dgraph.py:953"),
            ("distributed_matching_stacked", "dmatch",
             "src/repro/core/dgraph.py:1161")):
        root = dcases["root_30"][case]
        r = row(name, "dgraph.cu", replaces, dlaunch[name], root, 0,
                root["library_ms"])
        r["call_ms"], r["queued_ms"] = root["call_ms"], root["queued_ms"]
        r["launch_floor"] = dist["launch_floor"]
        r["shape"] = dcases["root_30"]["shape"]
        r["on_dist_path"] = dlaunch[name] > 0
        wide = dcases["many_lanes"]
        many = wide["dmatch_lanes"] if case == "dmatch" else wide[case]
        keys = ("ms", "queued_ms", "call_ms", "plain_ms", "bound_ms")
        if case in ("dbfs", "dmatch"):
            r["design"], r["designs"] = root["design"], root["designs"]
            r["place"] = root["place"]
            keys += ("design", "place")
        r["at"] = {
            "grid3d_100": {k: dcases["grid3d_100"][case][k] for k in keys},
            "many_lanes": dict(
                {k: many[k] for k in keys},
                shape=many.get("shape", wide["shape"]))}
        # phase 15: the route on a group (the grid design, each member's
        # own launches): launches on the ordering under both drivers, and
        # each bucket's call (the BFS's for the relaxation)
        on_group = "dbfs" if case == "relax" else case
        r["groups"] = {
            str(size): {
                "distinct": order["distinct"],
                "launches": order["frontier"]["launches"][name],
                "launches_dfs": order["dfs"]["launches"][name],
                **{bucket: by_size[size][on_group]
                   for bucket, by_size in grouped["buckets"].items()}}
            for size, order in grouped["orders"].items()}
        rows.append(r)
    # the multi-lane cases of rows 0-2 (phase 8): shapes, times, and the
    # service path's launches (phase 7)
    for r, kind, count in ((rows[0], "match", "heavy_edge_matching_multi"),
                           (rows[1], "bfs", "bfs_multi"),
                           (rows[2], "fm", "fm_fused_multi")):
        r["service_launches"] = service["launches"][count]
        r["multi_lane"] = {
            name: {k: lanes[name][k] for k in ("shape", "ms", "call_ms",
                                                "plain_ms")}
            for name in (f"{kind}_root", f"{kind}_wide")}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
