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
7. a ``{"kernels": [...]}`` line with each kernel's launches, error, times,
   bound and library time, the card's name and power limit, and as the
   last line ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without that last line.  Imports neither jax
nor the reference package.
"""
from __future__ import annotations

import contextlib
import json
import os
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


def entry_ms(source: str, entry: str, *args, reps: int = 50) -> float:
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
    return cuda_ms(launch, reps)


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
    from repro_torch.sparse.symbolic import nnz_opc
    g = grid3d(30, 30, 30)
    stage_s = {}
    torch.cuda.synchronize()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    perm = nested_dissection(g, seed=0, nproc=8, device="cuda",
                             stage_s=stage_s)
    wall = time.perf_counter() - t0
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
    noise = phase_prng()
    kern = phase_kernels()
    ell = phase_ell()
    phase_small_parity()
    main_run = phase_main()
    hoisted = phase_hoisted(main_run)
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
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
