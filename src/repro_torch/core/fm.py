"""Vertex-separator FM refinement, multi-sequential (paper §3.3).

State per vertex: part ∈ {0, 1, 2=separator, 3=padding}.  Invariant: no edge
joins part 0 to part 1.  A move takes a separator vertex v to side p; every
neighbor of v in side 1−p is pulled into the separator (preserving the
invariant).  Gain = vwgt[v] − Σ pulled weights.  Moves may be negative
(hill-climbing); the best state seen is restored at end of pass.

The paper's *multi-sequential* refinement runs independent FM instances
on copies of the band graph, each from a perturbed start; here every
instance is a *lane*.  ``execute_fm_works`` pads each work to its
power-of-two ELL bucket and runs every work of a bucket as one
``kernels.ops.fm_refine_batch`` call.  ``REPRO_FM_MODE`` picks the path:
the fused pass loop (``kernels.fm_fused.fm_fused_multi``, one CUDA kernel
per bucket, the default), the hoisted pass loop of this module
(``fm_refine_multi``: per pass, the gains from
``kernels.band_batch.sep_gain_multi`` and one ``fm_move_loop``), or the
independent oracle, which is plain torch and so runs only on the CPU.  The
three return the same bits.  A work's lanes
share one ELL tile.  Per-lane results are independent of batch
composition, so bucketed execution equals one-work-at-a-time execution
bit for bit.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import defaultdict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs, prng
from repro_torch.kernels import fm_fused, ops
from repro_torch.kernels.band_batch import RowExtents, check_spans, \
    row_extents, sep_gain_multi
from repro_torch.kernels.fm_fused import fm_move_loop
from repro_torch.obs.instrument import _note_launch
from repro_torch.util import pow2 as _pow2, resolve_device

GAIN_MODES = ("pallas", "jnp")


def fm_lane_count(nproc: int, cap: int, fold_dup: bool,
                  strict: bool = False) -> int:
    """Multi-sequential FM lane count for a process group of ``nproc``.

    The paper runs one independent sequential FM instance per process of
    the group refining a band (§3.3); ``cap`` bounds the lane memory,
    ``fold_dup=False`` (ablation) keeps the host floor of two lanes, and
    ``strict`` (the ParMETIS-like baseline) runs a single lane.
    """
    if strict:
        return 1
    k = int(np.clip(nproc, 1, cap)) if fold_dup else 1
    return max(k, 2)


def gain_mode_default(device=None) -> str:
    """FM gain-recompute backend: REPRO_FM_GAIN=pallas|jnp|auto.

    The reference's names: ``pallas`` is the port's gain kernel (which,
    like every wrapper, runs its plain version on CPU tensors); ``jnp`` is
    the plain version, which runs only on the CPU: on CUDA tensors the
    hoisted path raises rather than give the card's work to plain torch.
    ``auto`` resolves to ``pallas`` on the card and ``jnp`` on the CPU.
    """
    mode = os.environ.get("REPRO_FM_GAIN", "auto")
    if mode == "auto":
        return "pallas" if resolve_device(device).type == "cuda" else "jnp"
    return mode


@obs.traced("fm:launch")
def fm_refine_multi(nbr, lane_work, vwgt, parts, locked, keys, eps_frac,
                    max_moves, n_pert, passes: int = 3,
                    pos_only: bool = False, gain_mode: str | None = None,
                    extents: Optional[RowExtents] = None):
    """The hoisted pass loop: FM over a flat lane axis, pass by pass.

    Shapes as ``fm_fused_multi``: nbr (W, n, d) int32 tiles with
    lane_work (L,) int32; vwgt (L, n); parts (L, n) int8; locked (L, n)
    bool; keys (L, 2); eps_frac (L,) float32; max_moves, n_pert (L,)
    int32; ``extents``, the tiles' ``RowExtents`` on their device
    (``band_batch.row_extents``), which every pass's gain and move-loop
    launches read and the card needs.  Per pass p, recompute the gains
    (``sep_gain_multi``), run ``fm_move_loop`` for pass p, which draws
    that pass's noise from ``keys``, revert to the best state.  The best
    separator weight and imbalance carry from pass to pass.  On the card
    each pass is two kernel launches and no noise tensor is made.  Returns
    (parts int8, sep_w, imb), the fused kernel's bits.
    Raises ``ValueError`` for an unknown ``gain_mode``, and for ``jnp`` on
    CUDA tensors.
    """
    gain_mode = gain_mode or gain_mode_default(nbr.device)
    if gain_mode not in GAIN_MODES:
        raise ValueError(f"REPRO_FM_GAIN={gain_mode!r} not in "
                         "pallas|jnp|auto")
    if gain_mode == "jnp" and nbr.is_cuda:
        raise ValueError("REPRO_FM_GAIN=jnp is the plain gains, which run "
                         "only on the CPU; on the card use pallas or auto")
    vwgt_f = vwgt.to(torch.float32)
    eps_abs = eps_frac.to(torch.float32) * vwgt_f.sum(dim=1)
    ws = (vwgt_f * (parts == 2)).sum(1)
    bimb = ((vwgt_f * (parts == 0)).sum(1) -
            (vwgt_f * (parts == 1)).sum(1)).abs()
    bpart, bws = parts, ws
    pert = n_pert                       # perturbation in the first pass only
    for p in range(passes):
        pulled0, pulled1 = sep_gain_multi(nbr, lane_work, vwgt_f, bpart,
                                          extents)
        bpart, bws, bimb = fm_move_loop(
            nbr, lane_work, vwgt_f, bpart, locked, pulled0, pulled1, keys,
            p, pert, eps_abs, max_moves, bws, bimb, pos_only=pos_only,
            extents=extents)
        pert = torch.zeros_like(n_pert)
    return bpart, bws, bimb


@dataclasses.dataclass
class FMWork:
    """One multi-instance FM refinement request (unpadded host arrays).

    The pipeline stages in ``core.nd`` *yield* these instead of dispatching
    directly.  ``locked`` and ``max_moves`` are lane data, not part of
    ``bucket_key``: works whose masks or move budgets differ still share
    one kernel call, because each lane's loop ends at its own budget.
    """
    nbr: np.ndarray                     # (n, d) int32 ELL ids, -1 pad
    vwgt: np.ndarray                    # (n,) vertex weights
    part: np.ndarray                    # (n,) int8 initial state
    locked: np.ndarray                  # (n,) bool
    seed: int
    k_inst: int = 8
    eps_frac: float = 0.1
    passes: int = 3
    max_moves: Optional[int] = None
    n_pert: int = 8
    parts_init: Optional[np.ndarray] = None    # (K, n) distinct starts
    pos_only: bool = False

    def effective_max_moves(self) -> int:
        n_pad = _pow2(self.nbr.shape[0])
        max_moves = self.max_moves
        if max_moves is None:
            if self.parts_init is None:
                sep_sz = int((self.part == 2).sum())
            else:
                sep_sz = int((np.asarray(self.parts_init) == 2).sum(1).max())
            max_moves = 2 * sep_sz + 16
        return min(int(max_moves), n_pad, 4096)

    def bucket_key(self) -> Tuple[int, int, int, bool]:
        n, d = self.nbr.shape
        return (_pow2(n), _pow2(max(d, 1), 8), self.passes, self.pos_only)


@dataclasses.dataclass
class _Lanes:
    """One work's padded arrays: one ELL tile, k_inst lanes of state."""
    nbr: np.ndarray                     # (n_pad, d_pad), shared by the lanes
    vwgt: np.ndarray                    # (n_pad,)
    locked: np.ndarray                  # (n_pad,)
    parts0: np.ndarray                  # (k, n_pad)
    eps: np.ndarray                     # (k,)
    max_moves: np.ndarray               # (k,)
    n_pert: np.ndarray                  # (k,)


def _prepare_lanes(w: FMWork) -> _Lanes:
    n, d = w.nbr.shape
    n_pad, d_pad = w.bucket_key()[:2]
    k_inst = _pow2(w.k_inst, 2)
    nbr_p = -np.ones((n_pad, d_pad), np.int32)
    nbr_p[:n, :d] = w.nbr
    vw_p = np.zeros(n_pad, np.int32)
    vw_p[:n] = w.vwgt
    lock_p = np.ones(n_pad, bool)
    lock_p[:n] = w.locked
    if w.parts_init is None:
        parts_init = np.broadcast_to(np.asarray(w.part, np.int8)[None, :],
                                     (k_inst, n))
    else:
        parts_init = np.asarray(w.parts_init, np.int8)[
            np.arange(k_inst) % len(w.parts_init)]
    parts0 = np.full((k_inst, n_pad), 3, np.int8)
    parts0[:, :n] = parts_init
    return _Lanes(
        nbr=nbr_p, vwgt=vw_p, locked=lock_p, parts0=parts0,
        eps=np.full(k_inst, w.eps_frac, np.float32),
        max_moves=np.full(k_inst, w.effective_max_moves(), np.int32),
        n_pert=np.full(k_inst, w.n_pert, np.int32))


@obs.traced("fm:select")
def _select_best(w: FMWork, parts: np.ndarray, sep_w: np.ndarray,
                 imb: np.ndarray) -> Tuple[np.ndarray, float, float]:
    """Paper's selection: min separator weight among balance-feasible."""
    total = float(np.asarray(w.vwgt).sum())
    feas = imb <= max(w.eps_frac * total, float(imb.min()))
    score = np.where(feas, sep_w, sep_w + total)            # infeasible last
    best = int(np.argmin(score))
    return parts[best], float(sep_w[best]), float(imb[best])


@obs.traced("fm:pack")
def pack_fm_bucket(works: Sequence[FMWork]) -> Tuple[dict, List[int]]:
    """Host tensors of one bucket's ``fm_refine_batch`` call; lanes per work.

    One ELL tile per work; each work's ``k_inst`` lanes name it through
    ``lane_work``.  Lanes are padded to a multiple of 8 with copies of the
    first lane that get no moves, as the reference pads them.  The tiles'
    ``extents`` (``band_batch.row_extents``) are made here, once a bucket,
    and ``lane_work`` and the extents are checked here on the host, so the
    kernels' wrappers need not read them back from the card.  The lanes'
    keys are ``prng.split_host`` of the works' seeds, one pass a bucket.
    """
    with obs.span("fm:lanes"):
        lanes = [_prepare_lanes(w) for w in works]
    counts = [ln.parts0.shape[0] for ln in lanes]
    L_real = sum(counts)
    with obs.span("fm:keys", lanes=L_real):
        keys = prng.split_host([w.seed for w in works], counts)
    pad = -(-L_real // 8) * 8 - L_real
    lane_work = np.concatenate([np.repeat(np.arange(len(lanes)), counts),
                                np.zeros(pad, np.int64)])
    first = np.concatenate([np.arange(L_real), np.zeros(pad, np.int64)])

    def per_lane(get, dtype):
        return torch.from_numpy(np.concatenate(
            [get(ln) for ln in lanes])[first].astype(dtype))

    def per_work(get):
        return torch.from_numpy(np.stack([get(ln) for ln in lanes])[lane_work])

    mm = np.concatenate([ln.max_moves for ln in lanes] +
                        [np.zeros(pad, np.int32)])          # dummies: 0 moves
    nbr = torch.from_numpy(np.stack([ln.nbr for ln in lanes]))
    lane_work = torch.from_numpy(lane_work.astype(np.int32))
    with obs.span("fm:extents"):
        extents = row_extents(nbr)
    with obs.span("fm:check_spans"):
        check_spans(nbr, lane_work, extents.row_len)
    return dict(
        nbr=nbr, lane_work=lane_work, extents=extents,
        vwgt=per_work(lambda ln: ln.vwgt),
        parts=per_lane(lambda ln: ln.parts0, np.int8),
        locked=per_work(lambda ln: ln.locked),
        keys=torch.from_numpy(keys[first]),
        eps_frac=per_lane(lambda ln: ln.eps, np.float32),
        max_moves=torch.from_numpy(mm),
        n_pert=per_lane(lambda ln: ln.n_pert, np.int32)), counts


def download(*tensors) -> List[np.ndarray]:
    """Host copies of a bucket's results: the one sync of an FM work."""
    return [t.cpu().numpy() for t in tensors]


def execute_fm_works(works: Sequence[FMWork], device=None, *,
                     gain_mode: Optional[str] = None,
                     mode: Optional[str] = None
                     ) -> List[Tuple[np.ndarray, float, float]]:
    """Run FM works, one ``ops.fm_refine_batch`` call per bucket.

    Each bucket's call, with its download, is one ``obs.timed_dispatch``
    (the fault-injection seam) and one launch record
    (``obs.instrument``); the ``fm`` stage is billed from the start of
    the bucket's packing.  Returns, for each work in input
    order, the best ``(part, sep_w, imb)`` across its instances —
    exactly what ``refine_parts`` returns.
    ``mode`` defaults to ``REPRO_FM_MODE`` (``ops.fm_mode_default``); an
    explicit ``gain_mode`` without a ``mode`` forces the hoisted path, the
    only one with a gain backend, as in the reference.
    """
    dev = resolve_device(device)
    if mode is None:
        mode = "hoisted" if gain_mode is not None else ops.fm_mode_default()
    if mode == "hoisted" and gain_mode is None:
        gain_mode = gain_mode_default(dev)
    results: List[Optional[Tuple[np.ndarray, float, float]]] = \
        [None] * len(works)
    groups = defaultdict(list)
    for i, w in enumerate(works):
        groups[w.bucket_key()].append(i)
    for bucket, idxs in groups.items():
        passes, pos_only = bucket[2:]
        t0 = time.perf_counter()
        host, counts = pack_fm_bucket([works[i] for i in idxs])
        L_real, L_pad = sum(counts), host["parts"].shape[0]
        # traced: the fused kernel's tally comes down with the results
        tally: Optional[list] = [] if obs.enabled() else None

        def dispatch(host=host, passes=passes, pos_only=pos_only,
                     tally=tally):
            with fm_fused.keep_tally(tally):
                out = ops.fm_refine_batch(
                    **host, passes=passes, pos_only=pos_only, mode=mode,
                    gain_mode=gain_mode, device=dev)
            with obs.span("fm:download"):
                got = download(*out, *(tally or ()))
            if tally:
                tally[:] = got[3:]
            return got[:3]

        # the first dispatch of a mode on a device loads (or builds) its
        # CUDA library: the load key bills it as the compile
        parts, sep_w, imb = obs.timed_dispatch(
            "fm", "fm", ("fm", mode, gain_mode, dev.type), dispatch,
            since=t0, lanes=L_real, lanes_pad=L_pad, mode=mode,
            max_moves=int(host["max_moves"].max()), bucket=bucket)
        counted = {}
        if tally:   # steps and operations of the real lanes, and the
            # longest lane's steps: the lanes run side by side, one block
            # each, so that lane is the launch's critical path
            lane_steps = tally[-1][:L_real, 0]
            counted = dict(steps=int(lane_steps.sum()),
                           ops=int(tally[-1][:L_real, 1].sum()),
                           steps_max=int(lane_steps.max()))
        _note_launch("fm", 0, L_real, L_pad, bucket, passes, 0, **counted)
        off = 0
        for i, k in zip(idxs, counts):
            n = works[i].nbr.shape[0]
            results[i] = _select_best(
                works[i], parts[off:off + k, :n],
                sep_w[off:off + k], imb[off:off + k])
            off += k
    return results                                           # type: ignore


def refine_parts(nbr: np.ndarray, vwgt: np.ndarray, part: np.ndarray,
                 locked: np.ndarray, seed: int, k_inst: int = 8,
                 eps_frac: float = 0.1, passes: int = 3,
                 max_moves: int | None = None, n_pert: int = 8,
                 parts_init: np.ndarray | None = None,
                 pos_only: bool = False, device=None
                 ) -> Tuple[np.ndarray, float, float]:
    """Run K FM instances on an ELL graph; return the best part vector.

    Selection is the paper's: best refined band separator wins —
    min separator weight among balance-feasible instances.
    ``parts_init`` optionally provides a distinct initial state per instance
    (K, n) — used by the initial-partition phase.  This is the one-work
    convenience wrapper over ``execute_fm_works``.
    """
    work = FMWork(nbr=nbr, vwgt=vwgt, part=part, locked=locked, seed=seed,
                  k_inst=k_inst, eps_frac=eps_frac, passes=passes,
                  max_moves=max_moves, n_pert=n_pert, parts_init=parts_init,
                  pos_only=pos_only)
    return execute_fm_works([work], device)[0]


@obs.traced("nd:check")
def separator_is_valid(nbr: np.ndarray, part: np.ndarray) -> bool:
    """No edge joins part 0 and part 1."""
    valid = nbr >= 0
    pn = np.where(valid, part[np.where(valid, nbr, 0)], 3)
    p = part[:, None]
    bad = ((p == 0) & (pn == 1)) | ((p == 1) & (pn == 0))
    return not bool(bad.any())
