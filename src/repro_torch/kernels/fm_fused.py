"""Fused multi-pass FM: the CUDA kernel, its plain version, a count.

``fm_fused_multi`` is the port of the reference's ``kernels/fm_fused.py``
``fm_fused_multi`` (a Pallas TPU kernel).  For every lane it runs
``passes`` passes of vertex-separator FM: recompute the pulled weights,
then up to ``max_moves`` moves (argmax of gain + noise over both sides,
move, pull the opposite side's neighbours into the separator, keep the
best feasible state), then revert to the best state.

Lanes share ELL tiles: ``nbr`` holds one (n, d) tile per work and
``lane_work[l]`` names the tile of lane ``l``, so a work's k lanes do not
carry k copies of it.  The per-pass tiebreak noise is drawn outside the
kernel by ``fm_noise`` with the reference's exact key sequence, and every
float sum is over integer-valued float32 weights, so the kernel, the
plain version and the reference agree bit for bit.

On a CUDA tensor the wrapper launches ``csrc/fm_fused.cu``; on a CPU
tensor it runs ``fm_fused_plain``.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import prng
from repro_torch.kernels import build

BIG_NOISE = 1e9
SMALL_NOISE = 1e-3

#: number of times ``fm_fused_multi`` launched the CUDA kernel
launches = 0


def fm_noise(keys: torch.Tensor, n: int, passes: int) -> torch.Tensor:
    """Per-pass tiebreak noise of every lane: (L, 2) keys → (L, passes, 2, n).

    The reference's sequence: per pass, split each lane's key in two,
    carry the first half and draw ``uniform((2, n))`` from the second.
    """
    noises = []
    for _ in range(passes):
        both = prng.split(keys)                         # (L, 2, 2)
        keys, subs = both[:, 0], both[:, 1]
        noises.append(prng.uniform(subs, (2, n)))
    return torch.stack(noises, dim=1)


def state_bytes(n: int, d: int) -> int:
    """Bytes of one lane's kernel state (pulled0/1, pull list, parts),
    kept in a device-memory scratch slice of 256-byte-aligned stride."""
    return 11 * n + 4 * d


def _sums(vw: torch.Tensor, part: torch.Tensor):
    return ((vw * (part == 0)).sum(1), (vw * (part == 1)).sum(1),
            (vw * (part == 2)).sum(1))


def fm_fused_plain(nbr, lane_work, vwgt_f, parts, locked, noise, eps_abs,
                   max_moves, n_pert, passes: int, pos_only: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pass loop in torch, batched over lanes, on any device.

    Takes the kernel's inputs: tiles ``nbr`` (W, n, d) int32 with
    ``lane_work`` (L,), float32 ``vwgt_f`` (L, n), int8 ``parts``, bool
    ``locked``, ``noise`` (L, passes, 2, n) from ``fm_noise``, float32
    ``eps_abs`` (L,), int32 ``max_moves`` / ``n_pert`` (L,).  Every lane
    runs its own move loop: a lane takes part in a step while it has
    budget left and its last move succeeded.  Returns (parts int8,
    sep_w, imb).
    """
    L = lane_work.shape[0]
    n, d = nbr.shape[1:]
    dev = nbr.device
    nbr_l = nbr.index_select(0, lane_work.long())           # (L, n, d)
    valid = nbr_l >= 0
    nbrs = torch.where(valid, nbr_l, 0).long()
    flat = nbrs.reshape(L, n * d)
    vw = vwgt_f
    part = parts.to(torch.int32)
    lane = torch.arange(L, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    big = torch.tensor(BIG_NOISE, dtype=torch.float32, device=dev)
    small = torch.tensor(SMALL_NOISE, dtype=torch.float32, device=dev)
    max_moves = max_moves.long()
    w0, w1, ws = _sums(vw, part)
    bpart, bws, bimb = part.clone(), ws.clone(), (w0 - w1).abs()
    for p in range(passes):
        pert = n_pert.long() if p == 0 else torch.zeros_like(max_moves)
        pn = part.gather(1, flat).reshape(L, n, d)
        wn = torch.where(valid, vw.gather(1, flat).reshape(L, n, d), 0.0)
        pulled0 = (wn * (pn == 1)).sum(2)
        pulled1 = (wn * (pn == 0)).sum(2)
        moved = torch.zeros((L, n), dtype=torch.bool, device=dev)
        alive = torch.ones(L, dtype=torch.bool, device=dev)
        i = 0
        while True:
            act = alive & (i < max_moves)
            if not bool(act.any()):
                break
            gain0, gain1 = vw - pulled0, vw - pulled1
            imb = (w0 - w1).abs()[:, None]
            thr = torch.maximum(eps_abs[:, None], imb)
            feas0 = ((w0[:, None] + vw) - (w1[:, None] - pulled0)).abs() <= thr
            feas1 = ((w0[:, None] - pulled1) - (w1[:, None] + vw)).abs() <= thr
            movable = (part == 2) & ~moved & ~locked & act[:, None]
            ok0, ok1 = movable & feas0, movable & feas1
            if pos_only:
                ok0, ok1 = ok0 & (gain0 > 0), ok1 & (gain1 > 0)
            amp = torch.where(i < pert, big, small)[:, None]
            s0 = torch.where(ok0, gain0 + noise[:, p, 0] * amp, neg_inf)
            s1 = torch.where(ok1, gain1 + noise[:, p, 1] * amp, neg_inf)
            scores = torch.cat([s0, s1], dim=1)
            idx = scores.argmax(dim=1)
            ok = scores.gather(1, idx[:, None])[:, 0] > neg_inf
            side = (idx >= n).to(torch.int32)
            v = idx % n
            nv, nvalid = nbrs[lane, v], valid[lane, v]             # (L, d)
            pull = nvalid & (part.gather(1, nv) == (1 - side)[:, None]) \
                & ok[:, None]
            pulled_w = torch.where(pull, vw.gather(1, nv), 0.0).sum(1)
            # the move: pulled vertices join the separator, v joins `side`
            pl, pj = pull.nonzero(as_tuple=True)
            part[pl, nv[pl, pj]] = 2
            part[lane[ok], v[ok]] = side[ok]
            # v's neighbours: pull toward v's new side grows by vwgt[v]
            dv_w = vw[lane, v]
            tl, tj = (nvalid & ok[:, None]).nonzero(as_tuple=True)
            one = side[tl] == 1
            pulled0.index_put_((tl[one], nv[tl[one], tj[one]]),
                               dv_w[tl[one]], accumulate=True)
            pulled1.index_put_((tl[~one], nv[tl[~one], tj[~one]]),
                               dv_w[tl[~one]], accumulate=True)
            # each pulled x's neighbours: pull toward x's old side shrinks
            x = nv[pl, pj]
            rows = nbrs[pl, x]                                    # (P, d)
            rl, rk = (valid[pl, x]).nonzero(as_tuple=True)
            ul, u = pl[rl], rows[rl, rk]
            amt = -vw[ul, x[rl]]
            zero = side[ul] == 0
            pulled0.index_put_((ul[zero], u[zero]), amt[zero], accumulate=True)
            pulled1.index_put_((ul[~zero], u[~zero]), amt[~zero],
                               accumulate=True)
            dv = torch.where(ok, dv_w, 0.0)
            w0 = w0 + torch.where(side == 0, dv, 0.0) \
                - torch.where(side == 1, pulled_w, 0.0)
            w1 = w1 + torch.where(side == 1, dv, 0.0) \
                - torch.where(side == 0, pulled_w, 0.0)
            ws = ws - dv + pulled_w
            moved[lane[ok], v[ok]] = True
            imb_new = (w0 - w1).abs()
            better = act & (ws < bws) & \
                (imb_new <= torch.maximum(eps_abs, bimb))
            bpart = torch.where(better[:, None], part, bpart)
            bws = torch.where(better, ws, bws)
            bimb = torch.where(better, torch.minimum(imb_new, bimb), bimb)
            alive = torch.where(act, ok, alive)
            i += 1
        part = bpart.clone()                                  # revert to best
        w0, w1, ws = _sums(vw, part)
    return bpart.to(torch.int8), bws, bimb


def _check(nbr, lane_work, vwgt_f, parts, locked, noise, eps_abs,
           max_moves, n_pert, passes) -> None:
    W, n, d = nbr.shape
    L = lane_work.shape[0]
    want = {"nbr": (nbr, torch.int32, (W, n, d)),
            "lane_work": (lane_work, torch.int32, (L,)),
            "vwgt": (vwgt_f, torch.float32, (L, n)),
            "parts": (parts, torch.int8, (L, n)),
            "locked": (locked, torch.bool, (L, n)),
            "noise": (noise, torch.float32, (L, passes, 2, n)),
            "eps_abs": (eps_abs, torch.float32, (L,)),
            "max_moves": (max_moves, torch.int32, (L,)),
            "n_pert": (n_pert, torch.int32, (L,))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != nbr.device:
            raise ValueError(f"{name} is on {t.device}, nbr on {nbr.device}")


def fm_fused_kernel(nbr, lane_work, vwgt_f, parts, locked, noise, eps_abs,
                    max_moves, n_pert, passes: int, pos_only: bool = False):
    """Launch the CUDA kernel on the current stream (CUDA tensors only).

    Same inputs as ``fm_fused_plain``; returns its three outputs and a
    fourth, each lane's tally of the work its moves needed, int64 (L, 3):
    move-loop steps, arithmetic operations, noise entries read.
    """
    global launches
    args = (nbr, lane_work, vwgt_f, parts, locked, noise, eps_abs,
            max_moves, n_pert)
    _check(*args, passes)
    if nbr.device.type != "cuda":
        raise ValueError("fm_fused_kernel takes CUDA tensors")
    lo, hi = int(lane_work.min()), int(lane_work.max())
    if lo < 0 or hi >= nbr.shape[0]:
        raise ValueError(f"lane_work spans [{lo}, {hi}], outside the "
                         f"{nbr.shape[0]} tiles")
    args = tuple(a.contiguous() for a in args)
    L = lane_work.shape[0]
    n, d = nbr.shape[1:]
    dev = nbr.device
    out_parts = torch.empty((L, n), dtype=torch.int8, device=dev)
    sep_w = torch.empty(L, dtype=torch.float32, device=dev)
    imb = torch.empty(L, dtype=torch.float32, device=dev)
    stats = torch.empty((L, 3), dtype=torch.int64, device=dev)
    stride = -(-state_bytes(n, d) // 256) * 256
    scratch = torch.empty(L * stride, dtype=torch.uint8, device=dev)
    lib = build.load("fm_fused")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fm_fused_launch(*(a.data_ptr() for a in args),
                              out_parts.data_ptr(), sep_w.data_ptr(),
                              imb.data_ptr(), stats.data_ptr(),
                              scratch.data_ptr(), L, n, d,
                              int(passes), int(bool(pos_only)), stream)
    build.check(err, "fm_fused")
    launches += 1
    return out_parts, sep_w, imb, stats


def fm_fused_multi(nbr, lane_work, vwgt, parts, locked, keys, eps_frac,
                   max_moves, n_pert, passes: int = 3,
                   pos_only: bool = False):
    """Fused FM over a flat lane axis, the reference's contract.

    nbr (W, n, d) int32 tiles with lane_work (L,) int32; vwgt (L, n);
    parts (L, n) int8; locked (L, n) bool; keys (L, 2) PRNG keys;
    eps_frac (L,) float32; max_moves, n_pert (L,) int32.  The balance
    slack ``eps_frac · Σvwgt`` is formed here in float32 and the noise is
    drawn here, as the reference does.  Returns (parts int8, sep_w, imb).
    """
    vwgt_f = vwgt.to(torch.float32)
    eps_abs = eps_frac.to(torch.float32) * vwgt_f.sum(dim=1)
    noise = fm_noise(keys, nbr.shape[1], passes)
    args = (nbr, lane_work, vwgt_f, parts, locked, noise, eps_abs,
            max_moves, n_pert)
    if nbr.device.type == "cuda":
        return fm_fused_kernel(*args, passes=passes, pos_only=pos_only)[:3]
    _check(*args, passes)
    return fm_fused_plain(*args, passes=passes, pos_only=pos_only)
