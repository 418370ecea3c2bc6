"""Fused multi-pass FM: the CUDA kernel, its plain version, a count.

``fm_fused_multi`` is the port of the reference's ``kernels/fm_fused.py``
``fm_fused_multi`` (a Pallas TPU kernel).  For every lane it runs
``passes`` passes of vertex-separator FM: recompute the pulled weights,
then up to ``max_moves`` moves (argmax of gain + noise over both sides,
move, pull the opposite side's neighbours into the separator, keep the
best feasible state), then revert to the best state.

Lanes share ELL tiles: ``nbr`` holds one (n, d) tile per work and
``lane_work[l]`` names the tile of lane ``l``, so a work's k lanes do not
carry k copies of it.  The kernels also take the tiles' ``RowExtents``
(``band_batch.row_extents``, made on the host once a bucket), so that they
read each row only to its last id.  The per-pass tiebreak noise is the
reference's draw (``fm_noise_plain``: per pass, split each lane's key,
draw ``uniform((2, n))`` from the second half), and the kernels draw it
themselves from the lanes' keys (``csrc/fm_fused.cu`` on
``csrc/threefry.cuh``), so no noise tensor is made on the card.  Every
float sum is over integer-valued float32 weights, so the kernel, the plain
version and the reference agree bit for bit.

On a CUDA tensor the wrapper launches ``csrc/fm_fused.cu``; on a CPU
tensor it runs ``fm_fused_plain``, which takes the extents and has no use
for them.  ``launches`` counts kernel launches.  The card's wrappers do
not read their inputs back to the host: ``lane_work`` and the extents are
checked where the bucket is made (``core.fm.pack_fm_bucket``), and the
kernels read a ``lane_work`` outside the tiles as an empty tile.

``fm_move_loop`` is pass ``p`` of the same move loop with the pulled
weights given: the hoisted path (``core.fm.fm_refine_multi``) alternates
it with ``band_batch.sep_gain_multi``.  Its kernel is a second entry of
``fm_fused.cu`` that shares the move loop and the draws with the fused
kernel, and its plain version ``fm_move_loop_plain`` is the body of
``fm_fused_plain``, so the two paths agree by construction.
``move_loop_launches`` counts its launches.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional, Tuple

import torch

from repro_torch import obs, prng
from repro_torch.kernels import build
from repro_torch.kernels.band_batch import RowExtents, check_spans, \
    check_tensors, require_card, sep_gain_multi_plain

BIG_NOISE = 1e9
SMALL_NOISE = 1e-3

#: number of times ``fm_fused_multi`` launched the CUDA kernel
launches = 0
#: number of times ``fm_move_loop`` launched its CUDA kernel
move_loop_launches = 0


def fm_noise_plain(keys: torch.Tensor, n: int, passes: int,
                   start: int = 0) -> torch.Tensor:
    """The noise in torch, on any device: (L, 2) keys →
    (L, passes - start, 2, n), the draws of passes ``start`` to
    ``passes - 1``.

    The reference's sequence: per pass, split each lane's key in two,
    carry the first half and draw ``uniform((2, n))`` from the second.
    The passes before ``start`` only carry the key.  The FM kernels draw
    these entries themselves; this is the plain versions' draw and the
    reference for the kernels'.
    """
    noises = []
    for p in range(passes):
        both = prng.split(keys)                         # (L, 2, 2)
        keys, subs = both[:, 0], both[:, 1]
        if p >= start:
            noises.append(prng.uniform(subs, (2, n)))
    return torch.stack(noises, dim=1)


def _check_keys(keys: torch.Tensor) -> None:
    if keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys: want int64 (L, 2), got {keys.dtype} "
                         f"{tuple(keys.shape)}")


def fm_noise(keys: torch.Tensor, n: int, passes: int) -> torch.Tensor:
    """Per-pass tiebreak noise of every lane: (L, 2) keys → (L, passes, 2, n),
    for the CPU paths (the oracle's input).

    CPU keys take the plain version.  CUDA keys raise ``ValueError``: on
    the card the FM kernels draw the noise themselves, and the card's
    work never goes to plain torch.
    """
    _check_keys(keys)
    if keys.device.type == "cuda":
        raise ValueError("fm_noise draws on the CPU only: on the card the FM "
                         "kernels draw the noise from the lanes' keys")
    return fm_noise_plain(keys, n, passes)


def state_bytes(n: int, d: int) -> int:
    """Bytes of one lane's kernel state (pulled0/1, the noise pairs, the
    candidate list, the move journal of at most 3n entries, the undo's
    marks, the pulled-slot list, part and flags), kept in a device-memory
    scratch slice of 256-byte-aligned stride; ``csrc/fm_fused.cu`` uses the
    same formula."""
    return 38 * n + 4 * d


def _sums(vw: torch.Tensor, part: torch.Tensor):
    return ((vw * (part == 0)).sum(1), (vw * (part == 1)).sum(1),
            (vw * (part == 2)).sum(1))


def fm_move_loop_plain(nbr, lane_work, vwgt_f, part, locked, pulled0,
                       pulled1, keys, p: int, pert, eps_abs, max_moves, bws,
                       bimb, pos_only: bool = False,
                       extents: Optional[RowExtents] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pass ``p`` of moves in torch, batched over lanes, on any device.

    The reference's per-lane ``fm_move_loop`` with the lane axis written
    out.  Takes the tiles ``nbr`` (W, n, d) with ``lane_work`` (L,),
    float32 ``vwgt_f`` (L, n), the pass-start state ``part`` (L, n) and
    its pulled weights ``pulled0/1`` (L, n) float32, bool ``locked``, the
    lanes' PRNG ``keys`` (L, 2) int64 and the pass index ``p``, whose noise
    it draws (``fm_noise_plain``'s pass p), int32 ``pert`` / ``max_moves``
    (L,), float32 ``eps_abs`` and the best so far ``bws`` / ``bimb`` (L,);
    ``extents``, the kernel's, has no use here.  A lane takes part in a
    step while it has budget left and its last move succeeded.  Returns
    (best part int8, bws, bimb); the inputs are not modified.
    """
    noise = fm_noise_plain(keys, nbr.shape[1], p + 1, start=p)[:, 0]
    return _move_loop(nbr, lane_work, vwgt_f, part, locked, pulled0,
                      pulled1, noise, pert, eps_abs, max_moves, bws, bimb,
                      pos_only)


def _move_loop(nbr, lane_work, vwgt_f, part, locked, pulled0, pulled1,
               noise, pert, eps_abs, max_moves, bws, bimb, pos_only):
    """``fm_move_loop_plain`` given the pass's ``noise`` (L, 2, n)."""
    L = lane_work.shape[0]
    n, d = nbr.shape[1:]
    dev = nbr.device
    nbr_l = nbr.index_select(0, lane_work.long())           # (L, n, d)
    valid = nbr_l >= 0
    nbrs = torch.where(valid, nbr_l, 0).long()
    vw = vwgt_f
    part = part.to(torch.int32, copy=True)
    pulled0, pulled1 = pulled0.clone(), pulled1.clone()
    lane = torch.arange(L, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    big = torch.tensor(BIG_NOISE, dtype=torch.float32, device=dev)
    small = torch.tensor(SMALL_NOISE, dtype=torch.float32, device=dev)
    max_moves, pert = max_moves.long(), pert.long()
    w0, w1, ws = _sums(vw, part)
    bpart, bws, bimb = part.clone(), bws.clone(), bimb.clone()
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
        s0 = torch.where(ok0, gain0 + noise[:, 0] * amp, neg_inf)
        s1 = torch.where(ok1, gain1 + noise[:, 1] * amp, neg_inf)
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
    return bpart.to(torch.int8), bws, bimb


def fm_fused_plain(nbr, lane_work, vwgt_f, parts, locked, keys, eps_abs,
                   max_moves, n_pert, passes: int, pos_only: bool = False,
                   extents: Optional[RowExtents] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pass loop in torch, batched over lanes, on any device.

    Takes the kernel's inputs: tiles ``nbr`` (W, n, d) int32 with
    ``lane_work`` (L,), float32 ``vwgt_f`` (L, n), int8 ``parts``, bool
    ``locked``, the lanes' PRNG ``keys`` (L, 2) int64, float32
    ``eps_abs`` (L,), int32 ``max_moves`` / ``n_pert`` (L,), and the
    kernel's ``extents``, which it has no use for.  Draws every pass's
    noise (``fm_noise_plain``), then per pass: the pulled weights
    (``sep_gain_multi_plain``), one move loop, and a revert to the best
    state.  Returns (parts int8, sep_w, imb).
    """
    noise = fm_noise_plain(keys, nbr.shape[1], passes)
    w0, w1, ws = _sums(vwgt_f, parts.to(torch.int32))
    bpart, bws, bimb = parts, ws, (w0 - w1).abs()
    no_pert = torch.zeros_like(n_pert)
    for p in range(passes):
        pulled0, pulled1 = sep_gain_multi_plain(nbr, lane_work, vwgt_f, bpart)
        bpart, bws, bimb = _move_loop(
            nbr, lane_work, vwgt_f, bpart, locked, pulled0, pulled1,
            noise[:, p], n_pert if p == 0 else no_pert, eps_abs, max_moves,
            bws, bimb, pos_only)
    return bpart, bws, bimb


def _check(nbr, lane_work, vwgt_f, parts, locked, keys, eps_abs,
           max_moves, n_pert, passes, extents) -> None:
    W, n, d = nbr.shape
    L = lane_work.shape[0]
    check_tensors(nbr, {
        "nbr": (nbr, torch.int32, (W, n, d)),
        "lane_work": (lane_work, torch.int32, (L,)),
        "vwgt": (vwgt_f, torch.float32, (L, n)),
        "parts": (parts, torch.int8, (L, n)),
        "locked": (locked, torch.bool, (L, n)),
        "keys": (keys, torch.int64, (L, 2)),
        "eps_abs": (eps_abs, torch.float32, (L,)),
        "max_moves": (max_moves, torch.int32, (L,)),
        "n_pert": (n_pert, torch.int32, (L,)),
        **_extents_want(nbr, extents)})


def _check_move_loop(nbr, lane_work, vwgt_f, part, locked, pulled0, pulled1,
                     keys, p, pert, eps_abs, max_moves, bws, bimb,
                     extents) -> None:
    if isinstance(p, bool) or not isinstance(p, int) or p < 0:
        raise ValueError(f"p: want a pass index, an int >= 0, got {p!r}")
    W, n, d = nbr.shape
    L = lane_work.shape[0]
    check_tensors(nbr, {
        "nbr": (nbr, torch.int32, (W, n, d)),
        "lane_work": (lane_work, torch.int32, (L,)),
        "vwgt": (vwgt_f, torch.float32, (L, n)),
        "part": (part, torch.int8, (L, n)),
        "locked": (locked, torch.bool, (L, n)),
        "pulled0": (pulled0, torch.float32, (L, n)),
        "pulled1": (pulled1, torch.float32, (L, n)),
        "keys": (keys, torch.int64, (L, 2)),
        "pert": (pert, torch.int32, (L,)),
        "eps_abs": (eps_abs, torch.float32, (L,)),
        "max_moves": (max_moves, torch.int32, (L,)),
        "bws": (bws, torch.float32, (L,)),
        "bimb": (bimb, torch.float32, (L,)),
        **_extents_want(nbr, extents)})


def _extents_want(nbr, extents) -> dict:
    """The extents' check: a ``RowExtents`` of the tiles, or none."""
    if extents is None:
        return {}
    if not isinstance(extents, RowExtents) or \
            extents.group not in (1, 2, 4, 8, 16, 32):
        raise ValueError("extents: want a RowExtents (row_extents) with a "
                         "group of 1 to 32 threads, a power of two")
    return {"row_len": (extents.row_len, torch.int32, tuple(nbr.shape[:2]))}


def _card_row_len(nbr, extents):
    """The kernels' common checks, CUDA tiles and the extents they read;
    returns the row extents."""
    require_card(nbr)
    if extents is None:
        raise ValueError("the FM kernels read the tiles' row extents: pass "
                         "extents=row_extents(tiles)")
    return extents.row_len.contiguous()


def _lane_outputs(L: int, n: int, d: int, dev):
    """Kernel outputs (parts, sep_w, imb, tally) and the lanes' scratch."""
    stride = -(-state_bytes(n, d) // 256) * 256
    return (torch.empty((L, n), dtype=torch.int8, device=dev),
            torch.empty(L, dtype=torch.float32, device=dev),
            torch.empty(L, dtype=torch.float32, device=dev),
            torch.empty((L, 3), dtype=torch.int64, device=dev),
            torch.empty(L * stride, dtype=torch.uint8, device=dev))


def fm_fused_kernel(nbr, lane_work, vwgt_f, parts, locked, keys, eps_abs,
                    max_moves, n_pert, passes: int, pos_only: bool = False,
                    extents: Optional[RowExtents] = None):
    """Launch the CUDA kernel on the current stream (CUDA tensors only).

    Same inputs as ``fm_fused_plain``, with the tiles' ``extents``
    required.  Returns its three
    outputs and a fourth, each lane's tally of the work its moves needed,
    int64 (L, 3): move-loop steps, arithmetic operations, noise entries
    drawn.
    """
    global launches
    args = (nbr, lane_work, vwgt_f, parts, locked, keys, eps_abs,
            max_moves, n_pert)
    _check(*args, passes, extents)
    row_len = _card_row_len(nbr, extents)
    args = tuple(a.contiguous() for a in args)
    L = lane_work.shape[0]
    W, n, d = nbr.shape
    outs = _lane_outputs(L, n, d, nbr.device)
    lib = build.load("fm_fused")
    stream = torch.cuda.current_stream(nbr.device).cuda_stream
    ptrs = [a.data_ptr() for a in (args[0], row_len) + args[1:] + outs]
    err = lib.fm_fused_launch(*ptrs, L, W, n, d, extents.group, int(passes),
                              int(bool(pos_only)), stream)
    build.check(err, "fm_fused")
    launches += 1
    return outs[:4]


def fm_move_loop_kernel(nbr, lane_work, vwgt_f, part, locked, pulled0,
                        pulled1, keys, p: int, pert, eps_abs, max_moves, bws,
                        bimb, pos_only: bool = False,
                        extents: Optional[RowExtents] = None):
    """Launch the one-pass CUDA kernel on the current stream (CUDA only).

    Same inputs as ``fm_move_loop_plain``, with the tiles' ``extents``
    required; returns its three
    outputs and the lanes' tally of the work their moves needed, as
    ``fm_fused_kernel``.
    """
    global move_loop_launches
    _check_move_loop(nbr, lane_work, vwgt_f, part, locked, pulled0, pulled1,
                     keys, p, pert, eps_abs, max_moves, bws, bimb, extents)
    row_len = _card_row_len(nbr, extents)
    args = tuple(a.contiguous() for a in (
        nbr, lane_work, vwgt_f, part, locked, pulled0, pulled1, keys, pert,
        eps_abs, max_moves, bws, bimb))
    L = lane_work.shape[0]
    W, n, d = nbr.shape
    outs = _lane_outputs(L, n, d, nbr.device)
    lib = build.load("fm_fused")
    stream = torch.cuda.current_stream(nbr.device).cuda_stream
    ptrs = [a.data_ptr() for a in (args[0], row_len) + args[1:] + outs]
    err = lib.fm_move_loop_launch(*ptrs, L, W, n, d, p, int(bool(pos_only)),
                                  stream)
    build.check(err, "fm_move_loop")
    move_loop_launches += 1
    return outs[:4]


def fm_move_loop(nbr, lane_work, vwgt_f, part, locked, pulled0, pulled1,
                 keys, p: int, pert, eps_abs, max_moves, bws, bimb,
                 pos_only: bool = False,
                 extents: Optional[RowExtents] = None):
    """Pass ``p`` of FM moves per lane, the hoisted path's move loop.

    Inputs as ``fm_move_loop_plain``, with the tiles' ``extents``, which
    the kernel needs.  CUDA tensors go to the kernel, which draws the
    pass's noise from ``keys``; CPU tensors go to the plain version, which
    checks ``lane_work`` and the extents.  Returns (best part int8, bws,
    bimb).
    """
    args = (nbr, lane_work, vwgt_f, part, locked, pulled0, pulled1, keys, p,
            pert, eps_abs, max_moves, bws, bimb)
    _check_move_loop(*args, extents)
    if nbr.device.type == "cuda":
        return fm_move_loop_kernel(*args, pos_only=pos_only,
                                   extents=extents)[:3]
    check_spans(nbr, lane_work, None if extents is None else extents.row_len)
    return fm_move_loop_plain(*args, pos_only=pos_only)


#: where ``fm_fused_multi`` puts each card launch's tally (``keep_tally``)
_TALLY: contextvars.ContextVar[Optional[List[torch.Tensor]]] = \
    contextvars.ContextVar("repro_fm_tally", default=None)


@contextlib.contextmanager
def keep_tally(into: Optional[List[torch.Tensor]]):
    """Within the block, each ``fm_fused_multi`` call on the card appends
    its kernel's tally to ``into``: int64 (L, 3) on the card, per lane
    the move-loop steps, operations and noise draws (``fm_fused_kernel``'s
    fourth output); None keeps none.  The caller downloads it."""
    token = _TALLY.set(into)
    try:
        yield
    finally:
        _TALLY.reset(token)


@obs.traced("fm:launch")
def fm_fused_multi(nbr, lane_work, vwgt, parts, locked, keys, eps_frac,
                   max_moves, n_pert, passes: int = 3,
                   pos_only: bool = False,
                   extents: Optional[RowExtents] = None):
    """Fused FM over a flat lane axis, the reference's contract.

    nbr (W, n, d) int32 tiles with lane_work (L,) int32; vwgt (L, n);
    parts (L, n) int8; locked (L, n) bool; keys (L, 2) PRNG keys;
    eps_frac (L,) float32; max_moves, n_pert (L,) int32; ``extents``, the
    tiles' ``RowExtents`` on their device (``band_batch.row_extents``),
    which the card needs.  The balance slack ``eps_frac · Σvwgt`` is
    formed here in float32, as the reference does; the noise is drawn
    from ``keys`` by the kernel (or the plain version).  Returns (parts
    int8, sep_w, imb).
    """
    vwgt_f = vwgt.to(torch.float32)
    eps_abs = eps_frac.to(torch.float32) * vwgt_f.sum(dim=1)
    args = (nbr, lane_work, vwgt_f, parts, locked, keys, eps_abs,
            max_moves, n_pert)
    if nbr.device.type == "cuda":
        out = fm_fused_kernel(*args, passes=passes, pos_only=pos_only,
                              extents=extents)
        tally = _TALLY.get()
        if tally is not None:
            tally.append(out[3])
        return out[:3]
    _check(*args, passes, extents)
    check_spans(nbr, lane_work, None if extents is None else extents.row_len)
    return fm_fused_plain(*args, passes=passes, pos_only=pos_only)
