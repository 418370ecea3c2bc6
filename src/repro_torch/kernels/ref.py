"""The independent per-lane oracle of the FM pass loop.

``fm_fused_ref`` is the port of the reference's ``kernels/ref.py``
``fm_fused_ref``: one lane at a time, one move at a time, written from the
algorithm and sharing no code with the fused kernel, the hoisted path or
their plain versions.  It is what ``ops.fm_refine_batch(mode="oracle")``
runs, the last rung of the reference's degrade ladder, and the third
implementation the parity tests hold the other two to.  It runs on any
device and is slow: it is meant for small graphs.

The reference's other oracles (``ell_spmv_ref``, ``bfs_multi_ref``,
``sep_gain_multi_ref``, ``diffusion_step_ref``) are the plain versions
beside the port's kernels.
"""
from __future__ import annotations

import torch


def _one_lane(nbr, vw, part, locked, noise, eps_abs, max_moves: int,
              n_pert: int, passes: int, pos_only: bool):
    n = nbr.shape[0]
    valid = nbr >= 0
    nbrs = torch.where(valid, nbr, 0).long()
    neg_inf = torch.tensor(float("-inf"))
    amps = (torch.tensor(1e-3, dtype=torch.float32),
            torch.tensor(1e9, dtype=torch.float32))

    def sums(part):
        return ((vw * (part == 0)).sum(), (vw * (part == 1)).sum(),
                (vw * (part == 2)).sum())

    w0, w1, ws = sums(part)
    bpart, bws, bimb = part.clone(), ws, (w0 - w1).abs()
    for p in range(passes):
        part = bpart.clone()
        w0, w1, ws = sums(part)
        wn = torch.where(valid, vw[nbrs], 0.0)
        pulled0 = (wn * (part[nbrs] == 1)).sum(1)
        pulled1 = (wn * (part[nbrs] == 0)).sum(1)
        moved = torch.zeros(n, dtype=torch.bool)
        pert = n_pert if p == 0 else 0
        i, alive = 0, True
        while i < max_moves and alive:
            imb = (w0 - w1).abs()
            thr = torch.maximum(eps_abs, imb)
            feas0 = ((w0 + vw) - (w1 - pulled0)).abs() <= thr
            feas1 = ((w0 - pulled1) - (w1 + vw)).abs() <= thr
            movable = (part == 2) & ~moved & ~locked
            ok0, ok1 = movable & feas0, movable & feas1
            if pos_only:
                ok0 = ok0 & (vw - pulled0 > 0)
                ok1 = ok1 & (vw - pulled1 > 0)
            amp = amps[i < pert]
            scores = torch.cat([
                torch.where(ok0, vw - pulled0 + noise[p, 0] * amp, neg_inf),
                torch.where(ok1, vw - pulled1 + noise[p, 1] * amp, neg_inf)])
            idx = int(scores.argmax())          # the first maximal index
            ok = bool(scores[idx] > neg_inf)
            dv = torch.tensor(0.0)
            pulled_w = torch.tensor(0.0)
            side = 0
            if ok:
                side, v = divmod(idx, n)
                nv = nbrs[v][valid[v]]          # v's slots, in order
                pull = part[nv] == 1 - side     # judged before the move
                x = nv[pull]
                pulled_w = vw[x].sum()
                part[x] = 2
                part[v] = side
                dv = vw[v]
                # v: separator -> side; its neighbours' pull toward side grows
                (pulled0 if side == 1 else pulled1).index_add_(
                    0, nv, dv.expand(nv.shape[0]).contiguous())
                # each pulled x: 1-side -> separator; its neighbours' pull
                # toward 1-side shrinks, once per slot
                for xx in x.tolist():
                    tgt = nbrs[xx][valid[xx]]
                    (pulled0 if side == 0 else pulled1).index_add_(
                        0, tgt, (-vw[xx]).expand(tgt.shape[0]).contiguous())
                moved[v] = True
            w0 = w0 + (dv if side == 0 else 0.0) \
                - (pulled_w if side == 1 else 0.0)
            w1 = w1 + (dv if side == 1 else 0.0) \
                - (pulled_w if side == 0 else 0.0)
            ws = ws - dv + pulled_w
            imb_new = (w0 - w1).abs()
            if ws < bws and imb_new <= torch.maximum(eps_abs, bimb):
                bpart, bws = part.clone(), ws
                bimb = torch.minimum(imb_new, bimb)
            alive = ok
            i += 1
    return bpart, bws, bimb


def fm_fused_ref(nbr: torch.Tensor, vwgt: torch.Tensor,
                 parts_init: torch.Tensor, locked: torch.Tensor,
                 noise: torch.Tensor, eps_abs: torch.Tensor,
                 max_moves: torch.Tensor, n_pert: torch.Tensor,
                 passes: int = 3, pos_only: bool = False):
    """Oracle for the FM pass loop, the reference's contract.

    nbr (L, n, d) int32 (one tile per lane); vwgt (L, n); parts_init
    (L, n); locked (L, n) bool; ``noise`` (L, passes, 2, n) from
    ``fm_fused.fm_noise``; ``eps_abs`` (L,) float32; max_moves, n_pert
    (L,).  Every float sum is over integer-valued float32 weights, so it
    is exact in any order.  Returns (parts int8, sep_w, imb) on the
    inputs' device.
    """
    dev = nbr.device
    nbr, vwgt, parts_init, locked, noise, eps_abs = (
        t.cpu() for t in (nbr, vwgt, parts_init, locked, noise, eps_abs))
    outs = [_one_lane(nbr[l], vwgt[l].to(torch.float32),
                      parts_init[l].to(torch.int32), locked[l].bool(),
                      noise[l], eps_abs[l].to(torch.float32),
                      int(max_moves[l]), int(n_pert[l]), passes, pos_only)
            for l in range(nbr.shape[0])]
    parts = torch.stack([o[0] for o in outs]).to(torch.int8)
    sep_w = torch.stack([o[1] for o in outs])
    imb = torch.stack([o[2] for o in outs])
    return parts.to(dev), sep_w.to(dev), imb.to(dev)
