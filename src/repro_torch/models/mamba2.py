"""Mamba-2 SSD (state-space duality) block — chunked matmul form.

The port of the reference's ``models.mamba2`` (arXiv:2405.21060): the
sequence is split into chunks; within a chunk the recurrence is computed
as a masked (L×L) matmul ("attention-like" dual), and states are passed
between chunks by a short loop over the chunks (the reference's
``lax.scan``).  Decode keeps an (H, N, P) state per layer, O(1) per
token, and a (W-1, ch) window of the causal convolution's inputs.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import sharding as shd
from repro_torch.models.layers import (PDT, _dense, _heads, _merge,
                                      rmsnorm, rmsnorm_init)

PyTree = Any


def ssm_dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    inner = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_headdim
    H = inner // P
    N = cfg.ssm_state
    return inner, H, P, N


def mamba_init(gen: torch.Generator, cfg: ArchConfig) -> PyTree:
    d = cfg.d_model
    inner, H, P, N = ssm_dims(cfg)
    dev = gen.device
    conv = torch.randn((cfg.ssm_conv, inner + 2 * N), generator=gen,
                       device=dev, dtype=torch.float32) * 0.2
    return {
        "wz": _dense(gen, (d, inner)),
        "wx": _dense(gen, (d, inner)),
        "wB": _dense(gen, (d, N)),
        "wC": _dense(gen, (d, N)),
        "wdt": _dense(gen, (d, H)),
        "dt_bias": torch.zeros((H,), dtype=PDT, device=dev),
        "A_log": torch.zeros((H,), dtype=torch.float32,
                             device=dev),            # A = -exp(A_log)
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "conv": conv.to(PDT),
        "norm": rmsnorm_init(inner, dev),
        "wo": _dense(gen, (inner, d)),
    }


def _causal_conv(u: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. u (B,S,ch), kern (W,ch).  Over DTensors each
    card convolves its batch rows, whole along the sequence and the
    channels (the shifts are views along a dim no card may split)."""
    mesh = shd.mesh_of(u, kern)
    if mesh is not None:
        pl = shd.batch_heads(mesh, u.shape[0], None)
        return shd.local_map(_causal_conv, mesh, (u, kern),
                             (pl, shd.replicated(mesh)), pl)
    W = kern.shape[0]
    S = u.shape[1]
    acc = u * kern[-1]
    for i in range(1, W):
        shifted = F.pad(u, (0, 0, i, 0))[:, :S]
        acc = acc + shifted * kern[W - 1 - i]
    return acc


def ssd_chunked(x, dt, A_log, B_, C_, chunk: int):
    """Chunked SSD scan.

    x (B,S,H,P), dt (B,S,H) (post-softplus), A_log (H,), B_/C_ (B,S,N).
    Returns (y (B,S,H,P), final_state (B,H,N,P)).
    """
    mesh = shd.mesh_of(x, dt, B_, C_)
    if mesh is not None:
        return _ssd_sharded(mesh, x, dt, A_log, B_, C_, chunk)
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}"
                         " (the caller pads it)")
    nc = S // chunk
    A = -torch.exp(A_log)                                  # (H,) negative
    xc = x.reshape(Bb, nc, chunk, H, P).float()
    dtc = dt.reshape(Bb, nc, chunk, H).float()
    Bc = B_.reshape(Bb, nc, chunk, N).float()
    Cc = C_.reshape(Bb, nc, chunk, N).float()
    dA = dtc * A                                           # (B,nc,L,H)
    cum = torch.cumsum(dA, dim=2)
    # --- intra-chunk (quadratic dual form)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,L,L,H)
    ltri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    # masked before the exp, not after: above the diagonal ``diff`` is
    # positive and its exp overflows (at L = 256, once the decay passes
    # 88), and the gradient of a ``where`` after it is 0 * inf = NaN (the
    # reference's, ``jnp.where(ltri, exp(diff), 0)``, is NaN there); the
    # forward is the same, exp(-inf) = 0
    decay = torch.exp(torch.where(ltri[None, None, :, :, None], diff,
                                  float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)           # (B,nc,L,L)
    w = cb[..., None] * decay * dtc[:, :, None, :, :]      # (B,nc,L,L,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xc)
    # --- chunk states
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)         # (B,nc,L,H)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc, decay_end * dtc,
                          xc)                              # (B,nc,H,N,P)
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (B,nc,H)
    prev = torch.zeros((Bb, H, N, P), dtype=torch.float32, device=x.device)
    prevs = []
    for c in range(nc):
        prevs.append(prev)
        prev = prev * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prevs, dim=1)                # (B,nc,H,N,P)
    # --- inter-chunk contribution
    y_inter = torch.einsum("bcin,bcih,bchnp->bcihp", Cc, torch.exp(cum),
                           prev_states)
    y = (y_intra + y_inter).reshape(Bb, S, H, P)
    return y.to(x.dtype), prev


def _ssd_sharded(mesh, x, dt, A_log, B_, C_, chunk):
    """``ssd_chunked`` over DTensors: each card scans its batch rows and
    its heads (split on the model axis where they divide) on its local
    shards; the chunk einsums never view a split head dim."""
    Bb, _, H, _ = x.shape
    h = 2 if shd.heads_split(mesh, H) else None
    xpl = shd.batch_heads(mesh, Bb, h)
    bpl = shd.batch_heads(mesh, Bb, None)
    spl = shd.batch_heads(mesh, Bb, None if h is None else 1)
    return shd.local_map(
        lambda *a: ssd_chunked(*a, chunk), mesh, (x, dt, A_log, B_, C_),
        (xpl, xpl, shd.heads_only(mesh, None if h is None else 0), bpl,
         bpl), (xpl, spl))


def ssd_step(state, dt, A_log, b, c, xh, D):
    """One token of the SSD: state (B,H,N,P), dt (B,H) (post-softplus),
    b/c (B,N) and xh (B,H,P) float32, D (H,).  Returns (y (B,H,P), the
    new state)."""
    mesh = shd.mesh_of(state, dt, b, c, xh)
    if mesh is not None:
        H = xh.shape[1]
        h = shd.heads_split(mesh, H)
        Bb = xh.shape[0]
        spl = shd.batch_heads(mesh, Bb, 1 if h else None)
        vec = shd.heads_only(mesh, 0 if h else None)
        bpl = shd.batch_heads(mesh, Bb, None)
        return shd.local_map(ssd_step, mesh, (state, dt, A_log, b, c, xh, D),
                             (spl, spl, vec, bpl, bpl, spl, vec), (spl, spl))
    A = -torch.exp(A_log)
    dA = torch.exp(dt * A)                                 # (B,H)
    state = state * dA[..., None, None] + torch.einsum(
        "bn,bh,bhp->bhnp", b, dt, xh)
    y = torch.einsum("bn,bhnp->bhp", c, state)
    y = y + D[None, :, None] * xh
    return y, state


def mamba_apply(p, x, cfg: ArchConfig, chunk: int = 256,
                return_state: bool = False):
    """Full-sequence Mamba-2 block (train / prefill).  With
    ``return_state``, also (final state, the last W-1 conv inputs)."""
    Bb, S, d = x.shape
    inner, H, P, N = ssm_dims(cfg)
    z = shd.pinned(x @ p["wz"])                            # (B,S,inner)
    u_in = torch.cat([x @ p["wx"], x @ p["wB"], x @ p["wC"]], -1)
    u = F.silu(_causal_conv(u_in, p["conv"]))
    xs, Bv, Cv = torch.split(u, [inner, N, N], dim=-1)
    dt = F.softplus((x @ p["wdt"]).float() + p["dt_bias"].float())
    xh = _heads(xs, Bb, S, H, P)
    ch = min(chunk, S) if S % chunk else chunk
    y, state = ssd_chunked(xh, dt, p["A_log"], Bv, Cv, ch)
    y = y + p["D"][None, None, :, None].to(y.dtype) * xh
    y = _merge(y, Bb, S, inner)
    y = rmsnorm(p["norm"], shd.pinned(y * F.silu(z)), cfg.norm_eps)
    out = y @ p["wo"]
    if return_state:
        return out, (state, u_in[:, -(cfg.ssm_conv - 1):])
    return out


def mamba_decode(p, x, state, conv_cache, cfg: ArchConfig):
    """One-token decode.  state (B,H,N,P); conv_cache (B,W-1,ch).
    Returns (y, new state, new conv window)."""
    Bb = x.shape[0]
    inner, H, P, N = ssm_dims(cfg)
    z = x @ p["wz"]                                        # (B,1,inner)
    u_t = torch.cat([x @ p["wx"], x @ p["wB"], x @ p["wC"]], -1)
    win = torch.cat([conv_cache, u_t], 1)                  # (B,W,ch)
    u = F.silu(torch.einsum("bwc,wc->bc", win.float(),
                            p["conv"].float()))[:, None]
    xs, Bv, Cv = torch.split(u, [inner, N, N], dim=-1)
    dt = F.softplus((x @ p["wdt"]).float()
                    + p["dt_bias"].float())[:, 0]          # (B,H)
    xh = _heads(xs, Bb, H, P).float()
    y, state = ssd_step(state, dt, p["A_log"], Bv[:, 0].float(),
                        Cv[:, 0].float(), xh, p["D"])
    y = _merge(y, Bb, 1, inner).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["wo"], state, win[:, 1:]
