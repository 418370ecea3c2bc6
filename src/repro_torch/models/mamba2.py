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
from repro_torch.models.layers import PDT, _dense, rmsnorm, rmsnorm_init

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
    """Depthwise causal conv. u (B,S,ch), kern (W,ch)."""
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


def mamba_apply(p, x, cfg: ArchConfig, chunk: int = 256,
                return_state: bool = False):
    """Full-sequence Mamba-2 block (train / prefill).  With
    ``return_state``, also (final state, the last W-1 conv inputs)."""
    Bb, S, d = x.shape
    inner, H, P, N = ssm_dims(cfg)
    z = x @ p["wz"]                                        # (B,S,inner)
    u_in = torch.cat([x @ p["wx"], x @ p["wB"], x @ p["wC"]], -1)
    u = F.silu(_causal_conv(u_in, p["conv"]))
    xs, Bv, Cv = torch.split(u, [inner, N, N], dim=-1)
    dt = F.softplus((x @ p["wdt"]).float() + p["dt_bias"].float())
    xh = xs.reshape(Bb, S, H, P)
    ch = min(chunk, S) if S % chunk else chunk
    y, state = ssd_chunked(xh, dt, p["A_log"], Bv, Cv, ch)
    y = y + p["D"][None, None, :, None].to(y.dtype) * xh
    y = y.reshape(Bb, S, inner)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
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
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                                 # (B,H)
    xh = xs.reshape(Bb, H, P).float()
    state = state * dA[..., None, None] + torch.einsum(
        "bn,bh,bhp->bhnp", Bv[:, 0].float(), dt, xh)
    y = torch.einsum("bn,bhnp->bhp", Cv[:, 0].float(), state)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(Bb, 1, inner).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["wo"], state, win[:, 1:]
