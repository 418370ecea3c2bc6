"""Model layer zoo: RMSNorm, RoPE, GQA/MLA attention, SwiGLU, MoE.

The port of the reference's ``models.layers``.  Conventions:
  * parameters are nested dicts of tensors (bfloat16, ``PDT``), built by
    ``*_init`` from an explicit ``torch.Generator`` on the device they
    live on; shapes and scales are the reference's, the draws are not;
  * ``*_apply`` are plain functions on tensors; full-sequence
    (train/prefill) and single-token (decode, with KV cache) paths are
    separate functions;
  * the compute dtype follows the inputs and parameters, as in the
    reference: bfloat16 parameters give the reference's bfloat16 model, a
    float32 copy of them a float32 one;
  * attention is plain einsum and a float32 softmax, query-chunked; no
    fused library attention, whose softmax precision differs;
  * MoE uses sort-based dispatch to static-capacity expert batches;
  * decode writes the new token's K/V (or latent) into the cache in place
    at ``pos`` and returns the same tensors: a server keeps one cache, not
    a copy a step.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

PyTree = Any
PDT = torch.bfloat16         # parameter/compute dtype
#: the masked score: finite, as in the reference (not -inf)
NEG = -1e30


def _dense(gen: torch.Generator, shape, scale=None) -> torch.Tensor:
    scale = scale or (1.0 / math.sqrt(shape[0]))
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(PDT)


# ------------------------------------------------------------------ #
# norms / rope
# ------------------------------------------------------------------ #
def rmsnorm_init(d: int, device) -> PyTree:
    return {"scale": torch.ones((d,), dtype=PDT, device=device)}


def rmsnorm(p: PyTree, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalized in float32, cast back to ``x``'s dtype, then scaled."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]


def rope_tables(positions: torch.Tensor, hd: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin tables (..., hd/2)."""
    freqs = 1.0 / (theta ** (torch.arange(
        0, hd, 2, dtype=torch.float32, device=positions.device) / hd))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (..., S, H, hd); cos/sin (..., S, hd/2) broadcast over heads.
    Rotates halves (``x[..., :hd/2]`` with ``x[..., hd/2:]``), not
    interleaved pairs."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], -1).to(x.dtype)


def _positions(start: int, n: int, device) -> torch.Tensor:
    return torch.arange(start, start + n, device=device)


# ------------------------------------------------------------------ #
# chunked softmax attention core
# ------------------------------------------------------------------ #
def _attend(q, k, v, *, causal: bool, q_pos0: int = 0,
            kv_len: Optional[int] = None, q_chunk: int = 1024
            ) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Sk,Hkv,hd) -> (B,Sq,H,hd).

    Query-chunked; the H query heads are grouped (Hkv, g) with each KV
    head's g queries contiguous; float32 scores and softmax, masked with
    ``NEG``.  ``kv_len`` masks a cache filled only up to that length
    (decode).  A ragged tail (whisper's ``enc_len`` 1500) is padded to a
    whole chunk and cut off after.
    """
    B, Sq, H, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    dv = v.shape[-1]
    g = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    kpos = torch.arange(Sk, device=q.device)
    kf, vf = k.float(), v.float()

    def one_chunk(qc, qc_pos):
        # qc (B,Cq,H,hd) -> scores (B,Hkv,g,Cq,Sk) in f32
        Cq = qc.shape[1]
        qg = qc.reshape(B, Cq, Hkv, g, hd).float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) * scale
        mask = torch.ones((Cq, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qc_pos[:, None] >= kpos[None, :]
        if kv_len is not None:
            mask &= kpos[None, :] < kv_len
        s = torch.where(mask, s, NEG)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p, vf)
        return o.reshape(B, Cq, H, dv).to(q.dtype)

    if Sq <= q_chunk:
        return one_chunk(q, _positions(q_pos0, Sq, q.device))
    pad = (-Sq) % q_chunk                 # ragged tail (e.g. enc_len 1500)
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
    outs = [one_chunk(q[:, i:i + q_chunk],
                      _positions(q_pos0 + i, q_chunk, q.device))
            for i in range(0, Sq + pad, q_chunk)]
    return torch.cat(outs, dim=1)[:, :Sq]


# ------------------------------------------------------------------ #
# GQA attention
# ------------------------------------------------------------------ #
def attn_init(gen: torch.Generator, cfg: ArchConfig) -> PyTree:
    d, hd, H, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": _dense(gen, (d, H * hd)),
        "wk": _dense(gen, (d, Hkv * hd)),
        "wv": _dense(gen, (d, Hkv * hd)),
        "wo": _dense(gen, (H * hd, d)),
    }


def attn_qkv(p, x, cfg: ArchConfig, pos0: int = 0):
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, S, Hkv, hd)
    cos, sin = rope_tables(_positions(pos0, S, x.device), hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attn_apply(p, x, cfg: ArchConfig, *, causal=True, return_kv=False):
    """Full-sequence attention (train / prefill)."""
    q, k, v = attn_qkv(p, x, cfg)
    o = _attend(q, k, v, causal=causal)
    y = o.reshape(*x.shape[:2], -1) @ p["wo"]
    return (y, (k, v)) if return_kv else y


def attn_decode(p, x, cache_k, cache_v, pos: int, cfg: ArchConfig):
    """One-token decode. cache_{k,v}: (B, S_max, Hkv, hd), written in place
    at ``pos``."""
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, 1, H, hd)
    k = (x @ p["wk"]).reshape(B, 1, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, 1, Hkv, hd)
    cos, sin = rope_tables(_positions(pos, 1, x.device), hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    cache_k[:, pos] = apply_rope(k, cos, sin)[:, 0]
    cache_v[:, pos] = v[:, 0]
    o = _attend(q, cache_k, cache_v, causal=False, kv_len=pos + 1)
    y = o.reshape(B, 1, H * hd) @ p["wo"]
    return y, cache_k, cache_v


def cross_attn_apply(p, x, kv_src, cfg: ArchConfig):
    """Encoder–decoder cross attention (no cache update, no causal mask)."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (kv_src @ p["wk"]).reshape(B, kv_src.shape[1], Hkv, hd)
    v = (kv_src @ p["wv"]).reshape(B, kv_src.shape[1], Hkv, hd)
    o = _attend(q, k, v, causal=False)
    return o.reshape(B, S, H * hd) @ p["wo"]


# ------------------------------------------------------------------ #
# MLA (DeepSeek-V2 multi-head latent attention)
# ------------------------------------------------------------------ #
def mla_init(gen: torch.Generator, cfg: ArchConfig) -> PyTree:
    d, hd, H = cfg.d_model, cfg.hd, cfg.n_heads
    r, c = cfg.rope_head_dim, cfg.kv_lora
    return {
        "wq": _dense(gen, (d, H * (hd + r))),      # q: nope + rope parts
        "wdkv": _dense(gen, (d, c)),               # down-proj (cached)
        "wkr": _dense(gen, (d, r)),                # shared rope key
        "wuk": _dense(gen, (c, H * hd)),           # up-proj keys
        "wuv": _dense(gen, (c, H * hd)),           # up-proj values
        "wo": _dense(gen, (H * hd, d)),
    }


def mla_apply(p, x, cfg: ArchConfig):
    """Full-sequence MLA (train/prefill): expand latents to per-head k/v."""
    B, S, d = x.shape
    H, hd, r = cfg.n_heads, cfg.hd, cfg.rope_head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd + r)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    ckv = x @ p["wdkv"]                              # (B,S,c) latent
    k_rope = (x @ p["wkr"]).reshape(B, S, 1, r)
    cos, sin = rope_tables(_positions(0, S, x.device), r, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)
    k_nope = (ckv @ p["wuk"]).reshape(B, S, H, hd)
    v = (ckv @ p["wuv"]).reshape(B, S, H, hd)
    qf = torch.cat([q_nope, q_rope], -1)
    kf = torch.cat([k_nope, k_rope.expand(B, S, H, r)], -1)
    o = _attend(qf, kf, v, causal=True)
    return o.reshape(B, S, H * hd) @ p["wo"]


def mla_decode(p, x, cache_c, cache_kr, pos: int, cfg: ArchConfig):
    """One-token MLA decode with weight absorption: the cache holds only the
    latent (c) and the shared rope key (r), written in place at ``pos``;
    ``wuk`` / ``wuv`` are absorbed into the query in float32 and the
    scores scaled by ``1/sqrt(hd + r)``."""
    B = x.shape[0]
    H, hd, r, c = cfg.n_heads, cfg.hd, cfg.rope_head_dim, cfg.kv_lora
    q = (x @ p["wq"]).reshape(B, 1, H, hd + r)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    cos, sin = rope_tables(_positions(pos, 1, x.device), r, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    cache_c[:, pos] = (x @ p["wdkv"])[:, 0]           # (B,c)
    kr_t = (x @ p["wkr"]).reshape(B, 1, 1, r)
    cache_kr[:, pos] = apply_rope(kr_t, cos, sin)[:, 0, 0]
    # absorb wuk into q: q_c (B,1,H,c)
    wuk = p["wuk"].reshape(c, H, hd)
    q_c = torch.einsum("bqhd,chd->bqhc", q_nope.float(), wuk.float())
    cf = cache_c.float()
    s = torch.einsum("bqhc,bsc->bhqs", q_c, cf)
    s = s + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), cache_kr.float())
    s = s * (1.0 / math.sqrt(hd + r))
    mask = torch.arange(cache_c.shape[1], device=x.device) < pos + 1
    s = torch.where(mask, s, NEG)
    pr = torch.softmax(s, dim=-1)
    o_c = torch.einsum("bhqs,bsc->bqhc", pr, cf)
    wuv = p["wuv"].reshape(c, H, hd)
    o = torch.einsum("bqhc,chd->bqhd", o_c, wuv.float())
    y = o.reshape(B, 1, H * hd).to(x.dtype) @ p["wo"]
    return y, cache_c, cache_kr


# ------------------------------------------------------------------ #
# FFN: SwiGLU + MoE
# ------------------------------------------------------------------ #
def swiglu_init(gen: torch.Generator, d: int, f: int) -> PyTree:
    return {"w1": _dense(gen, (d, f)), "w3": _dense(gen, (d, f)),
            "w2": _dense(gen, (f, d))}


def swiglu_apply(p, x):
    return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]


def moe_init(gen: torch.Generator, cfg: ArchConfig) -> PyTree:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p = {
        "router": _dense(gen, (d, E), scale=0.02),
        "w1": _dense(gen, (E, d, f)),
        "w3": _dense(gen, (E, d, f)),
        "w2": _dense(gen, (E, f, d)),
    }
    if cfg.n_shared_experts:
        p["shared"] = swiglu_init(gen, d, f * cfg.n_shared_experts)
    return p


def moe_apply(p, x, cfg: ArchConfig):
    """Sort-based static-capacity MoE.  x (B,S,d) -> ((B,S,d), aux).

    Tokens are flattened, routed top-k (ties to the lower expert index),
    stably sorted by expert, truncated at capacity C = T·k/E·cf (so prefill
    and decode route under different capacities, as in the reference),
    processed as (E, C, d) batched products against the stacked expert
    weights, and combined back by a float32 weighted scatter-add.  A
    dropped token's slot is column C, cut off.  The GShard aux
    load-balancing loss is the second output.
    """
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    C = max(8, int(T * K / E * cfg.capacity_factor))
    dev = x.device
    xt = x.reshape(T, d)
    logits = (xt @ p["router"]).float()                      # (T,E)
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = srt.values[:, :K], srt.indices[:, :K]        # (T,K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat_e = idx.reshape(-1)                                 # (T*K,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    flat_g = gate.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    pos = torch.arange(T * K, device=dev) - \
        torch.searchsorted(se, se, side="left")
    keep = pos < C
    slot = torch.where(keep, pos, C)
    disp = torch.full((E, C + 1), T, dtype=torch.long, device=dev)
    disp[se, slot] = torch.where(keep, st, T)
    disp = disp[:, :C]
    gsc = torch.zeros((E, C + 1), dtype=torch.float32, device=dev)
    gsc[se, slot] = torch.where(keep, sg, 0.0)
    gsc = gsc[:, :C]
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))], 0)
    xe = xt_pad[disp]                                        # (E,C,d)
    h = F.silu(torch.bmm(xe, p["w1"])) * torch.bmm(xe, p["w3"])
    ye = torch.bmm(h, p["w2"])                               # (E,C,d)
    y = torch.zeros((T + 1, d), dtype=torch.float32, device=dev)
    y.index_add_(0, disp.reshape(-1),
                 (ye.float() * gsc[..., None]).reshape(-1, d))
    y = y[:T].to(x.dtype).reshape(B, S, d)
    if cfg.n_shared_experts:
        y = y + swiglu_apply(p["shared"], x)
    # GShard aux loss: E * Σ_e (token-frac_e · prob-frac_e)
    frac_tokens = F.one_hot(idx, E).float().sum(1).mean(0)
    frac_probs = probs.mean(0)
    aux = E * torch.sum(frac_tokens * frac_probs) / K
    return y, aux
