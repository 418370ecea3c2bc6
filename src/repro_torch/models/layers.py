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
from repro_torch.models import sharding as shd

PyTree = Any
PDT = torch.bfloat16         # parameter/compute dtype

#: perf knob (the reference's §Perf B): when set (a ``sharding.
#: NamedSharding`` for (E, C, d)), the MoE dispatch/combine over DTensors
#: splits as it says (capacity over the data axes as well as experts over
#: the model axis; ``_expert_placements``).  Configured by
#: ``launch.dryrun``; plain tensors never read it.
MOE_SHARD_DISPATCH = False
MOE_DISPATCH_SPEC = None
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


def _heads(t: torch.Tensor, *shape) -> torch.Tensor:
    """``t`` (..., H * hd) viewed as ``shape`` (..., H, hd).  A DTensor
    split on its last dim over mesh dims that do not divide H is gathered
    on that dim first (a view cannot split a head)."""
    return shd.heads_ready(t, shape[-2]).reshape(*shape)


def _merge(o: torch.Tensor, *shape) -> torch.Tensor:
    """``o`` (..., H, hd) viewed as ``shape`` (..., H * hd); over a
    DTensor its gradient is made ready for the heads' view."""
    return shd.heads_merged(o.reshape(*shape), o.shape[-2])


def _positions(start: int, n: int, device) -> torch.Tensor:
    return torch.arange(start, start + n, device=device)


def embed_lookup(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``emb[tokens]``.  Over DTensors each card looks up its batch rows
    in its own vocab rows (split on the model axis where they divide; a
    token outside them gives zeros) and the sum over the model axis is
    left pending (``Partial``), as a vocab-parallel embedding does."""
    mesh = shd.mesh_of(emb, tokens)
    if mesh is None:
        return emb[tokens]
    split = shd.vocab_split(mesh, emb.shape[0])
    tpl = shd.batch_heads(mesh, tokens.shape[0], None)

    def local(e, t):
        if not split:
            return e[t]
        i = t - mesh.get_local_rank(shd.TP_AXIS) * e.shape[0]
        inside = (i >= 0) & (i < e.shape[0])
        return e[i.clamp(0, e.shape[0] - 1)] * inside[..., None].to(e.dtype)
    return shd.local_map(local, mesh, (emb, tokens),
                         (shd.heads_only(mesh, 0 if split else None), tpl),
                         shd.model_sum(mesh, tpl) if split else tpl)


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
    mesh = shd.mesh_of(q, k, v)
    if mesh is not None:
        return _attend_sharded(mesh, q, k, v, causal=causal, q_pos0=q_pos0,
                               kv_len=kv_len, q_chunk=q_chunk)
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


def _attend_sharded(mesh, q, k, v, **kw):
    """``_attend`` over DTensors: each card attends its batch rows and its
    heads (the query heads split on the model axis where they divide,
    else whole), on its local shards.  Where the KV heads do not divide
    the axis, each card takes the KV heads its query heads read (the
    reference's XLA re-shards them silently; a DTensor view cannot split
    a head)."""
    B, _, H, _ = q.shape
    Hkv = k.shape[2]
    tp = mesh.shape[tuple(mesh.mesh_dim_names).index(shd.TP_AXIS)]
    split = H % tp == 0
    kv_split = split and Hkv % tp == 0
    qpl = shd.batch_heads(mesh, B, 2 if split else None)
    kvpl = shd.batch_heads(mesh, B, 2 if kv_split else None)
    ql = shd.to_local(q, mesh, qpl)
    gpl = shd.summed_grad(kvpl, qpl)
    kl, vl = shd.to_local(k, mesh, kvpl, gpl), shd.to_local(v, mesh, kvpl,
                                                            gpl)
    if split and not kv_split:
        hl, g = H // tp, H // Hkv
        r = mesh.get_local_rank(shd.TP_AXIS)
        idx = torch.arange(r * hl, (r + 1) * hl, device=kl.device) // g
        kl, vl = kl[:, :, idx], vl[:, :, idx]
    return shd.from_local(_attend(ql, kl, vl, **kw), mesh, qpl)


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
    q = _heads(x @ p["wq"], B, S, H, hd)
    k = _heads(x @ p["wk"], B, S, Hkv, hd)
    v = _heads(x @ p["wv"], B, S, Hkv, hd)
    cos, sin = rope_tables(_positions(pos0, S, x.device), hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attn_apply(p, x, cfg: ArchConfig, *, causal=True, return_kv=False):
    """Full-sequence attention (train / prefill)."""
    q, k, v = attn_qkv(p, x, cfg)
    o = _attend(q, k, v, causal=causal)
    y = _merge(o, *x.shape[:2], -1) @ p["wo"]
    return (y, (k, v)) if return_kv else y


def attn_decode(p, x, cache_k, cache_v, pos: int, cfg: ArchConfig):
    """One-token decode. cache_{k,v}: (B, S_max, Hkv, hd), written in place
    at ``pos``."""
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _heads(x @ p["wq"], B, 1, H, hd)
    k = _heads(x @ p["wk"], B, 1, Hkv, hd)
    v = _heads(x @ p["wv"], B, 1, Hkv, hd)
    cos, sin = rope_tables(_positions(pos, 1, x.device), hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    shd.write_at(cache_k, 1, pos, apply_rope(k, cos, sin)[:, 0])
    shd.write_at(cache_v, 1, pos, v[:, 0])
    o = _attend(q, cache_k, cache_v, causal=False, kv_len=pos + 1)
    y = _merge(o, B, 1, H * hd) @ p["wo"]
    return y, cache_k, cache_v


def cross_attn_apply(p, x, kv_src, cfg: ArchConfig):
    """Encoder–decoder cross attention (no cache update, no causal mask)."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _heads(x @ p["wq"], B, S, H, hd)
    k = _heads(kv_src @ p["wk"], B, kv_src.shape[1], Hkv, hd)
    v = _heads(kv_src @ p["wv"], B, kv_src.shape[1], Hkv, hd)
    o = _attend(q, k, v, causal=False)
    return _merge(o, B, S, H * hd) @ p["wo"]


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
    q = _heads(x @ p["wq"], B, S, H, hd + r)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    ckv = x @ p["wdkv"]                              # (B,S,c) latent
    k_rope = (x @ p["wkr"]).reshape(B, S, 1, r)
    cos, sin = rope_tables(_positions(0, S, x.device), r, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)
    k_nope = _heads(ckv @ p["wuk"], B, S, H, hd)
    v = _heads(ckv @ p["wuv"], B, S, H, hd)
    qf = torch.cat([q_nope, q_rope], -1)
    kf = torch.cat([k_nope, k_rope.expand(B, S, H, r)], -1)
    o = _attend(qf, kf, v, causal=True)
    return _merge(o, B, S, H * hd) @ p["wo"]


def mla_decode(p, x, cache_c, cache_kr, pos: int, cfg: ArchConfig):
    """One-token MLA decode with weight absorption: the cache holds only the
    latent (c) and the shared rope key (r), written in place at ``pos``;
    ``wuk`` / ``wuv`` are absorbed into the query in float32 and the
    scores scaled by ``1/sqrt(hd + r)``."""
    B = x.shape[0]
    H, hd, r, c = cfg.n_heads, cfg.hd, cfg.rope_head_dim, cfg.kv_lora
    q = _heads(x @ p["wq"], B, 1, H, hd + r)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    cos, sin = rope_tables(_positions(pos, 1, x.device), r, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    shd.write_at(cache_c, 1, pos, (x @ p["wdkv"])[:, 0])      # (B,c)
    kr_t = (x @ p["wkr"]).reshape(B, 1, 1, r)
    shd.write_at(cache_kr, 1, pos, apply_rope(kr_t, cos, sin)[:, 0, 0])
    wuk = _heads(p["wuk"], c, H, hd)
    wuv = _heads(p["wuv"], c, H, hd)
    o = _mla_absorbed(q_nope, q_rope, cache_c, cache_kr, wuk, wuv, pos)
    y = _merge(o, B, 1, H * hd).to(x.dtype) @ p["wo"]
    return y, cache_c, cache_kr


def _mla_absorbed(q_nope, q_rope, cache_c, cache_kr, wuk, wuv, pos: int):
    """MLA decode's attention with ``wuk`` / ``wuv`` (c, H, hd) absorbed:
    q_nope (B,1,H,hd), q_rope (B,1,H,r), the latent caches (B,S,c) and
    (B,S,r) -> (B,1,H,hd) float32.  Over DTensors each card attends its
    batch rows and its heads on its local shards, the caches whole."""
    mesh = shd.mesh_of(q_nope, cache_c, wuk)
    if mesh is not None:
        B, _, H, _ = q_nope.shape
        h = 2 if shd.heads_split(mesh, H) else None
        qpl = shd.batch_heads(mesh, B, h)
        cpl = shd.batch_heads(mesh, B, None)
        wpl = shd.heads_only(mesh, None if h is None else 1)
        return shd.local_map(
            lambda *a: _mla_absorbed(*a, pos), mesh,
            (q_nope, q_rope, cache_c, cache_kr, wuk, wuv),
            (qpl, qpl, cpl, cpl, wpl, wpl), qpl)
    hd, r = q_nope.shape[-1], q_rope.shape[-1]
    # absorb wuk into q: q_c (B,1,H,c)
    q_c = torch.einsum("bqhd,chd->bqhc", q_nope.float(), wuk.float())
    cf = cache_c.float()
    s = torch.einsum("bqhc,bsc->bhqs", q_c, cf)
    s = s + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), cache_kr.float())
    s = s * (1.0 / math.sqrt(hd + r))
    mask = torch.arange(cache_c.shape[1], device=cf.device) < pos + 1
    s = torch.where(mask, s, NEG)
    pr = torch.softmax(s, dim=-1)
    o_c = torch.einsum("bhqs,bsc->bqhc", pr, cf)
    return torch.einsum("bqhc,chd->bqhd", o_c, wuv.float())


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


def _expert_placements(mesh, shape) -> tuple:
    """How the (E, C, d) dispatch splits over ``mesh``: the experts on the
    model axis where they divide (as their weights split), and as
    ``MOE_DISPATCH_SPEC`` says when the hook is set (capacity over the
    data axes), each where it splits evenly."""
    if MOE_SHARD_DISPATCH and MOE_DISPATCH_SPEC is not None:
        return shd.even(MOE_DISPATCH_SPEC.placements, shape, mesh)
    return shd.heads_only(mesh, 0 if shd.heads_split(mesh, shape[0])
                          else None)


def _route(logits: torch.Tensor, K: int, C: int):
    """The router's bookkeeping on (T, E) float32 logits: the
    probabilities, the top-k experts (T, K), and the dispatch table (E, C)
    of token ids (T for an empty slot) with its gates."""
    T, E = logits.shape
    dev = logits.device
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
    gsc = torch.zeros((E, C + 1), dtype=torch.float32, device=dev)
    gsc[se, slot] = torch.where(keep, sg, 0.0)
    return probs, idx, disp[:, :C], gsc[:, :C]


def moe_apply(p, x, cfg: ArchConfig):
    """Sort-based static-capacity MoE.  x (B,S,d) -> ((B,S,d), aux).

    Tokens are flattened, routed top-k (ties to the lower expert index),
    stably sorted by expert, truncated at capacity C = T·k/E·cf (so prefill
    and decode route under different capacities, as in the reference),
    processed as (E, C, d) batched products against the stacked expert
    weights, and combined back by a float32 weighted scatter-add.  A
    dropped token's slot is column C, cut off.  The GShard aux
    load-balancing loss is the second output.

    Over DTensors the router's logits and the tokens are gathered whole
    (an all-gather over the data axes) and every card routes the whole
    batch alike; each card then gathers, runs and combines only its own
    part of the (E, C, d) dispatch (its experts, as their weights split;
    with ``MOE_DISPATCH_SPEC`` also its share of the capacity), and the
    sum over cards is left pending (``Partial``) for the residual's
    reduce-scatter.
    """
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    C = max(8, int(T * K / E * cfg.capacity_factor))
    xt = x.reshape(T, d)
    logits = (xt @ p["router"]).float()                      # (T,E)
    mesh = shd.mesh_of(xt)
    experts = p
    if mesh is not None:                 # route the whole batch, alike
        pl = _expert_placements(mesh, (E, C, d))
        xt = shd.replicated_local(xt, pl)
        logits = shd.replicated_local(logits, pl)
    probs, idx, disp, gsc = _route(logits, K, C)
    dev = xt.device
    if mesh is not None:                 # this card's experts and slots
        rows, cols, _ = shd.local_slices((E, C, d), mesh, pl)
        disp, gsc = disp[rows, cols], gsc[rows, cols]
        split_e = any(isinstance(q, shd.Shard) and q.dim == 0 for q in pl)
        wpl = shd.heads_only(mesh, 0 if split_e else None)
        experts = {k: shd.to_local(p[k], mesh, wpl, shd.summed_grad(wpl, pl))
                   for k in ("w1", "w3", "w2")}
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))], 0)
    xe = xt_pad[disp]                                        # (E,C,d)
    h = F.silu(torch.bmm(xe, experts["w1"])) * torch.bmm(xe, experts["w3"])
    ye = torch.bmm(h, experts["w2"])                         # (E,C,d)
    y = torch.zeros((T + 1, d), dtype=torch.float32, device=dev)
    y.index_add_(0, disp.reshape(-1),
                 (ye.float() * gsc[..., None]).reshape(-1, d))
    y = y[:T].to(x.dtype).reshape(B, S, d)
    if mesh is not None:
        y = shd.from_local(y, mesh, shd.pending_sum(pl))
    if cfg.n_shared_experts:
        y = y + swiglu_apply(p["shared"], x)
    # GShard aux loss: E * Σ_e (token-frac_e · prob-frac_e)
    frac_tokens = F.one_hot(idx, E).float().sum(1).mean(0)
    frac_probs = probs.mean(0)
    aux = E * torch.sum(frac_tokens * frac_probs) / K
    if mesh is not None:                 # alike on every card
        aux = shd.from_local(shd.counted_once(aux, mesh, pl), mesh,
                             shd.replicated(mesh))
    return y, aux
