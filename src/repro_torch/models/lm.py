"""Unified causal LM over per-layer patterns, with enc-dec support.

The port of the reference's ``models.lm``.  One model covers all 10
assigned architectures:
  * per-layer descriptors (mixer ∈ {attn, mla, ssm}, ffn ∈ {dense, moe,
    moe+dense, none}) derived from the ArchConfig;
  * homogeneous runs of layers form groups of a (possibly multi-layer)
    super-block repeated ``count`` times; a repeated group's parameters
    and caches are stacked on a leading ``count`` axis, as in the
    reference, and a Python loop walks it (the reference's ``lax.scan``);
    layer ``i`` reads views ``a[i]``, no copies;
  * in training, each repetition of a repeated group's super-block and
    each encoder layer is checkpointed (remat), where the reference wraps
    ``jax.checkpoint``: only while grad is enabled, so serving runs the
    plain code;
  * decode threads per-layer caches through the same groups, writing
    each new token's entries in place.

Parameters are the reference's tree: nested dicts (and the ``groups``
list) of tensors, bfloat16 except the SSM's ``A_log`` and ``D``.  The
compute dtype follows the embedding's dtype, which for these parameters
is the reference's ``PDT``; a float32 copy of them runs the same code in
float32.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.sharding import NO_SHARD, ShardCfg, reduce_partial
from repro_torch.util import resolve_device

PyTree = Any

#: remat policy for the per-layer checkpoint: "full" recomputes everything
#: (min memory, max recompute flops); "dots" saves matmul outputs (the
#: reference's ``dots_with_no_batch_dims_saveable``: plain matrix
#: products, not batched ones); "none" checkpoints nothing.
REMAT_POLICY = "full"

#: the aten ops of a matmul without batch dims (``x @ w`` on a (B, S, d)
#: activation folds to ``mm``); ``bmm`` (einsums, the MoE's experts) has
#: a batch dim and is recomputed, as in the reference
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn):
    """``fn`` checkpointed under ``REMAT_POLICY`` while grad is enabled;
    ``fn`` itself otherwise (serving, ``torch.no_grad``)."""
    @functools.wraps(fn)
    def run(*args):
        if REMAT_POLICY == "none" or not torch.is_grad_enabled():
            return fn(*args)
        if REMAT_POLICY == "dots":
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=functools.partial(
                                  create_selective_checkpoint_contexts,
                                  _save_dots))
        if REMAT_POLICY != "full":
            raise ValueError(f"unknown REMAT_POLICY {REMAT_POLICY!r}")
        return checkpoint(fn, *args, use_reentrant=False)
    return run


def _take(tree: PyTree, i: int) -> PyTree:
    """Layer ``i`` of a stacked group: a view of each leaf."""
    return {k: _take(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _stack(trees: List[PyTree]) -> PyTree:
    """Stack same-structured trees on a new leading axis."""
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def generator(seed: int, device=None) -> torch.Generator:
    """A seeded generator on the device the model will live on (the card
    unless ``device`` names the CPU), for ``init_params``."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


# ------------------------------------------------------------------ #
# layer descriptors and grouping
# ------------------------------------------------------------------ #
def layer_descs(cfg: ArchConfig) -> List[Tuple[str, str]]:
    descs = []
    for kind, ffn in zip(cfg.layer_kinds(), cfg.layer_ffn()):
        mixer = "ssm" if kind == "ssm" else ("mla" if cfg.mla else "attn")
        if kind == "ssm" and not cfg.moe and cfg.d_ff == 0:
            ffn = "none"                       # pure mamba block
        elif ffn == "moe" and cfg.dense_residual:
            ffn = "moe+dense"
        descs.append((mixer, ffn))
    return descs


def group_descs(descs: List[Tuple[str, str]]
                ) -> List[Tuple[int, List[Tuple[str, str]]]]:
    """-> [(repeat_count, super_block_descs), ...] with minimal period."""
    groups = []
    rest = list(descs)
    while rest:
        found = None
        for p in range(1, len(rest) + 1):
            if len(rest) % p == 0 and rest == rest[:p] * (len(rest) // p):
                found = p
                break
        if found is not None and len(rest) // found > 1:
            groups.append((len(rest) // found, rest[:found]))
            rest = []
        else:
            groups.append((1, rest[:1]))       # peel non-repeating head
            rest = rest[1:]
    return groups


# ------------------------------------------------------------------ #
# per-layer init / apply
# ------------------------------------------------------------------ #
def _block_init(gen: torch.Generator, desc: Tuple[str, str],
                cfg: ArchConfig, cross: bool = False) -> PyTree:
    mixer, ffn = desc
    dev = gen.device
    p: Dict[str, PyTree] = {"norm1": L.rmsnorm_init(cfg.d_model, dev)}
    if mixer == "attn":
        p["attn"] = L.attn_init(gen, cfg)
    elif mixer == "mla":
        p["attn"] = L.mla_init(gen, cfg)
    else:
        p["ssm"] = M.mamba_init(gen, cfg)
    if cross:
        p["normx"] = L.rmsnorm_init(cfg.d_model, dev)
        p["xattn"] = L.attn_init(gen, cfg)
    if ffn != "none":
        p["norm2"] = L.rmsnorm_init(cfg.d_model, dev)
    if ffn in ("moe", "moe+dense"):
        p["moe"] = L.moe_init(gen, cfg)
    if ffn in ("dense", "moe+dense"):
        p["mlp"] = L.swiglu_init(gen, cfg.d_model, cfg.d_ff)
    return p


def _ffn(p, x, cfg: ArchConfig, shard: ShardCfg = NO_SHARD):
    """The block's FFN sum (MoE and/or dense MLP) on normed ``h``, and the
    MoE's aux loss (None without one)."""
    h = shard.act_gathered(L.rmsnorm(p["norm2"], x, cfg.norm_eps))
    add, aux = None, None
    if "moe" in p:
        add, aux = L.moe_apply(p["moe"], h, cfg)
    if "mlp" in p:
        mlp = L.swiglu_apply(p["mlp"], h)
        add = mlp if add is None else add + mlp
    return add, aux


def _block_apply(p, x, desc, cfg: ArchConfig, shard: ShardCfg,
                 enc_out=None, causal=True):
    """Full-sequence block.  Returns (x, aux_loss)."""
    mixer, ffn = desc
    h = shard.act_gathered(L.rmsnorm(p["norm1"], x, cfg.norm_eps))
    if mixer == "attn":
        h = L.attn_apply(p["attn"], h, cfg, causal=causal)
    elif mixer == "mla":
        h = L.mla_apply(p["attn"], h, cfg)
    else:
        h = M.mamba_apply(p["ssm"], h, cfg)
    x = x + shard.act_residual(h)
    if "xattn" in p:
        h = shard.act_gathered(L.rmsnorm(p["normx"], x, cfg.norm_eps))
        x = x + shard.act_residual(
            L.cross_attn_apply(p["xattn"], h, enc_out, cfg))
    aux = None
    if ffn != "none":
        add, aux = _ffn(p, x, cfg, shard)
        x = x + shard.act_residual(add)
    return shard.act_residual(x), aux


def _block_cache_init(desc, cfg: ArchConfig, lead: Tuple[int, ...], B: int,
                      S_max: int, device, dtype, cross: bool = False
                      ) -> PyTree:
    mixer, _ = desc

    def zeros(*shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=device)
    c: Dict[str, torch.Tensor] = {}
    if mixer == "attn":
        c["k"] = zeros(B, S_max, cfg.n_kv_heads, cfg.hd)
        c["v"] = zeros(B, S_max, cfg.n_kv_heads, cfg.hd)
    elif mixer == "mla":
        c["c"] = zeros(B, S_max, cfg.kv_lora)
        c["kr"] = zeros(B, S_max, cfg.rope_head_dim)
    else:
        inner, H, P_, N = M.ssm_dims(cfg)
        c["state"] = zeros(B, H, N, P_, dt=torch.float32)
        c["conv"] = zeros(B, cfg.ssm_conv - 1, inner + 2 * N)
    if cross:
        c["xk"] = zeros(B, cfg.enc_len, cfg.n_kv_heads * cfg.hd)
        c["xv"] = zeros(B, cfg.enc_len, cfg.n_kv_heads * cfg.hd)
    return c


def _block_decode(p, x, cache, pos: int, desc, cfg: ArchConfig):
    """One-token block; writes the token's cache entries in place."""
    mixer, ffn = desc
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if mixer == "attn":
        h, _, _ = L.attn_decode(p["attn"], h, cache["k"], cache["v"], pos,
                                cfg)
    elif mixer == "mla":
        h, _, _ = L.mla_decode(p["attn"], h, cache["c"], cache["kr"], pos,
                               cfg)
    else:
        h, st, cv = M.mamba_decode(p["ssm"], h, cache["state"],
                                   cache["conv"], cfg)
        cache["state"].copy_(st)
        cache["conv"].copy_(cv)
    x = x + h
    if "xattn" in p:                           # cross-attn from cached enc KV
        hq = L.rmsnorm(p["normx"], x, cfg.norm_eps)
        B = x.shape[0]
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q = L._heads(hq @ p["xattn"]["wq"], B, 1, H, hd)
        k = L._heads(cache["xk"], B, cfg.enc_len, Hkv, hd)
        v = L._heads(cache["xv"], B, cfg.enc_len, Hkv, hd)
        o = L._attend(q, k, v, causal=False)
        x = x + L._merge(o, B, 1, H * hd) @ p["xattn"]["wo"]
    if ffn != "none":
        add, _ = _ffn(p, x, cfg)
        x = x + add
    return x


# ------------------------------------------------------------------ #
# model init
# ------------------------------------------------------------------ #
def init_params(gen: torch.Generator, cfg: ArchConfig) -> PyTree:
    """Random parameters with the reference's tree, shapes and scales,
    drawn from ``gen`` on its device (``generator(seed, device)``)."""
    d = cfg.d_model
    params: Dict[str, PyTree] = {
        "embed": L._dense(gen, (cfg.vocab, d), scale=0.02),
        "final_norm": L.rmsnorm_init(d, gen.device),
        "unembed": L._dense(gen, (d, cfg.vocab)),
    }
    cross = cfg.enc_dec
    gparams = []
    for count, block in group_descs(layer_descs(cfg)):
        def one(block=block):
            return {f"p{i}": _block_init(gen, desc, cfg, cross=cross)
                    for i, desc in enumerate(block)}
        gparams.append(one() if count == 1 else
                       _stack([one() for _ in range(count)]))
    params["groups"] = gparams
    if cfg.enc_dec:
        params["enc"] = _stack([
            {"p0": _block_init(gen, ("attn", "dense"), cfg)}
            for _ in range(cfg.n_enc_layers)])
        params["enc_norm"] = L.rmsnorm_init(d, gen.device)
    if cfg.frontend == "patches":
        params["patch_proj"] = L._dense(gen, (d, d))
    return params


# ------------------------------------------------------------------ #
# forward (train / prefill)
# ------------------------------------------------------------------ #
def _layers(gp: PyTree, count: int):
    """The ``count`` layers' parameters (or caches) of one group: views,
    by one ``unbind`` a leaf, whose backward stacks the layers'
    gradients in one op (a ``select`` a layer would write a zero-filled
    copy of the whole stacked leaf for each layer, then sum them)."""
    if count == 1:
        return [gp]

    def unbind(t):
        return {k: unbind(v) if isinstance(v, dict) else v.unbind(0)
                for k, v in t.items()}
    layers = unbind(gp)
    return [_take(layers, i) for i in range(count)]


def _embed(params, cfg: ArchConfig, batch: Dict[str, Any]) -> torch.Tensor:
    """Token embeddings, the ``patches`` frontend's projections written
    over the first ``n_patches`` positions."""
    emb = params["embed"]
    tokens = torch.as_tensor(batch["tokens"], device=emb.device)
    x = L.embed_lookup(emb, tokens)
    if cfg.frontend == "patches" and "patches" in batch:
        patches = torch.as_tensor(batch["patches"], device=emb.device)
        proj = patches.to(emb.dtype) @ params["patch_proj"]
        proj = proj[:, :min(cfg.n_patches, x.shape[1])]
        x = reduce_partial(x)
        x[:, :proj.shape[1]] = proj
    return x


def _encode(params, cfg: ArchConfig, batch: Dict[str, Any],
            shard: ShardCfg) -> torch.Tensor:
    """Whisper's encoder over the frame embeddings (frontend stub), run
    once a call, normed."""
    emb = params["embed"]
    e = torch.as_tensor(batch["frames"], device=emb.device).to(emb.dtype)
    e = _run_encoder(params, cfg, shard.act_residual(e), shard)
    return shard.act_gathered(L.rmsnorm(params["enc_norm"], e, cfg.norm_eps))


def _run_encoder(params, cfg, e, shard):
    """Every encoder layer checkpointed, as the reference's scan body."""
    @_remat
    def enc_body(xx, bp):
        xx, _ = _block_apply(bp["p0"], xx, ("attn", "dense"), cfg, shard,
                             causal=False)
        return xx
    for bp in _layers(params["enc"], cfg.n_enc_layers):
        e = enc_body(e, bp)
    return e


def _run_groups(params, cfg, x, shard, enc_out=None, causal=True):
    """The groups in order; a repeated group's super-block checkpointed
    once a repetition (however many layers it holds), a ``count == 1``
    group's not, as in the reference."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for (count, block), gp in zip(group_descs(layer_descs(cfg)),
                                  params["groups"]):
        def super_block(xx, bp, block=block):
            a_tot = None
            for i, desc in enumerate(block):
                xx, a = _block_apply(bp[f"p{i}"], xx, desc, cfg, shard,
                                     enc_out=enc_out, causal=causal)
                if a is not None:
                    a_tot = a if a_tot is None else a_tot + a
            return xx, a_tot
        body = super_block if count == 1 else _remat(super_block)
        for bp in _layers(gp, count):
            x, a = body(x, bp)
            if a is not None:
                aux_total = aux_total + a
    return x, aux_total


def forward(params, cfg: ArchConfig, batch: Dict[str, Any],
            shard: ShardCfg = NO_SHARD) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward on the parameters' device.  ``batch`` holds
    ``tokens`` (B, S) and, per frontend, ``frames`` / ``patches`` (numpy
    arrays or tensors).  Returns (logits, aux_loss)."""
    x = shard.act_residual(_embed(params, cfg, batch))
    enc_out = _encode(params, cfg, batch, shard) if cfg.enc_dec else None
    x, aux = _run_groups(params, cfg, x, shard, enc_out=enc_out)
    x = shard.act_gathered(L.rmsnorm(params["final_norm"], x, cfg.norm_eps))
    logits = x @ params["unembed"]
    return shard.act_logits(logits), aux


# ------------------------------------------------------------------ #
# decode
# ------------------------------------------------------------------ #
def init_caches(cfg: ArchConfig, B: int, S_max: int, device=None,
                dtype: torch.dtype = L.PDT) -> PyTree:
    """Zeroed caches with the groups' structure (a repeated group's
    stacked on ``count``), on the card unless ``device`` names the CPU."""
    dev = resolve_device(device)
    return [{f"p{i}": _block_cache_init(
                desc, cfg, () if count == 1 else (count,), B, S_max, dev,
                dtype, cross=cfg.enc_dec)
             for i, desc in enumerate(block)}
            for count, block in group_descs(layer_descs(cfg))]


def decode_step(params, cfg: ArchConfig, token, caches: PyTree, pos: int,
                shard: ShardCfg = NO_SHARD) -> Tuple[torch.Tensor, PyTree]:
    """One decode step.  token (B,1) int; pos the token's position.  The
    caches are updated in place and returned."""
    pos = int(pos)
    x = _embed(params, cfg, {"tokens": token})
    for (count, block), gp, gc in zip(group_descs(layer_descs(cfg)),
                                      params["groups"], caches):
        for bp, bc in zip(_layers(gp, count), _layers(gc, count)):
            for i, desc in enumerate(block):
                x = _block_decode(bp[f"p{i}"], x, bc[f"p{i}"], pos, desc,
                                  cfg)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = x @ params["unembed"]
    return shard.act_logits(logits), caches
