"""Serving engine: prefill (cache-building) and batched decode steps.

The port of the reference's ``serve.engine``.  Prefill mirrors the
forward but captures per-layer KV/state caches, padded to ``pad_to``
positions, with the groups' structure (a repeated group's stacked on its
``count`` axis); decode threads the caches through ``lm.decode_step``,
which writes each new token's entries in place.  Each entry point runs
on the card unless the caller passes ``device="cpu"``, and the
parameters must already live there.

Under a ``ShardCfg`` with a mesh (the reference jits these entry points
with ``in_shardings`` / ``out_shardings``; the port places explicitly):
the parameters are placed by ``sharding.param_specs``, the batch and
the decode token by ``sharding.batch_specs`` (``train.step.place_batch``),
and ``prefill`` returns its caches placed by ``sharding.cache_specs``
(``place_caches``), on which each decode step writes in place.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.lm import (_embed, _encode, _ffn, _layers, _stack,
                                   decode_step, group_descs, layer_descs)
from repro_torch.models import sharding as shd
from repro_torch.models.sharding import NO_SHARD, ShardCfg
from repro_torch.util import resolve_device

PyTree = Any


def _on(params, device) -> torch.device:
    """The resolved device, after checking that the parameters live
    there (no quiet copy between the card and the host)."""
    dev = resolve_device(device)
    have = params["embed"].device
    if have.type != dev.type:
        raise ValueError(f"the parameters live on {have}, not on {dev}: "
                         "move them, or pass the device they live on")
    return dev


def _pad_seq(a: torch.Tensor, pad_to) -> torch.Tensor:
    """``a`` (B, S, ...) zero-padded to (B, pad_to, ...).  Over DTensors
    ``new_zeros`` is replicated and ``a`` whole on the sequence (prefill's
    k / v / latents come from the gathered activations), so the slice
    write lands; ``place_caches`` splits the result afterwards."""
    if pad_to is None or a.shape[1] == pad_to:
        return a
    out = a.new_zeros((a.shape[0], pad_to) + tuple(a.shape[2:]))
    out[:, :a.shape[1]] = a
    return out


def place_caches(caches: PyTree, shard: ShardCfg) -> PyTree:
    """``caches`` placed by ``sharding.cache_specs`` over ``shard.mesh``
    (each dim that its axes do not split evenly whole): a DTensor leaf
    redistributed, a plain one (alike on every card) distributed with
    each card keeping its own shard.  Without a mesh they are returned
    as they are."""
    if shard.mesh is None:
        return caches
    mesh = shard.mesh

    def one(x, spec):
        pl = shd.even(shd.placements(spec, mesh), x.shape, mesh)
        if not isinstance(x, DTensor):
            return distribute_tensor(x, mesh, pl, src_data_rank=None)
        return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
    return tree.map(one, caches, shd.cache_specs(caches, shard))


def _prefill_block(p, x, desc, cfg, shard, enc_out, pad_to):
    """Block apply that also returns its cache (padded to pad_to)."""
    mixer, ffn = desc
    cache: Dict[str, torch.Tensor] = {}
    h = shard.act_gathered(L.rmsnorm(p["norm1"], x, cfg.norm_eps))
    B, S, _ = x.shape
    if mixer == "attn":
        h, (k, v) = L.attn_apply(p["attn"], h, cfg, causal=True,
                                 return_kv=True)
        cache["k"], cache["v"] = _pad_seq(k, pad_to), _pad_seq(v, pad_to)
    elif mixer == "mla":
        ckv = h @ p["attn"]["wdkv"]
        kr = (h @ p["attn"]["wkr"]).reshape(B, S, 1, cfg.rope_head_dim)
        cos, sin = L.rope_tables(torch.arange(S, device=x.device),
                                 cfg.rope_head_dim, cfg.rope_theta)
        cache["c"] = _pad_seq(ckv, pad_to)
        cache["kr"] = _pad_seq(L.apply_rope(kr, cos, sin)[:, :, 0], pad_to)
        h = L.mla_apply(p["attn"], h, cfg)
    else:
        h, (state, conv_tail) = M.mamba_apply(p["ssm"], h, cfg,
                                              return_state=True)
        cache["state"], cache["conv"] = state, conv_tail
    x = x + shard.act_residual(h)
    if "xattn" in p:
        hq = shard.act_gathered(L.rmsnorm(p["normx"], x, cfg.norm_eps))
        x = x + shard.act_residual(
            L.cross_attn_apply(p["xattn"], hq, enc_out, cfg))
        cache["xk"] = enc_out @ p["xattn"]["wk"]
        cache["xv"] = enc_out @ p["xattn"]["wv"]
    if ffn != "none":
        add, _ = _ffn(p, x, cfg, shard)
        x = x + shard.act_residual(add)
    return shard.act_residual(x), cache


def prefill(params, cfg: ArchConfig, batch: Dict[str, Any],
            shard: ShardCfg = NO_SHARD, pad_to: int | None = None,
            device=None) -> Tuple[torch.Tensor, PyTree]:
    """Full-sequence prefill.  Returns (logits, caches), the caches
    placed by ``cache_specs`` under a mesh."""
    _on(params, device)
    with shd.replicating(shard):
        return _prefill(params, cfg, batch, shard, pad_to)


def _prefill(params, cfg, batch, shard, pad_to):
    x = shard.act_residual(_embed(params, cfg, batch))
    enc_out = _encode(params, cfg, batch, shard) if cfg.enc_dec else None
    caches = []
    for (count, block), gp in zip(group_descs(layer_descs(cfg)),
                                  params["groups"]):
        per_layer = []
        for bp in _layers(gp, count):
            cc = {}
            for i, desc in enumerate(block):
                x, cc[f"p{i}"] = _prefill_block(bp[f"p{i}"], x, desc, cfg,
                                                shard, enc_out, pad_to)
            per_layer.append(cc)
        caches.append(per_layer[0] if count == 1 else _stack(per_layer))
    x = shard.act_gathered(L.rmsnorm(params["final_norm"], x, cfg.norm_eps))
    logits = x @ params["unembed"]
    return shard.act_logits(logits), place_caches(caches, shard)


def make_decode_step(cfg: ArchConfig, shard: ShardCfg = NO_SHARD,
                     device=None):
    """``step(params, token, caches, pos) -> (logits, caches)`` on the
    device (the card unless ``device`` names the CPU)."""
    dev = resolve_device(device)

    def step(params, token, caches, pos):
        _on(params, dev)
        with shd.replicating(shard):
            return decode_step(params, cfg, token, caches, pos, shard)
    return step


def greedy_generate(params, cfg: ArchConfig, prompt, n_new: int,
                    s_max: int, device=None) -> torch.Tensor:
    """Simple batched greedy decoding loop: ``n_new`` tokens after
    ``prompt`` (B, S0), the first from the prefill's last logits."""
    dev = _on(params, device)
    prompt = torch.as_tensor(prompt, device=dev)
    B, S0 = prompt.shape
    logits, caches = prefill(params, cfg, {"tokens": prompt}, pad_to=s_max,
                             device=dev)
    tok = logits[:, -1:].argmax(-1).to(prompt.dtype)
    out = [tok]
    step = make_decode_step(cfg, device=dev)
    for t in range(n_new - 1):
        logits, caches = step(params, tok, caches, S0 + t)
        tok = logits[:, -1:].argmax(-1).to(prompt.dtype)
        out.append(tok)
    return torch.cat(out, dim=1)
