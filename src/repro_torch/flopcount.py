"""Exact analytic FLOP counter per (arch × shape) cell.

Pure arithmetic on ``ArchConfig``, a copy of the reference's
``flopcount``: the model math is the port's own, so a measured time is
set against this count (``chip_smoke.py`` divides the prefill's count by
its time and the card's dense bfloat16 peak) rather than against a
profiler's tally.

Counts are *global* (all chips) multiply-add×2 FLOPs.
"""
from __future__ import annotations

from repro_torch.configs.base import SHAPES, ArchConfig


def _attn_layer(cfg: ArchConfig, T: float, kv_len: float) -> float:
    d, hd, H, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    proj = 2 * T * d * (H * hd + 2 * Hkv * hd + H * hd)
    quad = 2 * T * kv_len * H * hd * 2           # scores + PV
    return proj + quad


def _mla_layer(cfg: ArchConfig, T: float, kv_len: float) -> float:
    d, hd, H = cfg.d_model, cfg.hd, cfg.n_heads
    r, c = cfg.rope_head_dim, cfg.kv_lora
    proj = 2 * T * d * (H * (hd + r) + c + r)
    expand = 2 * T * c * H * hd * 2              # k/v up-projections
    out = 2 * T * H * hd * d
    quad = 2 * T * kv_len * H * ((hd + r) + hd)
    return proj + expand + out + quad


def _ssm_layer(cfg: ArchConfig, T: float, chunk: int = 256) -> float:
    d = cfg.d_model
    inner = cfg.ssm_expand * d
    P = cfg.ssm_headdim
    H = inner // P
    N = cfg.ssm_state
    proj = 2 * T * d * (2 * inner + 2 * N + H) + 2 * T * inner * d
    conv = 2 * T * cfg.ssm_conv * (inner + 2 * N)
    L = min(chunk, int(T) or 1)
    intra = 2 * T * L * (N + H * P)              # CBᵀ + masked-matmul
    states = 2 * T * N * H * P * 2               # build + apply states
    return proj + conv + intra + states


def _ffn_layer(cfg: ArchConfig, T: float, kind: str) -> float:
    d = cfg.d_model
    total = 0.0
    if kind in ("dense", "moe+dense"):
        total += 2 * T * 3 * d * cfg.d_ff
    if kind in ("moe", "moe+dense"):
        E, K, f = cfg.n_experts, cfg.top_k, cfg.moe_d_ff
        C = max(8, int(T * K / E * cfg.capacity_factor))
        total += 2 * T * d * E                   # router
        total += 2 * E * C * 3 * d * f           # expert swiglu at capacity
        if cfg.n_shared_experts:
            total += 2 * T * 3 * d * f * cfg.n_shared_experts
    return total


def forward_flops(cfg: ArchConfig, T: float, kv_len: float) -> float:
    """One forward pass over T tokens with average attention span kv_len."""
    total = 2 * T * cfg.d_model * cfg.vocab      # unembed
    for mixer, ffn in zip(cfg.layer_kinds(), cfg.layer_ffn()):
        if mixer == "ssm":
            total += _ssm_layer(cfg, T)
        elif cfg.mla:
            total += _mla_layer(cfg, T, kv_len)
        else:
            total += _attn_layer(cfg, T, kv_len)
        kind = ffn
        if mixer == "ssm" and not cfg.moe and cfg.d_ff == 0:
            kind = "none"
        elif ffn == "moe" and cfg.dense_residual:
            kind = "moe+dense"
        if kind != "none":
            total += _ffn_layer(cfg, T, kind)
    if cfg.enc_dec:
        Te = cfg.enc_len * (T / max(SHAPES["train_4k"]["seq_len"], 1))
        # encoder layers + decoder cross-attention (approx: dense attn)
        total += cfg.n_enc_layers * (_attn_layer(cfg, Te, cfg.enc_len)
                                     + _ffn_layer(cfg, Te, "dense"))
        total += cfg.n_layers * 2 * T * cfg.d_model * cfg.n_heads * cfg.hd
    return total


def cell_flops(cfg: ArchConfig, shape_name: str,
               remat: str = "full") -> float:
    """FLOPs of what the implementation executes.

    Note the attention quadratic uses kv_len = S (the query-chunked kernel
    computes full (Cq, S) rectangles and masks — causal-block skipping is a
    known 2×-on-attention optimization, tracked in §Perf ideas), so this is
    the implementation's count, not the idealized causal S/2.
    """
    sh = SHAPES[shape_name]
    B, S = sh["global_batch"], sh["seq_len"]
    if sh["kind"] == "train":
        fwd = forward_flops(cfg, B * S, S)
        factor = 4.0 if remat == "full" else 10.0 / 3.0
        return fwd * factor
    if sh["kind"] == "prefill":
        return forward_flops(cfg, B * S, S)
    # decode: one token per sequence against a cache of length S
    return forward_flops(cfg, B, S)
