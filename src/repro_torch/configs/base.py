"""Architecture config system: one dataclass, one registry.

Each assigned architecture gets its own ``repro_torch/configs/<id>.py``
holding the exact published config; ``reduced()`` derives the CPU-smoke
variant of the same family (small widths/layers/experts, tiny vocab).  A
field-for-field copy of the reference's ``configs``: the port imports
nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                       # per-expert hidden dim
    moe_every: int = 1                      # MoE layer stride
    first_dense: int = 0                    # leading dense layers
    dense_residual: bool = False            # arctic: dense MLP ∥ MoE
    capacity_factor: float = 1.25
    # --- MLA (DeepSeek-V2) ---
    mla: bool = False
    kv_lora: int = 0
    rope_head_dim: int = 64
    # --- SSM (Mamba-2 SSD) ---
    ssm: bool = False
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    attn_every: int = 1                     # 1 = every layer, 8 = jamba, 0 = never
    # --- encoder/decoder (whisper) ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_len: int = 1500                     # frame embeddings (frontend stub)
    # --- modality frontend stubs ---
    frontend: str = "none"                  # none | frames | patches
    n_patches: int = 256
    # --- misc ---
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer mixer kind: 'attn' or 'ssm'."""
        if self.attn_every == 0:
            return tuple("ssm" for _ in range(self.n_layers))
        if self.attn_every == 1:
            return tuple("attn" for _ in range(self.n_layers))
        return tuple("attn" if i % self.attn_every == 0 else "ssm"
                     for i in range(self.n_layers))

    def layer_ffn(self) -> Tuple[str, ...]:
        """Per-layer FFN kind: 'dense' or 'moe'."""
        out = []
        for i in range(self.n_layers):
            if self.moe and i >= self.first_dense and \
                    (i - self.first_dense) % self.moe_every == 0:
                out.append("moe")
            else:
                out.append("dense")
        return tuple(out)

    def param_count(self) -> int:
        """Approximate total parameters (embeddings included)."""
        d, hd = self.d_model, self.hd
        total = self.vocab * d * 2              # embed + unembed (untied)
        kinds, ffns = self.layer_kinds(), self.layer_ffn()
        for kind, ffn in zip(kinds, ffns):
            if kind == "attn":
                if self.mla:
                    total += d * (self.n_heads * (hd + self.rope_head_dim))
                    total += d * (self.kv_lora + self.rope_head_dim)
                    total += self.kv_lora * self.n_heads * hd * 2
                    total += self.n_heads * hd * d
                else:
                    total += d * self.n_heads * hd          # q
                    total += 2 * d * self.n_kv_heads * hd   # k, v
                    total += self.n_heads * hd * d          # o
            else:
                inner = self.ssm_expand * d
                nheads = inner // self.ssm_headdim
                total += d * (2 * inner + 2 * self.ssm_state + nheads)
                total += inner * d
            if ffn == "moe":
                total += d * self.n_experts                  # router
                total += 3 * d * self.moe_d_ff * self.n_experts
                total += 3 * d * self.moe_d_ff * self.n_shared_experts
                if self.dense_residual:
                    total += 3 * d * self.d_ff
            else:
                total += 3 * d * self.d_ff
            total += 2 * d                                   # norms
        if self.enc_dec:
            enc = self.n_enc_layers * (4 * d * d + 3 * d * self.d_ff)
            total += enc + self.n_layers * 4 * d * d         # cross-attn
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        n_moe = sum(1 for f in self.layer_ffn() if f == "moe")
        unused = n_moe * 3 * d * self.moe_d_ff * \
            max(self.n_experts - self.top_k, 0)
        return full - unused

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 4 if self.attn_every <= 1 else
                         self.attn_every),
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)
                           if self.n_kv_heads < self.n_heads else 4),
            head_dim=32,
            d_ff=256,
            moe_d_ff=64 if self.moe else 0,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            vocab=256,
            kv_lora=64 if self.mla else 0,
            rope_head_dim=16 if self.mla else self.rope_head_dim,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=32 if self.ssm else 64,
            enc_len=32,
            n_patches=8,
            first_dense=min(self.first_dense, 1),
        )


ARCH_IDS = (
    "granite-34b", "yi-6b", "stablelm-3b", "mistral-large-123b",
    "deepseek-v2-lite-16b", "arctic-480b", "whisper-small",
    "phi-3-vision-4.2b", "mamba2-130m", "jamba-v0.1-52b",
)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ArchConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


#: assigned input shapes (shared by all LM archs)
SHAPES: Dict[str, dict] = {
    "train_4k":    dict(kind="train",   seq_len=4096,    global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768,   global_batch=32),
    "decode_32k":  dict(kind="decode",  seq_len=32768,   global_batch=128),
    "long_500k":   dict(kind="decode",  seq_len=524288,  global_batch=1),
}

#: archs allowed to run long_500k (sub-quadratic sequence mixers)
SUBQUADRATIC = ("mamba2-130m", "jamba-v0.1-52b")


def cell_is_runnable(arch: str, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, "pure full-attention arch: 500k decode skipped (DESIGN.md)"
    return True, ""
