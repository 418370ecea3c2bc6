"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave, 16-expert
top-2 MoE every other layer.  [arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=65536, head_dim=128,
    moe=True, n_experts=16, top_k=2, moe_d_ff=14336, moe_every=2,
    ssm=True, ssm_state=16, ssm_expand=2, ssm_headdim=64, attn_every=8,
    source="arXiv:2403.19887; hf",
)
