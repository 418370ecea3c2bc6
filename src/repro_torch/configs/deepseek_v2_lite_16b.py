"""deepseek-v2-lite-16b — MoE with MLA (kv_lora=512), 64 routed experts
top-6 + 2 shared, first layer dense.  [arXiv:2405.04434; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe", n_layers=27, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=10944, vocab=102400, head_dim=128,
    moe=True, n_experts=64, top_k=6, n_shared_experts=2, moe_d_ff=1408,
    first_dense=1, mla=True, kv_lora=512, rope_head_dim=64,
    source="arXiv:2405.04434; hf",
)
