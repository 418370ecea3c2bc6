"""arctic-480b — 128-expert top-2 MoE with parallel dense residual MLP.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=4864, vocab=32000, head_dim=128,
    moe=True, n_experts=128, top_k=2, moe_d_ff=4864, dense_residual=True,
    source="hf:Snowflake/snowflake-arctic-base; hf",
)
