"""mistral-large-123b — dense 88L, GQA kv=8.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b", family="dense", n_layers=88, d_model=12288,
    n_heads=96, n_kv_heads=8, d_ff=28672, vocab=32768, head_dim=128,
    source="hf:mistralai/Mistral-Large-Instruct-2407; unverified",
)
