"""stablelm-3b — dense, full MHA (GQA kv=32).
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b", family="dense", n_layers=32, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=6912, vocab=50304, head_dim=80,
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
)
