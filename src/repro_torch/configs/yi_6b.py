"""yi-6b — dense llama-arch with GQA kv=4.  [arXiv:2403.04652; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=4, d_ff=11008, vocab=64000, head_dim=128,
    source="arXiv:2403.04652; hf",
)
