"""mamba2-130m — attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=0, vocab=50280,
    ssm=True, ssm_state=128, ssm_expand=2, ssm_headdim=64, attn_every=0,
    source="arXiv:2405.21060; unverified",
)
