"""whisper-small — encoder–decoder; conv/audio frontend is a STUB
(input_specs provides precomputed frame embeddings).  [arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab=51865, head_dim=64,
    enc_dec=True, n_enc_layers=12, enc_len=1500, frontend="frames",
    source="arXiv:2212.04356; unverified",
)
