"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend STUB
(input_specs provides precomputed patch embeddings).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32064, head_dim=96,
    frontend="patches", n_patches=256,
    source="hf:microsoft/Phi-3-vision-128k-instruct; hf",
)
