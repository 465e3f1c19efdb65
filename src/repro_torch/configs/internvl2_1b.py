"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 -- InternViT + InternLM2 backbone. [arXiv:2404.16821; hf]

Per the assignment, the ViT frontend is a STUB: input_specs() provides
precomputed patch embeddings (frontend_len patches of d_model) which the
decoder prepends to the token embeddings.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151_655,
    frontend="vision_stub",
    frontend_len=256,
    tie_embeddings=True,
)
