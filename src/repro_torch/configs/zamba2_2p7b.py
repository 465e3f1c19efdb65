"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 -- Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf]

The shared transformer block (full MHA, kv=32 => no grouping) is applied
every `hybrid_attn_every` SSM layers with *shared weights*, following the
Zamba2 design (we share the block verbatim; the per-invocation LoRA deltas of
the released model are an orthogonal detail, noted in DESIGN.md).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_head_dim=64,
    ssm_chunk=256,
    hybrid_attn_every=6,
    tie_embeddings=True,
)
