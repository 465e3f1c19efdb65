"""whisper-medium [audio]: enc-dec, 24L(+24L enc) d_model=1024 16H (kv=16 MHA)
d_ff=4096 vocab=51865 -- conv frontend STUBBED. [arXiv:2212.04356; unverified]

input_specs() provides precomputed mel-frame embeddings (frontend_len frames
of d_model) standing in for the 2x strided-conv stem; the encoder runs full
bidirectional attention over them, the decoder runs causal self-attention +
cross-attention into the encoder memory. The assigned 32k/500k decode lengths
far exceed Whisper's native 448-token decoder -- honoured as a stress shape
(DESIGN.md §Arch-applicability).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    arch_kind="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51_865,
    norm_kind="layernorm",
    frontend="audio_stub",
    frontend_len=1500,
    tie_embeddings=True,
)
