"""Config system: ModelConfig (architectures) + ShapeSpec (workloads).

A copy of the reference package's `configs/base.py` (framework-free data).
Every assigned architecture is a ModelConfig instance in its own module under
repro_torch.configs; `repro_torch.configs.get(name)` resolves them. The CPU
tests use `cfg.reduced()` -- same family/topology, tiny dims; `chip_smoke.py`
runs glm4-9b at its full width on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | ssm | hybrid | moe | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 128
    d_ff: int = 0
    vocab_size: int = 32000

    # attention schedule
    sliding_window: int = 0       # 0 = full attention
    local_global_ratio: int = 0   # gemma3: N local layers per 1 global
    rope_theta: float = 10_000.0
    norm_kind: str = "rmsnorm"    # rmsnorm | layernorm

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_groups: int = 1

    # hybrid (zamba2): one *shared* attention block applied every k SSM layers
    hybrid_attn_every: int = 0

    # structure
    arch_kind: str = "decoder"    # decoder | encdec
    n_encoder_layers: int = 0
    frontend: str = "none"        # none | audio_stub | vision_stub
    frontend_len: int = 0         # precomputed frames/patches prepended

    norm_eps: float = 1e-6
    tie_embeddings: bool = True

    # compute knobs
    remat: bool = True
    scan_layers: bool = True
    attn_chunk: int = 512         # query-block size for chunked attention
    loss_chunk: int = 1024        # seq-chunked cross-entropy
    dtype: str = "bfloat16"

    # BANG-KV retrieval attention (the paper's technique inside decode)
    bangkv_m: int = 16            # PQ code bytes per key
    bangkv_topl: int = 64         # retrieved keys per head
    bangkv_window: int = 256      # exact recent window

    # beyond-paper perf knobs (EXPERIMENTS.md §Perf; default = baseline off)
    opt_attn_bf16: bool = False   # bf16 score/prob buffers (f32 accum)
    opt_window_skip: bool = False # banded local attention (static windows)
    opt_hier_topk: bool = False   # two-stage sharded top-k in BANG-KV
    opt_adc_lite: bool = False    # clip-mode + bf16 ADC gather in BANG-KV
    opt_moe_bf16: bool = False    # bf16 expert compute (f32 accum in dots)

    # ----------------------------------------------------------------- props
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim if self.ssm_state else 0

    def param_count(self) -> int:
        """Analytic parameter count (for roofline's 6·N·D and sanity checks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.family == "ssm" or (self.family == "hybrid"):
            di, g, ns = self.ssm_inner, self.ssm_groups, self.ssm_state
            conv_ch = di + 2 * g * ns
            ssm = (
                d * (2 * di + 2 * g * ns + self.ssm_heads)   # in_proj (z,x,B,C,dt)
                + conv_ch * self.ssm_conv                     # conv1d
                + 2 * self.ssm_heads                          # A_log, D
                + di * d                                      # out_proj
                + di                                          # ssm norm
            )
        else:
            ssm = 0
        if self.n_experts:
            ffn = self.n_experts * 3 * d * f + d * self.n_experts
            ffn += self.n_shared_experts * 3 * d * f
        elif f:
            ffn = 3 * d * f
        else:
            ffn = 0
        norms = 2 * d

        if self.family == "ssm":
            per_layer = ssm + d
            total = self.n_layers * per_layer
        elif self.family == "hybrid":
            per_layer = ssm + d
            total = self.n_layers * per_layer
            # one shared attention+ffn block
            total += attn + 3 * d * self.d_ff + norms
        else:
            per_layer = attn + ffn + norms
            total = self.n_layers * per_layer
            if self.arch_kind == "encdec":
                # encoder layers + decoder cross-attention
                total += self.n_encoder_layers * (attn + 3 * d * f + norms)
                total += self.n_layers * (attn + d)
        return total + emb + d

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_experts = self.moe_top_k + self.n_shared_experts
        inactive = (self.n_experts - self.moe_top_k) * 3 * d * f
        return self.param_count() - self.n_layers * inactive

    def reduced(self, **overrides: Any) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        base = dict(
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16 if self.n_heads else 128,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            sliding_window=16 if self.sliding_window else 0,
            n_experts=min(self.n_experts, 4),
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            frontend_len=4 if self.frontend_len else 0,
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            attn_chunk=16,
            loss_chunk=16,
            bangkv_m=4,
            bangkv_topl=8,
            bangkv_window=8,
            name=self.name + "-reduced",
        )
        if self.family == "hybrid":
            base["n_layers"] = 4
        base.update(overrides)
        return dataclasses.replace(self, **base)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str        # train_4k | prefill_32k | decode_32k | long_500k
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}
