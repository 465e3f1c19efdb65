"""SwiGLU feed-forward (LLaMA/phi/gemma family standard).

The port of the reference package's `models/ffn.py`. On one card the
reference's partitioning constraints have no counterpart.
"""
from __future__ import annotations

import torch

from .layers import truncated_normal_init


def ffn_params(generator: torch.Generator, d_model: int, d_ff: int, dtype) -> dict:
    return {
        "w_gate": truncated_normal_init((d_model, d_ff), generator, dtype=dtype),
        "w_up": truncated_normal_init((d_model, d_ff), generator, dtype=dtype),
        "w_down": truncated_normal_init((d_ff, d_model), generator, dtype=dtype),
    }


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    gate = x @ p["w_gate"]
    up = x @ p["w_up"]
    gate = torch.nn.functional.silu(gate.float()).to(x.dtype)
    return (gate * up) @ p["w_down"]
