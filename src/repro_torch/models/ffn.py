"""SwiGLU feed-forward (LLaMA/phi/gemma family standard).

The port of the reference package's `models/ffn.py`. With a mesh (the
mesh training step, `distributed.collectives.MeshContext`) the reference's
`constrain` sites become explicit collectives: a Megatron-TP pair with
FSDP gather-before-use -- the three weights gathered over `data` at their
use, the hidden activations split over `model` between the up- and
down-projections, and one (B, S, D) all-reduce over `model` after
`w_down` (an MoE block's shared expert leaves it to the block's sum).
Where the rules leave d_ff whole over `model` (it does not divide the
axis), every `model` rank computes the whole block and nothing is
reduced. With no mesh the code is the single-device one.
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


def swiglu(p, x: torch.Tensor, mesh=None, *, key: str = "", reduce: bool = True) -> torch.Tensor:
    """With `mesh`: `key` prefixes the weights' names in the mesh context
    ("shared/" for an MoE block's shared expert); with `reduce=False` a
    split block returns its partial sum, for the caller's all-reduce."""
    if mesh is not None:
        return _mesh_swiglu(p, x, mesh, key, reduce)
    gate = x @ p["w_gate"]
    up = x @ p["w_up"]
    gate = torch.nn.functional.silu(gate.float()).to(x.dtype)
    return (gate * up) @ p["w_down"]


def _mesh_swiglu(p, x: torch.Tensor, mesh, key: str, reduce: bool) -> torch.Tensor:
    split = mesh.model_sharded(key + "w_down", 0)   # d_ff over `model`
    use = "shard" if split else "replicated"
    if split:
        x = mesh.to_model(x)
    gate = x @ mesh.weight(p["w_gate"], key + "w_gate", use)
    up = x @ mesh.weight(p["w_up"], key + "w_up", use)
    gate = torch.nn.functional.silu(gate.float()).to(x.dtype)
    y = (gate * up) @ mesh.weight(p["w_down"], key + "w_down", use)
    return mesh.from_model(y) if split and reduce else y
