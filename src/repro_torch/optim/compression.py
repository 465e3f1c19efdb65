"""int8 error-feedback gradient compression (cross-pod DP all-reduce trick).

The port of the reference package's `optim/compression.py`: each gradient
plus its carried residual is quantised to int8 with one scale a tensor and
dequantised again -- the wire format modelled end to end -- and the
quantisation error is carried to the next step, so the sum of the
transmitted gradients stays unbiased over time. `torch.round` rounds half
to even, as `jnp.round`, so the round trip equals the reference's bit for
bit. The reference's `compressed_psum` (its shard_map form, over a
data-parallel axis) waits for the mesh LM (ROADMAP A8e).

One scale a tensor of the reference's tree: the reference stacks a
parameter of every layer into one (L, ...) leaf and quantises it with one
scale, so the port's per-layer tensors of one stacked leaf ("layers/3/attn/wq"
for every layer index, `stacked_key`) share the largest of their scales.
"""
from __future__ import annotations

import re
from typing import NamedTuple

import torch

from ..tree import flat_dict


class CompressionState(NamedTuple):
    err: dict   # {path: float32 residual}


def compression_init(grads) -> CompressionState:
    """Zero residuals shaped as `grads` (a tree of tensors: the parameters
    or their gradients), keyed by path (`tree.flat_dict`)."""
    return CompressionState(err={k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                                 for k, g in flat_dict(grads).items()})


def stacked_key(key: str) -> str:
    """The reference's leaf of a port path: the layer index of a layer stack
    replaced by '*' ("encoder/layers/2/ffn/w_up" -> "encoder/layers/*/ffn/w_up")."""
    return re.sub(r"(^|/)layers/\d+(/|$)", r"\1layers/*\2", key)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def ef_int8_compress(grads: dict, state: CompressionState) -> tuple[dict, CompressionState]:
    """Error-feedback int8 round trip of {path: gradient} (None is a zero
    gradient): returns (dequantised gradients, new state). The tensors of
    one stacked leaf share one scale (`stacked_key`)."""
    xs = {}
    for k, e in state.err.items():
        g = grads.get(k)
        xs[k] = e.clone() if g is None else g.float() + e
    amax: dict[str, torch.Tensor] = {}
    for k, x in xs.items():
        m = torch.max(torch.abs(x))
        s = stacked_key(k)
        amax[s] = m if s not in amax else torch.maximum(amax[s], m)
    deq, err = {}, {}
    for k, x in xs.items():
        scale = amax[stacked_key(k)] / 127.0 + 1e-12
        deq[k] = _quantize(x, scale).float() * scale
        err[k] = x - deq[k]
    return deq, CompressionState(err)
