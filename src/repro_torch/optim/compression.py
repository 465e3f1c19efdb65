"""int8 error-feedback gradient compression (cross-pod DP all-reduce trick).

The port of the reference package's `optim/compression.py`: each gradient
plus its carried residual is quantised to int8 with one scale a tensor and
dequantised again -- the wire format modelled end to end -- and the
quantisation error is carried to the next step, so the sum of the
transmitted gradients stays unbiased over time. `torch.round` rounds half
to even, as `jnp.round`, so the round trip equals the reference's bit for
bit. `compressed_psum` is the reference's shard_map form over a
data-parallel group: the scale is the largest over the group, the int8
values are summed as int32 over it, and the sum is dequantised and divided
by the group's size.

One scale a tensor of the reference's tree: the reference stacks a
parameter of every layer into one (L, ...) leaf and quantises it with one
scale, so the port's per-layer tensors of one stacked leaf ("layers/3/attn/wq"
for every layer index, `stacked_key`) share the largest of their scales.
"""
from __future__ import annotations

import re
from typing import NamedTuple

import torch
import torch.distributed as dist

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


def _with_residuals(grads: dict, state: CompressionState) -> tuple[dict, dict]:
    """Each gradient plus its residual ({path: float32}), and the largest
    magnitude of each stacked leaf ({stacked key: scalar})."""
    xs = {}
    for k, e in state.err.items():
        g = grads.get(k)
        xs[k] = e.clone() if g is None else g.float() + e
    amax: dict[str, torch.Tensor] = {}
    for k, x in xs.items():
        m = torch.max(torch.abs(x))
        s = stacked_key(k)
        amax[s] = m if s not in amax else torch.maximum(amax[s], m)
    return xs, amax


def ef_int8_compress(grads: dict, state: CompressionState) -> tuple[dict, CompressionState]:
    """Error-feedback int8 round trip of {path: gradient} (None is a zero
    gradient): returns (dequantised gradients, new state). The tensors of
    one stacked leaf share one scale (`stacked_key`)."""
    xs, amax = _with_residuals(grads, state)
    deq, err = {}, {}
    for k, x in xs.items():
        scale = amax[stacked_key(k)] / 127.0 + 1e-12
        deq[k] = _quantize(x, scale).float() * scale
        err[k] = x - deq[k]
    return deq, CompressionState(err)


def compressed_psum(grads: dict, group, state: CompressionState) -> tuple[dict, CompressionState]:
    """The shard_map form over `group` (a data-parallel process group):
    each stacked leaf's scale is the largest of the group's (an all-reduce
    MAX of one float32), each gradient plus residual is quantised to int8
    values, summed over the group as int32 (an all-reduce SUM) and
    dequantised: deq = sum * scale / n, n the group's size; the residual
    is x - q * scale, q * scale rounded first as `ef_int8_compress` rounds
    it (the reference's XLA:CPU fuses the two into one rounding in its
    vectorised lanes, ROADMAP C19). Returns (deq, new state); every rank of
    `group` calls it with the same keys."""
    xs, amax = _with_residuals(grads, state)
    scales = {}
    for s, m in amax.items():
        scales[s] = m / 127.0 + 1e-12
        dist.all_reduce(scales[s], op=dist.ReduceOp.MAX, group=group)
    n = float(dist.get_world_size(group))
    deq, err = {}, {}
    for k, x in xs.items():
        scale = scales[stacked_key(k)]
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int32)
        total = q.clone()
        dist.all_reduce(total, group=group)
        deq[k] = total.float() * scale / n
        err[k] = x - q.float() * scale
    return deq, CompressionState(err)
