"""Shared layer primitives: norms, RoPE, embeddings, initialisers.

The port of the reference package's `models/layers.py`. Parameters live in
`nn.Module`s (`ParamTree`), indexed by the reference's names; the layer math
is plain functions on tensors, computed on their inputs' device. Compute
dtype is bf16 by default; norms and softmax accumulate in float32.
"""
from __future__ import annotations

import torch
from torch import nn


class ParamTree(nn.Module):
    """A tree of parameters with the reference's pytree names.

    Nested dicts become `ParamTree`s and lists `nn.ModuleList`s, so
    `p["attn"]["wq"]` and `"shared" in p` read as they do on the reference's
    dicts. The serve path computes no gradients: the parameters are frozen.
    """

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(name, nn.ModuleList(ParamTree(v) for v in value))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def truncated_normal_init(shape, generator: torch.Generator, scale: float = 0.02,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times `scale`: drawn in float32 on the
    generator's device, then cast."""
    x = torch.empty(shape, dtype=torch.float32, device=generator.device)
    nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return x.mul_(scale).to(dtype)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + weight.float())).to(x.dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    normed = (xf - mu) * torch.rsqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(x.dtype)


def norm(x: torch.Tensor, p, kind: str, eps: float) -> torch.Tensor:
    if kind == "layernorm":
        return layernorm(x, p["w"], p["b"], eps)
    return rmsnorm(x, p["w"], eps)


def norm_params(d: int, kind: str, device=None) -> dict:
    if kind == "layernorm":
        return {"w": torch.ones((d,), dtype=torch.float32, device=device),
                "b": torch.zeros((d,), dtype=torch.float32, device=device)}
    return {"w": torch.zeros((d,), dtype=torch.float32, device=device)}  # rmsnorm stores (1+w)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) float32. The power is taken in float64 and rounded once,
    which gives the correctly rounded float32 power that the reference's XLA
    computes (float32 `pow` is an ulp off at some exponents, and at position
    32,768 an ulp of a frequency moves the angle by 2e-3). The base stays a
    Python number: a tensor made from it on the card would wait for the
    device at every call."""
    e = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(float(theta), e.double()).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), positions: broadcastable to (..., S). Rotates the
    two halves of the head dimension, as the reference's `jnp.split`."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)                    # (hd/2,)
    angles = positions[..., :, None, None].float() * freqs           # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]
