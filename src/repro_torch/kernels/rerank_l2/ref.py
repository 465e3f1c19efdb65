"""Plain PyTorch version of the exact-L2 re-rank kernel (csrc/rerank_l2.cu).

Computes ||q||^2 + ||v||^2 - 2<v,q>, the formula of the reference kernel.
The formula cancels: at ||v||^2 ~ 30 one float32 ulp is ~4e-6, so two
implementations that sum in different orders disagree by ~1e-5 on every
distance. The order here is the reference's on its CPU backend, so that the
port tracks it to the bit:

  * ||q||^2 and ||v||^2: sequential sums over d of the rounded squares;
  * <v,q>: 8 partial sums, partial l taking dimensions l, l+8, ... as fused
    multiply-adds, folded as (0+4, 1+5, 2+6, 3+7), then (0+2, 1+3), then
    (0+1).

A fused multiply-add is formed as float64 product and sum rounded to
float32, the same on the CPU, in PyTorch on the card and in the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import pad_axis

LANES = 8


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sequential float32 sum over the last axis."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def dot8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> over the last axis in 8 strided fused-multiply-add partials,
    folded pairwise."""
    a = pad_axis(a, -1, LANES, 0.0).reshape(*a.shape[:-1], -1, LANES).to(torch.float64)
    b = pad_axis(b, -1, LANES, 0.0).reshape(*b.shape[:-1], -1, LANES).to(torch.float64)
    acc = torch.zeros(a.shape[:-2] + (LANES,), dtype=torch.float32, device=a.device)
    for j in range(a.shape[-2]):
        acc = (acc.to(torch.float64) + a[..., j, :] * b[..., j, :]).to(torch.float32)
    off = LANES // 2
    while off >= 1:
        acc = acc[..., :off] + acc[..., off : 2 * off]
        off //= 2
    return acc[..., 0]


def exact_sq_dists_ref(queries: torch.Tensor, cand_vecs: torch.Tensor) -> torch.Tensor:
    """queries (B, d), cand_vecs (B, C, d) -> (B, C) squared L2."""
    q = queries.to(torch.float32)
    v = cand_vecs.to(torch.float32)
    qq = seq_sum(q * q)                              # (B,)
    vv = seq_sum(v * v)                              # (B, C)
    vq = dot8(v, q[:, None, :].expand_as(v))         # (B, C)
    return (qq[:, None] + vv) - 2.0 * vq
