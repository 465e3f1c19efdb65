"""Re-ranking stage (paper §4.9).

PQ distances steer the traversal; the final answer comes from exact L2
distances between each query and every candidate it expanded, then the true
top-k. In the in-memory variant the full vectors are gathered from device
memory; the exact-L2 distances have a CUDA kernel
(`repro_torch.kernels.rerank_l2`).
"""
from __future__ import annotations

import torch

from ..kernels.rerank_l2 import ops as rr_ops
from .worklist import INVALID_ID


def exact_topk(
    queries: torch.Tensor,
    cand_vecs: torch.Tensor,
    cand_ids: torch.Tensor,
    k: int,
    *,
    use_kernels: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact squared-L2 re-rank: top-k of candidates per query.

    queries (B, d), cand_vecs (B, C, d), cand_ids (B, C) with INVALID padding.
    Returns (ids (B, k), dists (B, k)) ascending. The top-k is a stable
    ascending sort, so ties resolve to the lowest index as `lax.top_k` does
    (`torch.topk` gives no such order).
    """
    q = queries.to(torch.float32)
    v = cand_vecs.to(torch.float32)
    d2 = rr_ops.exact_sq_dists(q, v) if use_kernels else rr_ops.exact_sq_dists_ref(q, v)
    d2 = torch.where(cand_ids == INVALID_ID, torch.full_like(d2, float("inf")), d2)
    dists, pos = torch.sort(d2, dim=-1, stable=True)
    return torch.gather(cand_ids, -1, pos[:, :k]), dists[:, :k]


def rerank(
    queries: torch.Tensor,
    history_ids: torch.Tensor,
    k: int,
    *,
    data: torch.Tensor,
    use_kernels: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full re-rank stage: gather candidate vectors on the device, exact top-k."""
    pad = history_ids == INVALID_ID
    vecs = data[torch.where(pad, torch.zeros_like(history_ids), history_ids).long()]
    return exact_topk(queries, vecs, history_ids, k, use_kernels=use_kernels)
