"""Batched Lloyd's k-means, the substrate of PQ codebook training (paper §2.3).

256 centroids per subspace; the m subspaces train together as one batch.
Initialisation is the reference's deterministic strided sample, and empty
clusters are re-seeded from the point farthest from its centroid.
"""
from __future__ import annotations

import torch


def _pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(..., n, d) x (..., k, d) -> (..., n, k) squared L2 via the matmul identity."""
    xn = (x * x).sum(-1, keepdim=True)
    cn = (c * c).sum(-1)[..., None, :]
    return xn + cn - 2.0 * torch.matmul(x, c.transpose(-1, -2))


def _lloyd_iter(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """One Lloyd iteration over (m, n, d) points and (m, k, d) centroids."""
    d2 = _pairwise_sq_dists(x, centroids)                          # (m, n, k)
    assign = torch.argmin(d2, dim=-1)                               # (m, n)
    k = centroids.shape[-2]
    onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype)     # (m, n, k)
    counts = onehot.sum(-2)                                         # (m, k)
    sums = torch.matmul(onehot.transpose(-1, -2), x)                # (m, k, d)
    new_c = sums / torch.clamp(counts, min=1.0)[..., None]
    # Empty-cluster repair: pull the point farthest from its centroid.
    far = torch.argmax(d2.min(dim=-1).values, dim=-1)               # (m,)
    far_pt = torch.gather(x, 1, far[:, None, None].expand(-1, 1, x.shape[-1]))
    return torch.where((counts == 0)[..., None], far_pt, new_c)


def kmeans_per_subspace(x_sub: torch.Tensor, k: int, iters: int = 12) -> torch.Tensor:
    """k-means independently per subspace: (m, n, dsub) -> codebooks (m, k, dsub)."""
    n = x_sub.shape[1]
    idx = (torch.arange(k, device=x_sub.device) * max(n // k, 1)) % n
    c = x_sub[:, idx]
    for _ in range(iters):
        c = _lloyd_iter(x_sub, c)
    return c
