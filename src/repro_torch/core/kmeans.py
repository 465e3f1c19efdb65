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


def _lloyd(x: torch.Tensor, centroids: torch.Tensor, iters: int) -> torch.Tensor:
    """`iters` Lloyd iterations over (m, n, d) points from (m, k, d) centroids."""
    for _ in range(iters):
        centroids = _lloyd_iter(x, centroids)
    return centroids


def _strided_init(n: int, k: int, device) -> torch.Tensor:
    """The reference's deterministic initialisation: k strided row ids."""
    return (torch.arange(k, device=device) * max(n // k, 1)) % n


def kmeans(
    x: torch.Tensor, k: int, iters: int = 12, *, generator: torch.Generator | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means on (n, d) data: (centroids (k, d), assignment (n,)).

    Initialisation: the deterministic strided sample of the data when
    `generator` is None (n >= k assumed; if n < k the extra centroids
    coincide and empty-cluster repair spreads them), else k rows drawn with
    `generator` (without replacement while n >= k). The reference draws them
    with a JAX key; only the strided initialisation gives its centroids.
    """
    n = x.shape[0]
    if generator is None:
        idx = _strided_init(n, k, x.device)
    elif n >= k:
        idx = torch.randperm(n, generator=generator, device=generator.device)[:k].to(x.device)
    else:
        idx = torch.randint(0, n, (k,), generator=generator, device=generator.device).to(x.device)
    centroids = _lloyd(x[None], x[idx][None], iters)[0]
    assign = torch.argmin(_pairwise_sq_dists(x, centroids), dim=-1)
    return centroids, assign


def kmeans_per_subspace(x_sub: torch.Tensor, k: int, iters: int = 12) -> torch.Tensor:
    """k-means independently per subspace: (m, n, dsub) -> codebooks (m, k, dsub)."""
    idx = _strided_init(x_sub.shape[1], k, x_sub.device)
    return _lloyd(x_sub, x_sub[:, idx], iters)
