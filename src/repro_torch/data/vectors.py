"""Synthetic ANN datasets (the benchmark substrate for the paper's tables).

gaussian_mixture mimics the clustered structure of SIFT/DEEP-style descriptor
datasets (PQ behaves realistically: per-subspace k-means has real centroids to
find); uniform data is the adversarial case. Queries are drawn near the data
manifold so recall curves are informative. numpy, seeded: the same seed gives
the same arrays as the reference package's generators.

With `intrinsic_dim` set, gaussian_mixture spreads each cluster over a
subspace of that dimension instead of all d axes. Descriptor sets such as
SIFT have an intrinsic dimension far below d, which gives their points near
neighbours that stand out from farther ones; full-rank clusters of many
points in d = 128 make a query's neighbours almost equidistant instead.
"""
from __future__ import annotations

import numpy as np


def gaussian_mixture(
    n: int,
    d: int,
    *,
    n_clusters: int = 64,
    spread: float = 0.15,
    seed: int = 0,
    intrinsic_dim: int | None = None,
) -> np.ndarray:
    """n points in d dims around `n_clusters` standard-normal centres.

    intrinsic_dim=None: isotropic clusters with std `spread` per axis (the
    reference generator, bit for bit). Otherwise each cluster draws its
    offsets as `spread` * N(0, I) in an `intrinsic_dim`-dim subspace with a
    random orthonormal basis of its own.
    """
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    assign = rng.integers(0, n_clusters, n)
    if intrinsic_dim is None:
        x = centers[assign] + spread * rng.standard_normal((n, d)).astype(np.float32)
        return x.astype(np.float32)
    if not 0 < intrinsic_dim <= d:
        raise ValueError(f"intrinsic_dim must lie in [1, {d}], got {intrinsic_dim}")
    bases = np.linalg.qr(rng.standard_normal((n_clusters, d, intrinsic_dim)))[0]
    bases = bases.transpose(0, 2, 1).astype(np.float32)      # (c, L, d), orthonormal rows
    z = spread * rng.standard_normal((n, intrinsic_dim)).astype(np.float32)
    x = centers[assign]
    for c in range(n_clusters):
        rows = np.flatnonzero(assign == c)
        x[rows] += z[rows] @ bases[c]
    return x


def uniform_queries(data: np.ndarray, n_queries: int, *, noise: float = 0.1,
                    seed: int = 1) -> np.ndarray:
    """Queries near the data manifold: perturbed random data points."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, data.shape[0], n_queries)
    q = data[idx] + noise * rng.standard_normal((n_queries, data.shape[1]))
    return q.astype(np.float32)
