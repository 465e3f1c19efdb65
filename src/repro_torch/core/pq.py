"""Product Quantization codec (paper §2.3, §4.2).

PQ splits a d-dim vector into m subspaces of dsub = d/m dims, k-means
quantises each subspace to 256 centroids, and stores each point as m uint8
cluster ids. A query's PQDistTable (m, 256) holds the squared L2 distance from
its subvectors to every centroid; the distance to a compressed point is the
sum of m table lookups (ADC).

`build_dist_table` stays a plain `torch.matmul`, as the reference leaves it
to XLA. The ADC sum is taken in MC-subspace chunks (`adc_sum`), the order the
ADC and search kernels use, so every path that scores candidates gives the
same bits on the same table.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.common import pad_axis
from .kmeans import kmeans_per_subspace

N_CLUSTERS = 256
MC = 8  # subspaces per chunk of the ADC sum


@dataclasses.dataclass
class PQCodec:
    """Trained PQ codebooks. codebooks: (m, 256, dsub) float32."""

    codebooks: torch.Tensor

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]

    @property
    def d(self) -> int:
        return self.m * self.dsub


def split_subspaces(x: torch.Tensor, m: int) -> torch.Tensor:
    """(n, d) -> (m, n, dsub), zero-padding d up to a multiple of m (distance
    neutral for L2 as long as queries are padded the same way)."""
    x = pad_axis(x, 1, m, 0.0)
    return x.reshape(x.shape[0], m, -1).permute(1, 0, 2)


def train_pq(data: torch.Tensor, m: int, *, iters: int = 12, sample: int | None = 65536) -> PQCodec:
    """Train PQ codebooks on (n, d) data, k-means per subspace."""
    n = data.shape[0]
    if sample is not None and n > sample:
        # Deterministic strided subsample for codebook training.
        data = data[:: max(n // sample, 1)][:sample]
    x_sub = split_subspaces(data.to(torch.float32), m).contiguous()
    return PQCodec(kmeans_per_subspace(x_sub, N_CLUSTERS, iters))


def _sq_dists_to_centroids(x_sub: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(m, n, dsub), (m, 256, dsub) -> (m, n, 256) squared L2, reference formula."""
    return (
        (x_sub * x_sub).sum(-1, keepdim=True)
        + (codebooks * codebooks).sum(-1)[:, None, :]
        - 2.0 * torch.matmul(x_sub, codebooks.transpose(1, 2))
    )


def pq_encode(codec: PQCodec, data: torch.Tensor, *, chunk: int = 65536) -> torch.Tensor:
    """(n, d) -> (n, m) uint8 cluster ids (argmin centroid per subspace).

    Encoded `chunk` rows at a time, so the (m, chunk, 256) distance block
    stays small at n = 10**6 and beyond.
    """
    out = []
    for s in range(0, data.shape[0], chunk):
        x_sub = split_subspaces(data[s : s + chunk].to(torch.float32), codec.m)
        d2 = _sq_dists_to_centroids(x_sub, codec.codebooks)
        out.append(torch.argmin(d2, dim=-1).T.to(torch.uint8))
    return torch.cat(out, 0)


def pq_decode(codec: PQCodec, codes: torch.Tensor) -> torch.Tensor:
    """(n, m) uint8 -> (n, m*dsub) reconstruction (centroid concat)."""
    m = codec.m
    sub = torch.arange(m, device=codes.device)[None, :]
    return codec.codebooks[sub, codes.long()].reshape(codes.shape[0], -1)


def build_dist_table(codec: PQCodec, queries: torch.Tensor) -> torch.Tensor:
    """PQDistTable (paper §4.2): (B, d) queries -> (B, m, 256) f32, contiguous."""
    q_sub = split_subspaces(queries.to(torch.float32), codec.m)
    return _sq_dists_to_centroids(q_sub, codec.codebooks).permute(1, 0, 2).contiguous()


def adc_sum(vals: torch.Tensor) -> torch.Tensor:
    """Sum the last axis (m looked-up table entries) in MC-subspace chunks:
    each chunk sequentially, then the chunks in order; entries past m count
    as 0.0. This is the arithmetic order of the CUDA kernels."""
    vals = pad_axis(vals, -1, MC, 0.0)
    acc = torch.zeros(vals.shape[:-1], dtype=vals.dtype, device=vals.device)
    for c in range(0, vals.shape[-1], MC):
        part = vals[..., c]
        for j in range(1, MC):
            part = part + vals[..., c + j]
        acc = acc + part
    return acc


def adc_distance(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADC (paper §4.5): table (B, m, 256), codes (B, R, m) -> (B, R) f32."""
    idx = codes.long()
    gathered = torch.gather(
        table[:, None, :, :].expand(-1, idx.shape[1], -1, -1), 3, idx[..., None]
    )[..., 0]
    return adc_sum(gathered)


def quantization_error(codec: PQCodec, data: torch.Tensor) -> float:
    """Mean squared reconstruction error (codec quality diagnostic)."""
    data = data.to(torch.float32)
    rec = pq_decode(codec, pq_encode(codec, data))
    d = data.shape[1]
    return float(((rec[:, :d] - data) ** 2).sum(-1).mean())
