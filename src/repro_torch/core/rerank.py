"""Re-ranking stage (paper §4.9).

PQ distances steer the traversal; the final answer comes from exact L2
distances between each query and every candidate it expanded, then the true
top-k. The in-memory variant gathers the full vectors from device memory.
BANG Base keeps them in host RAM: the expanded ids go to the host, their
rows are gathered from the pinned vectors into a pinned buffer, and one
non-blocking copy sends them to the device ("only full vectors of selected
nodes are sent to GPU"). The exact-L2 distances have a CUDA kernel
(`repro_torch.kernels.rerank_l2`).

The formula ||q||^2 + ||v||^2 - 2<v,q> cancels, so the order of its sums
shows in the last bits (ROADMAP C4), and the reference has two: its kernel
modes run the Pallas kernel, whose order K3 and its plain version follow,
and its "reference" mode runs the formula in XLA, which on the CPU sums the
norms as sequential fused multiply-adds and the dot product in 8 strided
partials folded by neighbours (probed on (16, 56, 32) candidate tiles). The
port's "reference" mode follows the second on the CPU, where it is compared
with the reference, and K3's plain version on the card, where the modes are
compared with each other.

The reference gathers host vectors in chunks of at most 64 KB
(`gather_host_vectors`) only to keep each host callback under the size at
which XLA:CPU hands its consumer to a thread pool that the callback may be
holding; nothing here runs inside such a callback, so the gather is one
`index_select`.
"""
from __future__ import annotations

import torch

from ..kernels.rerank_l2 import ops as rr_ops
from .hostrows import HostRows
from .search import _xla_cpu_dot, _xla_cpu_sq_norm
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
    (`torch.topk` gives no such order). `use_kernels` runs K3 (its plain
    version on the CPU); without it the sums follow the reference's
    "reference" mode on the CPU and K3's order on the card (module
    docstring).
    """
    q = queries.to(torch.float32)
    v = cand_vecs.to(torch.float32)
    if use_kernels:
        d2 = rr_ops.exact_sq_dists(q, v)
    elif q.device.type == "cpu":
        d2 = _xla_cpu_sq_norm(q)[:, None] + _xla_cpu_sq_norm(v) - 2.0 * _xla_cpu_dot(v, q)
    else:
        d2 = rr_ops.exact_sq_dists_ref(q, v)
    d2 = torch.where(cand_ids == INVALID_ID, torch.full_like(d2, float("inf")), d2)
    dists, pos = torch.sort(d2, dim=-1, stable=True)
    return torch.gather(cand_ids, -1, pos[:, :k]), dists[:, :k]


def rerank(
    queries: torch.Tensor,
    history_ids: torch.Tensor,
    k: int,
    *,
    data: torch.Tensor | None = None,
    host_data: HostRows | None = None,
    use_kernels: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full re-rank stage: gather the candidates' vectors, exact top-k.

    Exactly one source is given: `data`, the (n, d) vectors on the device,
    or `host_data`, the vectors in host RAM.
    """
    if (data is None) == (host_data is None):
        raise ValueError("rerank needs exactly one of data= and host_data=")
    if data is not None:
        pad = history_ids == INVALID_ID
        vecs = data[torch.where(pad, torch.zeros_like(history_ids), history_ids).long()]
    else:
        vecs = host_data.gather(history_ids.cpu().reshape(-1)).reshape(*history_ids.shape, -1)
    return exact_topk(queries, vecs, history_ids, k, use_kernels=use_kernels)
