"""Exact squared L2 for the re-rank: the CUDA kernel on the card, its plain
version on the CPU."""
from __future__ import annotations

import torch

from repro_torch.kernels import common

from .ref import exact_sq_dists_ref

THREADS = 128  # candidates per work item, one per thread


def rows_per_item(C: int) -> int:
    """Threads of a block: the work item's candidates, cut to whole warps."""
    return min(THREADS, -(-C // 32) * 32)


def exact_sq_dists(queries: torch.Tensor, cand_vecs: torch.Tensor) -> torch.Tensor:
    """queries (B, d) f32, cand_vecs (B, C, d) f32 -> (B, C) f32. On the card
    d is at most 7,380 (the kernel's shared memory, csrc/rerank_l2.cu)."""
    if not common.on_cuda(queries, cand_vecs):
        return exact_sq_dists_ref(queries, cand_vecs)
    B, C, d = cand_vecs.shape
    common.check(queries, "queries", torch.float32, (B, d))
    common.check(cand_vecs, "cand_vecs", torch.float32, (B, C, d))
    out = torch.empty((B, C), dtype=torch.float32, device=queries.device)
    if B and C:
        fn = common.kernel_fn("repro_rerank_l2", [common.PTR] * 3 + [common.INT] * 4 + [common.PTR])
        with torch.cuda.device(queries.device):
            rc = fn(queries.data_ptr(), cand_vecs.data_ptr(), out.data_ptr(),
                    B, C, d, rows_per_item(C), common.stream_of(queries))
        common.check_launch(rc, "rerank_l2")
        exact_sq_dists.launches += 1
    return out


exact_sq_dists.launches = 0

__all__ = ["exact_sq_dists", "exact_sq_dists_ref"]
