"""PQ distance-table construction: the CUDA kernel on the card, its plain
version on the CPU.

`build_dist_table` is the public entry point, as
`repro.kernels.pq_table.ops.build_dist_table` is in the reference. As
there, the search executors build their tables with the plain
`core.pq.build_dist_table` (one matrix product); this kernel is reached only
through its own entry point.
"""
from __future__ import annotations

import torch

from repro_torch.core.pq import PQCodec, split_subspaces
from repro_torch.kernels import common

from .ref import dist_table_ref


def dist_table(q_sub: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """q_sub (B, m, dsub) f32, codebooks (m, 256, dsub) f32 -> (B, m, 256) f32."""
    if not common.on_cuda(q_sub, codebooks):
        return dist_table_ref(q_sub, codebooks)
    B, m, dsub = q_sub.shape
    common.check(q_sub, "q_sub", torch.float32, (B, m, dsub))
    common.check(codebooks, "codebooks", torch.float32, (m, 256, dsub))
    out = torch.empty((B, m, 256), dtype=torch.float32, device=q_sub.device)
    if B and m:
        fn = common.kernel_fn("repro_pq_table", [common.PTR] * 3 + [common.INT] * 3 + [common.PTR])
        with torch.cuda.device(q_sub.device):
            rc = fn(q_sub.data_ptr(), codebooks.data_ptr(), out.data_ptr(), B, m, dsub,
                    common.stream_of(q_sub))
        common.check_launch(rc, f"pq_table (m={m}, dsub={dsub})")
        dist_table.launches += 1
    return out


def build_dist_table(codec: PQCodec, queries: torch.Tensor) -> torch.Tensor:
    """(B, d) queries -> (B, m, 256) PQDistTable through the kernel."""
    q_sub = split_subspaces(queries.to(torch.float32), codec.m).permute(1, 0, 2).contiguous()
    return dist_table(q_sub, codec.codebooks.to(torch.float32).contiguous())


dist_table.launches = 0

__all__ = ["build_dist_table", "dist_table", "dist_table_ref"]
