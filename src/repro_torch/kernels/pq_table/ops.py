"""PQ distance-table construction: the CUDA kernel on the card, its plain
version on the CPU.

`build_dist_table` is the public entry point, as
`repro.kernels.pq_table.ops.build_dist_table` is in the reference. As
there, the search executors build their tables with the plain
`core.pq.build_dist_table` (one matrix product); this kernel is reached only
through its own entry point.

The kernel has two regimes, chosen here from dsub: up to `TILE_MAX_DSUB` a
block takes one subspace and tiles of `TABLE_QUERIES` queries, its codebook
rows loaded once into registers, each thread writing 16 bytes a query; beyond
it one block per (query, subspace), one thread per centroid.
"""
from __future__ import annotations

import torch

from repro_torch.core.pq import PQCodec, split_subspaces
from repro_torch.kernels import common

from .ref import dist_table_ref


# The tile regime's widest subspace: a thread holds 4 codebook rows of up to
# 16 floats in registers (csrc/pq_table.cu).
TILE_MAX_DSUB = 16
# Queries a tile of the tile regime: the fastest of the tiles that
# chip_smoke.py sweeps at the main shape (PERF.md section 6).
TABLE_QUERIES = 32


def table_queries(dsub: int) -> int:
    """Queries a tile of K8 for subspaces of dsub dimensions:
    `TABLE_QUERIES` (the tile regime) up to `TILE_MAX_DSUB`, else 0 (the
    general regime, one block per (query, subspace))."""
    return TABLE_QUERIES if dsub <= TILE_MAX_DSUB else 0


def dist_table(q_sub: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """q_sub (B, m, dsub) f32, codebooks (m, 256, dsub) f32 -> (B, m, 256) f32."""
    return _dist_table(q_sub, codebooks, queries=table_queries(q_sub.shape[-1]))


def _dist_table(q_sub: torch.Tensor, codebooks: torch.Tensor, *, queries: int) -> torch.Tensor:
    """`dist_table` with the kernel's tile given (the tests and
    chip_smoke.py check and time each): `queries` queries a tile in the tile
    regime (dsub <= TILE_MAX_DSUB), or 0 for the general regime. CPU tensors
    take the plain version."""
    if not common.on_cuda(q_sub, codebooks):
        return dist_table_ref(q_sub, codebooks)
    B, m, dsub = q_sub.shape
    common.check(q_sub, "q_sub", torch.float32, (B, m, dsub))
    common.check(codebooks, "codebooks", torch.float32, (m, 256, dsub))
    out = torch.empty((B, m, 256), dtype=torch.float32, device=q_sub.device)
    if B and m:
        fn = common.kernel_fn("repro_pq_table", [common.PTR] * 3 + [common.INT] * 4 + [common.PTR])
        with torch.cuda.device(q_sub.device):
            rc = fn(q_sub.data_ptr(), codebooks.data_ptr(), out.data_ptr(), B, m, dsub, queries,
                    common.stream_of(q_sub))
        common.check_launch(rc, f"pq_table (m={m}, dsub={dsub}, queries={queries})")
        dist_table.launches += 1
    return out


def build_dist_table(codec: PQCodec, queries: torch.Tensor) -> torch.Tensor:
    """(B, d) queries -> (B, m, 256) PQDistTable through the kernel."""
    q_sub = split_subspaces(queries.to(torch.float32), codec.m).permute(1, 0, 2).contiguous()
    return dist_table(q_sub, codec.codebooks.to(torch.float32).contiguous())


dist_table.launches = 0

__all__ = ["build_dist_table", "dist_table", "dist_table_ref"]
