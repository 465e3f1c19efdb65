"""One fused Algorithm-2 hop (K1), the same hop on precomputed distances
(K6) and the owner-shard gather + ADC of the sharded search (K7): the CUDA
kernels on the card, their plain versions on the CPU.

K1 and K6 share the hop's tail (sort, select, merge), which has two
regimes, chosen here from the merge row's P = next_pow2(t + next_pow2(R))
slots: up to `WARP_MAX_P` one warp per query runs it in registers (K6 with
`TRAVERSE_WARPS` queries a block; K1 on warp 0 of its block, after its
ADC), beyond it one block of `THREADS` per query runs it in shared memory.

`fused_step` takes the place of both reference entry points,
`fused_step_pallas` and the beyond-VMEM `fused_step_dma_pallas`: the TPU had
to stream a codes block larger than VMEM through it in tiles, while the GPU
kernel gathers code rows straight from global memory at any n. `tile_rows`
is accepted and validated so configurations carry over, and changes no bit
of the result. `local_adc` likewise serves both `local_adc_pallas` and
`local_adc_dma_pallas`.

The card has no VMEM to budget, so the reference's placement decision
(`resolve_codes_tiling`, `vmem_budget_bytes` and its `REPRO_VMEM_BUDGET`
knob) has no counterpart here. What stays is the traffic model
(`hbm_candidate_roundtrips_per_hop`, `hbm_intermediate_bytes_per_hop`,
`hbm_codes_stream_bytes_per_hop`), counted from this port's code: the hop
kernels here and the staged step of `repro_torch.core.search`.
"""
from __future__ import annotations

import torch

from repro_torch.core.worklist import Worklist
from repro_torch.kernels import common

from .ref import local_adc_ref, step_ref, traverse_ref

THREADS = 128
# The warp regime's largest merge row: 16 slots a lane (t <= 448 at R = 64).
WARP_MAX_P = 512
# Queries a block of K6's warp regime, one warp each (the kernel takes 1 to
# 8): the fastest of 1, 2, 4 and 8 at the main shape (chip_smoke.py's sweep;
# PERF.md section 6).
TRAVERSE_WARPS = 8


def merge_slots(R: int, t: int) -> int:
    """P: the slots of the hop's merge row, the worklist and the padded,
    reversed candidate tile."""
    return common.next_pow2(t + common.next_pow2(R))


def traverse_warps(P: int) -> int:
    """Queries a block of K6 for a merge row of P slots: `TRAVERSE_WARPS` (the
    warp regime) up to `WARP_MAX_P`, else 0 (the block regime, one query a
    block of `THREADS`)."""
    return TRAVERSE_WARPS if P <= WARP_MAX_P else 0


def _launch(table, codes, nbrs, fresh, wl: Worklist, active, eager: bool):
    B, m, _ = table.shape
    n = codes.shape[0]
    R = nbrs.shape[1]
    t = wl.t
    for name, x, dtype, shape in (
        ("table", table, torch.float32, (B, m, 256)),
        ("codes", codes, torch.uint8, (n, m)),
        ("nbrs", nbrs, torch.int32, (B, R)),
        ("fresh", fresh, torch.bool, (B, R)),
        ("wl.dists", wl.dists, torch.float32, (B, t)),
        ("wl.ids", wl.ids, torch.int32, (B, t)),
        ("wl.visited", wl.visited, torch.bool, (B, t)),
        ("active", active, torch.bool, (B,)),
    ):
        common.check(x, name, dtype, shape)
    if R < 1 or t < 1 or n < 1:
        raise ValueError(f"need R, t, n >= 1, got R={R}, t={t}, n={n}")
    Rp = common.next_pow2(R)
    P = merge_slots(R, t)
    dev = table.device
    owd = torch.empty((B, t), dtype=torch.float32, device=dev)
    owi = torch.empty((B, t), dtype=torch.int32, device=dev)
    owv = torch.empty((B, t), dtype=torch.bool, device=dev)
    ou = torch.empty((B,), dtype=torch.int32, device=dev)
    oact = torch.empty((B,), dtype=torch.bool, device=dev)
    if B:
        fn = common.kernel_fn("repro_search_step", [common.PTR] * 13 + [common.INT] * 10 + [common.PTR])
        with torch.cuda.device(dev):
            rc = fn(
                table.data_ptr(), codes.data_ptr(), nbrs.data_ptr(), fresh.data_ptr(),
                wl.dists.data_ptr(), wl.ids.data_ptr(), wl.visited.data_ptr(), active.data_ptr(),
                owd.data_ptr(), owi.data_ptr(), owv.data_ptr(), ou.data_ptr(), oact.data_ptr(),
                B, n, m, R, t, Rp, P, int(eager), THREADS, int(P <= WARP_MAX_P),
                common.stream_of(table),
            )
        common.check_launch(rc, f"search_step (m={m}, R={R}, t={t})")
        fused_step.launches += 1
    return owd, owi, owv, ou, oact


def fused_step(
    table: torch.Tensor,
    codes: torch.Tensor,
    wl: Worklist,
    nbrs: torch.Tensor,
    fresh: torch.Tensor,
    active: torch.Tensor,
    *,
    eager: bool = True,
    tile_rows: int = 0,
) -> tuple[Worklist, torch.Tensor, torch.Tensor]:
    """One fused iteration: returns (worklist', u_next (B,), active' (B,)).

    table (B, m, 256) f32; codes (n, m) uint8; nbrs (B, R) int32 (ids of
    fresh lanes in [0, n)); fresh (B, R) bool; wl (B, t); active (B,) bool.
    """
    if int(tile_rows) != tile_rows or tile_rows < 0:
        raise ValueError(f"tile_rows must be an integer >= 0, got {tile_rows}")
    tensors = (table, codes, nbrs, fresh, wl.dists, wl.ids, wl.visited, active)
    if common.on_cuda(*tensors):
        d, i, v, u, a = _launch(table, codes, nbrs, fresh, wl, active, eager)
    else:
        d, i, v, u, a = step_ref(
            table, codes, nbrs, fresh, wl.dists, wl.ids, wl.visited, active, eager=eager
        )
    return Worklist(d, i, v), u, a


def fused_traverse(
    wl: Worklist,
    cand_dists: torch.Tensor,
    cand_ids: torch.Tensor,
    active: torch.Tensor,
    *,
    eager: bool = True,
) -> tuple[Worklist, torch.Tensor, torch.Tensor]:
    """Sort + select + merge + mark-visited on precomputed candidate
    distances: returns (worklist', u_next (B,), active' (B,)).

    cand_dists (B, R) f32, +inf on masked lanes; cand_ids (B, R) int32,
    INVALID on masked lanes; wl (B, t); active (B,) bool.
    """
    P = merge_slots(cand_dists.shape[1], wl.dists.shape[1])
    return _traverse(wl, cand_dists, cand_ids, active, eager=eager, warps=traverse_warps(P))


def _traverse(wl: Worklist, cand_dists, cand_ids, active, *, eager: bool, warps: int):
    """`fused_traverse` with the kernel's block shape given (the tests and
    chip_smoke.py check and time each): `warps` queries a block in the warp
    regime (P <= WARP_MAX_P), or 0 for the block regime. CPU tensors take
    the plain version."""
    tensors = (cand_dists, cand_ids, wl.dists, wl.ids, wl.visited, active)
    if not common.on_cuda(*tensors):
        d, i, v, u, a = traverse_ref(cand_dists, cand_ids, wl.dists, wl.ids, wl.visited, active,
                                     eager=eager)
        return Worklist(d, i, v), u, a
    B, t = wl.dists.shape
    R = cand_dists.shape[1]
    for name, x, dtype, shape in (
        ("cand_dists", cand_dists, torch.float32, (B, R)),
        ("cand_ids", cand_ids, torch.int32, (B, R)),
        ("wl.dists", wl.dists, torch.float32, (B, t)),
        ("wl.ids", wl.ids, torch.int32, (B, t)),
        ("wl.visited", wl.visited, torch.bool, (B, t)),
        ("active", active, torch.bool, (B,)),
    ):
        common.check(x, name, dtype, shape)
    if R < 1 or t < 1:
        raise ValueError(f"need R, t >= 1, got R={R}, t={t}")
    Rp = common.next_pow2(R)
    P = merge_slots(R, t)
    dev = wl.dists.device
    owd, owi, owv = torch.empty_like(wl.dists), torch.empty_like(wl.ids), torch.empty_like(wl.visited)
    ou = torch.empty((B,), dtype=torch.int32, device=dev)
    oact = torch.empty((B,), dtype=torch.bool, device=dev)
    if B:
        fn = common.kernel_fn("repro_fused_traverse", [common.PTR] * 11 + [common.INT] * 8 + [common.PTR])
        with torch.cuda.device(dev):
            rc = fn(
                cand_dists.data_ptr(), cand_ids.data_ptr(), wl.dists.data_ptr(), wl.ids.data_ptr(),
                wl.visited.data_ptr(), active.data_ptr(),
                owd.data_ptr(), owi.data_ptr(), owv.data_ptr(), ou.data_ptr(), oact.data_ptr(),
                B, R, t, Rp, P, int(eager), THREADS, warps, common.stream_of(cand_dists),
            )
        common.check_launch(rc, f"fused_traverse (R={R}, t={t}, warps={warps})")
        fused_traverse.launches += 1
    return Worklist(owd, owi, owv), ou, oact


def local_adc(
    table: torch.Tensor,
    codes_local: torch.Tensor,
    rel: torch.Tensor,
    own: torch.Tensor,
    *,
    tile_rows: int = 0,
) -> torch.Tensor:
    """Owner-shard fused gather + ADC: (B, R) f32 contributions, 0.0 where
    a lane is not owned.

    table (B, m, 256) f32; codes_local (n_loc, m) uint8, this shard's rows;
    rel (B, R) int32 shard-relative ids in [0, n_loc); own (B, R) bool.
    `tile_rows` is validated as for `fused_step` and changes no bit.
    """
    if int(tile_rows) != tile_rows or tile_rows < 0:
        raise ValueError(f"tile_rows must be an integer >= 0, got {tile_rows}")
    if not common.on_cuda(table, codes_local, rel, own):
        return local_adc_ref(table, codes_local, rel, own)
    B, m, _ = table.shape
    n_loc = codes_local.shape[0]
    R = rel.shape[1]
    for name, x, dtype, shape in (
        ("table", table, torch.float32, (B, m, 256)),
        ("codes_local", codes_local, torch.uint8, (n_loc, m)),
        ("rel", rel, torch.int32, (B, R)),
        ("own", own, torch.bool, (B, R)),
    ):
        common.check(x, name, dtype, shape)
    if n_loc < 1:
        raise ValueError("codes_local must hold at least one row")
    out = torch.empty((B, R), dtype=torch.float32, device=table.device)
    if B and R:
        fn = common.kernel_fn("repro_local_adc", [common.PTR] * 5 + [common.INT] * 5 + [common.PTR])
        # One thread per lane: one warp a block at the medoid seed (R = 1).
        threads = min(THREADS, -(-R // 32) * 32)
        with torch.cuda.device(table.device):
            rc = fn(table.data_ptr(), codes_local.data_ptr(), rel.data_ptr(), own.data_ptr(),
                    out.data_ptr(), B, R, m, n_loc, threads, common.stream_of(table))
        common.check_launch(rc, f"local_adc (m={m})")
        local_adc.launches += 1
    return out


fused_step.launches = 0
fused_traverse.launches = 0
local_adc.launches = 0


# ---------------------------------------------------------------- accounting
def hbm_candidate_roundtrips_per_hop(mode: str) -> int:
    """How many times one hop's (B, R) candidate tile crosses device memory.

    fused: K1 takes the neighbour ids in and scores, sorts and merges the
    tile in registers and shared memory, so it crosses once. staged
    (`StagedStep`): K2 writes the distances, K4 reads them and writes the
    sorted tile, K5 reads it -- four crossings. reference: the same four
    stage boundaries at least; eager PyTorch also materialises every op
    between them.
    """
    return {"fused": 1, "staged": 4, "reference": 4}[mode]


def hbm_intermediate_bytes_per_hop(mode: str, batch: int, R: int, m: int, t: int) -> int:
    """Device-memory bytes of the intermediates one hop writes between its
    stages (not the loop state the hop reads: neighbour ids, fresh mask,
    worklist). `t` does not enter: the worklist is loop state.

    fused: none (K1 keeps the gather, the distances and the sorted tile on
    chip). staged and reference, as `StagedStep.step` and its PQ distance
    function write them, per (query, lane): the safe ids (`zeros_like`, the
    int32 `where` and its int64 copy, 4 + 4 + 8 bytes), the gathered code
    rows (m bytes of uint8), the distances (4), the candidate ids
    (`full_like` and `where`, 4 + 4) and the sorted tile (4 + 4).
    """
    if mode == "fused":
        return 0
    return batch * R * (4 + 4 + 8 + m + 4 + 4 + 4 + 8)


def hbm_codes_stream_bytes_per_hop(
    mode: str, batch: int, n: int, m: int, tile_rows: int = 0, *, R: int
) -> int:
    """Bytes of code rows the fused hop kernel reads a hop, at most.

    K1 gathers from global memory the (m-byte) code row of each fresh lane
    only, at any n: at most B·R rows a hop, whatever the size of the codes
    block (n) and `tile_rows` (validated, no effect). The TPU kernel read
    the whole (n, m) block instead. A lane that the bloom filter or the
    worklist ruled out reads nothing, so the hop's real figure is the fresh
    lanes times m. staged and reference gather the same rows in PyTorch
    before the ADC kernel, counted as the gathered tile of
    `hbm_intermediate_bytes_per_hop`, so this lane reports 0 for them.
    """
    if int(tile_rows) != tile_rows or tile_rows < 0:
        raise ValueError(f"tile_rows must be an integer >= 0, got {tile_rows}")
    if mode != "fused":
        return 0
    return batch * R * m


__all__ = [
    "fused_step", "fused_traverse", "local_adc", "local_adc_ref", "step_ref", "traverse_ref",
    "hbm_candidate_roundtrips_per_hop", "hbm_intermediate_bytes_per_hop",
    "hbm_codes_stream_bytes_per_hop",
]
