"""Bitonic sort (K4) and worklist merge (K5): the CUDA kernels on the card,
their plain versions on the CPU. The staged kernel mode runs them between
the ADC kernel and the search loop, each its own launch.

Each has two regimes, chosen here from the padded row p (K4: next_pow2(n),
K5: next_pow2(t + R)): up to `WARP_MAX_P` one warp per row holds it in
registers, `SORT_ROWS` (K4) or `MERGE_ROWS` (K5) rows a block; beyond it one
block per row works on it in shared memory."""
from __future__ import annotations

import torch

from repro_torch.core.worklist import Worklist
from repro_torch.kernels import common

from .ref import merge_ref, sort_kv_ref

MAX_THREADS = 128
# The warp regime's longest row: 16 elements a lane.
WARP_MAX_P = 512
# Rows a block of K4's warp regime, one warp each (the kernel takes 1 to 8):
# the fastest of 1, 2, 4 and 8 at the main shape (chip_smoke.py's sweep;
# PERF.md section 6).
SORT_ROWS = 4
# Rows a block of K5's warp regime (the kernel takes 1 to 8), chosen the same
# way.
MERGE_ROWS = 4


def _threads(p: int) -> int:
    """The block regime: one thread per compare-exchange pair, at least a
    warp."""
    return max(32, min(MAX_THREADS, p // 2))


def sort_rows(p: int) -> int:
    """Rows a block of K4 for rows padded to p: `SORT_ROWS` (the warp regime,
    one warp a row) up to `WARP_MAX_P`, else 0 (the block regime, one row a
    block of `_threads(p)`)."""
    return SORT_ROWS if p <= WARP_MAX_P else 0


def sort_kv(dists: torch.Tensor, ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort (B, n) candidate lists ascending by (dist, id); f32 and int32."""
    return _sort(dists, ids, rows=sort_rows(common.next_pow2(dists.shape[-1])))


def _sort(dists: torch.Tensor, ids: torch.Tensor, *, rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`sort_kv` with the kernel's block shape given (the tests and
    chip_smoke.py check and time each): `rows` rows a block in the warp
    regime (p <= WARP_MAX_P), or 0 for the block regime. CPU tensors take
    the plain version."""
    if not common.on_cuda(dists, ids):
        return sort_kv_ref(dists, ids)
    B, n = dists.shape
    common.check(dists, "dists", torch.float32, (B, n))
    common.check(ids, "ids", torch.int32, (B, n))
    out_d = torch.empty_like(dists)
    out_i = torch.empty_like(ids)
    if B and n:
        p = common.next_pow2(n)
        threads = 32 * rows if rows else _threads(p)
        fn = common.kernel_fn("repro_bitonic_sort", [common.PTR] * 4 + [common.INT] * 5 + [common.PTR])
        with torch.cuda.device(dists.device):
            rc = fn(dists.data_ptr(), ids.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
                    B, n, p, threads, rows, common.stream_of(dists))
        common.check_launch(rc, f"bitonic sort (n={n}, rows={rows})")
        sort_kv.launches += 1
    return out_d, out_i


def merge_rows(p: int) -> int:
    """Rows a block of K5 for merge rows padded to p: `MERGE_ROWS` (the warp
    regime, one warp a row) up to `WARP_MAX_P`, else 0 (the block regime,
    one row a block of `_threads(p)`)."""
    return MERGE_ROWS if p <= WARP_MAX_P else 0


def merge_worklist(wl: Worklist, cand_dists: torch.Tensor, cand_ids: torch.Tensor) -> Worklist:
    """Merge sorted (B, R) candidates, which enter unvisited, into the sorted
    (B, t) worklist; keep the t best with their visited flags. Both inputs
    must be sorted by (dist, id)."""
    p = common.next_pow2(wl.dists.shape[-1] + cand_dists.shape[-1])
    return _merge(wl, cand_dists, cand_ids, rows=merge_rows(p))


def _merge(wl: Worklist, cand_dists: torch.Tensor, cand_ids: torch.Tensor, *, rows: int) -> Worklist:
    """`merge_worklist` with the kernel's block shape given (the tests and
    chip_smoke.py check and time each): `rows` rows a block in the warp
    regime (p <= WARP_MAX_P), or 0 for the block regime. CPU tensors take
    the plain version."""
    tensors = (wl.dists, wl.ids, wl.visited, cand_dists, cand_ids)
    if not common.on_cuda(*tensors):
        return Worklist(*merge_ref(*tensors))
    B, t = wl.dists.shape
    R = cand_dists.shape[1]
    for name, x, dtype, shape in (
        ("wl.dists", wl.dists, torch.float32, (B, t)),
        ("wl.ids", wl.ids, torch.int32, (B, t)),
        ("wl.visited", wl.visited, torch.bool, (B, t)),
        ("cand_dists", cand_dists, torch.float32, (B, R)),
        ("cand_ids", cand_ids, torch.int32, (B, R)),
    ):
        common.check(x, name, dtype, shape)
    out_d, out_i, out_v = torch.empty_like(wl.dists), torch.empty_like(wl.ids), torch.empty_like(wl.visited)
    if B and t:
        p = common.next_pow2(t + R)
        threads = 32 * rows if rows else _threads(p)
        fn = common.kernel_fn("repro_bitonic_merge", [common.PTR] * 8 + [common.INT] * 6 + [common.PTR])
        with torch.cuda.device(wl.dists.device):
            rc = fn(wl.dists.data_ptr(), wl.ids.data_ptr(), wl.visited.data_ptr(),
                    cand_dists.data_ptr(), cand_ids.data_ptr(),
                    out_d.data_ptr(), out_i.data_ptr(), out_v.data_ptr(),
                    B, t, R, p, threads, rows, common.stream_of(wl.dists))
        common.check_launch(rc, f"bitonic merge (t={t}, R={R}, rows={rows})")
        merge_worklist.launches += 1
    return Worklist(out_d, out_i, out_v)


sort_kv.launches = 0
merge_worklist.launches = 0

__all__ = ["sort_kv", "merge_worklist", "sort_kv_ref", "merge_ref"]
