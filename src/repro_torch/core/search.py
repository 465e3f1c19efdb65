"""BANG batched greedy search -- Algorithm 2 of the paper, on PyTorch.

One query per CUDA thread block (the paper's mapping) inside the fused step
kernel; the batch advances in lock-step hops of a host loop, with a
convergence mask standing in for per-block exit. Each hop performs the
paper's stages:

    fetch neighbours of u*        (device gather in-memory)
    bloom-filter visited           (§4.4)
    PQ asymmetric distances        (§4.5)
    sort neighbours                (§4.7)
    merge into worklist 𝓛          (§4.8)
    select next candidate u*       (§4.6 eager or lazy)

The distance/sort/select/merge stages sit behind one pluggable StepFn
(`SearchConfig.kernel_mode`):

    "reference"  plain PyTorch: gather ADC + stable sorts
    "staged"     separate kernels per stage -- raises NotImplementedError
                 until the bitonic sort and merge kernels are ported
    "fused"      the search_step kernel: the whole hop in one launch

"reference" and "fused" give identical neighbour ids. This slice ports the
"inmem" variant (graph and codes on the device).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..kernels.pq_adc import ops as adc_ops
from ..kernels.search_step import ops as step_ops
from . import bloom as bloomlib
from . import pq as pqlib
from .worklist import (
    INVALID_ID,
    Worklist,
    first_unvisited,
    mark_visited,
    merge_worklist,
    sort_candidates,
    worklist_init,
)

KERNEL_MODES = ("reference", "staged", "fused")


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    t: int = 64                  # worklist size (paper's search parameter t/L)
    max_iters: int = 0           # 0 -> ceil(1.5*t)+8 (Fig 10 headroom)
    bloom_z: int = 399887        # paper §6.3 default
    eager: bool = True           # §4.6 eager candidate selection
    use_kernels: bool = False    # legacy alias for kernel_mode="staged"
    kernel_mode: str | None = None  # "reference" | "staged" | "fused"
    # Codes tile rows of the reference's beyond-VMEM kernel. The GPU kernel
    # gathers code rows from global memory at any n, so every value gives the
    # same result; it is validated and keys cached pipelines as in the
    # reference.
    codes_tile_rows: int = 0

    def __post_init__(self) -> None:
        if self.codes_tile_rows < 0:
            raise ValueError(
                f"codes_tile_rows must be >= 0, got {self.codes_tile_rows}"
            )

    def iters(self) -> int:
        return self.max_iters if self.max_iters > 0 else int(1.5 * self.t) + 8

    def resolved_kernel_mode(self) -> str:
        """Explicit kernel_mode wins; else the legacy use_kernels flag."""
        if self.kernel_mode is not None:
            if self.kernel_mode not in KERNEL_MODES:
                raise ValueError(
                    f"unknown kernel_mode {self.kernel_mode!r}, expected one "
                    f"of {KERNEL_MODES}"
                )
            return self.kernel_mode
        return "staged" if self.use_kernels else "reference"

    def uses_kernels(self) -> bool:
        """Whether the kernels (re-rank included) are used."""
        return self.resolved_kernel_mode() != "reference"


class SearchResult(NamedTuple):
    worklist: Worklist           # final 𝓛 (B, t), sorted
    history_ids: torch.Tensor    # (B, C) every expanded candidate, INVALID padded
    history_len: torch.Tensor    # (B,) number of expanded candidates
    n_iters: int                 # lock-step iterations executed
    n_hops: torch.Tensor         # (B,) per-query expansions (== history_len)


NeighborFn = Callable[[torch.Tensor], torch.Tensor]           # (B,) -> (B, R)
DistanceFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class StepFn:
    """One Algorithm-2 iteration body.

    `init_dists(ids, valid)` seeds the worklist (medoid distance);
    `step(wl, nbrs, fresh, active)` consumes the bloom-filtered neighbour
    tile and returns `(worklist', u_next, active')` with the §4.6 selection
    applied and the selected slot already marked visited.
    """

    eager: bool = True

    def init_dists(self, ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def step(self, wl: Worklist, nbrs: torch.Tensor, fresh: torch.Tensor, active: torch.Tensor):
        raise NotImplementedError


class ReferenceStep(StepFn):
    """Plain PyTorch body: gather ADC (via distance_fn) + stable sorts."""

    def __init__(self, distance_fn: DistanceFn, eager: bool = True) -> None:
        self.distance_fn = distance_fn
        self.eager = eager

    def init_dists(self, ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return self.distance_fn(ids, valid)

    def step(self, wl: Worklist, nbrs: torch.Tensor, fresh: torch.Tensor, active: torch.Tensor):
        d = self.distance_fn(nbrs, fresh)
        cand_ids = torch.where(fresh, nbrs, torch.full_like(nbrs, INVALID_ID))
        sd, si = sort_candidates(d, cand_ids)
        if self.eager:
            # §4.6: best of {first unvisited of the pre-merge worklist,
            # nearest fresh neighbour} -- known before the merge.
            wl_u, wl_found = first_unvisited(wl)
            inf = torch.full_like(wl.dists, float("inf"))
            wl_d = torch.where(wl.visited, inf, wl.dists).min(dim=-1).values
            wl_d = torch.where(wl_found, wl_d, inf[:, 0])
            u_next = torch.where(sd[:, 0] < wl_d, si[:, 0], wl_u)
            found = wl_found | (si[:, 0] != INVALID_ID)
            wl = merge_worklist(wl, sd, si)
        else:
            wl = merge_worklist(wl, sd, si)
            u_next, found = first_unvisited(wl)
        active = active & found
        u_next = torch.where(active, u_next, torch.full_like(u_next, INVALID_ID))
        return mark_visited(wl, u_next), u_next, active


class FusedStep(StepFn):
    """The whole iteration body in one search_step kernel launch; the code
    gather happens inside the kernel."""

    def __init__(self, table: torch.Tensor, codes: torch.Tensor, eager: bool = True,
                 tile_rows: int = 0) -> None:
        self.table = table
        self.codes = codes
        self.eager = eager
        self.tile_rows = tile_rows

    def init_dists(self, ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        # One-off medoid seeding through the ADC kernel (one candidate per
        # query); the kernel writes +inf where invalid.
        safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
        return adc_ops.adc(self.table, self.codes[safe], valid)

    def step(self, wl: Worklist, nbrs: torch.Tensor, fresh: torch.Tensor, active: torch.Tensor):
        return step_ops.fused_step(
            self.table, self.codes, wl, nbrs, fresh, active,
            eager=self.eager, tile_rows=self.tile_rows,
        )


def _adc_distance_fn(table: torch.Tensor, codes: torch.Tensor) -> DistanceFn:
    """PQ asymmetric distances for candidate ids (paper §4.5)."""

    def fn(ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
        d = pqlib.adc_distance(table, codes[safe])
        return torch.where(valid, d, torch.full_like(d, float("inf")))

    return fn


def _adc_step_fn(table: torch.Tensor, codes: torch.Tensor, cfg: SearchConfig) -> StepFn:
    mode = cfg.resolved_kernel_mode()
    if mode == "fused":
        return FusedStep(table, codes, cfg.eager, cfg.codes_tile_rows)
    if mode == "staged":
        raise NotImplementedError(
            'kernel_mode="staged" needs the bitonic sort and merge kernels, '
            "which are not ported yet"
        )
    return ReferenceStep(_adc_distance_fn(table, codes), cfg.eager)


def device_neighbor_fn(adjacency: torch.Tensor) -> NeighborFn:
    """In-memory variant: adjacency rows gathered from device memory."""

    def fn(u: torch.Tensor) -> torch.Tensor:
        pad = u == INVALID_ID
        nbrs = adjacency[torch.where(pad, torch.zeros_like(u), u).long()]
        return torch.where(pad[:, None], torch.full_like(nbrs, -1), nbrs)

    return fn


def bang_search(
    queries: torch.Tensor,
    *,
    neighbor_fn: NeighborFn,
    step_fn: StepFn,
    medoid: int,
    cfg: SearchConfig,
    prefetch_fn=None,
    tombstone_fn=None,
) -> SearchResult:
    """Run Algorithm 2 for a batch of queries.

    A host loop with the reference's stop test, `any(active) & it < C-1`, so
    `n_iters` and `n_hops` match the reference. Reading `any(active)` each
    hop synchronises the host with the device once per hop.

    `prefetch_fn` (the host-I/O double-buffered exchange) and `tombstone_fn`
    (streaming deletes) keep their places in the signature; they come with
    later slices of the port and raise NotImplementedError until then.
    """
    if prefetch_fn is not None:
        raise NotImplementedError("prefetch_fn comes with the host-I/O slice of the port")
    if tombstone_fn is not None:
        raise NotImplementedError("tombstone_fn comes with the mutability slice of the port")
    B = queries.shape[0]
    dev = queries.device
    t, C = cfg.t, cfg.iters()

    # 𝓛 = {medoid}, bloom = {medoid} (Algorithm 2 line 2).
    med = torch.full((B,), medoid, dtype=torch.int32, device=dev)
    med_d = step_fn.init_dists(med[:, None], torch.ones((B, 1), dtype=torch.bool, device=dev))[:, 0]
    wl = worklist_init(B, t, dev)
    wl.dists[:, 0] = med_d
    wl.ids[:, 0] = med
    filt = bloomlib.bloom_set(bloomlib.bloom_init(B, cfg.bloom_z, dev), med[:, None])
    hist = torch.full((B, C), INVALID_ID, dtype=torch.int32, device=dev)
    hist[:, 0] = med
    hist_len = torch.ones((B,), dtype=torch.int32, device=dev)
    u = med
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    rows = torch.arange(B, device=dev)

    it = 0
    while it < C - 1 and bool(active.any()):
        # 1. Fetch neighbours of the pending candidate.
        nbrs = neighbor_fn(u)                                   # (B, R)
        valid = (nbrs >= 0) & active[:, None]
        # 2. Bloom filter: drop already-seen neighbours, insert fresh ones.
        fresh, filt = bloomlib.bloom_query_and_set(filt, nbrs, valid)
        # 3-5. Distances + sort + select + merge behind the StepFn.
        wl, u, active = step_fn.step(wl, nbrs, fresh, active)
        # 6. Record the expansion for re-ranking.
        pos = torch.clamp(hist_len, max=C - 1).long()
        hist[rows, pos] = torch.where(active, u, hist[rows, pos])
        hist_len = hist_len + active.to(torch.int32)
        it += 1

    return SearchResult(
        worklist=wl, history_ids=hist, history_len=hist_len, n_iters=it, n_hops=hist_len,
    )


def search_inmem(
    queries: torch.Tensor,
    table: torch.Tensor,
    codes: torch.Tensor,
    adjacency: torch.Tensor,
    medoid: int,
    cfg: SearchConfig,
) -> SearchResult:
    """BANG In-memory: graph and PQ codes on the device."""
    return bang_search(
        queries,
        neighbor_fn=device_neighbor_fn(adjacency),
        step_fn=_adc_step_fn(table, codes, cfg),
        medoid=medoid,
        cfg=cfg,
    )
