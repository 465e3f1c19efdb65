"""BANG batched greedy search -- Algorithm 2 of the paper, on PyTorch.

One query per CUDA thread block (the paper's mapping) inside the kernels;
the batch advances in lock-step hops of a host loop, with a convergence mask
standing in for per-block exit. Each hop performs the paper's stages:

    fetch neighbours of u*        (host RAM in BANG Base; device gather in-memory)
    bloom-filter visited           (§4.4)
    PQ asymmetric distances        (§4.5; exact L2 in the Exact-distance variant)
    sort neighbours                (§4.7)
    merge into worklist 𝓛          (§4.8)
    select next candidate u*       (§4.6 eager or lazy)

The distance/sort/select/merge stages sit behind one pluggable StepFn
(`SearchConfig.kernel_mode`):

    "reference"  plain PyTorch: gather ADC + stable sorts
    "staged"     one kernel per stage: ADC, bitonic sort, bitonic merge
    "fused"      the search_step kernel: the whole hop in one launch (the
                 traverse-only kernel where distances come from full vectors)

All three give identical neighbour ids. `kernel_mode=None` resolves by
device: "fused" on a CUDA device, "reference" on the CPU.

Variants (paper §5):
    base    graph + full vectors in pinned host RAM; per hop the frontier
            goes to the host and its adjacency rows come back
    inmem   graph on the device, PQ distances (BANG In-memory)
    exact   graph + vectors on the device, exact L2, no re-rank
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple

import torch

from ..kernels.bitonic import ops as bitonic_ops
from ..kernels.common import pad_axis
from ..kernels.pq_adc import ops as adc_ops
from ..kernels.search_step import ops as step_ops
from . import bloom as bloomlib
from . import pq as pqlib
from .hostrows import HostRows
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
    kernel_mode: str | None = None  # "reference" | "staged" | "fused"; None: by device
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

    def resolved_kernel_mode(self, device: torch.device | str) -> str:
        """An explicit kernel_mode wins; None means "fused" for a search on a
        CUDA device and "reference" on the CPU."""
        if self.kernel_mode is not None:
            if self.kernel_mode not in KERNEL_MODES:
                raise ValueError(
                    f"unknown kernel_mode {self.kernel_mode!r}, expected one "
                    f"of {KERNEL_MODES}"
                )
            return self.kernel_mode
        return "fused" if torch.device(device).type == "cuda" else "reference"


class SearchResult(NamedTuple):
    worklist: Worklist           # final 𝓛 (B, t), sorted
    history_ids: torch.Tensor    # (B, C) every expanded candidate, INVALID padded
    history_len: torch.Tensor    # (B,) number of expanded candidates
    n_iters: int                 # lock-step iterations executed
    n_hops: torch.Tensor         # (B,) per-query expansions (== history_len)


NeighborFn = Callable[[torch.Tensor], torch.Tensor]           # (B,) -> (B, R), on the device
DistanceFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# (u_pred (B,), active (B,)) -> a ticket the next hop's fetch redeems
PrefetchFn = Callable[[torch.Tensor, torch.Tensor], object]


class StepFn:
    """One Algorithm-2 iteration body.

    `init_dists(ids, valid)` seeds the worklist (medoid distance);
    `step(wl, nbrs, fresh, active)` consumes the bloom-filtered neighbour
    tile and returns `(worklist', u_next, active')` with the §4.6 selection
    applied and the selected slot already marked visited.

    `step_with_prefetch` is the async-fetch seam for the host-I/O subsystem
    (`repro_torch.runtime.hostio`): it also calls `prefetch_fn(u_pred,
    active')` with the expected next frontier and returns the resulting
    ticket, which the search loop hands to the next hop's fetch. The
    default issues after the whole step; steps whose eager selection is
    known before the merge (ReferenceStep, StagedStep) issue *between
    selection and merge*, so the host gather overlaps the merge.
    """

    eager: bool = True

    def init_dists(self, ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def step(self, wl: Worklist, nbrs: torch.Tensor, fresh: torch.Tensor, active: torch.Tensor):
        raise NotImplementedError

    def step_with_prefetch(self, wl: Worklist, nbrs: torch.Tensor, fresh: torch.Tensor,
                           active: torch.Tensor, prefetch_fn: PrefetchFn):
        wl, u_next, active = self.step(wl, nbrs, fresh, active)
        return wl, u_next, active, prefetch_fn(u_next, active)


class ReferenceStep(StepFn):
    """Plain PyTorch body: distances from `distance_fn` + stable sorts."""

    def __init__(self, distance_fn: DistanceFn, eager: bool = True) -> None:
        self.distance_fn = distance_fn
        self.eager = eager

    def init_dists(self, ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return self.distance_fn(ids, valid)

    def _sort(self, d: torch.Tensor, i: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return sort_candidates(d, i)

    def _merge(self, wl: Worklist, sd: torch.Tensor, si: torch.Tensor) -> Worklist:
        return merge_worklist(wl, sd, si)

    def _body(self, wl: Worklist, nbrs: torch.Tensor, fresh: torch.Tensor, active: torch.Tensor,
              prefetch_fn: PrefetchFn | None = None):
        d = self.distance_fn(nbrs, fresh)
        cand_ids = torch.where(fresh, nbrs, torch.full_like(nbrs, INVALID_ID))
        sd, si = self._sort(d, cand_ids)
        tok = None
        if self.eager:
            # §4.6: best of {first unvisited of the pre-merge worklist,
            # nearest fresh neighbour} -- known before the merge.
            wl_u, wl_found = first_unvisited(wl)
            inf = torch.full_like(wl.dists, float("inf"))
            wl_d = torch.where(wl.visited, inf, wl.dists).min(dim=-1).values
            wl_d = torch.where(wl_found, wl_d, inf[:, 0])
            u_next = torch.where(sd[:, 0] < wl_d, si[:, 0], wl_u)
            found = wl_found | (si[:, 0] != INVALID_ID)
            if prefetch_fn is not None:
                # The expected frontier is known before the merge, so hop
                # k+1's host gather is issued here and runs while the merge
                # is launched. It is the frontier before the convergence
                # mask; the fetch re-gathers any lane that differs.
                tok = prefetch_fn(u_next, active & found)
            wl = self._merge(wl, sd, si)
        else:
            wl = self._merge(wl, sd, si)
            u_next, found = first_unvisited(wl)
        active = active & found
        u_next = torch.where(active, u_next, torch.full_like(u_next, INVALID_ID))
        if prefetch_fn is not None and tok is None:
            tok = prefetch_fn(u_next, active)        # lazy selection: after the merge
        return mark_visited(wl, u_next), u_next, active, tok

    def step(self, wl: Worklist, nbrs: torch.Tensor, fresh: torch.Tensor, active: torch.Tensor):
        wl, u_next, active, _ = self._body(wl, nbrs, fresh, active)
        return wl, u_next, active

    def step_with_prefetch(self, wl: Worklist, nbrs: torch.Tensor, fresh: torch.Tensor,
                           active: torch.Tensor, prefetch_fn: PrefetchFn):
        return self._body(wl, nbrs, fresh, active, prefetch_fn)


class StagedStep(ReferenceStep):
    """One kernel per stage: distances (the ADC kernel where `distance_fn`
    is PQ), then the bitonic sort kernel, then the bitonic merge kernel;
    the (B, R) candidate tile goes through device memory between them."""

    def _sort(self, d: torch.Tensor, i: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return bitonic_ops.sort_kv(d, i)

    def _merge(self, wl: Worklist, sd: torch.Tensor, si: torch.Tensor) -> Worklist:
        return bitonic_ops.merge_worklist(wl, sd, si)


class FusedTraverseStep(StepFn):
    """Distances from `distance_fn`, then sort + select + merge in one
    traverse kernel launch: for distances that cannot be taken inside the
    hop kernel, as the exact variant's full-vector L2."""

    def __init__(self, distance_fn: DistanceFn, eager: bool = True) -> None:
        self.distance_fn = distance_fn
        self.eager = eager

    def init_dists(self, ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return self.distance_fn(ids, valid)

    def step(self, wl: Worklist, nbrs: torch.Tensor, fresh: torch.Tensor, active: torch.Tensor):
        d = self.distance_fn(nbrs, fresh)
        cand_ids = torch.where(fresh, nbrs, torch.full_like(nbrs, INVALID_ID))
        return step_ops.fused_traverse(wl, d, cand_ids, active, eager=self.eager)


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


def make_step_fn(cfg: SearchConfig, distance_fn: DistanceFn, device: torch.device | str) -> StepFn:
    """StepFn for a pluggable distance source (the exact path), for a
    search on `device`."""
    mode = cfg.resolved_kernel_mode(device)
    if mode == "fused":
        return FusedTraverseStep(distance_fn, cfg.eager)
    if mode == "staged":
        return StagedStep(distance_fn, cfg.eager)
    return ReferenceStep(distance_fn, cfg.eager)


def _adc_step_fn(table: torch.Tensor, codes: torch.Tensor, cfg: SearchConfig) -> StepFn:
    """StepFn for the PQ variants: "fused" runs the whole hop in one kernel
    (code gather inside it); "staged" and "reference" gather the codes in
    the distance function."""
    mode = cfg.resolved_kernel_mode(table.device)
    if mode == "fused":
        return FusedStep(table, codes, cfg.eager, cfg.codes_tile_rows)
    return make_step_fn(cfg, _adc_distance_fn(table, codes, mode == "staged"), table.device)


def _adc_distance_fn(table: torch.Tensor, codes: torch.Tensor, use_kernels: bool) -> DistanceFn:
    """PQ asymmetric distances for candidate ids (paper §4.5): the (B, R, m)
    codes are gathered, then summed by the ADC kernel or its plain
    counterpart."""

    def fn(ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
        gathered = codes[safe]
        if use_kernels:
            return adc_ops.adc(table, gathered, valid)
        d = pqlib.adc_distance(table, gathered)
        return torch.where(valid, d, torch.full_like(d, float("inf")))

    return fn


def _fma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """acc + a*b rounded once to float32: the float32 product is exact in
    float64."""
    return (acc.double() + a.double() * b.double()).float()


def _xla_cpu_sq_norm(x: torch.Tensor) -> torch.Tensor:
    """sum(x*x, -1) in XLA:CPU's order: sequential fused multiply-adds."""
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for j in range(x.shape[-1]):
        acc = _fma(acc, x[..., j], x[..., j])
    return acc


def _xla_cpu_dot(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """einsum("brd,bd->br") in XLA:CPU's order: 8 strided fused-multiply-add
    partials, folded by neighbours ((0+1), (2+3), ...)."""
    lanes = 8
    q = pad_axis(q[:, None, :].expand_as(v), -1, lanes, 0.0)
    v = pad_axis(v, -1, lanes, 0.0)
    v, q = (x.reshape(*x.shape[:-1], -1, lanes) for x in (v, q))
    acc = torch.zeros(v.shape[:-2] + (lanes,), dtype=torch.float32, device=v.device)
    for j in range(v.shape[-2]):
        acc = _fma(acc, v[..., j, :], q[..., j, :])
    while acc.shape[-1] > 1:
        acc = acc[..., 0::2] + acc[..., 1::2]
    return acc[..., 0]


def _exact_distance_fn(data: torch.Tensor, queries: torch.Tensor) -> DistanceFn:
    """Exact squared-L2 distances (BANG Exact-distance variant, §5.2),
    ||q||^2 + ||v||^2 - 2<v,q> as in the reference.

    The formula cancels, so on near-ties the order of summation decides the
    ids. On the CPU the sums follow XLA:CPU's order (probed at d = 32 on
    (B >= 8, R > 1) tiles; the (B, 1) medoid seed can differ from it in the
    last bit), so the parity tests follow the reference's traversal. On the
    card one batched matrix product (TF32 off) takes the dot products.
    """
    q = queries.to(torch.float32)
    on_cpu = q.device.type == "cpu"
    qn = _xla_cpu_sq_norm(q) if on_cpu else (q * q).sum(-1)

    def fn(ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
        vecs = data[safe].to(torch.float32)                       # (B, R, d)
        if on_cpu:
            vn, dot = _xla_cpu_sq_norm(vecs), _xla_cpu_dot(vecs, q)
        else:
            vn, dot = (vecs * vecs).sum(-1), torch.bmm(vecs, q[:, :, None])[..., 0]
        d = qn[:, None] + vn - 2.0 * dot
        return torch.where(valid, d, torch.full_like(d, float("inf")))

    return fn


def device_neighbor_fn(adjacency: torch.Tensor) -> NeighborFn:
    """In-memory variant: adjacency rows gathered from device memory."""

    def fn(u: torch.Tensor) -> torch.Tensor:
        pad = u == INVALID_ID
        nbrs = adjacency[torch.where(pad, torch.zeros_like(u), u).long()]
        return torch.where(pad[:, None], torch.full_like(nbrs, -1), nbrs)

    return fn


class HostNeighborFn:
    """BANG Base: the adjacency stays in (pinned) host RAM and each hop
    crosses the link -- the frontier ids go to the host, the host gathers
    their rows and sends (B, R) ids back (Algorithm 2 lines 5-6), INVALID
    lanes as -1 rows.

    `bang_search` calls `fetch(u, active)`, which takes the hop's one
    device-to-host copy: the frontier with the inactive lanes marked, from
    which the host reads both the ids and the stop test. `wait_s` adds up
    the host seconds that copy takes (it waits for the device to finish the
    hop before it); `rows.gather_s` and `rows.send_s` the gather and the
    copy up.
    """

    INACTIVE = -2     # never an id: ids lie in [0, n) or are INVALID

    def __init__(self, rows: HostRows) -> None:
        self.rows = rows
        self.frontier_bytes = 0      # frontier ids copied to the host
        self.wait_s = 0.0

    def _frontier(self, u: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        lanes = torch.where(active, u, torch.full_like(u, self.INACTIVE)).cpu()
        self.wait_s += time.perf_counter() - t0
        self.frontier_bytes += lanes.numel() * lanes.element_size()
        return lanes

    def fetch(self, u: torch.Tensor, active: torch.Tensor) -> torch.Tensor | None:
        """Adjacency rows of the frontier, or None once no lane is active."""
        lanes = self._frontier(u, active)
        live = lanes != self.INACTIVE
        if not bool(live.any()):
            return None
        return self.rows.gather(torch.where(live, lanes, torch.full_like(lanes, INVALID_ID)), fill=-1)


def host_neighbor_fn(adjacency: torch.Tensor, device: torch.device | str) -> HostNeighborFn:
    """Neighbour source over an (n, R) int32 host adjacency (pinned for a
    CUDA device) serving searches on `device`."""
    return HostNeighborFn(HostRows(adjacency, device))


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
    hop synchronises the host with the device once per hop; with a host
    neighbour source (one with `fetch(u, active[, ticket])`:
    `HostNeighborFn`, or the host-I/O exchange) that one copy also brings
    the frontier to the host.

    With `prefetch_fn` (the host-I/O prefetched exchange, whose neighbour
    source is that exchange's `fetch`) each hop's `step_with_prefetch`
    issues the next hop's expected gather and the fetch redeems the ticket
    the hop before issued; a warm-start ticket on the medoid serves the
    first hop. The ticket's frontier copy carries the stop test, so a hop
    still synchronises once. Results are bit-exact vs the synchronous path.

    `tombstone_fn` (streaming deletes) keeps its place in the signature; it
    comes with a later slice of the port and raises NotImplementedError
    until then.
    """
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
    fetch = getattr(neighbor_fn, "fetch", None)
    tok = None
    if prefetch_fn is not None:
        if fetch is None:
            raise ValueError("prefetch_fn needs a host neighbour source (one with fetch)")
        # Warm-start ticket: the first hop's medoid fetch redeems a gather
        # issued before the loop.
        tok = prefetch_fn(med, active)

    it = 0
    while it < C - 1:
        # 1. Fetch neighbours of the pending candidate.
        if fetch is not None:
            nbrs = fetch(u, active) if prefetch_fn is None else fetch(u, active, tok)  # (B, R)
            if nbrs is None:
                break
        else:
            if not bool(active.any()):
                break
            nbrs = neighbor_fn(u)                               # (B, R)
        valid = (nbrs >= 0) & active[:, None]
        # 2. Bloom filter: drop already-seen neighbours, insert fresh ones.
        fresh, filt = bloomlib.bloom_query_and_set(filt, nbrs, valid)
        # 3-5. Distances + sort + select + merge behind the StepFn; with
        # prefetch it also issues the next hop's gather.
        if prefetch_fn is None:
            wl, u, active = step_fn.step(wl, nbrs, fresh, active)
        else:
            wl, u, active, tok = step_fn.step_with_prefetch(wl, nbrs, fresh, active, prefetch_fn)
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


def search_base(
    queries: torch.Tensor,
    table: torch.Tensor,
    codes: torch.Tensor,
    neighbor_fn: HostNeighborFn,
    medoid: int,
    cfg: SearchConfig,
    *,
    prefetch_fn: PrefetchFn | None = None,
) -> SearchResult:
    """BANG Base: PQ codes on the device, the graph in host RAM behind
    `neighbor_fn` (`host_neighbor_fn`, or the host-I/O subsystem's exchange
    with its `prefetch_fn`) -- bit-exact either way."""
    return bang_search(
        queries,
        neighbor_fn=neighbor_fn,
        step_fn=_adc_step_fn(table, codes, cfg),
        medoid=medoid,
        cfg=cfg,
        prefetch_fn=prefetch_fn,
    )


def search_exact(
    queries: torch.Tensor,
    data: torch.Tensor,
    adjacency: torch.Tensor,
    medoid: int,
    cfg: SearchConfig,
) -> SearchResult:
    """BANG Exact-distance: graph and full vectors on the device; distances
    come from full vectors, so even "fused" keeps the distance stage outside
    the kernel (FusedTraverseStep)."""
    dist = _exact_distance_fn(data, queries)
    return bang_search(
        queries,
        neighbor_fn=device_neighbor_fn(adjacency),
        step_fn=make_step_fn(cfg, dist, queries.device),
        medoid=medoid,
        cfg=cfg,
    )
