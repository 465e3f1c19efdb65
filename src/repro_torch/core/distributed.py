"""Mesh-sharded BANG: the per-rank body of the sharded search.

The reference spreads the index over the `model` axis of a
("data", "model") mesh and runs this body inside `shard_map`; here each rank
of a `repro_torch.distributed.Mesh` runs it as its own program. The
adjacency, the PQ codes and the full vectors are row-sharded over the model
group (rank s of it owns the contiguous rows [s * n_loc, (s + 1) * n_loc)),
queries over the data group, and each hop exchanges only the frontier:

    neighbour fetch : owner-shard gather + all-reduce(model) -- (B_loc, R) int32
    ADC distances   : owner-shard ADC    + all-reduce(model) -- (B_loc, R) f32
    worklist, bloom : replicated over the model group (no exchange)
    re-rank         : owner-shard exact L2 + all-reduce(model)

Each valid id is owned by exactly one rank of the model group, so a sum of
the owner-masked contributions rebuilds the full row exactly (x + 0 = x).
The adjacency has two placements: on the device (`sharded_neighbor_fn`) or
in this rank's pinned host memory (`host_shard_neighbor_fn`, BANG Base at
mesh scale: the frontier goes to the host, only owned rows come back). The
all-reduce is issued on every hop even when the group has one rank.

`bang_search` runs unchanged on every rank. The ranks of a model group hold
identical worklists, so they agree on every stop test and issue the same
collectives in the same order; the ranks of different data groups run their
own loops and meet only in the final all-gather.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.pq_adc import ops as adc_ops
from ..kernels.rerank_l2 import ops as rr_ops
from ..kernels.search_step import ops as step_ops
from . import pq as pqlib
from .hostrows import HostRows
from .search import (
    HostNeighborFn,
    SearchConfig,
    SearchResult,
    _xla_cpu_dot,
    _xla_cpu_sq_norm,
    bang_search,
    make_step_fn,
)
from .worklist import INVALID_ID


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum `x` in place over `group`. `all_reduce_sum.calls` counts the
    collectives issued and `all_reduce_sum.seconds` adds up the host time
    spent issuing them. On a card the collective is ordered after the work
    already queued on the current stream, and the work queued after it waits
    for it."""
    t0 = time.perf_counter()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    all_reduce_sum.seconds += time.perf_counter() - t0
    all_reduce_sum.calls += 1
    return x


all_reduce_sum.calls = 0
all_reduce_sum.seconds = 0.0


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate `x` over the ranks of `group` along axis 0, in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, 0)


def _owned_at(shard: int, local_n: int, ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(relative ids, ownership mask) for shard `shard` of contiguous rows.

    Over shards 0..S-1, every id in [0, S*local_n) is owned exactly once, and
    INVALID, negative and out-of-range ids by nobody. Relative ids are
    clamped into [0, local_n), so they are safe gathers.
    """
    rel = ids - shard * local_n
    own = (rel >= 0) & (rel < local_n) & (ids != INVALID_ID) & (ids >= 0)
    return torch.clamp(rel, 0, local_n - 1), own


def _owned(local_n: int, ids: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor]:
    """(relative ids, ownership mask) for this rank's block of the model group."""
    return _owned_at(dist.get_rank(group), local_n, ids)


def sharded_neighbor_fn(adjacency_local: torch.Tensor, group) -> Callable:
    """Frontier adjacency fetch from device-sharded rows: owner gather +
    all-reduce (Algorithm 2 lines 5-6)."""
    n_loc = adjacency_local.shape[0]

    def fn(u: torch.Tensor) -> torch.Tensor:
        rel, own = _owned(n_loc, u, group)
        rows = adjacency_local[rel.long()]                          # (B, R)
        # Shifted by +1, so that 0 is neutral in the sum (pads are -1).
        contrib = torch.where(own[:, None], rows + 1, torch.zeros_like(rows))
        return all_reduce_sum(contrib, group) - 1

    return fn


def host_shard_service(
    partition: torch.Tensor, rel: torch.Tensor, own: torch.Tensor, out: torch.Tensor | None = None
) -> torch.Tensor:
    """One shard's host adjacency contribution, on the host.

    Only owned lanes index `partition` (sentinel, padded and other shards'
    ids never touch it); their rows come back shifted by +1 and every other
    lane is 0, the neutral element of the sum over shards. Written into
    `out` (a (len(rel), R) int32 host tensor) where it is given.
    """
    if out is None:
        out = torch.empty((rel.shape[0], partition.shape[1]), dtype=torch.int32)
    out.zero_()
    lanes = own.nonzero()[:, 0]
    out[lanes] = partition.index_select(0, rel[lanes].long()) + 1
    return out


class HostShardNeighborFn(HostNeighborFn):
    """Sharded BANG Base: this rank's block of the adjacency stays in (pinned)
    host RAM. Per hop one copy of the frontier comes to the host (it carries
    the stop test, as for `HostNeighborFn`), the host gathers the rows this
    rank owns into a pinned buffer, one non-blocking copy sends them up, and
    an all-reduce over the model group rebuilds the full rows. The copy and
    the all-reduce are queued on one stream in that order, and the buffer is
    written again only after the event behind its copy has passed
    (`HostRows.send`)."""

    def __init__(self, partition: torch.Tensor, group, device: torch.device | str) -> None:
        super().__init__(HostRows(partition, device))
        self.group = group
        self.n_loc = int(partition.shape[0])

    def fetch(self, u: torch.Tensor, active: torch.Tensor) -> torch.Tensor | None:
        lanes = self._frontier(u, active)
        live = lanes != self.INACTIVE
        if not bool(live.any()):
            return None
        ids = torch.where(live, lanes, torch.full_like(lanes, INVALID_ID))
        rel, own = _owned(self.n_loc, ids, self.group)
        table = self.rows.table
        contrib = self.rows.send(ids.shape[0], lambda out: host_shard_service(table, rel, own, out))
        return all_reduce_sum(contrib, self.group) - 1


def host_shard_neighbor_fn(partition: torch.Tensor, group, device: torch.device | str) -> HostShardNeighborFn:
    """Neighbour source over this rank's (n_loc, R) int32 host block of the
    adjacency (pinned for a CUDA device), for searches on `device`."""
    return HostShardNeighborFn(partition, group, device)


def sharded_adc_distance_fn(
    table: torch.Tensor,
    codes_local: torch.Tensor,
    group,
    *,
    kernel_mode: str,
    codes_tile_rows: int = 0,
) -> Callable:
    """Owner-computed ADC distances + all-reduce (§4.5 over the mesh).

    table (B, m, 256) replicated over the model group; codes_local (n_loc, m).

      "reference"  gather + the plain ADC
      "staged"     gather into a (B, R, m) temporary + the ADC kernel (K2)
      "fused"      the owner-shard kernel (K7): the gather happens inside it

    Each mode scores the lanes this rank owns among the valid ones (the
    reference scores every owned lane and masks the invalid ones after; the
    values kept are the same) and contributes 0.0 elsewhere, so all three
    give the same sums and the traversal is mode-independent.
    """
    n_loc = codes_local.shape[0]

    def fn(ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        rel, own = _owned(n_loc, ids, group)
        mine = own & valid
        if kernel_mode == "fused":
            d = step_ops.local_adc(table, codes_local, rel, mine, tile_rows=codes_tile_rows)
        elif kernel_mode == "staged":
            d = adc_ops.adc(table, codes_local[rel.long()], mine)
        else:
            d = pqlib.adc_distance(table, codes_local[rel.long()])
        d = all_reduce_sum(torch.where(mine, d, torch.zeros_like(d)), group)
        return torch.where(valid, d, torch.full_like(d, float("inf")))

    return fn


def sharded_exact_dists(
    queries: torch.Tensor,
    data_local: torch.Tensor,
    ids: torch.Tensor,
    group,
    *,
    use_kernels: bool = False,
) -> torch.Tensor:
    """Owner-computed exact squared L2 + all-reduce (re-rank stage, §4.9).

    ||q||^2 + ||v||^2 - 2<v,q> as in the reference, which computes it in
    XLA outside any kernel. On a card each rank scores its owned candidates
    with the re-rank kernel (K3; its plain version in "reference" mode), the
    single-device re-rank's order, so the sharded distances equal the
    single-device ones bit for bit. On the CPU the sums follow XLA:CPU's
    order for this expression (ROADMAP C5), so they track the reference's.
    """
    n_loc = data_local.shape[0]
    rel, own = _owned(n_loc, ids, group)
    vecs = data_local[rel.long()].to(torch.float32)                 # (B, C, d)
    q = queries.to(torch.float32)
    if q.device.type == "cuda":
        d2 = rr_ops.exact_sq_dists(q, vecs) if use_kernels else rr_ops.exact_sq_dists_ref(q, vecs)
    else:
        d2 = _xla_cpu_sq_norm(q)[:, None] + _xla_cpu_sq_norm(vecs) - 2.0 * _xla_cpu_dot(vecs, q)
    d2 = all_reduce_sum(torch.where(own, d2, torch.zeros_like(d2)), group)
    return torch.where(ids == INVALID_ID, torch.full_like(d2, float("inf")), d2)


def sharded_bang_search_block(
    queries: torch.Tensor,                  # (B_loc, d), this data rank's slice
    table: torch.Tensor,                    # (B_loc, m, 256)
    codes_local: torch.Tensor,              # (n_loc, m)
    adjacency_local: torch.Tensor | None,   # (n_loc, R) on the device, or None
    data_local: torch.Tensor,               # (n_loc, d) on the device
    medoid: int,
    k: int,
    cfg: SearchConfig,
    group,
    rerank: bool = True,
    neighbor_fn: Callable | None = None,
    prefetch_fn: Callable | None = None,
    tombstone_fn: Callable | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """The per-rank body: the full BANG pipeline on sharded state.

    The graph source is `sharded_neighbor_fn(adjacency_local)` by default,
    or `neighbor_fn` (`host_shard_neighbor_fn` for the sharded base
    variant, with `adjacency_local=None`). `cfg.kernel_mode` must be
    resolved. The fused mode runs K7 for the distances and the fused
    traverse kernel (K6) on the all-reduced rows. `prefetch_fn` is the
    host-I/O exchange's issue (with that exchange as `neighbor_fn`);
    `tombstone_fn` masks deleted ids (`search.tombstone_mask_fn` over the
    bitmap of global ids, replicated on every rank).

    Returns (ids (B_loc, k), dists (B_loc, k), n_hops (B_loc,), n_iters),
    identical on every rank of the model group.
    """
    if neighbor_fn is None:
        neighbor_fn = sharded_neighbor_fn(adjacency_local, group)
    distance_fn = sharded_adc_distance_fn(
        table, codes_local, group, kernel_mode=cfg.kernel_mode,
        codes_tile_rows=cfg.codes_tile_rows,
    )
    res: SearchResult = bang_search(
        queries,
        neighbor_fn=neighbor_fn,
        step_fn=make_step_fn(cfg, distance_fn, queries.device),
        medoid=medoid,
        cfg=cfg,
        prefetch_fn=prefetch_fn,
        tombstone_fn=tombstone_fn,
    )
    if rerank:
        # Each rank scores only the expanded candidates it owns; the sum
        # rebuilds the exact distances. Stable ascending sort: ties go to
        # the lowest index, as `lax.top_k` takes them.
        d2 = sharded_exact_dists(queries, data_local, res.history_ids, group,
                                 use_kernels=cfg.kernel_mode != "reference")
        dists, pos = torch.sort(d2, dim=-1, stable=True)
        ids = torch.gather(res.history_ids, -1, pos[:, :k])
        dists = dists[:, :k]
    else:
        ids = res.worklist.ids[:, :k]
        dists = res.worklist.dists[:, :k]
    return ids, dists, res.n_hops, res.n_iters


def make_sharded_search(mesh, medoid: int, k: int, cfg: SearchConfig, *,
                        neighbor_fn: Callable | None = None) -> Callable:
    """The mesh search as a function of this rank's state:
    fn(queries (B, d), codebooks, codes_local, adjacency_local, data_local)
    -> (ids (B, k), dists (B, k)), the whole batch on every rank. The
    queries are cut over the mesh's batch group, as the reference's
    `data_axes=("pod", "data")` cuts them: pod x data on a (P, D, S) mesh,
    the data group on a (D, S) one. B must be a multiple of its size; each
    of its ranks searches its slice of the batch, and the slices are
    all-gathered over it. `neighbor_fn` stands in for
    `sharded_neighbor_fn(adjacency_local)` (the shape-only dry run's source,
    which serves a set number of hops)."""
    model, batch = mesh.group("model"), mesh.group("batch")

    def fn(queries, codebooks, codes_local, adjacency_local, data_local):
        cfg_r = dataclasses.replace(cfg, kernel_mode=cfg.resolved_kernel_mode(queries.device))
        q = data_slice(queries, mesh)
        table = pqlib.build_dist_table(pqlib.PQCodec(codebooks), q)
        ids, dists, _, _ = sharded_bang_search_block(
            q, table, codes_local, adjacency_local, data_local, medoid, k, cfg_r, model,
            neighbor_fn=neighbor_fn,
        )
        return all_gather_rows(ids, batch), all_gather_rows(dists, batch)

    return fn


def data_slice(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a batch split evenly over the mesh's batch group
    (pod x data, pod-major; the data axis on a (D, S) mesh)."""
    D = mesh.shape["data"] * mesh.shape.get("pod", 1)
    if x.shape[0] % D:
        raise ValueError(f"batch {x.shape[0]} does not split over {D} data ranks")
    b = x.shape[0] // D
    i = mesh.index("batch")
    return x[i * b : (i + 1) * b]


def pad_to_multiple(x, multiple: int, fill):
    """Pad axis 0 so that row-sharding divides evenly; `fill` must be
    search-neutral. Takes and returns a numpy array or a tensor."""
    n = x.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)], 0)
    return np.concatenate([x, np.full((pad, *x.shape[1:]), fill, x.dtype)], 0)


def local_rows(x: torch.Tensor, shard: int, n_shards: int, fill) -> torch.Tensor:
    """Rows [shard * n_loc, (shard + 1) * n_loc) of `x` padded (as
    `pad_to_multiple`) to a multiple of `n_shards`: a view of `x` where no
    padding falls into the block, else a padded copy."""
    n = x.shape[0]
    n_loc = -(-n // n_shards)
    lo, hi = shard * n_loc, (shard + 1) * n_loc
    if hi <= n:
        return x[lo:hi]
    block = x[min(lo, n):n]
    return torch.cat([block, torch.full((hi - lo - block.shape[0], *x.shape[1:]), fill,
                                        dtype=x.dtype, device=x.device)], 0)
