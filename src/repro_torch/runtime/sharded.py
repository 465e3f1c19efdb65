"""Mesh-parallel search executor: BANG serving beyond one device's memory.

`SearchExecutor` keeps the whole index on one device, the paper's regime.
This executor serves the same contract over a ("data", "model") mesh of
ranks (`repro_torch.distributed.make_mesh`): the adjacency, the PQ codes and
the full vectors are row-sharded over the model group (each rank owns a
contiguous block of node ids, padded so that S divides n), queries over the
data group, and every rank runs the three stages itself:

    stage 1  PQ distance table    per data rank, from replicated codebooks
    stage 2  graph traversal      owner-shard adjacency gather + all-reduce,
                                  owner-shard ADC + all-reduce; worklist and
                                  bloom state replicated over the model group
    stage 3  exact re-rank        owner-shard exact L2 + all-reduce

then the data group all-gathers the slices, so every rank returns the whole
(B, k) result. Two graph placements (`variant=`):

  * "sharded"       the adjacency block on the device, the mesh analogue of
                    "inmem".
  * "sharded-base"  the adjacency block stays in this rank's pinned host
                    memory and is never uploaded: per hop the host link
                    carries the (B_loc,) frontier down and (B_loc, R) rows up
                    (`exchange_bytes_per_hop()["host_link_bytes"]`). Codes
                    and re-rank vectors stay on the device. With
                    `hostio=HostIOConfig(...)` the block is served by this
                    rank's host-I/O service (one partition per model rank,
                    worker pool, replicated hot cache, prefetched exchange),
                    bit-exact vs the inline gather.

Every rank of a model group computes identical worklists from the summed
rows, so results equal the single-device executor's on the same index. The
serving surface (shape buckets rounded up to a multiple of the data-axis
size, the per-(bucket, d, k, rerank, cfg) cache, `dispatch`/`finish`,
`SearchStats`) is `SearchExecutor`'s.

Typical use, one process per rank (`torchrun --nproc-per-node=N`)::

    mesh = make_mesh((D, S), ("data", "model"), "cuda")
    ex = ShardedSearchExecutor.from_index(index, mesh)
    ids, dists = ex.search(queries, k=10, t=64)
    # or: index.search(queries, variant="sharded", mesh=mesh)
"""
from __future__ import annotations

import torch

from repro_torch.core import pq as pqlib
from repro_torch.core.distributed import (
    all_gather_rows,
    data_slice,
    host_shard_neighbor_fn,
    local_rows,
    pad_to_multiple,
    sharded_bang_search_block,
)
from repro_torch.core.search import SearchConfig
from repro_torch.core.vamana import VamanaGraph
from repro_torch.distributed import AXES

from .executor import SearchExecutor, bucket_size
from .hostio import HostIOConfig, HostIORuntime

SHARDED_VARIANTS = ("sharded", "sharded-base")


class ShardedSearchExecutor(SearchExecutor):
    """Mesh sibling of `SearchExecutor`: same contract, sharded state."""

    def __init__(
        self,
        codec: pqlib.PQCodec,
        codes: torch.Tensor,
        graph: VamanaGraph,
        mesh,
        *,
        data: torch.Tensor,
        variant: str = "sharded",
        hostio: HostIOConfig | None = None,
        with_tombstones: bool = False,
    ) -> None:
        """`codes` (n, m) on this rank's device, `graph.adjacency` (n, R) in
        host memory, `data` (n, d) on the device or the host: the whole
        index, of which this rank keeps its block."""
        if variant not in SHARDED_VARIANTS:
            raise ValueError(
                f"unknown sharded variant {variant!r}, expected one of {SHARDED_VARIANTS}"
            )
        if tuple(mesh.shape) != AXES:
            raise ValueError(f"mesh axes {tuple(mesh.shape)} must be {AXES}")
        if data is None:
            raise ValueError("sharded executor needs full vectors (re-rank source)")
        if hostio is not None and variant != "sharded-base":
            raise ValueError(
                "hostio= only applies to the host-resident-graph variant "
                f"'sharded-base', got {variant!r}"
            )
        if with_tombstones:
            raise NotImplementedError("with_tombstones=True comes with the mutability slice of the port")
        if mesh.device.type != codes.device.type:
            raise ValueError(f"the mesh drives {mesh.device}, the index lies on {codes.device}")
        self.variant = variant
        self.mesh = mesh
        self.device = codes.device
        self._codec = codec
        self._medoid = int(graph.medoid)
        self._model = mesh.group("model")
        self._data_group = mesh.group("data")
        S = self.n_model_shards = mesh.shape["model"]
        self.n_data_shards = mesh.shape["data"]
        s = mesh.index("model")
        # This rank's contiguous block of every row-sharded table. Pad rows
        # are unreachable (adjacency pad is -1, and no real row points past
        # n), so their fill values are inert.
        self._codes = local_rows(codes, s, S, 0)
        self._data = local_rows(data, s, S, 0.0).to(self.device)
        adjacency = local_rows(graph.adjacency, s, S, -1)
        self.R = int(adjacency.shape[1])
        self._dim = int(data.shape[1])
        # The host source of "sharded-base"'s adjacency block, public for
        # its byte and time counters: the inline `HostShardNeighborFn`, or
        # this rank's host-I/O exchange.
        self.neighbors = None
        self._hostio = hostio
        self.hostio_runtime = None
        self._prefetch_fn = None
        if variant == "sharded-base":
            self._adjacency = None
            if hostio is None:
                self.neighbors = host_shard_neighbor_fn(adjacency, self._model, self.device)
            else:
                # One partition per model rank: this rank's block. The hot
                # cache ranks the whole padded graph, replicated on every
                # rank, as the reference's does.
                self.hostio_runtime = HostIORuntime(
                    hostio, [adjacency], pad_to_multiple(graph.adjacency, S, -1),
                    medoid=self._medoid, name=f"hostio-shard{s}", device=self.device,
                )
                self.neighbors, self._prefetch_fn = self.hostio_runtime.shard_exchange(self._model)
        else:
            self._adjacency = adjacency.to(self.device)
        self._cache = {}
        self.trace_counts = {}
        self.telemetry = None

    @classmethod
    def from_index(cls, index, mesh, **kw) -> "ShardedSearchExecutor":
        data = index.data_dev if index.data_dev is not None else index.data_host
        return cls(index.codec, index.codes, index.graph, mesh, data=data, **kw)

    def autotune_shape(self) -> tuple[int, int, int]:
        """(R, m, per-shard codes rows): one owner-shard ADC kernel's view."""
        return self.R, int(self._codes.shape[1]), int(self._codes.shape[0])

    def _bucket_for(self, batch: int) -> int:
        """Power-of-two bucket, rounded up so that the data ranks split it evenly."""
        b = bucket_size(batch)
        D = self.n_data_shards
        return b if b % D == 0 else -(-b // D) * D

    # -------------------------------------------------------------- building
    def _build_pipeline(self, k: int, rerank: bool, cfg: SearchConfig):
        """The mesh pipeline: this rank's slice of the queries searched over
        the model group, the slices gathered over the data group."""

        def pipeline(queries: torch.Tensor):
            q = data_slice(queries, self.mesh)
            table = pqlib.build_dist_table(self._codec, q)
            ids, dists, hops, n_iters = sharded_bang_search_block(
                q, table, self._codes, self._adjacency, self._data, self._medoid, k, cfg,
                self._model, rerank=rerank, neighbor_fn=self.neighbors,
                prefetch_fn=self._prefetch_fn,
            )
            # One all-gather over the data group carries every output of the
            # slice: ids, the distances' bits, hops and this slice's n_iters.
            b_loc = q.shape[0]
            packed = torch.cat([
                ids, dists.contiguous().view(torch.int32), hops[:, None],
                torch.full((b_loc, 1), n_iters, dtype=torch.int32, device=q.device),
            ], 1)
            whole = all_gather_rows(packed, self._data_group)
            return (whole[:, :k], whole[:, k : 2 * k].contiguous().view(torch.float32),
                    whole[:, 2 * k], whole[:, 2 * k + 1].max())

        return pipeline

    # ------------------------------------------------------------ accounting
    def exchange_bytes_per_hop(self, batch: int) -> dict:
        """Logical bytes one hop moves, split by link (paper §4.3).

        Collectives: per data rank and hop, the model-group all-reduces carry
        a (B_loc, R) int32 neighbour payload and a (B_loc, R) f32 distance
        payload (`collective_bytes`; `payload_bytes` is the same number).
        `ring_bytes_per_device` estimates a ring all-reduce's wire traffic per
        rank (2 (S-1)/S x payload); one shard exchanges nothing.

        Host link ("sharded-base"): the (B_loc,) int32 frontier down to this
        rank's host block and the (B_loc, R) int32 rows back. With the
        host-I/O hot cache, `host_bytes_saved_per_hop` (this rank's measured
        hit rate x the rows-back leg) is subtracted: hit rows are served from
        the replicated device cache and cross no rank's host link.
        """
        bucket = self._bucket_for(batch)
        b_loc = bucket // self.n_data_shards
        payload = b_loc * self.R * (4 + 4)
        S = self.n_model_shards
        ring = int(2 * (S - 1) / S * payload) if S > 1 else 0
        base = self.variant == "sharded-base"
        host_ids_out = b_loc * 4 if base else 0
        host_rows_in = b_loc * self.R * 4 if base else 0
        hot = self._hot_cache_fields(host_rows_in)
        return {
            "payload_bytes": payload,
            "collective_bytes": payload,
            "ring_bytes_per_device": ring,
            "host_ids_out_bytes": host_ids_out,
            "host_rows_in_bytes": host_rows_in,
            "host_link_bytes": host_ids_out + host_rows_in - hot["host_bytes_saved_per_hop"],
            "model_shards": S,
            "data_shards": self.n_data_shards,
            "tombstone_fraction": 0.0,
            "delta_points": 0,
            **hot,
        }
