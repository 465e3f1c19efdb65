"""Search executor: the three-stage pipeline as a resident service.

`SearchExecutor` keeps the index state on its device and serves batches
through `dispatch` / `finish`:

  * **Shape buckets.** Batches are padded up to power-of-two buckets
    (`bucket_size`) by replicating the last query, and the pipeline for
    each `(bucket, d, k, rerank, SearchConfig)` is built once and cached;
    `trace_counts` counts the builds per key, so tests can assert "built
    exactly once". PyTorch runs eagerly, so a build binds the configuration
    and the index state; capturing the pipeline as a CUDA graph comes in a
    later change.
  * **Dispatch and finish.** `dispatch` uploads the queries and runs the
    pipeline; on the card it returns once the work is launched on the
    current stream, with a CUDA event recorded behind it, and `finish` waits
    on that event. The search loop reads the convergence flag each hop, so
    on the card `dispatch` returns after the traversal with the re-rank
    still in flight ("base" waits for the expanded ids, which its re-rank
    sends to the host).
  * **Kernel mode.** A configuration without `kernel_mode` runs "fused" on
    a CUDA device and "reference" on the CPU; the mode is resolved here,
    before the cache key is formed.
  * **Telemetry.** `set_telemetry` attaches a
    `repro_torch.runtime.telemetry.Telemetry` bundle as executor state: a
    pipeline build on a cache miss adds its seconds to
    `bang_serve_compile_seconds_total` (and a `compile` span to an attached
    tracer), and with a profiler attached each dispatch stamps its kernel
    metadata and runs inside a `bang_dispatch:<mode>:b<bucket>` profiler
    range. The bundle never enters a cache key and changes no result.

Variants, as the reference's `_compile` dispatches them:

  * "inmem": codes, adjacency and vectors on the device; PQ search, re-rank
    from device vectors.
  * "base": only the codes and codebooks on the device; the adjacency and
    the vectors stay in pinned host memory, the search fetches each hop's
    rows from there and the re-rank gathers the candidates' vectors there.
  * "exact": adjacency and vectors on the device; exact distances, and no
    re-rank (the worklist already holds exact distances).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import pq as pqlib
from repro_torch.core import rerank as rr
from repro_torch.core import search as searchlib
from repro_torch.core.bang import SearchStats
from repro_torch.core.hostrows import HostRows
from repro_torch.core.search import SearchConfig

VARIANTS = ("inmem", "base", "exact")


def bucket_size(batch: int, *, min_bucket: int = 8) -> int:
    """Next power-of-two shape bucket holding `batch` queries."""
    if min_bucket < 1 or (min_bucket & (min_bucket - 1)):
        raise ValueError(f"min_bucket must be a positive power of two, got {min_bucket}")
    if batch <= 0:
        raise ValueError(f"batch must be positive, got {batch}")
    return max(min_bucket, 1 << (batch - 1).bit_length())


def pad_batch(queries: np.ndarray, bucket: int) -> np.ndarray:
    """Pad (B, d) queries up to (bucket, d) by replicating the last row.

    Query lanes are independent, so padding lanes cannot perturb real lanes.
    Callers slice the first B rows of every output.
    """
    B = queries.shape[0]
    if B > bucket:
        raise ValueError(f"batch {B} exceeds bucket {bucket}")
    if B == bucket:
        return queries
    return np.concatenate([queries, np.repeat(queries[-1:], bucket - B, 0)], 0)


@dataclasses.dataclass
class SearchHandle:
    """An in-flight search batch."""

    ids: torch.Tensor        # (bucket, k)
    dists: torch.Tensor      # (bucket, k)
    n_hops: torch.Tensor     # (bucket,)
    n_iters: int | torch.Tensor  # a 0-d device tensor where it is read at finish
    batch: int               # true batch size (<= bucket)
    bucket: int
    dispatch_t: float        # perf_counter at dispatch (after set-up)
    compile_s: float         # pipeline set-up this dispatch paid (0 on cache hit)
    done: torch.cuda.Event | None  # recorded after the batch's work (CUDA only)


class SearchExecutor:
    """Device-resident three-stage BANG search pipeline."""

    def __init__(
        self,
        codec: pqlib.PQCodec,
        codes: torch.Tensor,
        medoid: int,
        *,
        variant: str = "inmem",
        adjacency: torch.Tensor | None = None,
        data: torch.Tensor | None = None,
        host_adjacency: torch.Tensor | None = None,
        host_data: torch.Tensor | None = None,
    ) -> None:
        """`adjacency`/`data` are the device copies ("inmem", "exact"),
        `host_adjacency`/`host_data` the host ones ("base"; "inmem" re-ranks
        from `host_data` when it has no device vectors)."""
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}, expected one of {VARIANTS}")
        self.variant = variant
        self.device = codes.device
        self._codec = codec
        self._codes = codes
        self._medoid = int(medoid)
        self._adjacency = None
        self._data = None
        # Host sources ("base"; "inmem" without device vectors), public for
        # their byte and time counters.
        self.neighbors: searchlib.HostNeighborFn | None = None
        self.host_data: HostRows | None = None
        if variant == "base":
            if host_adjacency is None or host_data is None:
                raise ValueError("the base variant needs host_adjacency and host_data")
            self.neighbors = searchlib.host_neighbor_fn(host_adjacency, self.device)
            self.host_data = HostRows(host_data, self.device)
        else:
            if adjacency is None:
                raise ValueError(f"the {variant} variant needs the device adjacency")
            if variant == "exact" and data is None:
                raise ValueError("the exact variant needs the vectors on the device")
            if data is None and host_data is None:
                raise ValueError("the re-rank needs data or host_data")
            self._adjacency = adjacency
            self._data = data
            if data is None:
                self.host_data = HostRows(host_data, self.device)
        self._dim = int((data if data is not None else host_data).shape[1])
        self.R = int((adjacency if adjacency is not None else host_adjacency).shape[1])
        self._cache: dict[Any, Any] = {}
        self.trace_counts: dict[Any, int] = {}
        self.telemetry = None

    @classmethod
    def from_index(cls, index, variant: str = "inmem") -> "SearchExecutor":
        if variant == "base":
            return cls(index.codec, index.codes, index.graph.medoid, variant=variant,
                       host_adjacency=index.graph.adjacency, host_data=index.data_host)
        return cls(index.codec, index.codes, index.graph.medoid, variant=variant,
                   adjacency=index.adjacency_dev(), data=index.data_dev, host_data=index.data_host)

    @property
    def n_traces(self) -> int:
        return sum(self.trace_counts.values())

    @property
    def cache_size(self) -> int:
        return len(self._cache)

    @property
    def query_dim(self) -> int:
        return self._dim

    def _bucket_for(self, batch: int) -> int:
        return bucket_size(batch)

    def set_telemetry(self, telemetry) -> "SearchExecutor":
        """Attach (or detach, with None) a telemetry bundle. Host-side
        state only: the pipeline cache, its keys and every result are the
        same with or without it."""
        self.telemetry = telemetry
        return self

    # -------------------------------------------------------------- building
    def _pipeline(self, bucket: int, d: int, k: int, rerank: bool, cfg: SearchConfig):
        """Cached pipeline for the key, and the seconds its set-up took.
        `cfg.kernel_mode` is resolved."""
        key = (bucket, d, k, rerank, cfg)
        fn = self._cache.get(key)
        if fn is not None:
            return fn, 0.0
        t0 = time.perf_counter()
        fn = self._build_pipeline(k, rerank, cfg)
        t1 = time.perf_counter()
        self._cache[key] = fn
        self.trace_counts[key] = self.trace_counts.get(key, 0) + 1
        tel = self.telemetry
        if tel is not None:
            tel.registry.counter(
                "bang_serve_compile_seconds_total",
                "wall seconds spent building search pipelines (cache misses)",
            ).inc(t1 - t0)
            if tel.tracer is not None:
                tr = tel.tracer
                tr.complete("compile", tr.at_us(t0), tr.at_us(t1), track="serve",
                            bucket=bucket, k=k, kernel_mode=cfg.kernel_mode)
        return fn, t1 - t0

    def _build_pipeline(self, k: int, rerank: bool, cfg: SearchConfig):
        """The pipeline for one cache key (subclass hook): a function of the
        padded (bucket, d) queries on the device that returns (ids, dists,
        n_hops, n_iters)."""
        use_kernels = cfg.kernel_mode != "reference"
        variant = self.variant

        def pipeline(queries: torch.Tensor):
            if variant == "exact":
                res = searchlib.search_exact(
                    queries, self._data, self._adjacency, self._medoid, cfg,
                )
                # The exact variant skips the re-rank (§5.2): the worklist
                # already holds exact distances.
                return res.worklist.ids[:, :k], res.worklist.dists[:, :k], res.n_hops, res.n_iters
            table = pqlib.build_dist_table(self._codec, queries)
            if variant == "inmem":
                res = searchlib.search_inmem(
                    queries, table, self._codes, self._adjacency, self._medoid, cfg,
                )
            else:
                res = searchlib.search_base(
                    queries, table, self._codes, self.neighbors, self._medoid, cfg,
                )
            if rerank:
                ids, dists = rr.rerank(
                    queries, res.history_ids, k, data=self._data, host_data=self.host_data,
                    use_kernels=use_kernels,
                )
            else:
                ids, dists = res.worklist.ids[:, :k], res.worklist.dists[:, :k]
            return ids, dists, res.n_hops, res.n_iters

        return pipeline

    # -------------------------------------------------------------- serving
    def dispatch(
        self,
        queries: np.ndarray | torch.Tensor,
        k: int = 10,
        *,
        t: int = 64,
        cfg: SearchConfig | None = None,
        rerank: bool = True,
        kernel_mode: str | None = None,
    ) -> SearchHandle:
        """Pad, look up or build the pipeline, and launch one batch."""
        if isinstance(queries, torch.Tensor):
            queries = queries.detach().cpu().numpy()
        q = np.asarray(queries, np.float32)
        if q.ndim != 2:
            raise ValueError(f"queries must be (B, d), got shape {q.shape}")
        if q.shape[1] != self.query_dim:
            raise ValueError(f"queries must have d={self.query_dim}, got {q.shape[1]}")
        B, d = q.shape
        cfg = cfg or SearchConfig(t=max(t, k))
        if kernel_mode is not None:
            if kernel_mode not in searchlib.KERNEL_MODES:
                raise ValueError(
                    f"unknown kernel_mode {kernel_mode!r}, expected one of "
                    f"{searchlib.KERNEL_MODES}"
                )
            cfg = dataclasses.replace(cfg, kernel_mode=kernel_mode)
        cfg = dataclasses.replace(cfg, kernel_mode=cfg.resolved_kernel_mode(self.device))
        bucket = self._bucket_for(B)
        pipeline, compile_s = self._pipeline(bucket, d, k, rerank, cfg)
        q_dev = torch.from_numpy(pad_batch(q, bucket)).to(self.device)
        t0 = time.perf_counter()
        tel = self.telemetry
        if tel is not None and tel.profiler is not None:
            # Kernel metadata for the codes-stream model, and a named
            # profiler range around the batch's kernels.
            n_block, m = self._codes.shape
            tel.profiler.set_kernel_info(kernel_mode=cfg.kernel_mode, batch=bucket, n=n_block,
                                         m=m, R=self.R, tile_rows=cfg.codes_tile_rows)
            with tel.profiler.annotate(f"bang_dispatch:{cfg.kernel_mode}:b{bucket}"):
                ids, dists, n_hops, n_iters = pipeline(q_dev)
        else:
            ids, dists, n_hops, n_iters = pipeline(q_dev)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return SearchHandle(
            ids=ids, dists=dists, n_hops=n_hops, n_iters=n_iters, batch=B,
            bucket=bucket, dispatch_t=t0, compile_s=compile_s, done=done,
        )

    def finish(self, handle: SearchHandle, *, return_stats: bool = False):
        """Wait until the batch is done; slice padding off; report stats."""
        if handle.done is not None:
            handle.done.synchronize()
        wall = time.perf_counter() - handle.dispatch_t
        ids = handle.ids[: handle.batch]
        dists = handle.dists[: handle.batch]
        if not return_stats:
            return ids, dists
        hops = handle.n_hops[: handle.batch].cpu().numpy()
        stats = SearchStats(
            n_iters=int(handle.n_iters),
            mean_hops=float(hops.mean()),
            p95_hops=float(np.percentile(hops, 95)),
            wall_s=wall,
            qps=handle.batch / wall,
            compile_s=handle.compile_s,
            batch=handle.batch,
            bucket=handle.bucket,
        )
        return ids, dists, stats

    def search(
        self,
        queries: np.ndarray | torch.Tensor,
        k: int = 10,
        *,
        t: int = 64,
        cfg: SearchConfig | None = None,
        rerank: bool = True,
        return_stats: bool = False,
        kernel_mode: str | None = None,
    ):
        """Synchronous batched k-NN search: dispatch + finish."""
        handle = self.dispatch(
            queries, k, t=t, cfg=cfg, rerank=rerank, kernel_mode=kernel_mode,
        )
        return self.finish(handle, return_stats=return_stats)
