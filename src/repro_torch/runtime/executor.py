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
    range. It is forwarded to the host-I/O runtime where there is one. The
    bundle never enters a cache key and changes no result.
  * **Host I/O.** `hostio=HostIOConfig(...)` ("base" only) serves the
    adjacency through `repro_torch.runtime.hostio`: a multi-worker
    neighbour service, an optional device-resident hot-adjacency cache and
    an optional prefetched frontier exchange, bit-exact vs the inline
    gather. The config joins the pipeline cache key.
  * **Tombstones.** With `with_tombstones=True` (streaming mutability,
    `repro_torch.runtime.mutation`) every pipeline takes the (n,) bool
    delete bitmap as an argument, never as state it closes over, so a
    delete builds no pipeline. The executor keeps one bitmap on its device
    and rewrites it in place on each dispatch, so its address stays fixed.
  * **Autotune.** With `autotune=AutotuneCache(...)`
    (`repro_torch.kernels.autotune`) the winner for this executor's
    (device kind, bucket, R, m) replaces the tuned `SearchConfig` fields
    before the cache key is formed, so a reloaded winners file reproduces
    the same pipeline keys.

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

from .hostio import HostIOConfig, HostIORuntime

VARIANTS = ("inmem", "base", "exact")


def _validate_min_bucket(min_bucket: int) -> int:
    """min_bucket must be a positive power of two: the buckets are powers of
    two, so another floor would make misaligned buckets (12, then 16 for a
    batch of 13) whose pipelines duplicate cache entries."""
    if min_bucket < 1 or (min_bucket & (min_bucket - 1)):
        raise ValueError(f"min_bucket must be a positive power of two, got {min_bucket}")
    return min_bucket


def bucket_size(batch: int, *, min_bucket: int = 8) -> int:
    """Next power-of-two shape bucket holding `batch` queries."""
    _validate_min_bucket(min_bucket)
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
        hostio: HostIOConfig | None = None,
        min_bucket: int = 8,
        with_tombstones: bool = False,
        autotune=None,
    ) -> None:
        """`adjacency`/`data` are the device copies ("inmem", "exact"),
        `host_adjacency`/`host_data` the host ones ("base"; "inmem" re-ranks
        from `host_data` when it has no device vectors). `hostio` serves
        "base"'s adjacency through the host-I/O subsystem. `min_bucket` is
        the smallest shape bucket, `with_tombstones` makes every pipeline
        take the delete bitmap, and `autotune` is an `AutotuneCache` whose
        winners tune the configurations (module docstring)."""
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}, expected one of {VARIANTS}")
        if hostio is not None and variant != "base":
            raise ValueError(
                "hostio= only applies to the host-resident-graph variant "
                f"'base', got {variant!r}"
            )
        self.variant = variant
        self.device = codes.device
        self._codec = codec
        self._codes = codes
        self._medoid = int(medoid)
        self._adjacency = None
        self._data = None
        # Host sources ("base"; "inmem" without device vectors), public for
        # their byte and time counters: the inline `HostNeighborFn`, or the
        # host-I/O runtime's exchange.
        self.neighbors = None
        self.host_data: HostRows | None = None
        self._hostio = hostio
        self.hostio_runtime: HostIORuntime | None = None
        self._prefetch_fn = None
        if variant == "base":
            if host_adjacency is None or host_data is None:
                raise ValueError("the base variant needs host_adjacency and host_data")
            if hostio is None:
                self.neighbors = searchlib.host_neighbor_fn(host_adjacency, self.device)
            else:
                self.hostio_runtime = HostIORuntime(
                    hostio, [host_adjacency], host_adjacency, medoid=self._medoid,
                    name="hostio-base", device=self.device,
                )
                self.neighbors, self._prefetch_fn = self.hostio_runtime.base_exchange()
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
        adj = adjacency if adjacency is not None else host_adjacency
        self.R = int(adj.shape[1])
        self._init_serving_state(min_bucket, with_tombstones, int(adj.shape[0]), autotune)

    def _init_serving_state(self, min_bucket: int, with_tombstones: bool, tombstone_len: int,
                            autotune) -> None:
        """The dispatch/finish bookkeeping both executor classes share."""
        self._min_bucket = _validate_min_bucket(min_bucket)
        self._with_tombstones = bool(with_tombstones)
        self._tombstone_len = tombstone_len
        self._autotune = autotune
        # The delete bitmap on the device, written in place by each dispatch,
        # and on a card the pinned buffer it is copied up from with the event
        # of the last copy (made on first use).
        self._tomb_dev: torch.Tensor | None = None
        self._tomb_host: torch.Tensor | None = None
        self._tomb_copied: torch.cuda.Event | None = None
        self._cache: dict[Any, Any] = {}
        self.trace_counts: dict[Any, int] = {}
        self.telemetry = None

    @classmethod
    def from_index(cls, index, variant: str = "inmem", **kw) -> "SearchExecutor":
        """The executor over a `BangIndex`; `kw` are the constructor's
        keywords (hostio, min_bucket, with_tombstones, autotune)."""
        if variant == "base":
            return cls(index.codec, index.codes, index.graph.medoid, variant=variant,
                       host_adjacency=index.graph.adjacency, host_data=index.data_host, **kw)
        return cls(index.codec, index.codes, index.graph.medoid, variant=variant,
                   adjacency=index.adjacency_dev(), data=index.data_dev, host_data=index.data_host,
                   **kw)

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
        return bucket_size(batch, min_bucket=self._min_bucket)

    def autotune_shape(self) -> tuple[int, int, int]:
        """(R, m, codes rows): the shape axes autotune winners key on; the
        codes rows are those one hop kernel reads, here the whole index."""
        return self.R, int(self._codes.shape[1]), int(self._codes.shape[0])

    @property
    def hostio_service(self):
        """The live NeighborService (None unless hostio is configured)."""
        rt = self.hostio_runtime
        return None if rt is None else rt.service

    def set_telemetry(self, telemetry) -> "SearchExecutor":
        """Attach (or detach, with None) a telemetry bundle, forwarded to
        the host-I/O runtime when there is one, so host-I/O counters, gather
        spans and fault postmortems report through the same bundle.
        Host-side state only: the pipeline cache, its keys and every result
        are the same with or without it."""
        self.telemetry = telemetry
        rt = self.hostio_runtime
        if rt is not None:
            rt.set_telemetry(telemetry)
        return self

    # -------------------------------------------------------------- building
    def _pipeline(self, bucket: int, d: int, k: int, rerank: bool, cfg: SearchConfig):
        """Cached pipeline for the key, and the seconds its set-up took.
        `cfg.kernel_mode` is resolved. The host-I/O config and the tombstone
        flag ride the key: they are fixed at construction, but keying them
        keeps pipelines from being confused across executors whose caches
        are merged. An autotune winner replaces the tuned fields of `cfg`
        first, so the tuned configuration is the key."""
        if self._autotune is not None:
            from repro_torch.kernels import autotune as autotune_lib

            R, m, _ = self.autotune_shape()
            cfg = self._autotune.apply(cfg, autotune_lib.device_kind(self.device), bucket, R, m)
        key = (bucket, d, k, rerank, cfg, self._hostio, self._with_tombstones)
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
        padded (bucket, d) queries on the device and the delete bitmap (None
        without tombstones) that returns (ids, dists, n_hops, n_iters)."""
        use_kernels = cfg.kernel_mode != "reference"
        variant = self.variant

        def pipeline(queries: torch.Tensor, tombstones: torch.Tensor | None = None):
            tombstone_fn = None if tombstones is None else searchlib.tombstone_mask_fn(tombstones)
            if variant == "exact":
                res = searchlib.search_exact(
                    queries, self._data, self._adjacency, self._medoid, cfg,
                    tombstone_fn=tombstone_fn,
                )
                # The exact variant skips the re-rank (§5.2): the worklist
                # already holds exact distances.
                return res.worklist.ids[:, :k], res.worklist.dists[:, :k], res.n_hops, res.n_iters
            table = pqlib.build_dist_table(self._codec, queries)
            if variant == "inmem":
                res = searchlib.search_inmem(
                    queries, table, self._codes, self._adjacency, self._medoid, cfg,
                    tombstone_fn=tombstone_fn,
                )
            else:
                res = searchlib.search_base(
                    queries, table, self._codes, self.neighbors, self._medoid, cfg,
                    prefetch_fn=self._prefetch_fn, tombstone_fn=tombstone_fn,
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

    def _device_tombstones(self, tombstones: np.ndarray | None) -> torch.Tensor:
        """The (n,) bool delete bitmap on the device (all False when none is
        given), written in place into the executor's one device bitmap. On a
        card the copy up goes through a pinned buffer that is rewritten only
        once the previous copy out of it has run."""
        n = self._tombstone_len
        t = np.zeros(n, np.bool_) if tombstones is None else np.asarray(tombstones, np.bool_)
        if t.shape != (n,):
            raise ValueError(f"tombstones must be ({n},), got {t.shape}")
        return self._upload_tombstones(t)

    def _upload_tombstones(self, t: np.ndarray) -> torch.Tensor:
        if self._tomb_dev is None:
            self._tomb_dev = torch.zeros(t.shape, dtype=torch.bool, device=self.device)
            if self.device.type == "cuda":
                self._tomb_host = torch.zeros(t.shape, dtype=torch.bool).pin_memory()
        if self._tomb_host is None:
            self._tomb_dev.copy_(torch.from_numpy(t))
            return self._tomb_dev
        if self._tomb_copied is not None:
            # The previous dispatch's copy may still be queued behind its
            # search: rewriting the buffer first would hand that batch this
            # dispatch's bitmap.
            self._tomb_copied.synchronize()
        self._tomb_host.numpy()[:] = t
        self._tomb_dev.copy_(self._tomb_host, non_blocking=True)
        self._tomb_copied = torch.cuda.Event()
        self._tomb_copied.record(torch.cuda.current_stream(self.device))
        return self._tomb_dev

    # ------------------------------------------------------------ accounting
    def _hot_cache_fields(self, host_rows_in: int) -> dict:
        """Hot-adjacency-cache accounting shared by both executor classes.

        `hot_cache_hit_rate` is the *measured* service-side hit rate (0.0
        before any traffic); `host_bytes_saved_per_hop` scales the rows-back
        leg by it -- the host-link bytes the device-resident cache absorbed.
        `host_link_bytes` in the caller is reduced by the saving, so with no
        cache (or no traffic yet) host_link == ids_out + rows_in exactly.
        """
        rt = self.hostio_runtime
        if rt is None or rt.cache is None:
            return {
                "hot_cache_rows": 0,
                "hot_cache_hit_rate": 0.0,
                "host_bytes_saved_per_hop": 0,
            }
        rate = rt.service.cache_hit_rate()
        return {
            "hot_cache_rows": rt.cache.n_rows,
            "hot_cache_hit_rate": rate,
            "host_bytes_saved_per_hop": int(host_rows_in * rate),
        }

    def exchange_bytes_per_hop(self, batch: int) -> dict:
        """Logical link bytes one hop moves, in the sharded executor's schema.

        A single device pays no collectives; "base" pays the paper's host
        link each hop -- (bucket,) int32 frontier ids down and (bucket, R)
        int32 adjacency rows up (§4.1/§4.3). Device-resident-graph variants
        move nothing. With the host-I/O hot cache,
        `host_bytes_saved_per_hop` (measured hit rate x the rows-up leg) is
        subtracted from `host_link_bytes`: hit rows never cross the link.
        """
        bucket = self._bucket_for(batch)
        base = self.variant == "base"
        host_ids_out = bucket * 4 if base else 0
        host_rows_in = bucket * self.R * 4 if base else 0
        hot = self._hot_cache_fields(host_rows_in)
        return {
            "payload_bytes": 0,
            "collective_bytes": 0,
            "ring_bytes_per_device": 0,
            "host_ids_out_bytes": host_ids_out,
            "host_rows_in_bytes": host_rows_in,
            "host_link_bytes": host_ids_out + host_rows_in - hot["host_bytes_saved_per_hop"],
            "model_shards": 1,
            "data_shards": 1,
            # Streaming mutability's fields: the frozen index's identity.
            "tombstone_fraction": 0.0,
            "delta_points": 0,
            **hot,
        }

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
        tombstones: np.ndarray | None = None,
    ) -> SearchHandle:
        """Pad, look up or build the pipeline, and launch one batch.

        `tombstones` (an executor built with `with_tombstones=True` only) is
        the (n,) bool delete bitmap, an argument of the pipeline: changing
        it between dispatches builds nothing. None means nothing deleted.
        """
        if tombstones is not None and not self._with_tombstones:
            raise ValueError("tombstones= requires an executor built with with_tombstones=True")
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
        args = (q_dev,) if not self._with_tombstones else (q_dev, self._device_tombstones(tombstones))
        t0 = time.perf_counter()
        tel = self.telemetry
        if tel is not None and tel.profiler is not None:
            # Kernel metadata for the codes-stream model, and a named
            # profiler range around the batch's kernels.
            n_block, m = self._codes.shape
            tel.profiler.set_kernel_info(kernel_mode=cfg.kernel_mode, batch=bucket, n=n_block,
                                         m=m, R=self.R, tile_rows=cfg.codes_tile_rows)
            with tel.profiler.annotate(f"bang_dispatch:{cfg.kernel_mode}:b{bucket}"):
                ids, dists, n_hops, n_iters = pipeline(*args)
        else:
            ids, dists, n_hops, n_iters = pipeline(*args)
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
        tombstones: np.ndarray | None = None,
    ):
        """Synchronous batched k-NN search: dispatch + finish."""
        handle = self.dispatch(
            queries, k, t=t, cfg=cfg, rerank=rerank, kernel_mode=kernel_mode,
            tombstones=tombstones,
        )
        return self.finish(handle, return_stats=return_stats)
