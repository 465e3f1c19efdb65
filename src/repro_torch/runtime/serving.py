"""Streaming serve pipeline: micro-batching + a dispatch thread.

The paper's serving loop (§6) keeps the GPU busy by overlapping the CPU-side
work of one query batch with the device-side search of another.
`ServePipeline` reproduces that structure on top of `SearchExecutor`:

  * **Queue + micro-batches.** `submit()` enqueues query rows (with arrival
    timestamps and optional ground truth); `drain()` pops them in arrival
    order into micro-batches of at most `max_batch` rows.
  * **Dispatch thread.** The port's `dispatch` runs the whole hop loop
    before it returns (the loop is a host loop), so the pipeline runs every
    `executor.dispatch` on one FIFO thread that it owns, and `finish` and
    the host bookkeeping on the caller's thread: batch i+1 is handed to the
    dispatch thread before the caller finishes batch i, so batch i's
    results, latency, recall and cache bookkeeping overlap batch i+1's
    search. One thread means each executor runs at most one batch loop at a
    time, and the sharded executors' collectives stay in one order on every
    rank. An exception raised on the dispatch thread surfaces from
    `drain()` when its batch is finished.
  * **Rolling stats.** Per-row latency (enqueue -> results ready), rolling
    QPS with pipeline set-up time separated out, and recall@k whenever
    ground truth was submitted.
  * **Cross-batch result cache.** With `result_cache_size > 0`, an LRU cache
    keyed on the exact query bytes serves repeat queries without touching
    the executor at all. Hits return bit-identical ids/dists -- the cache
    stores the executor's own outputs -- and are reported in
    `ServeStats.result_cache_hits`/`result_cache_hit_rate`. The cache is
    **mutation-epoch scoped**: when the executor exposes `mutation_epoch`,
    every insert/delete/consolidation bumps it and the next drain() drops
    all cached results, so a hit can never return a deleted id or miss a
    fresh insert.
  * **Host-I/O lifecycle.** When the executor serves its graph through the
    host-I/O subsystem (`repro_torch.runtime.hostio`), the pipeline owns the
    service: worker pools start at pipeline construction, `close()` (or the
    context manager) stops them, and each drain's `ServeStats.hostio`
    carries the service's counter snapshot (queue depth, latency, cache hit
    rate, prefetch `overlap_fraction`).
  * **Admission control.** With `max_queue > 0`, `submit()` sheds whatever
    would push the backlog past the bound -- shed rows are rejected *at
    submission*, exactly once, and never consume executor work. With
    `deadline_s > 0` (or a per-submit override), each accepted row carries
    an absolute deadline and is dropped when its micro-batch is formed if it
    has already expired -- its result slots stay (-1, inf), it is excluded
    from latency/recall, and it can never hold a micro-batch hostage. Both
    counters surface as `ServeStats.shed_queries` / `expired_queries`;
    host-side fault handling (retries, hedges, degraded lanes, failover)
    reports through `ServeStats.hostio` (see
    `repro_torch.runtime.resilience`).
  * **Telemetry.** `telemetry=` (a `repro_torch.runtime.telemetry.Telemetry`)
    attaches the observability bundle to the pipeline AND its executor
    (which forwards to the host-I/O runtime): serve counters mirror into
    the metrics registry (`bang_serve_*`), every submitted row gets a
    request id whose lifecycle lands on the Chrome trace timeline as
    exactly one `request` span (outcome served/cache_hit) or
    `request_shed`/`request_expired` instant, micro-batches emit
    `admission`/`dispatch`/`device` spans, and `ServeStats.telemetry`
    carries the registry delta over the drain window. Detached (the
    default) the pipeline behaves identically.

The pipeline is executor-agnostic: any object with the `SearchExecutor`
dispatch/finish contract works, including `ShardedSearchExecutor` -- then
each micro-batch fans out across the mesh with the drain loop unchanged.

Typical use::

    with ServePipeline(index.executor("inmem"), k=10, cfg=cfg, max_batch=128) as pipe:
        pipe.submit(queries, gt_ids=gt)            # any number of times
        ids, dists, stats = pipe.drain()
    print(stats.qps, stats.p95_ms, stats.mean_recall)
"""
from __future__ import annotations

import copy
import dataclasses
import time
from collections import OrderedDict, deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from repro_torch.core.bang import recall_at_k
from repro_torch.core.search import SearchConfig

from .executor import SearchExecutor


def _host(x) -> np.ndarray:
    """A result array on the host (the executors return device tensors)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class BatchReport:
    """Per-micro-batch report passed to the drain() callback."""

    index: int          # micro-batch ordinal within this drain
    size: int           # rows in the batch
    wall_s: float       # dispatch -> results ready for this batch
    compile_s: float    # pipeline set-up this batch paid (0 on cache hit)
    recall: float | None
    ids: np.ndarray     # (size, k)
    dists: np.ndarray   # (size, k)


@dataclasses.dataclass
class ServeStats:
    """Rolling statistics for one drain() window."""

    batches: int
    queries: int
    wall_s: float           # first dispatch -> last batch ready (incl. set-up)
    compile_s: float        # total pipeline set-up paid inside the window
    qps: float              # steady-state: queries / (wall_s - compile_s);
                            # result-cache hits count as served queries
    p50_ms: float           # per-row latency percentiles (enqueue -> ready)
    p95_ms: float
    mean_recall: float | None  # row-weighted mean recall@k over gt rows
    result_cache_hits: int = 0      # rows served from the query-result LRU
    result_cache_hit_rate: float = 0.0  # hits / queries in this window
    shed_queries: int = 0       # rows rejected by admission control (submit)
    expired_queries: int = 0    # accepted rows dropped at dispatch: deadline
    hostio: dict | None = None  # NeighborService counter snapshot, if any
    mutation: dict | None = None  # MutableSearchExecutor counters, if any
    # Registry window: metrics delta over this drain (telemetry attached
    # only). The cumulative registry is the source of truth; this is the
    # per-window view of it.
    telemetry: dict | None = None


class ServePipeline:
    """Drains a query queue through a search executor, dispatching on a
    thread of its own while the caller finishes the batch before.

    Accepts a single-device `SearchExecutor` or a mesh-parallel
    `ShardedSearchExecutor`; both expose the same dispatch/finish contract.
    Close it (or use it as a context manager) to stop its dispatch thread
    and the executor's host-I/O workers.
    """

    def __init__(
        self,
        executor: SearchExecutor,
        *,
        k: int = 10,
        t: int = 64,
        cfg: SearchConfig | None = None,
        rerank: bool = True,
        max_batch: int = 128,
        kernel_mode: str | None = None,
        result_cache_size: int = 0,
        max_queue: int = 0,
        deadline_s: float = 0.0,
        telemetry=None,
    ) -> None:
        if max_batch <= 0:
            raise ValueError("max_batch must be positive")
        if result_cache_size < 0:
            raise ValueError("result_cache_size must be >= 0")
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        if deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got {deadline_s}")
        self._ex = executor
        self._k = k
        self._cfg = cfg or SearchConfig(t=max(t, k))
        if kernel_mode is not None:
            # Baked into the pipeline's cfg so every micro-batch hits the
            # same (bucket, cfg) pipeline in the executor's cache.
            self._cfg = dataclasses.replace(self._cfg, kernel_mode=kernel_mode)
        self._rerank = rerank
        self._max_batch = max_batch
        # Admission control: bounded backlog + per-request deadlines.
        self._max_queue = max_queue
        self._deadline_s = deadline_s
        self._shed_pending = 0      # sheds since the last drain() report
        # Telemetry (repro_torch.runtime.telemetry.Telemetry or None): the
        # pipeline attaches the bundle to its executor too, which forwards
        # it to the host-I/O runtime -- one bundle observes the whole
        # serving stack. Every submitted row gets a request id so trace
        # spans attribute each one exactly once (served / cache_hit /
        # shed / expired).
        self._tel = telemetry
        self._next_rid = 0
        # Window anchor for ServeStats.telemetry: "since the last drain",
        # NOT "since drain start" -- sheds happen inside submit(), and the
        # window must agree with ServeStats.shed_queries about them.
        self._reg_snap = None if telemetry is None \
            else telemetry.registry.snapshot()
        if telemetry is not None and hasattr(executor, "set_telemetry"):
            executor.set_telemetry(telemetry)
        # queue rows: (query row (d,), enqueue timestamp, gt row or None,
        #              absolute deadline (perf_counter seconds; 0 = none),
        #              request id)
        self._queue: deque = deque()
        # Cross-batch query-result LRU: exact query bytes -> (ids, dists)
        # rows, exactly as the executor returned them (bit-identical hits).
        self._result_cache_size = result_cache_size
        self._result_cache: OrderedDict[bytes, tuple[np.ndarray, np.ndarray]]
        self._result_cache = OrderedDict()
        # Mutation-epoch scoping: cached results are only valid for the
        # executor epoch they were computed under. Executors without a
        # mutation_epoch attribute read as None forever -> cache never
        # invalidates (the frozen-index behaviour).
        self._result_cache_epoch = getattr(executor, "mutation_epoch", None)
        self.last_stats: ServeStats | None = None
        # The one FIFO thread every dispatch runs on, made at the first
        # drain after construction or close().
        self._dispatcher: ThreadPoolExecutor | None = None
        # The pipeline owns the executor's host-I/O service lifecycle: spin
        # the worker pools up front so the first drain doesn't pay thread
        # creation, and stop them in close().
        rt = getattr(executor, "hostio_runtime", None)
        if rt is not None:
            rt.start()

    @property
    def executor(self) -> SearchExecutor:
        return self._ex

    @property
    def result_cache_len(self) -> int:
        """Current number of cached query results (capacity is the
        `result_cache_size` constructor parameter)."""
        return len(self._result_cache)

    def close(self) -> None:
        """Stop the dispatch thread and the executor's host-I/O worker pools
        (idempotent; a later drain starts the thread again)."""
        pool, self._dispatcher = self._dispatcher, None
        if pool is not None:
            pool.shutdown(wait=True)
        rt = getattr(self._ex, "hostio_runtime", None)
        if rt is not None:
            rt.stop()

    def __enter__(self) -> "ServePipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def pending(self) -> int:
        return len(self._queue)

    def _dispatch(self, queries: np.ndarray):
        """One batch's dispatch, on the dispatch thread: (handle, start,
        end) on the host clock."""
        t0 = time.perf_counter()
        handle = self._ex.dispatch(queries, self._k, cfg=self._cfg, rerank=self._rerank)
        return handle, t0, time.perf_counter()

    def submit(
        self,
        queries: np.ndarray,
        gt_ids: np.ndarray | None = None,
        *,
        deadline_s: float | None = None,
    ) -> int:
        """Enqueue queries ((B, d) or (d,)); optional (B, k') ground truth.

        Validates shape/dtype/content up front with a clear error instead of
        failing deep inside dispatch (or silently corrupting the result-LRU
        key, which is the raw query bytes): queries must be a real-numeric
        1-D or 2-D array whose values are finite, with the executor's query
        width when it exposes one; `gt_ids` must be an integer array with
        one row per query. Rows are normalised to contiguous float32 so the
        cache key is canonical for every input dtype/stride.

        Returns the number of rows *accepted*. With `max_queue > 0`, rows
        that would push the backlog past the bound are shed here -- counted
        once in the next drain's `ServeStats.shed_queries`, never enqueued,
        never served. `deadline_s` overrides the pipeline default for this
        call's rows (0 disables); expired rows are dropped at dispatch.
        """
        q = np.asarray(queries)
        if q.ndim == 1:
            q = q[None]
        if q.ndim != 2:
            raise ValueError(
                f"queries must be (d,) or (B, d), got shape {q.shape}"
            )
        if q.dtype == object or not (
            np.issubdtype(q.dtype, np.floating)
            or np.issubdtype(q.dtype, np.integer)
            or np.issubdtype(q.dtype, np.bool_)
        ):
            raise TypeError(
                f"queries must be real-numeric, got dtype {q.dtype}"
            )
        q = np.ascontiguousarray(q, np.float32)
        if not np.isfinite(q).all():
            raise ValueError("queries contain NaN/Inf")
        d = getattr(self._ex, "query_dim", None)
        if d is not None and q.shape[1] != d:
            raise ValueError(
                f"queries have dim {q.shape[1]}, executor expects {d}"
            )
        gt = None
        if gt_ids is not None:
            gt = np.asarray(gt_ids)
            if gt.ndim == 1 and q.shape[0] == 1:
                gt = gt[None]
            if gt.ndim != 2 or gt.shape[0] != q.shape[0]:
                raise ValueError(
                    f"gt_ids must have one row per query: got shape "
                    f"{np.asarray(gt_ids).shape} for {q.shape[0]} queries"
                )
            if not np.issubdtype(gt.dtype, np.integer):
                raise TypeError(
                    f"gt_ids must be integer ids, got dtype {gt.dtype}"
                )
        now = time.perf_counter()
        ttl = self._deadline_s if deadline_s is None else deadline_s
        if ttl < 0:
            raise ValueError(f"deadline_s must be >= 0, got {ttl}")
        deadline = now + ttl if ttl > 0 else 0.0
        accept = total = q.shape[0]
        if self._max_queue > 0:
            room = max(self._max_queue - len(self._queue), 0)
            if accept > room:
                # Shed the tail *at submission* -- the rejected rows are
                # never enqueued, so they can be counted exactly once.
                self._shed_pending += accept - room
                accept = room
        rid0 = self._next_rid
        self._next_rid += total
        for i in range(accept):
            self._queue.append(
                (q[i], now, None if gt is None else gt[i], deadline, rid0 + i)
            )
        tel = self._tel
        if tel is not None:
            shed = total - accept
            if shed:
                tel.registry.counter(
                    "bang_serve_shed_total",
                    "rows rejected by admission control at submit",
                ).inc(shed)
                # One instant per shed row: the acceptance contract is that
                # every submitted rid is attributable on the timeline.
                for i in range(accept, total):
                    tel.instant("request_shed", track="serve", rid=rid0 + i)
                    tel.record("request_shed", rid=rid0 + i)
            if tel.tracer is not None:
                tr = tel.tracer
                tr.complete("admission", tr.at_us(now), tr.now_us(),
                            track="serve", submitted=total, accepted=accept,
                            shed=shed, rid0=rid0)
        return accept

    # ------------------------------------------------------- result cache
    def _cache_lookup(self, row: np.ndarray):
        """LRU hit for one query row (exact byte match), or None."""
        if self._result_cache_size == 0:
            return None
        key = row.tobytes()          # one serialisation per lookup, hit or not
        hit = self._result_cache.get(key)
        if hit is not None:
            self._result_cache.move_to_end(key)
        return hit

    def _cache_insert(self, queries: np.ndarray, ids, dists) -> None:
        if self._result_cache_size == 0:
            return
        if getattr(self._ex, "mutation_epoch", None) != self._result_cache_epoch:
            # A mutation landed between this drain's epoch check and these
            # results coming back: they may already be stale, so don't cache
            # them (the next drain clears and re-syncs the epoch).
            return
        for q_row, i_row, d_row in zip(queries, np.asarray(ids), np.asarray(dists)):
            self._result_cache[q_row.tobytes()] = (i_row.copy(), d_row.copy())
            self._result_cache.move_to_end(q_row.tobytes())
        while len(self._result_cache) > self._result_cache_size:
            self._result_cache.popitem(last=False)

    def drain(
        self, on_batch: Callable[[BatchReport], None] | None = None
    ) -> tuple[np.ndarray, np.ndarray, ServeStats]:
        """Process every queued query; results aligned to submission order."""
        n = len(self._queue)
        k = self._k
        # Mutation-epoch fence: every insert()/delete()/consolidate() on a
        # MutableSearchExecutor bumps its epoch, and results cached under an
        # older epoch may name deleted ids or miss fresh ones -- drop them.
        epoch = getattr(self._ex, "mutation_epoch", None)
        if epoch != self._result_cache_epoch:
            self._result_cache.clear()
            self._result_cache_epoch = epoch
        ids_out = np.full((n, k), -1, np.int32)
        dists_out = np.full((n, k), np.inf, np.float32)
        latencies: list[float] = []
        # (recall, n_gt_rows) pairs: the final stat is row-weighted so a
        # 1-row tail micro-batch can't outvote a 128-row batch.
        recalls: list[tuple[float, int]] = []
        batches = 0
        compile_s = 0.0
        cache_hits = 0
        expired = 0
        tel = self._tel
        tr = None if tel is None else tel.tracer
        # Window anchor set at construction / previous drain end:
        # ServeStats.telemetry is the delta since then, so submit-time
        # activity (sheds, hostio prefetch) lands in the window it is
        # reported in (ServeStats.shed_queries counts the same way).
        reg_snap = self._reg_snap
        t_start = time.perf_counter()

        # Result-cache pre-pass: rows seen in an earlier drain are answered
        # straight from the LRU and never reach the executor; the remaining
        # misses keep their original submission positions. Rows whose
        # deadline already passed are dropped here (their result slots stay
        # -1/inf) -- a timed-out client gets nothing, not late work.
        misses: deque = deque()
        hit_gt_ids: list[np.ndarray] = []
        hit_gt_true: list[np.ndarray] = []
        for at, (row, t_enq, gt, dl, rid) in enumerate(self._queue):
            if dl and time.perf_counter() > dl:
                expired += 1
                if tel is not None:
                    tel.instant("request_expired", track="serve", rid=rid,
                                where="prepass")
                    tel.record("request_expired", rid=rid)
                continue
            cached = self._cache_lookup(row)
            if cached is None:
                misses.append((at, (row, t_enq, gt, dl, rid)))
                continue
            ids_out[at], dists_out[at] = cached
            cache_hits += 1
            now = time.perf_counter()
            latencies.append((now - t_enq) * 1e3)
            if tr is not None:
                tr.complete("request", tr.at_us(t_enq), tr.at_us(now),
                            track="serve", rid=rid, outcome="cache_hit")
            if gt is not None:
                hit_gt_ids.append(ids_out[at])
                hit_gt_true.append(gt)
        self._queue.clear()
        if hit_gt_ids:
            kk = min(k, min(len(g) for g in hit_gt_true))
            recalls.append((recall_at_k(
                np.stack(hit_gt_ids)[:, :kk],
                np.stack([g[:kk] for g in hit_gt_true]),
            ), len(hit_gt_ids)))

        if self._dispatcher is None:
            self._dispatcher = ThreadPoolExecutor(1, thread_name_prefix="serve-dispatch")
        dispatcher = self._dispatcher
        # A batch in flight: (rows, result positions, the future of its
        # dispatch, the time it was handed to the dispatch thread).
        inflight: tuple[list, list, Future, float] | None = None
        nxt: tuple[list, list, Future, float] | None = None
        try:
            while misses or inflight is not None:
                nxt = None
                # The next batch is formed and handed to the dispatch thread
                # before the previous one is finished here. Deadlines are
                # enforced at this point: a row that expired while waiting
                # behind earlier batches is dropped instead of padded in.
                popped = []
                while misses and len(popped) < self._max_batch:
                    at, item = misses.popleft()
                    if item[3] and time.perf_counter() > item[3]:
                        expired += 1
                        if tel is not None:
                            tel.instant("request_expired", track="serve",
                                        rid=item[4], where="dispatch")
                            tel.record("request_expired", rid=item[4])
                        continue
                    popped.append((at, item))
                if popped:
                    at_idx = [p[0] for p in popped]
                    rows = [p[1] for p in popped]
                    queries = np.stack([r[0] for r in rows])
                    t_disp = time.perf_counter()
                    try:
                        fut = dispatcher.submit(self._dispatch, queries)
                    except BaseException:
                        # The popped rows never reached the executor; put
                        # them back so the outer handler re-enqueues them.
                        misses.extendleft(reversed(popped))
                        raise
                    nxt = (rows, at_idx, fut, t_disp)

                if inflight is not None:
                    rows, at_idx, fut, t_disp = inflight
                    # Raises what the dispatch thread raised for this batch.
                    handle, t0, t1 = fut.result()
                    if tr is not None:
                        # The dispatch call on its thread (bucketing,
                        # padding, upload, the hop loop); the device's tail
                        # shows up in the following `device` span.
                        tr.complete("dispatch", tr.at_us(t0), tr.at_us(t1),
                                    track="serve", size=len(rows),
                                    bucket=handle.bucket)
                    ids, dists = self._ex.finish(handle)
                    ready = time.perf_counter()
                    ids = _host(ids)
                    dists = _host(dists)
                    ids_out[at_idx] = ids
                    dists_out[at_idx] = dists
                    self._cache_insert(np.stack([r[0] for r in rows]), ids, dists)
                    latencies.extend((ready - r[1]) * 1e3 for r in rows)
                    compile_s += handle.compile_s
                    if tr is not None:
                        # Device span: hand-off -> results on the host. Then
                        # one `request` span per row, closing each rid's
                        # lifecycle (queue time is the span's pre-dispatch
                        # portion, stamped as an arg).
                        tr.complete("device", tr.at_us(t_disp),
                                    tr.at_us(ready), track="serve",
                                    size=len(rows), bucket=handle.bucket,
                                    compile_s=handle.compile_s)
                        for r in rows:
                            tr.complete("request", tr.at_us(r[1]),
                                        tr.at_us(ready), track="serve",
                                        rid=r[4], outcome="served",
                                        queue_s=max(t_disp - r[1], 0.0))
                    # Score whichever rows carry ground truth (a micro-batch
                    # may mix gt and non-gt rows across submit() calls).
                    gt_idx = [i for i, r in enumerate(rows) if r[2] is not None]
                    rec = None
                    if gt_idx:
                        # Rows may carry gt of different widths (separate
                        # submit() calls); truncate to the narrowest before
                        # stacking so wide gt doesn't deflate the ratio and
                        # ragged widths don't crash the stack.
                        gt_rows = [rows[i][2] for i in gt_idx]
                        kk = min(ids.shape[1], min(len(g) for g in gt_rows))
                        gt = np.stack([g[:kk] for g in gt_rows])
                        rec = recall_at_k(ids[gt_idx][:, :kk], gt)
                        recalls.append((rec, len(gt_idx)))
                    if on_batch is not None:
                        on_batch(BatchReport(
                            index=batches, size=len(rows),
                            wall_s=ready - t_disp,
                            compile_s=handle.compile_s, recall=rec,
                            ids=ids, dists=dists,
                        ))
                    batches += 1
                inflight = nxt
                nxt = None
        except BaseException:
            # Exception safety: the pre-pass cleared self._queue, so without
            # this every un-dispatched miss would be silently dropped and the
            # in-flight batches leaked. Wait for the batches still in flight
            # (ignoring their own failures) and re-enqueue every row whose
            # result was never recorded, in submission order, before
            # re-raising -- the caller can retry drain() after handling the
            # error.
            pending: list = []
            for batch in (inflight, nxt):
                if batch is None:
                    continue
                try:
                    self._ex.finish(batch[2].result()[0])
                except Exception:
                    pass
                pending.extend(batch[0])
            pending.extend(row for _at, row in misses)
            self._queue.extend(pending)
            raise

        wall = time.perf_counter() - t_start
        steady = max(wall - compile_s, 1e-9)
        rt = getattr(self._ex, "hostio_runtime", None)
        mut = getattr(self._ex, "mutation_stats", None)
        n_gt = sum(rows for _r, rows in recalls)
        shed = self._shed_pending
        self._shed_pending = 0
        qps = (n - expired) / steady
        mean_recall = (
            float(sum(r * rows for r, rows in recalls) / n_gt)
            if n_gt else None
        )
        tel_window = None
        if tel is not None:
            reg = tel.registry
            reg.counter(
                "bang_serve_queries_total", "rows drained (incl. expired)",
            ).inc(n)
            reg.counter(
                "bang_serve_batches_total", "micro-batches dispatched",
            ).inc(batches)
            reg.counter(
                "bang_serve_expired_total",
                "accepted rows dropped at dispatch (deadline passed)",
            ).inc(expired)
            reg.counter(
                "bang_serve_result_cache_hits_total",
                "rows served from the query-result LRU",
            ).inc(cache_hits)
            lat = reg.histogram(
                "bang_serve_latency_seconds",
                "per-row latency, enqueue -> results ready",
            )
            for ms in latencies:
                lat.observe(ms / 1e3)
            reg.gauge(
                "bang_serve_qps", "steady-state QPS of the last drain window",
            ).set(qps)
            if mean_recall is not None:
                reg.gauge(
                    "bang_serve_recall",
                    "row-weighted mean recall@k of the last drain window",
                ).set(mean_recall)
            tel_window = reg.delta(reg_snap)
            # Re-anchor: the next window starts where this one ended.
            self._reg_snap = reg.snapshot()
        # Snapshots are deep-copied: hostio/mutation stats reach callers
        # (benchmarks, dashboards) that hold them across later drains, and
        # nothing a caller does to its copy may alias live counter state
        # (tests/test_torch_serving.py holds this with a mutating reader).
        stats = ServeStats(
            batches=batches,
            queries=n,
            wall_s=wall,
            compile_s=compile_s,
            # Expired rows were dropped, not served: they don't inflate QPS.
            qps=qps,
            p50_ms=float(np.percentile(latencies, 50)) if latencies else 0.0,
            p95_ms=float(np.percentile(latencies, 95)) if latencies else 0.0,
            mean_recall=mean_recall,
            result_cache_hits=cache_hits,
            result_cache_hit_rate=cache_hits / n if n else 0.0,
            shed_queries=shed,
            expired_queries=expired,
            hostio=None if rt is None else copy.deepcopy(rt.stats()),
            mutation=copy.deepcopy(mut() if callable(mut) else mut),
            telemetry=tel_window,
        )
        self.last_stats = stats
        return ids_out, dists_out, stats
