"""Multi-worker host neighbour service: the paper's CPU half as a subsystem.

BANG's CPU side (§4.1) is a service: per GPU, host threads drain a queue of
frontier batches and gather adjacency rows from the host-RAM graph while the
GPU computes distances. `NeighborService` is that host side:

  * **One worker pool per graph partition.** Each partition (one for the
    single-device "base" variant, this rank's block for "sharded-base")
    owns `workers` daemon threads draining a request queue.
  * **Batched gathers.** A request's owned lanes are split into up to
    `workers` contiguous chunks gathered concurrently -- the service-side
    analogue of the paper's multi-threaded `memcpy` fan-out.
  * **Two protocols.** `request()` is the synchronous path (the caller
    blocks until the pooled gather lands). `issue()`/`collect()` split the
    exchange in two for the prefetched frontier exchange
    (`repro_torch.runtime.hostio.prefetch`): `issue` enqueues hop k+1's
    expected gather and returns a sequence ticket at once; `collect` waits
    on that ticket one hop later, re-gathering inline any lane whose
    prediction missed, so results stay bit-exact. `issue_lazy` is `issue`
    whose request is computed on the worker (after it has waited for the
    device to finish copying the frontier to the host).
  * **Pinned destinations.** Each protocol takes an optional `out`, an
    (B, R) int32 host array (on a CUDA index a numpy view of a pinned
    staging tensor) that the workers write straight into. The call returns
    `out` when the result lies there and no worker writes it any more;
    any other returned array means `out` was abandoned to a stalled worker
    (a hedged gather) and must not be reused.
  * **Counters.** Queue depth, per-request latency, rows gathered,
    cache-hit/miss lanes (the device-resident hot cache reports its hit mask
    with each request), prefetch hit/miss/mismatch counts, and the measured
    `overlap_fraction` -- the share of host gather time hidden behind the
    search thread's other work (`stats()`).
  * **Telemetry** (`repro_torch.runtime.telemetry`). `set_telemetry()`
    attaches a `Telemetry` bundle: every counter bump mirrors into the
    process metrics registry as `bang_hostio_*` (cumulative -- registry
    metrics ignore `reset_stats()` windows), gathers emit per-partition
    `gather` spans on `hostio-p<shard>` trace tracks, the per-hop profiler
    hooks the `_account` seam, and resilience transitions (partition down,
    failover, recovery, degraded lanes, deadline expiry) both mark the
    trace timeline and trigger flight-recorder postmortem dumps. All of it
    is host-side and detached by default.
  * **Fault handling** (`repro_torch.runtime.resilience`). A
    `ResilienceConfig` turns on deadline-aware gathers with retry +
    exponential backoff on transient errors, hedged inline re-issue when a
    pooled gather or a prefetch ticket stalls past its wait budget, a
    per-partition health tracker (consecutive primary-read failures mark a
    partition down, with optional automatic replica pinning for bit-exact
    failover reads), and degraded-mode row substitution -- unfetchable lanes
    serve either the medoid's adjacency row ("medoid": the search restarts
    toward the graph centre) or nothing at all ("mask": the lanes surface as
    -1 rows and ride the `(nbrs >= 0)` validity mask in
    `core.search.bang_search`). A seeded `FaultInjector` can be attached
    (`set_injector`) to script worker crashes/stalls, partition outages,
    queue overflow and transient gather errors deterministically; the
    handling machinery cannot tell injected faults from real ones.

The gather math is `core.distributed.host_shard_service`'s: owned lanes
contribute `partition[rel] + 1`, everything else 0, so a sum over shards (or
a plain `-1` for the single-partition base variant) rebuilds the row
exchange bit-for-bit. The service never touches host memory for non-owned
or cache-hit lanes (`tests/test_torch_hostio.py` holds the
exactly-once-per-miss property). Every fault decision happens host-side
inside these calls, so the device work of a hop is the same whether the
host tier is healthy, degraded or failed over.

numpy and `threading` only: the service launches no CUDA work, and its
worker threads touch nothing but host arrays (and, through `issue_lazy`'s
resolver, a CUDA event they wait on).
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np

from ..resilience import (
    InjectedWorkerCrash,
    PartitionDownError,
    TransientGatherError,
    backoff_delay,
)

__all__ = ["NeighborService"]

# Below this many owned lanes a request is gathered by a single worker: the
# chunk bookkeeping would cost more than the copy it parallelises.
_MIN_CHUNK = 8

# Ceiling on outstanding prefetch tickets. Every search's final hop issues a
# ticket nobody collects (the loop exits before redeeming it), so a
# long-running server would otherwise leak one pending gather per search. Evicting is always safe: collect() of an evicted seq
# falls back to an inline gather (counted as a prefetch miss), bit-exact.
_MAX_PENDING = 64

# Last-resort wait on a pooled gather / prefetch ticket when no
# ResilienceConfig is attached: long enough to never fire in healthy
# operation, finite so a wedged pool can never hang the search loop.
_STUCK_POOL_S = 60.0


class _Pending:
    """One in-flight prefetched gather (issue() -> collect()).

    `rel`/`own` are the issued request, known at issue time or, for a lazy
    issue, once the worker has resolved it; `out` is set once the gather
    landed."""

    __slots__ = ("rel", "own", "out", "done", "t_issue", "t_done")

    def __init__(self) -> None:
        self.rel: np.ndarray | None = None
        self.own: np.ndarray | None = None
        self.out: np.ndarray | None = None
        self.done = threading.Event()
        self.t_issue = time.perf_counter()
        self.t_done = 0.0


class NeighborService:
    """Thread-pooled host adjacency gathers over pinned graph partitions.

    `partitions[s]` holds the contiguous rows `[s*n_loc, (s+1)*n_loc)` of the
    (padded) adjacency in host RAM; all partitions share one `(n_loc, R)`
    shape (numpy arrays, or host tensors, whose memory is shared, not
    copied). `workers` threads serve each partition's queue. The service is
    safe to share between concurrent searches: every prefetch ticket is a
    unique sequence number, so interleaved issue/collect streams never
    cross-match.

    `resilience` (a `ResilienceConfig`) enables the fault-handling contract
    described in the module docstring; `medoid` (a global row id) pins the
    medoid's adjacency row host-side for degraded-mode substitution, or
    `medoid_row` gives that row itself (a rank of "sharded-base" holds one
    block of the graph, which need not hold the medoid); `injector` (or
    `set_injector`) attaches a scripted `FaultInjector`.
    """

    def __init__(self, partitions, *, workers: int = 1, name: str = "hostio",
                 resilience=None, medoid: int | None = None, injector=None,
                 medoid_row=None):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self._parts = [
            np.ascontiguousarray(np.asarray(p, np.int32)) for p in partitions
        ]
        if not self._parts:
            raise ValueError("need at least one graph partition")
        n_loc, R = self._parts[0].shape
        if any(p.shape != (n_loc, R) for p in self._parts):
            raise ValueError("host partitions must share one (n_loc, R) shape")
        self.n_loc, self.R = n_loc, R
        self.workers = workers
        self.name = name
        self.resilience = resilience
        self._injector = injector
        self._tel = None
        # Medoid adjacency row, pinned at construction: degraded-mode
        # substitution must not read the (possibly down) owning partition.
        self._medoid_row: np.ndarray | None = None
        if medoid_row is not None:
            self._medoid_row = np.array(medoid_row, np.int32).reshape(R)
        elif medoid is not None and 0 <= medoid < n_loc * len(self._parts):
            self._medoid_row = self._parts[medoid // n_loc][
                medoid % n_loc
            ].copy()
        # Partition health (all guarded by self._lock): partitions marked
        # down, pinned failover replicas, and consecutive-failure streaks.
        self._down: set[int] = set()
        self._failover: dict[int, np.ndarray] = {}
        self._fail_streak: dict[int, int] = {}
        self._queues: list[queue.Queue] | None = None
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()
        self._seq = 0
        self._pending: dict[int, _Pending] = {}
        self.reset_stats()

    # ------------------------------------------------------------- lifecycle
    @property
    def started(self) -> bool:
        return self._queues is not None

    def start(self) -> "NeighborService":
        """Spin up the per-partition worker pools (idempotent)."""
        self._ensure_started()
        return self

    def _ensure_started(self) -> list | None:
        """Start-if-needed and return the live queue list (or None mid-stop)."""
        with self._lock:
            if self._queues is None:
                self._queues = [queue.Queue() for _ in self._parts]
                self._threads = []
                for s, q in enumerate(self._queues):
                    for w in range(self.workers):
                        th = threading.Thread(
                            target=self._worker_loop, args=(q, s),
                            name=f"{self.name}-p{s}-w{w}", daemon=True,
                        )
                        th.start()
                        self._threads.append(th)
            return self._queues

    def _enqueue(self, shard: int, item) -> bool:
        """Queue a work item unless a concurrent stop() won the race.

        The lock serialises this against stop(): an item queued while the
        pools are live lands *before* stop()'s shutdown sentinels, so its
        worker always executes it; once stop() has run, the caller gets
        False and must do the work inline. This is what makes one service
        safe to share between pipelines (BangIndex caches executors per
        config, so two ServePipelines can own the same service).

        The fault injector models queue overflow here: a rejected put
        returns False and the caller degrades to the same inline path, so
        overflow sheds *queueing*, never work. Items destined for a
        partition that is marked down are routed to the least-loaded
        surviving pool -- its workers can serve the pinned replica just as
        well, which is how failover re-pins a dead partition's rows onto
        the remaining workers.
        """
        inj = self._injector
        if inj is not None and not inj.on_enqueue(shard):
            self._bump(enqueue_rejections=1)
            return False
        with self._lock:
            if self._queues is None:
                return False
            target = shard
            if shard in self._down:
                alive = [
                    s for s in range(len(self._parts)) if s not in self._down
                ]
                if alive:
                    target = min(alive, key=lambda s: self._queues[s].qsize())
            self._bump_locked(max_queue_depth=self._queues[target].qsize() + 1)
            self._queues[target].put(item)
            return True

    def stop(self) -> None:
        """Drain and join the pools (idempotent; start() revives them).

        In-flight prefetch tickets are poisoned under the same lock that
        guards issue(): any pending gather that has not completed gets its
        done-event set with `out` still None, so a collect() racing the
        shutdown takes the inline-gather miss path immediately (bit-exact)
        instead of blocking on a queue no worker will ever drain again.
        """
        with self._lock:
            queues, threads = self._queues, self._threads
            self._queues, self._threads = None, []
            if queues is not None:
                # Sentinels go in under the same lock that guards _enqueue:
                # everything queued while the pools were live precedes them.
                for q in queues:
                    for _ in range(self.workers):
                        q.put(None)
            now = time.perf_counter()
            for p in self._pending.values():
                if not p.done.is_set():
                    p.t_done = now
                    p.done.set()
        for th in threads:
            th.join(timeout=5.0)

    def _worker_loop(self, q: queue.Queue, shard: int) -> None:
        while True:
            item = q.get()
            if item is None:
                return
            fn = item
            died = False
            try:
                inj = self._injector
                if inj is not None:
                    inj.on_worker(shard)
                fn()
            except InjectedWorkerCrash:
                # The crash fires before fn() ran: requeue the untouched
                # item so a surviving pool mate completes it (or, for a
                # now-empty pool, the caller's hedge/ticket timeout gathers
                # inline) -- a dead worker loses zero requests.
                q.put(fn)
                self._bump(worker_deaths=1)
                died = True
            except Exception as e:
                # Work items release their own latches in finally blocks, so
                # nothing deadlocks; keep the worker alive for later requests
                # (the failed request surfaces through its own result path).
                # The failure is *observable*: it bumps the worker_errors
                # counter and pins the message into the stats() snapshot
                # (and so into ServeStats.hostio), not just stderr.
                import sys

                with self._lock:
                    self._bump_locked(worker_errors=1)
                    self._last_worker_error = f"{type(e).__name__}: {e}"
                print(f"[{self.name}] worker error: {e!r}", file=sys.stderr)
            finally:
                q.task_done()
            if died:
                return

    # ----------------------------------------------------- health & faults
    def set_injector(self, injector) -> None:
        """Attach (or detach, with None) a scripted FaultInjector."""
        self._injector = injector
        tel = self._tel
        if injector is not None and tel is not None \
                and tel.recorder is not None:
            injector.set_recorder(tel.recorder)

    def set_telemetry(self, telemetry) -> None:
        """Attach (or detach, with None) a `telemetry.Telemetry` bundle.

        Pure host-side state: changes no result and no counter window, only
        adds mirroring/trace/postmortem emission.
        """
        self._tel = telemetry
        inj = self._injector
        if inj is not None and telemetry is not None \
                and telemetry.recorder is not None:
            inj.set_recorder(telemetry.recorder)

    def _resilience_event(self, name: str, *, postmortem: bool,
                          **fields) -> None:
        """Timeline instant + ring entry (+ postmortem dump) for one
        health/fault transition. Called with self._lock NOT held: the
        flight recorder snapshots the metrics registry, and keeping the
        service lock out of that keeps lock ordering one-directional."""
        tel = self._tel
        if tel is None:
            return
        tel.event(name, **fields)
        if postmortem and tel.recorder is not None:
            tel.recorder.trigger(name, **fields)

    def mark_partition_down(self, shard: int) -> None:
        """Mark a host partition unreachable (reads degrade or fail over)."""
        with self._lock:
            self._down.add(int(shard))
        self._resilience_event("partition_down", postmortem=True,
                               shard=int(shard))

    def fail_over(self, shard: int) -> None:
        """Mark a partition down AND pin a replica of its rows.

        Reads of a failed-over partition come from the replica -- bit-exact
        vs the primary -- and are served by the surviving pools. In this
        in-process model the replica is copied from the still-resident
        primary array; it stands in for the pre-provisioned replica a real
        disaggregated tier would promote.
        """
        shard = int(shard)
        with self._lock:
            self._down.add(shard)
            pinned = shard not in self._failover
            if pinned:
                self._failover[shard] = self._parts[shard].copy()
                self._bump_locked(failovers=1)
        if pinned:
            self._resilience_event("failover", postmortem=True, shard=shard)

    def recover(self, shard: int) -> None:
        """Bring a partition back: primary reads resume (bit-exact)."""
        shard = int(shard)
        with self._lock:
            was = shard in self._down or shard in self._failover
            self._down.discard(shard)
            self._failover.pop(shard, None)
            self._fail_streak.pop(shard, None)
            if was:
                self._bump_locked(recoveries=1)
        if was:
            self._resilience_event("recover", postmortem=False, shard=shard)

    def partition_state(self, shard: int) -> str:
        """'up', 'down' (degraded lanes) or 'failover' (replica reads)."""
        with self._lock:
            if shard in self._down:
                return "failover" if shard in self._failover else "down"
            return "up"

    def _read_rows(self, shard: int, idx: np.ndarray) -> np.ndarray:
        """The single host-memory touch point for adjacency rows.

        Down + replica -> replica read (counted as a failover gather).
        Down + no replica -> PartitionDownError (degrade/retry upstream).
        Up -> injector gate, then the primary partition.
        """
        with self._lock:
            down = shard in self._down
            replica = self._failover.get(shard)
        if down:
            if replica is not None:
                self._bump(failover_gathers=1)
                return replica[idx]
            raise PartitionDownError(
                f"partition {shard} is down and has no failover replica"
            )
        inj = self._injector
        if inj is not None:
            inj.on_gather(shard)
        return self._parts[shard][idx]

    def _note_gather_failure(self, shard: int) -> None:
        """Record one failed primary read; mark down on a long streak."""
        res = self.resilience
        auto_down = auto_failover = False
        with self._lock:
            self._bump_locked(gather_failures=1)
            streak = self._fail_streak.get(shard, 0) + 1
            self._fail_streak[shard] = streak
            if (res is not None and streak >= res.unhealthy_after
                    and shard not in self._down):
                self._down.add(shard)
                auto_down = True
                if res.auto_failover and shard not in self._failover:
                    self._failover[shard] = self._parts[shard].copy()
                    self._bump_locked(failovers=1)
                    auto_failover = True
        if auto_failover:
            self._resilience_event("failover", postmortem=True, shard=shard,
                                   auto=True, streak=streak)
        elif auto_down:
            self._resilience_event("partition_down", postmortem=True,
                                   shard=shard, auto=True, streak=streak)

    def _degrade_lanes(self, out: np.ndarray, lanes: np.ndarray,
                       shard: int) -> None:
        """Serve unfetchable lanes without host reads.

        "medoid": substitute the pinned medoid adjacency row -- the search
        restarts toward the graph centre, keeping the worklist populated.
        "mask": contribute 0, so after the -1 shift the lanes surface as
        all -1 rows and are dropped by the same `(nbrs >= 0)` validity mask
        that drops tombstone padding (see core.search.bang_search).
        """
        res = self.resilience
        mode = "medoid" if res is None else res.degraded_mode
        if mode == "medoid" and self._medoid_row is not None:
            out[lanes] = self._medoid_row[None, :] + 1
        else:
            out[lanes] = 0
        self._bump(degraded_lanes=int(lanes.size))
        self._resilience_event("degraded", postmortem=True, shard=int(shard),
                               lanes=int(lanes.size), mode=mode)

    def _gather_chunk(self, shard: int, rel: np.ndarray, out: np.ndarray,
                      lanes: np.ndarray, deadline: float) -> None:
        """Fill one chunk of owned lanes; retries, then degrades. Never raises.

        Transient errors and down-partitions retry up to
        `resilience.max_retries` times with exponential backoff capped at
        the remaining deadline (a failure streak can flip the partition to
        failover mid-loop, in which case a retry succeeds bit-exactly from
        the replica). Exhausted attempts degrade the lanes instead of
        failing the request.
        """
        res = self.resilience
        attempts = 1 + (res.max_retries if res is not None else 0)
        for attempt in range(attempts):
            try:
                out[lanes] = self._read_rows(shard, rel[lanes]) + 1
            except (PartitionDownError, TransientGatherError):
                self._note_gather_failure(shard)
                if attempt + 1 >= attempts:
                    break
                if deadline > 0:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        self._bump(deadline_hits=1)
                        self._resilience_event(
                            "deadline_hit", postmortem=True,
                            shard=int(shard), attempt=attempt)
                        break
                else:
                    remaining = -1.0
                if res is not None:
                    time.sleep(backoff_delay(res, attempt, remaining))
                continue
            # Success: reset the failure streak and count the host traffic.
            if self._fail_streak.get(shard):
                with self._lock:
                    self._fail_streak[shard] = 0
            bumps = {"rows_gathered": int(lanes.size)}
            if attempt > 0:
                bumps["retries"] = attempt
            self._bump(**bumps)
            return
        self._degrade_lanes(out, lanes, shard)

    # -------------------------------------------------------------- counters
    def reset_stats(self) -> None:
        with self._lock:
            self._c = {
                "requests": 0,
                "rows_gathered": 0,
                "host_miss_lanes": 0,
                "cache_hit_lanes": 0,
                "prefetch_issued": 0,
                "prefetch_hits": 0,
                "prefetch_misses": 0,
                "prefetch_lane_mismatches": 0,
                "worker_errors": 0,
                "worker_deaths": 0,
                "retries": 0,
                "gather_failures": 0,
                "degraded_lanes": 0,
                "hedged_gathers": 0,
                "deadline_hits": 0,
                "failover_gathers": 0,
                "failovers": 0,
                "recoveries": 0,
                "enqueue_rejections": 0,
                "max_queue_depth": 0,
                "gather_s_total": 0.0,
                "gather_s_hidden": 0.0,
                "latency_s_total": 0.0,
            }
            self._last_worker_error: str | None = None

    def _bump_locked(self, **kw) -> None:
        """Counter update; caller must hold self._lock (it is not reentrant)."""
        for k, v in kw.items():
            if k == "max_queue_depth":
                self._c[k] = max(self._c[k], v)
            else:
                self._c[k] += v
        tel = self._tel
        if tel is not None:
            # Registry lock is strictly innermost under self._lock; nothing
            # in the registry ever calls back into the service.
            tel.bump_hostio(kw)

    def _bump(self, **kw) -> None:
        with self._lock:
            self._bump_locked(**kw)

    @staticmethod
    def _hit_rate_of(c: dict) -> float:
        total = c["cache_hit_lanes"] + c["host_miss_lanes"]
        return c["cache_hit_lanes"] / total if total else 0.0

    @staticmethod
    def _overlap_of(c: dict) -> float:
        total = c["gather_s_total"]
        return min(c["gather_s_hidden"] / total, 1.0) if total > 0 else 0.0

    def cache_hit_rate(self) -> float:
        """Measured hot-cache hit rate over all lanes that needed a row."""
        with self._lock:
            c = dict(self._c)
        return self._hit_rate_of(c)

    def overlap_fraction(self) -> float:
        """Share of host gather time hidden behind device compute.

        Per prefetched request, the hidden portion is the part of
        [issue, done] that elapsed before collect() started waiting; the
        fraction aggregates hidden time over total prefetched gather time.
        0.0 when nothing was prefetched.
        """
        with self._lock:
            c = dict(self._c)
        return self._overlap_of(c)

    def stats(self) -> dict:
        """Snapshot of the cumulative counters (JSON-serialisable).

        Every derived ratio is computed from the one counter copy taken
        under the lock, so a snapshot is internally consistent even under
        concurrent traffic -- the reported cache_hit_rate always equals
        cache_hit_lanes / (cache_hit_lanes + host_miss_lanes) of the *same*
        dict (re-reading the live counters per ratio could not promise
        that).
        """
        with self._lock:
            c = dict(self._c)
            last_error = self._last_worker_error
            partitions_down = len(self._down)
        n = max(c["requests"], 1)
        return {
            **{k: v for k, v in c.items()
               if k not in ("gather_s_total", "gather_s_hidden")},
            "mean_latency_ms": c["latency_s_total"] / n * 1e3,
            "cache_hit_rate": self._hit_rate_of(c),
            "overlap_fraction": self._overlap_of(c),
            "last_worker_error": last_error,
            "workers": self.workers,
            "partitions": len(self._parts),
            "partitions_down": partitions_down,
        }

    # --------------------------------------------------------------- gathers
    def _wait_budget_s(self) -> float:
        """How long to wait on a pooled gather / ticket before hedging."""
        res = self.resilience
        return _STUCK_POOL_S if res is None else min(
            res.wait_s(), _STUCK_POOL_S
        )

    def _deadline(self) -> float:
        """Absolute per-gather deadline (0.0 = none configured)."""
        res = self.resilience
        if res is None or res.deadline_s <= 0:
            return 0.0
        return time.perf_counter() + res.deadline_s

    def _gather(
        self, shard: int, rel: np.ndarray, own: np.ndarray, pooled: bool = True,
        out: np.ndarray | None = None,
    ) -> np.ndarray:
        """Gather one request's owned lanes (+1-shifted contributions).

        With `pooled=True` the owned lanes split into up to `workers`
        contiguous chunks run concurrently on the partition's pool; lanes the
        shard does not own (or that the hot cache already served) contribute
        0 and never index host memory. `pooled=False` gathers serially -- the
        prefetch path uses it *inside* a pool slot, so a request must never
        block that slot waiting on chunk tasks queued behind it (two
        concurrent prefetches could otherwise occupy every worker and
        deadlock).

        The result is written into `out` where it is given (else a fresh
        array) and that array is returned. The pooled wait is bounded by the
        hedge budget: if the pool stalls (slow worker, crashed worker with
        no pool mate, rejected enqueue racing a stop), `out` is abandoned and
        the whole gather re-runs serially on the calling thread into a fresh
        array, which is returned instead -- a stalled worker finishing late
        can therefore never corrupt a result already returned.
        """
        rel = np.asarray(rel)
        own = np.asarray(own, bool)
        if out is None:
            out = np.zeros((rel.shape[0], self.R), np.int32)
        else:
            out[~own] = 0       # owned lanes are all written below
        lanes = np.nonzero(own)[0]
        if lanes.size == 0:
            return out
        deadline = self._deadline()
        part_n = min(self.workers, max(1, lanes.size // _MIN_CHUNK))
        if part_n == 1 or not pooled:
            # Serial fast path (tiny request, or in-slot prefetch gather).
            self._gather_chunk(shard, rel, out, lanes, deadline)
            return out
        remaining = threading.Semaphore(0)

        def task(chunk: np.ndarray):
            def run() -> None:
                try:
                    self._gather_chunk(shard, rel, out, chunk, deadline)
                finally:
                    remaining.release()
            return run

        chunks = np.array_split(lanes, part_n)
        for chunk in chunks:
            item = task(chunk)
            if not self._enqueue(shard, item):
                item()          # pools stopped / queue rejected: inline
        hedge_at = time.perf_counter() + self._wait_budget_s()
        for _ in chunks:
            budget = hedge_at - time.perf_counter()
            if budget <= 0 or not remaining.acquire(timeout=budget):
                # Hedged re-issue: redo the full gather serially into a
                # fresh buffer (late workers may still write `out`).
                self._bump(hedged_gathers=1)
                fresh = np.zeros((rel.shape[0], self.R), np.int32)
                self._gather_chunk(shard, rel, fresh, lanes, deadline)
                return fresh
        return out

    # ----------------------------------------------------- request protocol
    # Pools auto-start on first use: executors can be driven directly
    # (without a ServePipeline owning the lifecycle), and an explicit
    # start() merely warms the threads up front. stop() remains the
    # tear-down; a stopped service revives itself if traffic returns.
    def request(self, shard, rel, own, cache_hit, *,
                out: np.ndarray | None = None) -> np.ndarray:
        """Synchronous path: block on the pooled gather (no prefetch)."""
        self._ensure_started()
        t0 = time.perf_counter()
        shard = int(np.asarray(shard))
        own = np.asarray(own, bool)
        res = self._gather(shard, rel, own, out=out)
        t1 = time.perf_counter()
        self._account(shard, own, np.asarray(cache_hit, bool), t1 - t0)
        self._bump(requests=1, latency_s_total=t1 - t0)
        tel = self._tel
        if tel is not None and tel.tracer is not None:
            tr = tel.tracer
            tr.complete("gather", tr.at_us(t0), tr.at_us(t1),
                        track=f"hostio-p{shard}", mode="sync",
                        rows=int(own.sum()))
        return res

    def issue(self, shard, rel, own) -> np.ndarray:
        """Enqueue hop k+1's expected gather; return a (1,) sequence ticket.

        The gather runs on the partition pool while the device is still
        computing hop k; `collect()` redeems the ticket one hop later.
        """
        rel = np.array(rel, np.int32, copy=True)
        own = np.array(own, bool, copy=True)
        return self._issue(int(np.asarray(shard)), lambda: (rel, own),
                           None, None, lazy=False, any_own=bool(own.any()))

    def issue_lazy(self, shard, resolve, *, out: np.ndarray | None = None,
                   settled: threading.Event | None = None) -> np.ndarray:
        """`issue` of the request `resolve()` returns as (rel, own), called
        on the worker before the gather. The prefetched exchange resolves
        there, so the search thread never waits for the frontier to reach the
        host at issue time. The ticket's gather time starts once `resolve`
        returns. The gather writes into `out` where it is given, and sets
        `settled` once it no longer writes there."""
        return self._issue(int(np.asarray(shard)), resolve, out, settled,
                           lazy=True, any_own=True)

    def _issue(self, shard: int, resolve, out, settled, *, lazy: bool,
               any_own: bool) -> np.ndarray:
        self._ensure_started()
        p = _Pending()
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._pending[seq] = p
            while len(self._pending) > _MAX_PENDING:
                # Oldest-first eviction (dict preserves insertion order);
                # a later collect of an evicted ticket inline-gathers.
                self._pending.pop(next(iter(self._pending)))
        self._bump(prefetch_issued=1)

        def run() -> None:
            try:
                rel, own = resolve()
                if lazy:
                    p.t_issue = time.perf_counter()
                p.rel, p.own = rel, own
                p.out = self._gather(shard, rel, own, pooled=False, out=out)
            finally:
                # Always release the waiter; collect() treats a ticket whose
                # gather died (out is None) as a miss and gathers inline.
                p.t_done = time.perf_counter()
                p.done.set()
                if settled is not None:
                    settled.set()

        # One pool slot per prefetched request: concurrent requests spread
        # across the workers. _enqueue returns False if stop() won the race
        # -- then gather inline.
        if not (any_own and self._enqueue(shard, run)):
            run()
        return np.array([seq], np.int32)

    def collect(self, shard, rel, own, cache_hit, seq, *,
                out: np.ndarray | None = None) -> np.ndarray:
        """Redeem a prefetch ticket; inline-gather whatever it missed.

        Bit-exactness does not depend on the prediction: lanes whose issued
        (rel, own) disagree with the ones requested now are re-gathered
        inline (counted as `prefetch_lane_mismatches`), and an unknown or
        never-issued ticket falls back to a full synchronous gather
        (`prefetch_misses`). A ticket whose pooled gather stalls past the
        hedge/deadline budget is abandoned the same way (counted as a
        hedged gather as well) -- collect never blocks past its wait
        budget, which is what bounds the request deadline end to end.

        A redeemed ticket's result is left in `out` where it is given (the
        buffer the ticket was issued with, or a copy into it); a miss
        returns a fresh array, since a writer of `out` may still be live.
        """
        t0 = time.perf_counter()
        shard = int(np.asarray(shard))
        rel = np.asarray(rel)
        own = np.asarray(own, bool)
        seq = int(np.asarray(seq).ravel()[0])
        with self._lock:
            p = self._pending.pop(seq, None)
        if p is not None and not p.done.wait(timeout=self._wait_budget_s()):
            # Stalled ticket: hedge inline rather than block the search.
            self._bump(hedged_gathers=1)
            p = None
        tel = self._tel
        if p is None or p.out is None:
            res = self._gather(shard, rel, own)
            self._bump(prefetch_misses=1)
        else:
            dur = max(p.t_done - p.t_issue, 0.0)
            hidden = max(min(p.t_done, t0) - p.t_issue, 0.0)
            self._bump(
                prefetch_hits=1, gather_s_total=dur,
                gather_s_hidden=min(hidden, dur),
            )
            if tel is not None and tel.tracer is not None:
                # The background gather as the search saw it: the span runs
                # issue -> done, the hidden share is what overlapped other
                # work (overlap_fraction, but now per ticket on the
                # timeline).
                tr = tel.tracer
                tr.complete("prefetch_gather", tr.at_us(p.t_issue),
                            tr.at_us(p.t_done), track=f"hostio-p{shard}",
                            seq=seq, hidden_s=min(hidden, dur))
            reuse = (p.own == own) & (~own | (p.rel == rel))
            if reuse.all():
                res = p.out
            else:
                redo = own & ~reuse
                patch = self._gather(shard, rel, redo)
                res = np.where(reuse[:, None], p.out, patch)
                # Issued-but-unwanted lanes must contribute 0 again.
                res = np.where((own | reuse)[:, None], res, 0).astype(np.int32)
                self._bump(prefetch_lane_mismatches=int(redo.sum()))
            if out is not None and res is not out:
                np.copyto(out, res)
                res = out
        t1 = time.perf_counter()
        self._account(shard, own, np.asarray(cache_hit, bool), t1 - t0)
        self._bump(requests=1, latency_s_total=t1 - t0)
        if tel is not None and tel.tracer is not None:
            tr = tel.tracer
            tr.complete("gather", tr.at_us(t0), tr.at_us(t1),
                        track=f"hostio-p{shard}", mode="collect", seq=seq,
                        rows=int(own.sum()))
        return res

    def _account(self, shard: int, own: np.ndarray, cache_hit: np.ndarray,
                 wall_s: float = 0.0):
        # Misses: every lane a request logically needed from host RAM (each
        # valid id is owned by exactly one shard, so summing over shards
        # counts each global lane once; `rows_gathered` -- counted inside
        # _gather -- additionally includes prefetch re-gathers). Hits: the
        # replicated hit mask would be counted once per partition, so only
        # partition 0's requests report it (on "sharded-base" each rank's
        # service holds its own block as its partition 0, so each rank
        # counts the hits of its own requests).
        own_n = int(own.sum())
        hit_n = int(cache_hit.sum())
        self._bump(
            host_miss_lanes=own_n,
            **({"cache_hit_lanes": hit_n} if shard == 0 else {}),
        )
        tel = self._tel
        if tel is not None and tel.profiler is not None:
            # The per-hop profiler seam: one record per shard per hop.
            # `wall_s` is the search thread's blocking time in the call.
            tel.profiler.on_hop(
                shard, lanes=int(own.size), own_lanes=own_n,
                cache_hit_lanes=hit_n if shard == 0 else 0, wall_s=wall_s,
            )
