"""Unified observability for the serving runtime.

One `Telemetry` bundle threads through the serving subsystems via their
`set_telemetry()` / `telemetry=` hooks (in this package: `SearchExecutor`
and `ShardedSearchExecutor`; the serve pipeline, the host-I/O neighbour
service and the mutable index use the same hooks) and carries up to four
components. It is plain host Python; its device-side annotations are
`torch.profiler` ranges:

  registry   always present -- the process-wide `MetricsRegistry`
             (counters/gauges/histograms, `to_json()` / `to_prom()`
             exporters, window deltas). Metric families and names:

             bang_serve_queries_total / bang_serve_shed_total /
             bang_serve_expired_total / bang_serve_batches_total /
             bang_serve_result_cache_hits_total /
             bang_serve_compile_seconds_total     (counters; the last is
                                                   an executor's pipeline
                                                   set-up on a cache miss)
             bang_serve_latency_seconds           (histogram)
             bang_serve_recall / bang_serve_qps   (gauges, last window)

             bang_hostio_<counter>_total for every `NeighborService`
             counter (requests, rows_gathered, host_miss_lanes,
             cache_hit_lanes, prefetch_issued, prefetch_hits,
             prefetch_misses, prefetch_lane_mismatches, worker_errors,
             worker_deaths, retries, gather_failures, degraded_lanes,
             hedged_gathers, deadline_hits, failover_gathers, failovers,
             recoveries, enqueue_rejections), plus
             bang_hostio_max_queue_depth (gauge, high-watermark),
             bang_hostio_gather_seconds_total,
             bang_hostio_gather_hidden_seconds_total,
             bang_hostio_request_latency_seconds_total (time counters)

             bang_mutation_inserts_total / bang_mutation_deletes_total /
             bang_mutation_consolidations_total   (counters)
             bang_mutation_epoch / bang_mutation_generation (gauges)

  tracer     optional -- per-request spans and hostio/mutation/resilience
             timeline events, exported as Chrome `trace_event` JSON
             (span vocabulary in `tracing.py`).
  recorder   optional -- `FlightRecorder` ring buffer; the resilience
             layer triggers a structured postmortem dump on failover /
             partition-down / degrade / deadline-expiry / shed.
  profiler   optional -- `HopProfiler` per-hop host-seam profiling +
             `torch.profiler.record_function` annotations (`profile.py`).

Design contract (test-enforced): telemetry NEVER enters an executor's
pipeline-cache key and never changes what runs on the device -- with the
bundle detached the hot path pays exactly one `is None` test per seam, and
with it attached all instrumentation runs host-side. Registry counters are
cumulative (they ignore `NeighborService.reset_stats()` windows);
per-window views come from `registry.delta(snapshot)` and surface as
`ServeStats.telemetry`.
"""
from __future__ import annotations

from .flightrecorder import FlightRecorder
from .profile import HopProfiler
from .registry import (
    LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    log_buckets,
    parse_prom,
)
from .tracing import Span, Tracer, validate_chrome_trace

__all__ = [
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "HopProfiler",
    "LATENCY_BUCKETS_S",
    "MetricsRegistry",
    "Span",
    "Telemetry",
    "Tracer",
    "default_registry",
    "log_buckets",
    "parse_prom",
    "validate_chrome_trace",
]

# NeighborService counter key -> (metric name, kind). Everything not listed
# is a plain counter named bang_hostio_<key>_total.
_HOSTIO_SPECIAL = {
    "max_queue_depth": ("bang_hostio_max_queue_depth", "gauge_max"),
    "gather_s_total": ("bang_hostio_gather_seconds_total", "counter"),
    "gather_s_hidden": ("bang_hostio_gather_hidden_seconds_total", "counter"),
    "latency_s_total": (
        "bang_hostio_request_latency_seconds_total", "counter"),
}


class Telemetry:
    """The bundle every subsystem accepts; see the module docstring."""

    def __init__(self, registry: MetricsRegistry | None = None, *,
                 tracer: Tracer | None = None,
                 recorder: FlightRecorder | None = None,
                 profiler: HopProfiler | None = None) -> None:
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer
        self.recorder = recorder
        self.profiler = profiler
        # Hostio handles are resolved lazily and memoized: bump_hostio runs
        # on every gather, and a dict hit is much cheaper than re-validating
        # the metric name against the registry each time.
        self._hostio_handles: dict[str, tuple] = {}

    @classmethod
    def create(cls, *, trace: bool = False, flight_record: bool = False,
               profile: bool = False, registry: MetricsRegistry | None = None,
               shared_registry: bool = False,
               trace_max_events: int = 200_000,
               ring_capacity: int = 512,
               max_dumps: int = 64) -> "Telemetry":
        """Assemble a bundle; components are opt-in, the registry is not.

        `shared_registry=True` uses the process-wide `default_registry()`
        (what a long-lived server wants); the default is a private registry
        so tests and benches get isolated counters. `max_dumps` bounds the
        flight recorder's retained postmortems (a sustained degraded phase
        triggers one per affected gather; raise it when the dump *after*
        the storm matters too).
        """
        if registry is None:
            registry = default_registry() if shared_registry \
                else MetricsRegistry()
        rec = FlightRecorder(ring_capacity, registry=registry,
                             max_dumps=max_dumps) \
            if flight_record else None
        return cls(
            registry,
            tracer=Tracer(trace_max_events) if trace else None,
            recorder=rec,
            profiler=HopProfiler() if profile else None,
        )

    # ------------------------------------------------------------ hostio feed
    def bump_hostio(self, counters: dict) -> None:
        """Mirror one `NeighborService._bump` update into the registry.

        Called with the service's own lock held; safe because the registry
        lock is always innermost (nothing under the registry lock ever
        takes a service lock).
        """
        for key, v in counters.items():
            h = self._hostio_handles.get(key)
            if h is None:
                name, kind = _HOSTIO_SPECIAL.get(
                    key, (f"bang_hostio_{key}_total", "counter"))
                if kind == "counter":
                    h = (self.registry.counter(name).inc, "inc")
                else:
                    h = (self.registry.gauge(name).set_max, "set_max")
                self._hostio_handles[key] = h
            h[0](v)

    # ------------------------------------------------------- tracer shortcuts
    def span(self, name: str, track: str = "serve", **args):
        """Open a span if tracing is on; returns None otherwise."""
        t = self.tracer
        return None if t is None else t.span(name, track, **args)

    def instant(self, name: str, track: str = "events", **args) -> None:
        t = self.tracer
        if t is not None:
            t.instant(name, track, **args)

    def record(self, kind: str, **fields) -> None:
        r = self.recorder
        if r is not None:
            r.record(kind, **fields)

    def event(self, name: str, track: str = "events", **fields) -> None:
        """Instant + flight-recorder entry in one call (resilience seams)."""
        self.instant(name, track, **fields)
        self.record(name, **fields)
