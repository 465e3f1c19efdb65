"""Process-wide metrics registry: typed handles, exporters, window deltas.

Serving signals (the host-I/O service's counters, the serve pipeline's
window stats, the mutable index's mutation stats, the executors' set-up
time) each come with their own locking, naming and reset semantics.
`MetricsRegistry` is the single sink they report through, exportable to
anything a router or dashboard can scrape (see
`repro_torch.runtime.telemetry.Telemetry` for the attach points):

  * **Typed handles.** `counter(name)` / `gauge(name)` / `histogram(name)`
    get-or-create a handle; re-registering a name with a different type is
    an error (two subsystems can safely share one handle by name, but can
    never silently alias a counter as a gauge). Counters are cumulative and
    monotone (Prometheus semantics: they survive `NeighborService.
    reset_stats()` windows); gauges are last-write-wins with a `set_max`
    high-watermark helper; histograms bucket observations into fixed
    log-spaced bounds (`LATENCY_BUCKETS_S` spans 10us..10s, 4 per decade)
    so latency percentiles are estimable without storing samples.
  * **Exporters.** `to_json()` is the machine-readable snapshot (schema
    version 1); `to_prom()` is Prometheus text exposition format, the
    uniform health/QoS surface a multi-host router scrapes. Both give the
    same text as the reference package's registry after the same
    operations.
  * **Window deltas.** `snapshot()` captures every metric's current value
    under one lock; `delta(prev)` subtracts a previous snapshot so a
    serving window (one serve-pipeline drain) becomes a *view* over the
    cumulative registry, replacing parallel window bookkeeping.

Thread safety: one registry lock guards registration, every handle bump and
both exporters, so a snapshot is internally consistent even under
concurrent worker-thread traffic. Handle methods are cheap (one lock, one
float add); nothing here runs on a device hot path -- all call sites are
host-side (gathers, drain loops, worker threads).
"""
from __future__ import annotations

import math
import re
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS_S",
    "MetricsRegistry",
    "default_registry",
    "log_buckets",
]

SCHEMA_VERSION = 1

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def log_buckets(lo: float = 1e-5, hi: float = 10.0,
                per_decade: int = 4) -> tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds covering [lo, hi]."""
    if not (lo > 0 and hi > lo and per_decade >= 1):
        raise ValueError(f"bad bucket spec lo={lo} hi={hi}/{per_decade}")
    n = int(round(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10.0 ** (i / per_decade) for i in range(n + 1))


# Default latency buckets: 10us .. 10s, four per decade. Fixed (not
# configurable per call site) so every latency histogram in the process is
# directly comparable and the Prometheus `le` label set is stable.
LATENCY_BUCKETS_S = log_buckets(1e-5, 10.0, 4)


class _Metric:
    """Shared handle plumbing; bumps go through the registry lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str, lock: threading.Lock) -> None:
        self.name = name
        self.help = help
        self._lock = lock


class Counter(_Metric):
    """Cumulative, monotone float counter."""

    kind = "counter"

    def __init__(self, name: str, help: str, lock: threading.Lock) -> None:
        super().__init__(name, help, lock)
        self._v = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {v})")
        with self._lock:
            self._v += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Gauge(_Metric):
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str, help: str, lock: threading.Lock) -> None:
        super().__init__(name, help, lock)
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def set_max(self, v: float) -> None:
        """High-watermark update (used for queue-depth style gauges)."""
        with self._lock:
            self._v = max(self._v, float(v))

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._v += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Histogram(_Metric):
    """Fixed-bound bucketed distribution (cumulative counts + sum)."""

    kind = "histogram"

    def __init__(self, name: str, help: str, lock: threading.Lock,
                 buckets: tuple[float, ...]) -> None:
        super().__init__(name, help, lock)
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError("histogram buckets must be a sorted non-empty "
                             f"sequence, got {buckets}")
        self.buckets = tuple(float(b) for b in buckets)
        # counts[i] observations <= buckets[i]; counts[-1] is the +Inf bucket.
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        with self._lock:
            self._sum += v
            self._count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """Bucket-interpolated percentile estimate (q in [0, 100]).

        0.0 on an empty histogram. The estimate is the upper bound of the
        bucket containing the q-th observation -- coarse by construction
        (the registry stores no samples), good enough for dashboards; exact
        window percentiles stay in `ServeStats.p50_ms/p95_ms`.
        """
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"q must be in [0, 100], got {q}")
        with self._lock:
            if self._count == 0:
                return 0.0
            rank = q / 100.0 * self._count
            seen = 0
            for i, b in enumerate(self.buckets):
                seen += self._counts[i]
                if seen >= rank and seen > 0:
                    return b
            return self.buckets[-1]


class MetricsRegistry:
    """Thread-safe name -> typed-metric registry with exporters.

    See the module docstring; `default_registry()` returns the process-wide
    instance most callers share, but tests (and anything wanting isolated
    windows) construct their own.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    # ------------------------------------------------------------ registration
    def _get_or_create(self, cls, name: str, help: str, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, self._lock, **kw)
                self._metrics[name] = m
                return m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"cannot re-register as {cls.kind}"
            )
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = LATENCY_BUCKETS_S) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._metrics

    def __len__(self) -> int:
        with self._lock:
            return len(self._metrics)

    # --------------------------------------------------------------- snapshots
    def snapshot(self) -> dict:
        """One consistent {name: {"type", ...values}} capture (lock-held)."""
        out: dict = {}
        with self._lock:
            for name, m in self._metrics.items():
                if isinstance(m, Histogram):
                    out[name] = {
                        "type": "histogram",
                        "count": m._count,
                        "sum": m._sum,
                        "buckets": {
                            ("+Inf" if i == len(m.buckets) else repr(m.buckets[i])): c
                            for i, c in enumerate(m._counts)
                        },
                    }
                else:
                    out[name] = {"type": m.kind, "value": m._v}
        return out

    def delta(self, prev: dict) -> dict:
        """Window view: current snapshot minus `prev` (from `snapshot()`).

        Counters and histogram counts/sums subtract (a metric absent from
        `prev` contributes its full current value); gauges report their
        current value -- a gauge is instantaneous, a window has no
        meaningful difference for it.
        """
        cur = self.snapshot()
        out: dict = {}
        for name, c in cur.items():
            p = prev.get(name)
            if c["type"] == "gauge" or p is None:
                out[name] = c
            elif c["type"] == "counter":
                out[name] = {"type": "counter",
                             "value": c["value"] - p["value"]}
            else:
                out[name] = {
                    "type": "histogram",
                    "count": c["count"] - p["count"],
                    "sum": c["sum"] - p["sum"],
                    "buckets": {
                        le: n - p["buckets"].get(le, 0)
                        for le, n in c["buckets"].items()
                    },
                }
        return out

    # --------------------------------------------------------------- exporters
    def to_json(self) -> dict:
        """Schema-versioned JSON snapshot (machine-readable export)."""
        return {
            "schema_version": SCHEMA_VERSION,
            "metrics": {
                name: {**vals, "help": self._metrics[name].help}
                for name, vals in self.snapshot().items()
            },
        }

    def to_prom(self) -> str:
        """Prometheus text exposition format (one scrape body)."""
        lines: list[str] = []
        snap = self.snapshot()
        with self._lock:
            metas = {n: (m.kind, m.help) for n, m in self._metrics.items()}
        for name, vals in snap.items():
            kind, help = metas[name]
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")
            if kind == "histogram":
                cum = 0
                for le, n in vals["buckets"].items():
                    cum += n
                    lines.append(f'{name}_bucket{{le="{le}"}} {cum}')
                lines.append(f"{name}_sum {_fmt(vals['sum'])}")
                lines.append(f"{name}_count {vals['count']}")
            else:
                lines.append(f"{name} {_fmt(vals['value'])}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    """Prometheus value formatting: integral floats print as integers."""
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry (shared by every serving subsystem)."""
    return _DEFAULT


def parse_prom(text: str) -> dict[str, float]:
    """Strict line-format parse of `to_prom()` output -> {sample: value}.

    Exists so CI (and tests) can assert the exporter emits valid exposition
    format without a prometheus client dependency: every non-comment line
    must be `name[{labels}] value` with a well-formed name and a float
    value. Raises ValueError on any malformed line.
    """
    samples: dict[str, float] = {}
    line_re = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^{}]*\})?\s+(\S+)$"
    )
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        m = line_re.match(ln)
        if m is None:
            raise ValueError(f"malformed exposition line: {ln!r}")
        samples[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return samples
