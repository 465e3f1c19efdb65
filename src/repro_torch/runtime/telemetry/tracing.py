"""Per-request span tracing with Chrome `trace_event` JSON output.

BANG's serving story is phase overlap -- device traversal running
concurrently with the host neighbour service. The `Tracer` records *when
things actually happened* so one serve-pipeline drain renders as a
timeline in `chrome://tracing` / Perfetto: request lifecycles on one track,
hostio issue/collect tickets per partition on others, consolidation
generations and failover/degrade instants as markers. Device kernels are
not on it; `torch.profiler` traces those (see `profile.py`).

Span vocabulary (the names tests and docs pin):

  request lifecycle (track "serve", exactly one event per submitted row):
    ``request``            submit -> results ready; args: rid, outcome
                           ("served" | "cache_hit"), queue_s when served
    ``request_shed``       instant: admission rejected (bounded queue)
    ``request_expired``    instant: deadline passed before dispatch
  batch machinery (track "serve"):
    ``admission``          one submit() call; args: submitted/accepted/shed
    ``dispatch``           host-side batch prep + async launch; args:
                           size, bucket
    ``device``             async launch -> results on host; args: size,
                           bucket, compile_s
    ``compile``            executor cache miss: the pipeline's set-up
                           (args: bucket, k, kernel_mode)
  hostio (track "hostio-p<shard>"):
    ``gather``             one blocking callback gather (mode
                           "sync" | "collect"); args: rows, seq
    ``prefetch_gather``    background ticket gather, issue -> done; args:
                           seq, hidden_s (the overlapped share)
  mutation (track "mutation"):
    ``consolidate``        background consolidation; args: generation
  resilience instants (track "events"):
    ``failover``/``partition_down``/``recover``/``degraded``/
    ``deadline_hit``

Emission is append-under-lock of small dicts -- no I/O, no formatting --
and every call site is guarded by `tel is None or tel.tracer is None`, so
the disabled path costs one attribute test (zero hot-path cost when off).
Timestamps are `time.perf_counter()` microseconds relative to the
tracer's birth, the monotonic clock the executors already use.

`to_chrome()` emits the Chrome trace-event JSON object format
(`{"traceEvents": [...]}`): complete events `ph:"X"` with `ts`/`dur` in
microseconds, instants `ph:"i"`, plus `ph:"M"` thread_name metadata so
tracks are labelled. `validate_chrome_trace()` is the schema check CI
runs against a generated file.
"""
from __future__ import annotations

import json
import threading
import time

__all__ = ["Span", "Tracer", "validate_chrome_trace"]


class Span:
    """An open interval; `end()` (or the context manager) emits it once."""

    __slots__ = ("_tracer", "name", "track", "args", "_t0", "_done")

    def __init__(self, tracer: "Tracer", name: str, track: str,
                 args: dict) -> None:
        self._tracer = tracer
        self.name = name
        self.track = track
        self.args = args
        self._t0 = tracer._now_us()
        self._done = False

    def end(self, **extra_args) -> None:
        if self._done:
            return
        self._done = True
        if extra_args:
            self.args.update(extra_args)
        self._tracer._emit_complete(self.name, self.track, self._t0,
                                    self._tracer._now_us(), self.args)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class Tracer:
    """Bounded in-memory trace-event collector (see module docstring).

    `max_events` bounds memory on long drains; when the cap is hit the
    tracer keeps counting (`dropped_events`) but stops storing, and the
    drop count is stamped into the trace metadata so a truncated timeline
    is never mistaken for a complete one.
    """

    def __init__(self, max_events: int = 200_000) -> None:
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._tids: dict[str, int] = {}
        self._birth = time.perf_counter()
        self._max = max_events
        self.dropped_events = 0
        self.pid = 1

    # ------------------------------------------------------------------- time
    def _now_us(self) -> float:
        return (time.perf_counter() - self._birth) * 1e6

    def now_us(self) -> float:
        """Public clock for callers that time an interval themselves."""
        return self._now_us()

    def at_us(self, t_perf: float) -> float:
        """Convert an absolute `time.perf_counter()` stamp to trace us.

        Lets code that already timestamps with perf_counter (the hostio
        service, the serve pipeline) place events on this tracer's
        timeline without re-clocking.
        """
        return (t_perf - self._birth) * 1e6

    # ------------------------------------------------------------------ tracks
    def _tid_locked(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = len(self._tids)
            self._tids[track] = tid
            # Metadata events are exempt from the cap: a handful of track
            # labels must survive even on a saturated trace.
            self._events.append({
                "ph": "M", "name": "thread_name", "pid": self.pid,
                "tid": tid, "args": {"name": track},
            })
        return tid

    def _append_locked(self, ev: dict) -> None:
        if len(self._events) >= self._max:
            self.dropped_events += 1
            return
        self._events.append(ev)

    # ---------------------------------------------------------------- emitters
    def span(self, name: str, track: str = "serve", **args) -> Span:
        """Open a complete-event span; emitted on `.end()`/context exit."""
        return Span(self, name, track, dict(args))

    def _emit_complete(self, name: str, track: str, t0_us: float,
                       t1_us: float, args: dict) -> None:
        with self._lock:
            tid = self._tid_locked(track)
            self._append_locked({
                "ph": "X", "name": name, "pid": self.pid, "tid": tid,
                "ts": t0_us, "dur": max(t1_us - t0_us, 0.0),
                "args": args,
            })

    def complete(self, name: str, t0_us: float, t1_us: float,
                 track: str = "serve", **args) -> None:
        """Emit a complete event from caller-measured timestamps."""
        self._emit_complete(name, track, t0_us, t1_us, dict(args))

    def instant(self, name: str, track: str = "events", **args) -> None:
        with self._lock:
            tid = self._tid_locked(track)
            self._append_locked({
                "ph": "i", "name": name, "pid": self.pid, "tid": tid,
                "ts": self._now_us(), "s": "t", "args": args,
            })

    # ----------------------------------------------------------------- export
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object format."""
        with self._lock:
            return {
                "traceEvents": list(self._events),
                "displayTimeUnit": "ms",
                "otherData": {
                    "producer": "repro_torch.runtime.telemetry",
                    "dropped_events": self.dropped_events,
                },
            }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


def validate_chrome_trace(obj: dict) -> list[dict]:
    """Assert `obj` is schema-valid Chrome trace JSON; return its events.

    The checks mirror what the trace viewer actually requires of the
    object format: a `traceEvents` list whose entries carry a known phase,
    a name, pid/tid, and (for non-metadata phases) a numeric `ts`;
    complete events additionally need a non-negative numeric `dur`.
    Raises ValueError on the first violation -- this is the CI gate for
    `--trace-out` files, kept dependency-free on purpose.
    """
    if not isinstance(obj, dict) or not isinstance(
            obj.get("traceEvents"), list):
        raise ValueError("trace must be an object with a traceEvents list")
    for i, ev in enumerate(obj["traceEvents"]):
        ctx = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            raise ValueError(f"{ctx}: not an object")
        ph = ev.get("ph")
        if ph not in ("X", "i", "M", "B", "E", "b", "e", "C"):
            raise ValueError(f"{ctx}: unknown phase {ph!r}")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(f"{ctx}: missing name")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                raise ValueError(f"{ctx}: missing integer {key}")
        if ph != "M":
            if not isinstance(ev.get("ts"), (int, float)):
                raise ValueError(f"{ctx}: missing numeric ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"{ctx}: complete event needs dur >= 0")
    return obj["traceEvents"]
