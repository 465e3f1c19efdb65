"""Flight recorder: bounded event ring + structured postmortem dumps.

A fault bench tells you *that* a phase degraded; the flight recorder tells
you *why this request*: it keeps the last `capacity` telemetry events
(request outcomes, gather tickets, retries, health transitions, injected
faults) in a ring, and whenever the resilience layer does something a
human will be asked to explain -- shed, degrade, fail over, expire a
deadline -- it snapshots the ring plus the metrics registry into one
structured JSON postmortem. A `FaultInjector` with a recorder attached
(`set_recorder`) leaves a `fault_injected` entry for every event it fires,
so a dump shows which injected events preceded the failure it explains.

Recording is `deque.append` of a small dict under a lock -- safe from any
worker thread, cheap enough for per-gather call sites, and bounded by
construction. Postmortems are capped (`max_dumps`) so a flapping fault
can't grow memory without bound; `dropped_dumps` counts the overflow.

Postmortem schema (`schema_version` 1)::

    {
      "schema_version": 1,
      "seq":            monotonically increasing dump ordinal,
      "reason":         "failover" | "partition_down" | "degraded" |
                        "deadline_expired" | "request_shed" | ... ,
      "t_wall":         time.time() at dump,
      "context":        caller-supplied kwargs (shard, rid, phase, ...),
      "events":         ring contents, oldest first, each
                        {"t": perf_counter, "kind": str, ...fields},
      "metrics":        MetricsRegistry.snapshot() or None,
    }
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque

__all__ = ["FlightRecorder"]

SCHEMA_VERSION = 1


class FlightRecorder:
    """Bounded ring of events + triggered postmortem snapshots."""

    def __init__(self, capacity: int = 512, *, registry=None,
                 max_dumps: int = 64) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=capacity)
        self._registry = registry
        self._dumps: list[dict] = []
        self._max_dumps = max_dumps
        self._seq = 0
        self.dropped_dumps = 0

    def record(self, kind: str, **fields) -> None:
        """Append one event to the ring (never triggers a dump)."""
        ev = {"t": time.perf_counter(), "kind": kind}
        ev.update(fields)
        with self._lock:
            self._ring.append(ev)

    def trigger(self, reason: str, **context) -> dict:
        """Snapshot the ring into a postmortem and retain it.

        Returns the dump (also kept in `self.dumps` up to `max_dumps`).
        The triggering moment itself is recorded into the ring first, so
        a later dump's ring still shows this one happened.
        """
        # Registry snapshot outside our lock: the registry has its own.
        metrics = None if self._registry is None else self._registry.snapshot()
        with self._lock:
            self._ring.append(
                {"t": time.perf_counter(), "kind": f"trigger:{reason}",
                 **context})
            dump = {
                "schema_version": SCHEMA_VERSION,
                "seq": self._seq,
                "reason": reason,
                "t_wall": time.time(),
                "context": dict(context),
                "events": list(self._ring),
                "metrics": metrics,
            }
            self._seq += 1
            if len(self._dumps) < self._max_dumps:
                self._dumps.append(dump)
            else:
                self.dropped_dumps += 1
        return dump

    @property
    def dumps(self) -> list[dict]:
        with self._lock:
            return list(self._dumps)

    def dumps_for(self, reason: str) -> list[dict]:
        return [d for d in self.dumps if d["reason"] == reason]

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dumps.clear()
            self.dropped_dumps = 0

    def save(self, path: str) -> None:
        """Write every retained postmortem as one JSON document."""
        with open(path, "w") as f:
            json.dump({"schema_version": SCHEMA_VERSION,
                       "dumps": self.dumps,
                       "dropped_dumps": self.dropped_dumps}, f)
