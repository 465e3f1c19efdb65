"""Deterministic fault injection for the host-I/O serving stack.

Production serving means surviving the host side misbehaving: a stalled
gather thread, a dead host partition, a transient copy error, a request
queue that overflows under burst load. None of those are reproducible by
waiting for them to happen, so this module makes every failure mode a
*scripted, seedable event*: a `FaultInjector` carries a list of
`FaultSpec`s, each describing a fault kind, a target partition, and a
window of hook-event ordinals during which it fires. The host-I/O
neighbour service (`NeighborService`) calls the three hooks at its natural
seams:

    on_worker(shard)    top of each worker-pool work item -- may sleep
                        (`worker_stall`) or raise `InjectedWorkerCrash`
                        (`worker_crash`, which kills that worker thread
                        after it requeues its item);
    on_gather(shard)    every *primary* host-memory read -- may raise
                        `TransientGatherError` (`transient_error`, the
                        retry/backoff path) or `PartitionDownError`
                        (`partition_down`, the degraded/failover path);
    on_enqueue(shard)   every pool-queue put -- returns False to model a
                        full queue (`queue_overflow`; the caller falls
                        back to an inline gather, never dropping work).

Determinism: each hook keeps one event ordinal per (hook, shard) pair,
advanced under a lock, and a spec fires iff the ordinal falls inside
`[start, start + count)` and the seeded per-ordinal Bernoulli draw (a
`probability < 1` spec hashes (seed, kind, shard, ordinal) into its own
Generator) accepts. Same specs + same seed + same single-stream drive ->
the same injected events, so tests can assert exact counter values; the
draws are numpy's, so the same specs and seed fire the same events as the
reference package's injector.

The error types double as the service's own vocabulary: the health
tracker raises `PartitionDownError` for a partition that was *marked*
down without any injector, so the retry/degrade machinery cannot tell
scripted faults from real ones -- by construction.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

__all__ = [
    "FAULT_KINDS",
    "FOREVER",
    "FaultInjector",
    "FaultSpec",
    "InjectedWorkerCrash",
    "PartitionDownError",
    "TransientGatherError",
]

FAULT_KINDS = (
    "worker_crash",     # kill a pool worker thread (item is requeued first)
    "worker_stall",     # sleep stall_s inside a pool worker before its item
    "partition_down",   # primary reads of the target partition raise
    "queue_overflow",   # pool-queue puts are rejected (inline fallback)
    "transient_error",  # one gather attempt raises; a retry can succeed
)

# "Until cleared" window length: large enough to never run out, small enough
# that start + count can't overflow any plausible integer arithmetic.
FOREVER = 1 << 30


class TransientGatherError(RuntimeError):
    """A retryable host gather failure (the retry/backoff path)."""


class PartitionDownError(RuntimeError):
    """A host graph partition is unreachable (degraded/failover path)."""


class InjectedWorkerCrash(RuntimeError):
    """Kills a worker thread; never raised outside fault injection."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scripted fault: kind + target partition + event window.

    shard        target partition (-1 = every partition)
    start/count  the fault fires on hook-event ordinals in
                 [start, start + count) of its (hook, shard) counter
    probability  seeded per-ordinal Bernoulli inside the window (1.0 =
                 every event in the window fires)
    stall_s      sleep length for worker_stall
    """

    kind: str
    shard: int = -1
    start: int = 0
    count: int = 1
    probability: float = 1.0
    stall_s: float = 0.02

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}, expected one of "
                f"{FAULT_KINDS}"
            )
        if self.count < 0 or self.start < 0:
            raise ValueError("start/count must be >= 0")
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError(
                f"probability must be in [0, 1], got {self.probability}"
            )
        if self.stall_s < 0:
            raise ValueError(f"stall_s must be >= 0, got {self.stall_s}")


# Hook name per fault kind: which event counter a spec's window indexes.
_HOOK_OF = {
    "worker_crash": "worker",
    "worker_stall": "worker",
    "partition_down": "gather",
    "transient_error": "gather",
    "queue_overflow": "enqueue",
}


class FaultInjector:
    """Scripted, seedable fault source for one `NeighborService`.

    Thread-safe: ordinal bookkeeping runs under a private lock; sleeps and
    raises happen outside it. `injected()` reports how many events each
    kind actually fired, to set beside the recall/latency impact they
    caused.
    """

    def __init__(self, specs, seed: int = 0, *, recorder=None) -> None:
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._ordinals: dict[tuple[str, int], int] = {}
        self._fired: dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self._recorder = recorder

    def set_recorder(self, recorder) -> None:
        """Attach a telemetry `FlightRecorder`: every fired spec leaves a
        `fault_injected` ring entry, so a postmortem dump shows exactly
        which injected events preceded the failure it explains."""
        self._recorder = recorder

    # ----------------------------------------------------------- internals
    def _decide(self, spec: FaultSpec, ordinal: int) -> bool:
        if not spec.start <= ordinal < spec.start + spec.count:
            return False
        if spec.probability >= 1.0:
            return True
        # Per-ordinal seeded draw: deterministic regardless of how many
        # other events interleave (the draw depends only on the ordinal).
        rng = np.random.default_rng(
            (self.seed, FAULT_KINDS.index(spec.kind),
             spec.shard & 0xFFFF, ordinal)
        )
        return bool(rng.random() < spec.probability)

    def _fire(self, hook: str, shard: int) -> list[FaultSpec]:
        """Advance the (hook, shard) ordinal; return the specs that fire."""
        with self._lock:
            key = (hook, shard)
            ordinal = self._ordinals.get(key, 0)
            self._ordinals[key] = ordinal + 1
            hits = [
                s for s in self.specs
                if _HOOK_OF[s.kind] == hook
                and s.shard in (-1, shard)
                and self._decide(s, ordinal)
            ]
            for s in hits:
                self._fired[s.kind] += 1
        rec = self._recorder
        if rec is not None:
            # Outside the ordinal lock: the recorder has its own.
            for s in hits:
                rec.record("fault_injected", fault=s.kind, shard=shard,
                           hook=hook, ordinal=ordinal)
        return hits

    # --------------------------------------------------------------- hooks
    def on_worker(self, shard: int) -> None:
        """Worker-pool hook: stall sleeps here; crash raises."""
        crash = False
        stall = 0.0
        for s in self._fire("worker", shard):
            if s.kind == "worker_stall":
                stall = max(stall, s.stall_s)
            elif s.kind == "worker_crash":
                crash = True
        if stall > 0.0:
            time.sleep(stall)
        if crash:
            raise InjectedWorkerCrash(f"injected crash (partition {shard})")

    def on_gather(self, shard: int) -> None:
        """Primary host-read hook: may raise a gather fault."""
        down = False
        transient = False
        for s in self._fire("gather", shard):
            if s.kind == "partition_down":
                down = True
            elif s.kind == "transient_error":
                transient = True
        # Partition-down wins: it is the stronger (non-retryable) fault.
        if down:
            raise PartitionDownError(f"injected: partition {shard} down")
        if transient:
            raise TransientGatherError(
                f"injected transient gather error (partition {shard})"
            )

    def on_enqueue(self, shard: int) -> bool:
        """Queue hook: False models a full request queue (caller inlines)."""
        return not any(
            s.kind == "queue_overflow" for s in self._fire("enqueue", shard)
        )

    # ---------------------------------------------------------- inspection
    def injected(self) -> dict:
        """Events fired so far, per fault kind (JSON-serialisable)."""
        with self._lock:
            return dict(self._fired)
