"""Resilience policy: deadlines, retry/backoff, hedging, degraded mode.

`ResilienceConfig` is the single knob-set for how the host-I/O neighbour
service (and the serve pipeline above it) reacts when the host tier
misbehaves. It is a frozen dataclass on purpose: it is hashable, so it can
ride a host-I/O configuration into an executor's pipeline-cache key, and
because every fault-handling decision happens host-side (in the neighbour
gathers and worker threads), the device work is identical for any config
value -- the key entry is just bookkeeping, never a rebuild trigger.

The failure-handling contract it parameterises:

    transient gather error   retry up to `max_retries` with exponential
                             backoff (`backoff_base_s` doubling, capped
                             at `backoff_max_s` and the remaining
                             deadline);
    stalled worker / pool    hedged re-issue: a pooled gather or a
                             prefetch `collect` waits at most
                             `hedge_s` (or the request deadline) before
                             re-running the gather inline on the caller
                             thread;
    partition down           after `unhealthy_after` consecutive
                             failures the partition is marked down;
                             `auto_failover` pins a replica of its rows
                             onto the surviving pool (bit-exact reads),
                             otherwise lanes degrade per
                             `degraded_mode`:
                               "medoid"  substitute the medoid's
                                         adjacency row (search restarts
                                         toward the graph centre);
                               "mask"    lanes yield no rows at all —
                                         they surface as -1 entries and
                                         ride the same validity mask as
                                         tombstone padding.
"""
from __future__ import annotations

import dataclasses

__all__ = ["DEGRADED_MODES", "ResilienceConfig", "backoff_delay"]

DEGRADED_MODES = ("medoid", "mask")


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Fault-handling knobs for the host-I/O service tier.

    deadline_s       per-request gather deadline; 0 disables (legacy
                     blocking behaviour, with a 60 s last-resort cap)
    max_retries      retries after the first failed gather attempt
    backoff_base_s   first retry delay; doubles per attempt
    backoff_max_s    upper bound on any single backoff sleep
    hedge_s          wait before hedging a pooled gather / prefetch
                     collect inline; 0 falls back to deadline_s
    unhealthy_after  consecutive primary-read failures before a
                     partition is marked down
    auto_failover    pin a replica of a newly-down partition's rows so
                     reads stay bit-exact (vs degrading lanes)
    degraded_mode    "medoid" or "mask" — what unfetchable lanes serve
    """

    deadline_s: float = 0.0
    max_retries: int = 2
    backoff_base_s: float = 0.001
    backoff_max_s: float = 0.05
    hedge_s: float = 0.0
    unhealthy_after: int = 3
    auto_failover: bool = True
    degraded_mode: str = "medoid"

    def __post_init__(self) -> None:
        for field in ("deadline_s", "backoff_base_s", "backoff_max_s",
                      "hedge_s"):
            v = getattr(self, field)
            if v < 0:
                raise ValueError(f"{field} must be >= 0, got {v}")
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}"
            )
        if self.unhealthy_after < 1:
            raise ValueError(
                f"unhealthy_after must be >= 1, got {self.unhealthy_after}"
            )
        if self.degraded_mode not in DEGRADED_MODES:
            raise ValueError(
                f"degraded_mode must be one of {DEGRADED_MODES}, "
                f"got {self.degraded_mode!r}"
            )

    def wait_s(self) -> float:
        """Hedge/collect wait: hedge_s, else deadline_s, else legacy 60 s."""
        if self.hedge_s > 0:
            return self.hedge_s
        if self.deadline_s > 0:
            return self.deadline_s
        return 60.0


def backoff_delay(cfg: ResilienceConfig, attempt: int,
                  remaining_s: float) -> float:
    """Exponential backoff for retry `attempt` (0-based), deadline-capped."""
    delay = min(cfg.backoff_base_s * (2.0 ** attempt), cfg.backoff_max_s)
    if remaining_s >= 0:
        delay = min(delay, remaining_s)
    return max(delay, 0.0)
