"""Fault injection and fault handling for the host-assisted serve tier.

BANG's search loop leans on a contended host memory tier for the graph
adjacency (the paper's CPU half). This package makes that dependency
survivable and testable; it is plain host Python, with no framework code:

    faults.py   deterministic, seedable `FaultInjector` + the exception
                vocabulary (`TransientGatherError`, `PartitionDownError`,
                `InjectedWorkerCrash`) shared with the host-I/O neighbour
                service's health tracker;
    policy.py   `ResilienceConfig` -- deadlines, retry/backoff, hedged
                re-issue, partition health thresholds, failover and
                degraded-mode selection.
"""
from .faults import (
    FAULT_KINDS,
    FOREVER,
    FaultInjector,
    FaultSpec,
    InjectedWorkerCrash,
    PartitionDownError,
    TransientGatherError,
)
from .policy import DEGRADED_MODES, ResilienceConfig, backoff_delay

__all__ = [
    "DEGRADED_MODES",
    "FAULT_KINDS",
    "FOREVER",
    "FaultInjector",
    "FaultSpec",
    "InjectedWorkerCrash",
    "PartitionDownError",
    "ResilienceConfig",
    "TransientGatherError",
    "backoff_delay",
]
