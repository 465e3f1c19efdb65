"""Port vs reference: fault injection and the resilience policy.

The same specs, seed and drive sequence must fire the same events in both
packages' `FaultInjector` (the per-ordinal Bernoulli draws are numpy's), and
the configuration must refuse what the reference refuses.
"""
import os
import sys
import threading

import pytest
import torch

from repro.runtime import resilience as jres
from repro.runtime.telemetry import FlightRecorder as JFlightRecorder
from repro_torch.runtime import resilience as tres
from repro_torch.runtime.telemetry import FlightRecorder

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core

SPECS = (
    ("transient_error", dict(shard=0, start=2, count=3)),
    ("transient_error", dict(shard=1, probability=0.5, count=1 << 30)),
    ("partition_down", dict(shard=2, start=5, count=4, probability=0.7)),
    ("queue_overflow", dict(shard=-1, start=1, count=9, probability=0.3)),
    ("worker_crash", dict(shard=1, start=3, count=2)),
    ("worker_stall", dict(shard=0, start=0, count=6, probability=0.4, stall_s=0.0)),
)


def _drive(pkg, recorder_cls, seed):
    """Every hook over three shards, interleaved; the outcome of each call."""
    rec = recorder_cls(capacity=1000)
    inj = pkg.FaultInjector([pkg.FaultSpec(kind, **kw) for kind, kw in SPECS], seed=seed)
    inj.set_recorder(rec)
    events = []
    for step in range(30):
        for shard in (0, 1, 2):
            try:
                inj.on_gather(shard)
                events.append("ok")
            except pkg.PartitionDownError:
                events.append("down")
            except pkg.TransientGatherError:
                events.append("transient")
            events.append("queued" if inj.on_enqueue(shard) else "rejected")
            try:
                inj.on_worker(shard)
                events.append("ran")
            except pkg.InjectedWorkerCrash:
                events.append("crash")
    return events, inj.injected(), [{k: v for k, v in e.items() if k != "t"} for e in rec.events()]


@pytest.mark.parametrize("seed", [0, 9, 12345])
def test_injector_fires_the_references_events(seed):
    out = _drive(tres, FlightRecorder, seed)
    ref = _drive(jres, JFlightRecorder, seed)
    assert out == ref
    events, fired, recorded = out
    assert fired["transient_error"] == events.count("transient")
    assert fired["partition_down"] == events.count("down")
    assert fired["queue_overflow"] == events.count("rejected")
    assert fired["worker_crash"] == events.count("crash") == 2
    assert len(recorded) == sum(fired.values())
    assert out == _drive(tres, FlightRecorder, seed)          # replayable exactly


def test_injector_window_is_exact():
    inj = tres.FaultInjector([tres.FaultSpec("transient_error", shard=0, start=2, count=3)])
    pattern = []
    for _ in range(8):
        try:
            inj.on_gather(0)
            pattern.append(0)
        except tres.TransientGatherError:
            pattern.append(1)
    assert pattern == [0, 0, 1, 1, 1, 0, 0, 0]
    assert inj.injected() == {k: (3 if k == "transient_error" else 0) for k in tres.FAULT_KINDS}


def test_fault_spec_and_config_validation_match_the_reference():
    for pkg in (tres, jres):
        for kw in (dict(kind="meteor_strike"), dict(kind="worker_stall", count=-1),
                   dict(kind="worker_stall", start=-1),
                   dict(kind="worker_stall", probability=1.5),
                   dict(kind="worker_stall", stall_s=-0.1)):
            with pytest.raises(ValueError):
                pkg.FaultSpec(**kw)
        for kw in (dict(deadline_s=-1.0), dict(backoff_base_s=-1.0), dict(backoff_max_s=-1.0),
                   dict(hedge_s=-1.0), dict(max_retries=-1), dict(unhealthy_after=0),
                   dict(degraded_mode="panic")):
            with pytest.raises(ValueError):
                pkg.ResilienceConfig(**kw)
    assert tres.FAULT_KINDS == jres.FAULT_KINDS and tres.FOREVER == jres.FOREVER
    assert tres.DEGRADED_MODES == jres.DEGRADED_MODES
    assert tres.ResilienceConfig() == tres.ResilienceConfig()
    assert hash(tres.ResilienceConfig(hedge_s=0.1)) == hash(tres.ResilienceConfig(hedge_s=0.1))
    with pytest.raises(AttributeError):
        tres.ResilienceConfig().max_retries = 3          # frozen: it can ride a cache key


def test_backoff_and_wait_match_the_reference():
    kw = dict(backoff_base_s=0.01, backoff_max_s=0.03)
    out, ref = tres.ResilienceConfig(**kw), jres.ResilienceConfig(**kw)
    for attempt, remaining in ((0, -1.0), (1, -1.0), (5, -1.0), (5, 0.004), (0, 0.0), (3, 1.0)):
        assert tres.backoff_delay(out, attempt, remaining) == jres.backoff_delay(ref, attempt, remaining)
    assert tres.backoff_delay(out, 1, -1.0) == pytest.approx(0.02)
    for kw in (dict(), dict(deadline_s=0.5), dict(hedge_s=0.2, deadline_s=0.5)):
        assert tres.ResilienceConfig(**kw).wait_s() == jres.ResilienceConfig(**kw).wait_s()


def test_injector_ordinals_are_exact_under_concurrent_hooks():
    """More threads than cores on one (hook, shard) counter, a short switch
    interval: every ordinal is handed out once, so a window of w events
    fires exactly w times."""
    inj = tres.FaultInjector([tres.FaultSpec("queue_overflow", shard=0, start=100, count=250)])
    n_threads, n_calls = 2 * (os.cpu_count() or 4), 200
    rejected = [0] * n_threads

    def work(i):
        for _ in range(n_calls):
            rejected[i] += not inj.on_enqueue(0)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert sum(rejected) == inj.injected()["queue_overflow"] == 250
