"""The port's host-I/O subsystem (`repro_torch.runtime.hostio`) vs the
reference's, on the CPU.

Held here:

  * host-I/O base is bit-exact (ids and distances) against the port's
    plain base in all three kernel modes and across the config sweep, and
    its ids are bit-exact against the reference executor with the same
    `HostIOConfig`. Its distances are the plain base's bits, whose re-rank
    sums in another order than the reference's (ROADMAP C4): on this
    test's queries they differ from the reference's by up to 1.5e-5, above
    the parity bound, so they are held to the plain base here and not to
    the reference;
  * the deterministic service counters of one search equal the
    reference's: `requests`, `prefetch_issued`, `prefetch_hits`,
    `prefetch_misses`, `prefetch_lane_mismatches`, `host_miss_lanes`,
    `cache_hit_lanes` and `rows_gathered`. `rows_gathered` depends on
    timing until the service stops: the last hop's ticket is never
    collected, and its gather may still be running when the search
    returns, so both services are stopped (which lets queued work finish)
    before it is read;
  * `NeighborService.request`/`issue`/`collect` and `HotAdjacencyCache`
    against the reference's on the same numpy inputs, and the
    exactly-once-per-miss property (integer draws only, ROADMAP C3);
  * the fault matrix under one `FaultInjector` seed in both packages.

The sharded-base paths (one-rank gloo group) are in
`tests/test_torch_sharded.py`, which owns the process group. Every test that
starts a service stops it in a `finally` block or a fixture finaliser, and
every wait has a timeout.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - fallback shim keeps suite collectable
    from _hypothesis_compat import given, settings, strategies as st

from repro.core import SearchConfig as JSearchConfig
from repro.data import uniform_queries
from repro.runtime import hostio as jhostio
from repro.runtime import resilience as jres
from repro_torch.convert import index_from_reference
from repro_torch.core import SearchConfig
from repro_torch.core.worklist import INVALID_ID
from repro_torch.runtime import SearchExecutor, hostio, resilience as tres
from repro_torch.runtime.hostio import HostIOConfig, HotAdjacencyCache, NeighborService

K = 5
MODES = ("reference", "staged", "fused")
FULL = dict(workers=2, hot_cache_rows=64, prefetch=True)
COUNTERS = ("requests", "prefetch_issued", "prefetch_hits", "prefetch_misses",
            "prefetch_lane_mismatches", "host_miss_lanes", "cache_hit_lanes", "rows_gathered")


@pytest.fixture(scope="module")
def port_index(small_ann_index):
    data, idx = small_ann_index
    arrays = {"codebooks": np.asarray(idx.codec.codebooks), "codes": np.asarray(idx.codes),
              "adjacency": idx.graph.adjacency, "medoid": idx.graph.medoid, "data": idx.data_np}
    tidx = index_from_reference(arrays, device="cpu")
    yield data, idx, tidx
    for ex in tidx._executors.values():
        if ex.hostio_runtime is not None:
            ex.hostio_runtime.stop()


def _search(tidx, q, cfg, mode, hostio_cfg=None):
    ids, d = tidx.search(q, K, cfg=cfg, variant="base", kernel_mode=mode, hostio=hostio_cfg)
    return ids.numpy(), d.numpy()


# ------------------------------------------------------------------ parity
@pytest.mark.parametrize("mode", MODES)
def test_hostio_base_bit_exact_across_kernel_modes(port_index, mode):
    data, _, tidx = port_index
    cfg = SearchConfig(t=32, bloom_z=8192)
    q = uniform_queries(data, 16, seed=91)
    ids_p, d_p = _search(tidx, q, cfg, mode)
    ids_h, d_h = _search(tidx, q, cfg, mode, HostIOConfig(**FULL))
    np.testing.assert_array_equal(ids_h, ids_p)
    np.testing.assert_array_equal(d_h, d_p)


@pytest.mark.parametrize(
    "workers,cache_rows,prefetch",
    [(1, 0, False), (4, 0, False), (1, 48, False), (1, 0, True), (2, 64, True)],
)
def test_hostio_config_sweep_bit_exact(port_index, workers, cache_rows, prefetch):
    """Each knob in isolation (and multi-worker, and all together) is
    invisible to results, eager and lazy."""
    data, _, tidx = port_index
    q = uniform_queries(data, 8, seed=93)
    hio = HostIOConfig(workers=workers, hot_cache_rows=cache_rows, prefetch=prefetch)
    for eager in (True, False):
        cfg = SearchConfig(t=24, bloom_z=8192, eager=eager)
        ids_p, d_p = _search(tidx, q, cfg, "reference")
        ids_h, d_h = _search(tidx, q, cfg, "reference", hio)
        np.testing.assert_array_equal(ids_h, ids_p)
        np.testing.assert_array_equal(d_h, d_p)


@pytest.mark.parametrize("hio", [FULL, dict(workers=4, hot_cache_rows=48, prefetch=False)])
def test_hostio_matches_reference_executor_and_counters(port_index, hio):
    """One search through the reference's executor and the port's with the
    same HostIOConfig, in "reference" mode: ids bit-exact, distances equal
    to the port's plain base (ROADMAP C4), and the deterministic counters
    equal."""
    data, idx, tidx = port_index
    q = uniform_queries(data, 16, seed=94)
    jex = type(idx.executor("base")).from_index(idx, variant="base",
                                                hostio=jhostio.HostIOConfig(**hio))
    tex = SearchExecutor.from_index(tidx, "base", hostio=HostIOConfig(**hio))
    try:
        jids, _ = jex.search(q, K, cfg=JSearchConfig(t=32, bloom_z=8192), kernel_mode="reference")
        ids, d = tex.search(q, K, cfg=SearchConfig(t=32, bloom_z=8192), kernel_mode="reference")
    finally:
        jex.hostio_runtime.stop()
        tex.hostio_runtime.stop()
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    plain_ids, plain_d = _search(tidx, q, SearchConfig(t=32, bloom_z=8192), "reference")
    np.testing.assert_array_equal(ids.numpy(), plain_ids)
    np.testing.assert_array_equal(d.numpy(), plain_d)
    js, ts = jex.hostio_runtime.stats(), tex.hostio_runtime.stats()
    assert {c: ts[c] for c in COUNTERS} == {c: js[c] for c in COUNTERS}
    assert ts["requests"] > 0 and ts["rows_gathered"] > 0
    assert set(ts) == set(js)
    assert ts["hot_cache_rows"] == js["hot_cache_rows"]
    assert ts["hot_cache_device_bytes"] == js["hot_cache_device_bytes"]
    if hio["prefetch"]:
        assert ts["prefetch_issued"] == ts["prefetch_hits"] + 1     # the last hop's ticket


def test_hostio_executor_cached_per_config(port_index):
    """(variant, mesh, hostio) caching: configs never share executors or
    worker pools; the no-hostio executor has no service."""
    _, _, tidx = port_index
    full = HostIOConfig(**FULL)
    ex_a = tidx.executor("base", hostio=full)
    ex_b = tidx.executor("base", hostio=HostIOConfig(workers=1))
    ex_plain = tidx.executor("base")
    assert ex_a is tidx.executor("base", hostio=HostIOConfig(**FULL))
    assert ex_a is not ex_b and ex_a is not ex_plain
    assert ex_plain.hostio_runtime is None and ex_plain.hostio_service is None
    assert ex_a.hostio_runtime is not ex_b.hostio_runtime
    assert ex_a.hostio_service is ex_a.hostio_runtime.service
    key = next(iter(ex_a.trace_counts), None)
    assert key is None or key[5] == full


def test_hostio_rejected_on_device_graph_variants(port_index):
    _, _, tidx = port_index
    full = HostIOConfig(**FULL)
    for variant in ("inmem", "exact"):
        with pytest.raises(ValueError, match="hostio"):
            tidx.executor(variant, hostio=full)
        with pytest.raises(ValueError, match="hostio"):
            SearchExecutor.from_index(tidx, variant, hostio=full)


# -------------------------------------------------------------- accounting
def test_exchange_accounting_reports_cache_savings(port_index):
    """host_link_bytes = ids_out + rows_in - measured saving; the saving is
    the measured hit rate x the rows-back leg."""
    data, idx, tidx = port_index
    ex = SearchExecutor.from_index(tidx, "base", hostio=HostIOConfig(**FULL))
    try:
        ex.search(uniform_queries(data, 16, seed=95), K, cfg=SearchConfig(t=32, bloom_z=8192))
        x = ex.exchange_bytes_per_hop(16)
        rate = ex.hostio_service.cache_hit_rate()
        assert x["hot_cache_rows"] == FULL["hot_cache_rows"]
        assert x["hot_cache_hit_rate"] == rate > 0.0
        assert x["host_bytes_saved_per_hop"] == int(x["host_rows_in_bytes"] * rate)
        assert x["host_link_bytes"] == (x["host_ids_out_bytes"] + x["host_rows_in_bytes"]
                                        - x["host_bytes_saved_per_hop"])
        s = ex.hostio_runtime.stats()
        assert s["prefetch_issued"] >= s["prefetch_hits"] > 0 and s["prefetch_misses"] == 0
        assert 0.0 < s["overlap_fraction"] <= 1.0
        split = ex.neighbors.split()
        assert split["hops"] == s["requests"] and split["rows_bytes"] == s["requests"] * 16 * ex.R * 4
    finally:
        ex.hostio_runtime.stop()
    x0 = tidx.executor("base").exchange_bytes_per_hop(16)
    jx0 = idx.executor("base").exchange_bytes_per_hop(16)
    assert x0 == jx0
    assert tidx.executor("inmem").exchange_bytes_per_hop(16) == idx.executor("inmem").exchange_bytes_per_hop(16)


def test_set_telemetry_forwards_to_the_runtime(port_index):
    from repro_torch.runtime.telemetry import Telemetry

    data, _, tidx = port_index
    ex = SearchExecutor.from_index(tidx, "base", hostio=HostIOConfig(**FULL))
    tel = Telemetry()
    try:
        ex.set_telemetry(tel)
        ex.search(uniform_queries(data, 8, seed=96), K, cfg=SearchConfig(t=24, bloom_z=8192))
        reg = tel.registry
        assert reg.counter("bang_hostio_requests_total").value == ex.hostio_service.stats()["requests"] > 0
        assert reg.gauge("bang_hostio_hot_cache_rows").value == FULL["hot_cache_rows"]
        assert reg.gauge("bang_hostio_hot_cache_device_bytes").value == ex.hostio_runtime.cache.device_bytes()
    finally:
        ex.hostio_runtime.stop()


# ------------------------------------------- service against the reference
def _both_services(parts, **kw):
    return (jhostio.NeighborService([p.copy() for p in parts], **kw),
            NeighborService([p.copy() for p in parts], **kw))


@settings(max_examples=20, deadline=None)
@given(data=st.data())
def test_service_protocol_matches_reference(data):
    """request, issue + collect (matching, mismatched and unknown tickets)
    give the reference service's arrays and counters on the same inputs."""
    n_loc = data.draw(st.integers(2, 24))
    R = data.draw(st.integers(1, 5))
    B = data.draw(st.integers(1, 20))
    workers = data.draw(st.integers(1, 3))
    vals = data.draw(st.lists(st.integers(-1, 3 * n_loc), min_size=n_loc * R, max_size=n_loc * R))
    part = np.array(vals, np.int32).reshape(n_loc, R)
    draw_ids = lambda: np.array(data.draw(st.lists(st.integers(0, n_loc - 1), min_size=B, max_size=B)),
                                np.int32)
    draw_mask = lambda: np.array(data.draw(st.lists(st.booleans(), min_size=B, max_size=B)), bool)
    rel, pred, own, hit = draw_ids(), draw_ids(), draw_mask(), draw_mask()
    ref, svc = _both_services([part], workers=workers)
    try:
        for s in (ref, svc):
            s.start()
        got = [svc.request(0, rel, own & ~hit, hit), svc.collect(0, rel, own, hit, svc.issue(0, pred, own)),
               svc.collect(0, rel, own, hit, svc.issue(0, rel, own)),
               svc.collect(0, rel, own, hit, np.array([10**6], np.int32))]
        exp = [ref.request(0, rel, own & ~hit, hit), ref.collect(0, rel, own, hit, ref.issue(0, pred, own)),
               ref.collect(0, rel, own, hit, ref.issue(0, rel, own)),
               ref.collect(0, rel, own, hit, np.array([10**6], np.int32))]
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g, e)
        js, ts = ref.stats(), svc.stats()
        keys = ("requests", "prefetch_issued", "prefetch_hits", "prefetch_misses",
                "prefetch_lane_mismatches", "host_miss_lanes", "cache_hit_lanes")
        assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
        # Into a caller's buffer: the same rows, left in that buffer.
        out = np.full((B, R), 7, np.int32)
        assert svc.request(0, rel, own, hit, out=out) is out
        np.testing.assert_array_equal(out, exp[2])
        out2 = np.full((B, R), 7, np.int32)
        tok = svc.issue_lazy(0, lambda: (rel, own), out=out2)
        assert svc.collect(0, rel, own, hit, tok, out=out2) is out2
        np.testing.assert_array_equal(out2, exp[2])
    finally:
        for s in (ref, svc):
            s.stop()


def test_issue_lazy_resolves_on_the_worker():
    """A lazy ticket's request is computed on a worker thread; the collect
    sees it as the ticket's request (a hit, bit-exact)."""
    part = np.arange(16 * 3, dtype=np.int32).reshape(16, 3)
    svc = NeighborService([part], workers=2)
    ids = np.array([3, 0, 15, 7], np.int32)
    own = np.ones(4, bool)
    seen, settled = [], threading.Event()

    def resolve():
        seen.append(threading.current_thread().name)
        return ids, own

    out = np.zeros((4, 3), np.int32)
    try:
        tok = svc.issue_lazy(0, resolve, out=out, settled=settled)
        assert settled.wait(timeout=10.0)
        res = svc.collect(0, ids, own, np.zeros(4, bool), tok, out=out)
    finally:
        svc.stop()
    assert res is out
    np.testing.assert_array_equal(res, part[ids] + 1)
    assert seen and seen[0].startswith("hostio-p0-w")
    s = svc.stats()
    assert s["prefetch_hits"] == 1 and s["prefetch_misses"] == 0


class _RecordingPartition(np.ndarray):
    """ndarray view logging every row-index array used to gather from it."""

    def __getitem__(self, item):
        self.served.append(np.array(item, copy=True))
        return np.asarray(super().__getitem__(item))


@settings(max_examples=25, deadline=None)
@given(data=st.data())
def test_service_gathers_each_miss_exactly_once(data):
    """Over all shards, every valid non-cache-hit frontier id is gathered
    from host memory exactly once; cache-hit, sentinel and out-of-range ids
    never index host memory; the summed contributions rebuild the
    unsharded gather bit-for-bit."""
    S = data.draw(st.integers(1, 4))
    local_n = data.draw(st.integers(2, 32))
    R = data.draw(st.integers(1, 6))
    workers = data.draw(st.integers(1, 3))
    n_total = S * local_n
    adjacency = (np.arange(n_total * R, dtype=np.int64) % (n_total + 1) - 1).astype(np.int32)
    adjacency = adjacency.reshape(n_total, R)
    parts = []
    for s in range(S):
        p = adjacency[s * local_n:(s + 1) * local_n].view(_RecordingPartition)
        p.served = []
        parts.append(p)
    svc = NeighborService(parts, workers=workers)
    svc._parts = parts          # keep the recording views (the service copies)
    raw = data.draw(st.lists(st.integers(-n_total - 3, 2 * n_total + 3), min_size=1, max_size=48))
    ids = np.array(raw, np.int32)
    hit = np.array([data.draw(st.integers(0, 3)) == 0 for _ in raw], bool)
    in_range = (ids >= 0) & (ids < n_total)
    total = np.zeros((len(ids), R), np.int64)
    try:
        svc.start()
        for s in range(S):
            rel = ids.astype(np.int64) - s * local_n
            own = (rel >= 0) & (rel < local_n) & (ids != INVALID_ID) & (ids >= 0)
            rel = np.clip(rel, 0, local_n - 1).astype(np.int32)
            contrib = svc.request(s, rel, own & ~hit, hit)
            assert contrib[~(own & ~hit)].sum() == 0
            total += contrib
    finally:
        svc.stop()
    served = [np.atleast_1d(x).ravel() + s * local_n for s, p in enumerate(parts) for x in p.served]
    served = np.concatenate(served) if served else np.array([], np.int64)
    np.testing.assert_array_equal(np.sort(served), np.sort(ids[in_range & ~hit]))
    expect = np.where((in_range & ~hit)[:, None], adjacency[np.clip(ids, 0, n_total - 1)] + 1, 0)
    np.testing.assert_array_equal(total, expect)
    assert svc.stats()["host_miss_lanes"] == int((in_range & ~hit).sum())


def test_service_stats_atomic_snapshot():
    """Every derived ratio in one stats() dict comes from the same locked
    counter copy, under concurrent counter traffic."""
    import sys

    svc = NeighborService([np.arange(16, dtype=np.int32).reshape(8, 2)], workers=1)
    stop = threading.Event()

    def hammer() -> None:
        while not stop.is_set():
            svc._bump(cache_hit_lanes=1)
            svc._bump(host_miss_lanes=2)
            svc._bump(gather_s_total=1e-4, gather_s_hidden=5e-5)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for th in threads:
        th.start()
    try:
        for _ in range(300):
            s = svc.stats()
            total = s["cache_hit_lanes"] + s["host_miss_lanes"]
            assert s["cache_hit_rate"] == (s["cache_hit_lanes"] / total if total else 0.0)
            assert 0.0 <= s["overlap_fraction"] <= 1.0
    finally:
        stop.set()
        sys.setswitchinterval(old)
        for th in threads:
            th.join(timeout=10.0)
    assert not any(th.is_alive() for th in threads)
    assert svc.stats()["cache_hit_lanes"] * 2 == svc.stats()["host_miss_lanes"]


def test_worker_errors_surface_in_stats():
    part = np.arange(16, dtype=np.int32).reshape(8, 2)
    svc = NeighborService([part], workers=1)
    done = threading.Event()

    def boom() -> None:
        try:
            raise RuntimeError("gather exploded")
        finally:
            done.set()

    try:
        svc.start()
        assert svc._enqueue(0, boom)
        assert done.wait(timeout=5.0)
        for _ in range(100):
            if svc.stats()["worker_errors"]:
                break
            time.sleep(0.01)
        s = svc.stats()
        assert s["worker_errors"] == 1 and s["last_worker_error"] == "RuntimeError: gather exploded"
        ids = np.array([3, 5], np.int32)
        np.testing.assert_array_equal(svc.request(0, ids, np.ones(2, bool), np.zeros(2, bool)),
                                      part[ids] + 1)
    finally:
        svc.stop()


# ------------------------------------------------------------------- cache
@pytest.mark.parametrize("n_rows,medoid", [(2, 5), (2, 31), (64, None), (5, 0)])
def test_hot_cache_matches_reference(n_rows, medoid):
    rng = np.random.default_rng(n_rows)
    n, R = 40, 4
    adjacency = rng.integers(-1, n, (n, R)).astype(np.int32)
    adjacency[:, 0] = 7                      # a hub
    ref = jhostio.HotAdjacencyCache(adjacency, n_rows, medoid=medoid)
    out = HotAdjacencyCache(adjacency, n_rows, medoid=medoid, device="cpu")
    np.testing.assert_array_equal(out.hot_ids, ref.hot_ids)
    assert out.hot_ids.dtype == np.int32 and out._slot_of.dtype == torch.int32
    np.testing.assert_array_equal(out._slot_of.numpy(), np.asarray(ref._slot_of))
    np.testing.assert_array_equal(out._rows.numpy(), np.asarray(ref._rows))
    assert out.n_rows == ref.n_rows and out.device_bytes() == ref.device_bytes()
    u = np.array([7, 5, 3, -1, int(INVALID_ID), 0, 31, n + 2], np.int32)
    rows, hit = out.probe(torch.from_numpy(u))
    jrows, jhit = ref.probe(u)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(out.covers(u), ref.covers(u))
    np.testing.assert_array_equal(out.covers(u), hit.numpy())
    adjacency2 = adjacency[::-1].copy()
    out.refresh(adjacency2)
    ref.refresh(adjacency2)
    np.testing.assert_array_equal(out._rows.numpy(), np.asarray(ref._rows))
    assert out.refreshes == ref.refreshes == 1


def test_config_and_cache_reject_bad_sizes():
    with pytest.raises(ValueError):
        HotAdjacencyCache(np.zeros((4, 2), np.int32), 0, device="cpu")
    with pytest.raises(ValueError):
        HostIOConfig(workers=0)
    with pytest.raises(ValueError):
        HostIOConfig(hot_cache_rows=-1)
    with pytest.raises(TypeError):
        HostIOConfig(resilience="yes please")
    assert HostIOConfig(**FULL) == HostIOConfig(**FULL) and hash(HostIOConfig(**FULL))
    assert [f.name for f in dataclasses.fields(HostIOConfig)] == \
        [f.name for f in dataclasses.fields(jhostio.HostIOConfig)]


# ------------------------------------------------------------ fault matrix
N_LOC, R = 64, 6


def _parts(n_parts=2, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2 * N_LOC, (N_LOC, R)).astype(np.int32) for _ in range(n_parts)]


def _inputs(B=48, seed=11):
    rng = np.random.default_rng(seed)
    return rng.integers(0, N_LOC, B).astype(np.int32), rng.integers(0, 4, B) < 3


def _pair(specs, *, seed=0, parts=None, **kw):
    """The reference's and the port's service over the same partitions, each
    with an injector of the same specs and seed."""
    parts = _parts() if parts is None else parts
    res = kw.pop("resilience", None)
    ref = jhostio.NeighborService(
        parts, resilience=None if res is None else jres.ResilienceConfig(**res),
        injector=jres.FaultInjector([jres.FaultSpec(k, **a) for k, a in specs], seed=seed), **kw)
    out = NeighborService(
        parts, resilience=None if res is None else tres.ResilienceConfig(**res),
        injector=tres.FaultInjector([tres.FaultSpec(k, **a) for k, a in specs], seed=seed), **kw)
    return ref, out


def _run_pair(ref, out, shard=0, B=48, seed=11):
    rel, own = _inputs(B, seed)
    try:
        got = out.request(shard, rel, own, np.zeros(B, bool))
        exp = ref.request(shard, rel, own, np.zeros(B, bool))
    finally:
        ref.stop()
        out.stop()
    return got, exp, out.stats(), ref.stats(), rel, own


def test_transient_errors_retry_to_bit_exact():
    ref, out = _pair([("transient_error", dict(shard=0, count=2))], workers=1,
                     resilience=dict(max_retries=3, backoff_base_s=1e-4))
    got, exp, s, js, rel, own = _run_pair(ref, out)
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(got[own], out._parts[0][rel[own]] + 1)
    for key in ("retries", "gather_failures", "degraded_lanes", "rows_gathered"):
        assert s[key] == js[key], key
    assert s["gather_failures"] == 2 and s["degraded_lanes"] == 0


@pytest.mark.parametrize("mode", ["medoid", "mask"])
def test_degraded_modes_give_the_references_rows(mode):
    ref, out = _pair([("transient_error", dict(shard=0, count=1 << 30))], workers=1,
                     medoid=N_LOC + 7,
                     resilience=dict(max_retries=1, backoff_base_s=1e-4, unhealthy_after=10_000,
                                     degraded_mode=mode))
    got, exp, s, js, _, own = _run_pair(ref, out)
    np.testing.assert_array_equal(got, exp)
    assert s["degraded_lanes"] == js["degraded_lanes"] == int(own.sum())
    if mode == "mask":
        assert (got == 0).all()


def test_medoid_row_given_directly_serves_degraded_lanes():
    """A rank's service holds only its block: `medoid_row` pins the row
    wherever the medoid lives."""
    parts = _parts(1)
    row = np.arange(R, dtype=np.int32) + 100
    svc = NeighborService(parts, workers=1, medoid_row=row,
                          resilience=tres.ResilienceConfig(max_retries=0, unhealthy_after=10_000))
    try:
        svc.mark_partition_down(0)
        rel, own = _inputs()
        got = svc.request(0, rel, own, np.zeros(len(rel), bool))
    finally:
        svc.stop()
    np.testing.assert_array_equal(got[own], np.broadcast_to(row + 1, (int(own.sum()), R)))
    assert (got[~own] == 0).all()


def test_failure_streak_auto_fails_over_and_recovery_is_bit_exact():
    ref, out = _pair([("transient_error", dict(shard=0, count=1 << 30))], workers=1,
                     resilience=dict(max_retries=4, backoff_base_s=1e-4, unhealthy_after=2,
                                     auto_failover=True))
    got, exp, s, js, _, _ = _run_pair(ref, out)
    np.testing.assert_array_equal(got, exp)
    assert out.partition_state(0) == ref.partition_state(0) == "failover"
    assert s["failovers"] == js["failovers"] == 1 and s["degraded_lanes"] == 0
    svc = NeighborService(_parts(), workers=2)
    try:
        rel, own = _inputs(seed=13)
        base = svc.request(1, rel, own, np.zeros(len(rel), bool))
        svc.fail_over(1)
        np.testing.assert_array_equal(svc.request(1, rel, own, np.zeros(len(rel), bool)), base)
        svc.recover(1)
        np.testing.assert_array_equal(svc.request(1, rel, own, np.zeros(len(rel), bool)), base)
        assert svc.partition_state(1) == "up" and svc.stats()["recoveries"] == 1
    finally:
        svc.stop()


def test_worker_crash_loses_no_request():
    ref, out = _pair([("worker_crash", dict(shard=0, count=1))], workers=2)
    got, exp, s, js, _, _ = _run_pair(ref, out, B=64)
    np.testing.assert_array_equal(got, exp)
    assert s["worker_deaths"] == js["worker_deaths"] == 1


def test_stalled_pool_hedges_inline_and_overflow_falls_back():
    ref, out = _pair([("worker_stall", dict(stall_s=0.4, count=1 << 30))], workers=2,
                     resilience=dict(hedge_s=0.03))
    t0 = time.perf_counter()
    rel, own = _inputs(64)
    try:
        got = out.request(0, rel, own, np.zeros(64, bool))
        wall = time.perf_counter() - t0
        exp = ref.request(0, rel, own, np.zeros(64, bool))
    finally:
        ref.stop()
        out.stop()
    np.testing.assert_array_equal(got, exp)
    assert wall < 0.4 and out.stats()["hedged_gathers"] >= 1
    ref, out = _pair([("queue_overflow", dict(count=1 << 30))], workers=2)
    got, exp, s, _, _, _ = _run_pair(ref, out, B=64)
    np.testing.assert_array_equal(got, exp)
    assert s["enqueue_rejections"] >= 1


def test_stop_poisons_pending_tickets_and_is_idempotent():
    parts = _parts(1)
    svc = NeighborService(parts, workers=1)
    svc.start()
    release = threading.Event()
    assert svc._enqueue(0, lambda: release.wait(timeout=30.0))   # wedge the only worker
    rel = np.arange(8, dtype=np.int32)
    own = np.ones(8, bool)
    seq = svc.issue(0, rel, own)             # queued behind the wedge
    stopper = threading.Thread(target=svc.stop)
    stopper.start()
    try:
        t0 = time.perf_counter()
        got = svc.collect(0, rel, own, np.zeros(8, bool), seq)
        assert time.perf_counter() - t0 < 2.0
        np.testing.assert_array_equal(got, parts[0][rel] + 1)
        assert svc.stats()["prefetch_misses"] == 1
    finally:
        release.set()
        stopper.join(timeout=10.0)
    assert not stopper.is_alive() and not svc.started
    svc.stop()
    assert not svc.started
    try:
        got = svc.start().request(0, rel, own, np.zeros(8, bool))
        np.testing.assert_array_equal(got, parts[0][rel] + 1)
    finally:
        svc.stop()


def test_fault_matrix_mid_search_bit_exact(port_index):
    """Injected faults in the middle of searches lose nothing and stay
    bit-exact against the fault-free run."""
    data, _, tidx = port_index
    hio = HostIOConfig(workers=2, hot_cache_rows=64, prefetch=True,
                       resilience=tres.ResilienceConfig(deadline_s=0.5, hedge_s=0.1, max_retries=3,
                                                        backoff_base_s=1e-4, unhealthy_after=1_000_000,
                                                        auto_failover=False))
    ex = SearchExecutor.from_index(tidx, "base", hostio=hio)
    svc = ex.hostio_service
    cfg = SearchConfig(t=32, bloom_z=8192)
    q = uniform_queries(data, 16, seed=91)
    matrix = [("transient_error", tres.FaultSpec("transient_error", shard=0, count=2), "retries"),
              ("worker_crash", tres.FaultSpec("worker_crash", shard=0, count=1), "worker_deaths"),
              ("worker_stall", tres.FaultSpec("worker_stall", stall_s=0.05, count=3), None),
              ("queue_overflow", tres.FaultSpec("queue_overflow", count=tres.FOREVER),
               "enqueue_rejections")]
    try:
        ids_0, d_0 = ex.search(q, K, cfg=cfg)
        for kind, spec, counter in matrix:
            inj = tres.FaultInjector([spec], seed=4)
            svc.set_injector(inj)
            svc.reset_stats()
            try:
                ids, d = ex.search(q, K, cfg=cfg)
            finally:
                svc.set_injector(None)
            assert torch.equal(ids, ids_0) and torch.equal(d, d_0), kind
            assert inj.injected()[kind] > 0, kind
            if counter is not None:
                assert svc.stats()[counter] > 0, (kind, svc.stats())
    finally:
        ex.hostio_runtime.stop()


def test_every_module_names_the_reference_api():
    """The port's host-I/O package exports the reference's names."""
    for name in jhostio.__all__:
        assert hasattr(hostio, name), name

