"""Port vs reference: the telemetry subsystem, and its seams in the port's
executor.

The registry, tracer, flight recorder and hop profiler are host Python in
both packages: the same operations must give the same exports (byte-equal
JSON and Prometheus text), traces the reference's schema check accepts,
postmortems with the same keys. Attaching a bundle to an executor must
change no cache key, no build count and no result.
"""
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from repro.runtime import telemetry as jtel
from repro_torch import SearchConfig
from repro_torch.convert import index_from_reference
from repro_torch.kernels.search_step import ops as step_ops
from repro_torch.runtime import telemetry as ttel
from repro_torch.runtime.executor import SearchExecutor

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core

K = 5
CFG = SearchConfig(t=16)


def _drive_registry(pkg):
    """One fixed sequence of registry operations; returns the registry and
    the window delta it took."""
    reg = pkg.MetricsRegistry()
    reg.counter("bang_serve_queries_total", "queries submitted").inc(7)
    reg.counter("bang_serve_queries_total").inc(2.5)
    reg.gauge("bang_serve_qps", "last window").set(123.5)
    reg.gauge("bang_hostio_max_queue_depth").set_max(4)
    reg.gauge("bang_hostio_max_queue_depth").set_max(2)
    h = reg.histogram("bang_serve_latency_seconds", "latency")
    for v in (3e-6, 2e-4, 0.05, 0.05, 7.0, 40.0):
        h.observe(v)
    snap = reg.snapshot()
    reg.counter("bang_serve_queries_total").inc(1)
    reg.histogram("bang_lat2_seconds", buckets=(0.1, 1.0)).observe(0.5)
    reg.gauge("bang_mutation_epoch").inc(3)
    return reg, reg.delta(snap)


def test_registry_exports_are_byte_equal_to_the_reference():
    out, out_delta = _drive_registry(ttel)
    ref, ref_delta = _drive_registry(jtel)
    assert json.dumps(out.to_json(), sort_keys=False) == json.dumps(ref.to_json(), sort_keys=False)
    assert out.to_json()["schema_version"] == 1
    assert out.to_prom() == ref.to_prom()
    assert out_delta == ref_delta
    assert ttel.parse_prom(out.to_prom()) == jtel.parse_prom(ref.to_prom())
    assert ttel.LATENCY_BUCKETS_S == jtel.LATENCY_BUCKETS_S
    assert ttel.log_buckets(1e-3, 1.0, 3) == jtel.log_buckets(1e-3, 1.0, 3)
    # Same refusals: a type clash, a bad name, a decreasing counter.
    for pkg in (ttel, jtel):
        reg = pkg.MetricsRegistry()
        reg.counter("c_total")
        with pytest.raises(TypeError):
            reg.gauge("c_total")
        with pytest.raises(ValueError):
            reg.counter("0bad name")
        with pytest.raises(ValueError):
            reg.counter("c_total").inc(-1)
    with pytest.raises(ValueError):
        ttel.parse_prom("0badname 17\n")


def _strip_time(ev: dict) -> dict:
    return {k: v for k, v in ev.items() if k not in ("ts", "dur")}


def _drive_tracer(tr):
    with tr.span("request", track="serve", rid=0):
        pass
    sp = tr.span("gather", track="hostio-p0", rows=4)
    sp.end(seq=9)
    sp.end()
    tr.instant("failover", shard=0)
    tr.complete("device", 10.0, 20.0, track="serve", size=8)
    return tr


def test_tracer_trace_passes_the_references_schema_check(tmp_path):
    out = _drive_tracer(ttel.Tracer())
    ref = _drive_tracer(jtel.Tracer())
    evs = jtel.validate_chrome_trace(out.to_chrome())
    assert [_strip_time(e) for e in evs] == [_strip_time(e) for e in ref.events()]
    assert ttel.validate_chrome_trace(out.to_chrome()) == evs
    chrome = out.to_chrome()
    assert chrome["otherData"] == {"producer": "repro_torch.runtime.telemetry", "dropped_events": 0}
    p = tmp_path / "trace.json"
    out.save(str(p))
    assert jtel.validate_chrome_trace(json.loads(p.read_text())) == evs
    # Bounded: metadata exempt, drops counted as in the reference.
    small = ttel.Tracer(max_events=5)
    for i in range(10):
        small.instant("tick", track="t", i=i)
    assert len(small.events()) == 5 and small.dropped_events == 6
    with pytest.raises(ValueError):
        ttel.validate_chrome_trace({"traceEvents": [{"ph": "Z", "name": "x", "pid": 1, "tid": 0}]})


def _drive_recorder(pkg):
    reg = pkg.MetricsRegistry()
    reg.counter("c_total").inc(4)
    rec = pkg.FlightRecorder(capacity=3, registry=reg, max_dumps=1)
    for i in range(5):
        rec.record("tick", i=i)
    first = rec.trigger("failover", shard=0)
    rec.trigger("degraded", shard=1)
    return rec, first


def test_flight_recorder_postmortems_match_the_reference(tmp_path):
    out, d_out = _drive_recorder(ttel)
    ref, d_ref = _drive_recorder(jtel)
    assert d_out.keys() == d_ref.keys()
    same = {k: v for k, v in d_out.items() if k not in ("t_wall", "events")}
    assert same == {k: v for k, v in d_ref.items() if k not in ("t_wall", "events")}

    def no_t(evs):
        return [{k: v for k, v in e.items() if k != "t"} for e in evs]

    assert no_t(d_out["events"]) == no_t(d_ref["events"])
    assert no_t(out.events()) == no_t(ref.events())
    assert len(out.dumps) == 1 and out.dropped_dumps == ref.dropped_dumps == 1
    assert out.dumps_for("failover") == [d_out]
    p = tmp_path / "pm.json"
    out.save(str(p))
    doc = json.loads(p.read_text())
    assert doc["schema_version"] == 1 and [d["reason"] for d in doc["dumps"]] == ["failover"]
    out.clear()
    assert out.events() == [] and out.dumps == [] and out.dropped_dumps == 0
    with pytest.raises(ValueError):
        ttel.FlightRecorder(capacity=0)


def test_hop_profiler_summary():
    hops = [(8, 4, 2, 0.002), (8, 8, 0, 0.001), (8, 2, 0, 0.004), (8, 1, 0, 0.1)]
    out, ref = ttel.HopProfiler(max_hops=3), jtel.HopProfiler(max_hops=3)
    for prof in (out, ref):
        for lanes, own, hits, wall in hops:
            prof.on_hop(0, lanes=lanes, own_lanes=own, cache_hit_lanes=hits, wall_s=wall)
    s = out.summary()
    assert s == ref.summary()      # no kernel info stamped: no codes-stream model
    assert out.hops == 3 and out.dropped_hops == 1
    assert s["hop_wall_s_total"] == pytest.approx(0.007)
    assert s["frontier_occupancy"] == pytest.approx((4 + 2 + 8 + 2) / 24)
    assert s["codes_stream_bytes_per_hop"] is None
    # The port's model: K1 reads at most one m-byte code row per lane.
    out.set_kernel_info(kernel_mode="fused", batch=8, n=1000, m=8, R=16)
    s = out.summary()
    assert s["kernel_info"] == {"kernel_mode": "fused", "batch": 8, "n": 1000, "m": 8, "R": 16,
                                "tile_rows": 0}
    assert s["codes_stream_bytes_per_hop"] == 8 * 16 * 8
    assert s["codes_stream_bytes_total"] == 8 * 16 * 8 * 3
    out.set_kernel_info(kernel_mode="staged", batch=8, n=1000, m=8, R=16)
    assert out.summary()["codes_stream_bytes_per_hop"] == 0
    assert set(s) == set(ref.summary())


def test_hop_profiler_annotation_shows_in_a_torch_profiler_trace():
    prof = ttel.HopProfiler()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        with prof.annotate("bang_test_region"):
            torch.ones(4).sum()
    assert "bang_test_region" in {e.key for e in p.key_averages()}
    with prof.annotate("bang_no_profiler"):   # a no-op range without a profiler
        pass


def test_telemetry_bundle_and_hostio_mapping_match_the_reference():
    tel = ttel.Telemetry.create()
    assert tel.tracer is None and tel.recorder is None and tel.profiler is None
    assert tel.span("x") is None
    tel.instant("x")
    tel.record("x")
    tel.event("x")
    full = ttel.Telemetry.create(trace=True, flight_record=True, profile=True, max_dumps=7)
    assert full.recorder._registry is full.registry and full.recorder._max_dumps == 7
    assert ttel.Telemetry.create(shared_registry=True).registry is ttel.default_registry()
    full.event("failover", shard=2)
    assert [e["name"] for e in full.tracer.events() if e["ph"] == "i"] == ["failover"]
    assert full.recorder.events()[-1]["kind"] == "failover"
    bumps = [{"requests": 2, "degraded_lanes": 3, "max_queue_depth": 7, "gather_s_total": 0.5,
              "gather_s_hidden": 0.25, "latency_s_total": 0.75},
             {"max_queue_depth": 3}, {"requests": 1}]
    out, ref = ttel.Telemetry.create(), jtel.Telemetry.create()
    for b in bumps:
        out.bump_hostio(b)
        ref.bump_hostio(b)
    assert out.registry.to_prom() == ref.registry.to_prom()
    assert out.registry.gauge("bang_hostio_max_queue_depth").value == 7


def test_traffic_model_counts_the_ports_hop():
    B, R, m, t = 1024, 64, 32, 64
    assert step_ops.hbm_candidate_roundtrips_per_hop("fused") == 1
    assert step_ops.hbm_candidate_roundtrips_per_hop("staged") == 4
    assert step_ops.hbm_intermediate_bytes_per_hop("fused", B, R, m, t) == 0
    assert step_ops.hbm_intermediate_bytes_per_hop("staged", B, R, m, t) == B * R * (m + 36)
    # At any n: the candidate rows, not the reference's whole (n, m) block.
    for n in (10**4, 10**6, 10**9):
        assert step_ops.hbm_codes_stream_bytes_per_hop("fused", B, n, m, R=R) == B * R * m
    assert step_ops.hbm_codes_stream_bytes_per_hop("fused", B, 10**6, m, tile_rows=4096, R=R) == B * R * m
    assert step_ops.hbm_codes_stream_bytes_per_hop("reference", B, 10**6, m, R=R) == 0
    with pytest.raises(ValueError):
        step_ops.hbm_codes_stream_bytes_per_hop("fused", B, 10, m, tile_rows=-1, R=R)


# ------------------------------------------------------- executor seams
@pytest.fixture(scope="module")
def cpu_index(small_ann_index):
    data, idx = small_ann_index
    arrays = {"codebooks": np.asarray(idx.codec.codebooks), "codes": np.asarray(idx.codes),
              "adjacency": idx.graph.adjacency, "medoid": idx.graph.medoid, "data": idx.data_np}
    return data, index_from_reference(arrays, device="cpu")


@pytest.mark.parametrize("variant", ["inmem", "base", "exact"])
def test_set_telemetry_changes_no_key_and_no_result(cpu_index, variant):
    data, index = cpu_index
    q = np.asarray(data[:4] + 0.01, np.float32)
    ex_off = SearchExecutor.from_index(index, variant=variant)
    ex_on = SearchExecutor.from_index(index, variant=variant)
    assert ex_on.telemetry is None
    tel = ttel.Telemetry.create(trace=True, flight_record=True, profile=True)
    assert ex_on.set_telemetry(tel) is ex_on
    ids_off, d_off = ex_off.search(q, K, cfg=CFG)
    ids_on, d_on = ex_on.search(q, K, cfg=CFG)
    assert torch.equal(ids_on, ids_off) and torch.equal(d_on, d_off)
    assert list(ex_on._cache) == list(ex_off._cache)
    assert ex_on.trace_counts == ex_off.trace_counts
    before = (ex_on.cache_size, ex_on.n_traces)
    ex_on.set_telemetry(None)
    ids2, d2 = ex_on.search(q, K, cfg=CFG)
    ex_on.set_telemetry(tel)
    ids3, d3 = ex_on.search(q, K, cfg=CFG)
    assert (ex_on.cache_size, ex_on.n_traces) == before
    assert torch.equal(ids2, ids_off) and torch.equal(ids3, ids_off) and torch.equal(d3, d_off)
    # The one build, accounted while attached; the dispatch stamp.
    assert tel.registry.counter("bang_serve_compile_seconds_total").value > 0
    compiles = [e for e in tel.tracer.events() if e["name"] == "compile"]
    assert len(compiles) == 1 and compiles[0]["args"] == {"bucket": 8, "k": K,
                                                          "kernel_mode": "reference"}
    info = tel.profiler.summary()["kernel_info"]
    assert info == {"kernel_mode": "reference", "batch": 8, "n": index.n, "m": index.codec.m,
                    "R": index.graph.R, "tile_rows": 0}
    jtel.validate_chrome_trace(tel.tracer.to_chrome())


def test_dispatch_range_shows_in_a_torch_profiler_trace(cpu_index):
    data, index = cpu_index
    ex = SearchExecutor.from_index(index, variant="inmem")
    ex.set_telemetry(ttel.Telemetry.create(profile=True))
    q = np.asarray(data[:3], np.float32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        ex.search(q, K, cfg=CFG)
    assert "bang_dispatch:reference:b8" in {e.key for e in p.key_averages()}


def test_registry_is_thread_safe_under_concurrent_bumps():
    """More threads than cores, a short switch interval: no bump is lost."""
    reg = ttel.MetricsRegistry()
    n_threads, n_bumps = 2 * (os.cpu_count() or 4), 500

    def work():
        for _ in range(n_bumps):
            reg.counter("bang_x_total").inc()
            reg.gauge("bang_x_gauge").inc()
            reg.histogram("bang_x_seconds").observe(1e-3)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    total = n_threads * n_bumps
    assert reg.counter("bang_x_total").value == total and reg.gauge("bang_x_gauge").value == total
    assert reg.histogram("bang_x_seconds").count == total
