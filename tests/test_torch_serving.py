"""The port's `ServePipeline` (`repro_torch.runtime.serving`) vs the
reference's, on the CPU.

Mirrors `tests/test_serve_stats.py`, the pipeline cases of
`tests/test_hostio.py` and the admission-control cases of
`tests/test_resilience.py`: the pipeline owns the host-I/O lifecycle and its
dispatch thread, `ServeStats.hostio` snapshots are not aliased, result-cache
hits are bit-identical and evict LRU, percentiles are defined on empty,
single-row and cache-hit-only windows, rows are shed at submit and dropped
at dispatch past their deadline, `drain()`'s ids equal the reference
pipeline's, and an exception raised on the dispatch thread surfaces from
`drain()` with every unrecorded row re-queued. Every pipeline is closed by a
`with` block or a `finally`, and every wait has a timeout.
"""
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - fallback shim keeps suite collectable
    from _hypothesis_compat import given, settings, strategies as st

from repro.core import SearchConfig as JSearchConfig
from repro.data import uniform_queries
from repro.runtime import ServePipeline as JServePipeline
from repro_torch.convert import index_from_reference
from repro_torch.core import SearchConfig, brute_force_knn
from repro_torch.runtime import SearchExecutor, ServePipeline, ServeStats
from repro_torch.runtime.hostio import HostIOConfig

K = 5
CFG = SearchConfig(t=16)
FULL = HostIOConfig(workers=2, hot_cache_rows=64, prefetch=True)


def _dispatch_threads() -> list:
    return [t for t in threading.enumerate() if t.name.startswith("serve-dispatch")]


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


class _StubExecutor:
    """The dispatch/finish contract: echoes 0..k-1 as ids; `fail_at` makes
    that dispatch (0-based) raise on the dispatch thread."""

    class _H:
        def __init__(self, ids, dists):
            self.ids, self.dists = ids, dists
            self.compile_s = 0.0

    def __init__(self, d=8, fail_at=None):
        self._d = d
        self.fail_at = fail_at
        self.calls = 0
        self.threads = set()

    @property
    def query_dim(self):
        return self._d

    def dispatch(self, queries, k, cfg=None, rerank=True):
        self.threads.add(threading.current_thread().name)
        n = self.calls
        self.calls += 1
        if n == self.fail_at:
            raise RuntimeError("dispatch exploded")
        q = np.asarray(queries)
        ids = np.tile(np.arange(k, dtype=np.int32), (q.shape[0], 1)) + q[:, :1].astype(np.int32)
        return self._H(ids, np.zeros((q.shape[0], k), np.float32))

    def finish(self, h):
        return h.ids, h.dists


# ------------------------------------------------------------- lifecycle
def test_pipeline_owns_service_and_dispatch_thread_lifecycle(port_index):
    data, _, tidx = port_index
    ex = SearchExecutor.from_index(tidx, "base", hostio=HostIOConfig(workers=2))
    assert not ex.hostio_service.started
    before = len(_dispatch_threads())
    with ServePipeline(ex, k=K, cfg=SearchConfig(t=24, bloom_z=8192), max_batch=8) as pipe:
        assert ex.hostio_service.started and pipe.executor is ex
        pipe.submit(uniform_queries(data, 12, seed=3))
        ids, _, st = pipe.drain()
        assert st.batches == 2 and (ids >= 0).all()
        assert len(_dispatch_threads()) == before + 1
    assert not ex.hostio_service.started
    assert len(_dispatch_threads()) == before
    # A closed pipeline's executor serves a second pipeline (start() revives
    # the pools).
    with ServePipeline(ex, k=K, max_batch=8) as pipe:
        assert ex.hostio_service.started
    assert not ex.hostio_service.started


def test_dispatch_runs_on_the_pipelines_thread():
    ex = _StubExecutor(d=4)
    with ServePipeline(ex, k=2, max_batch=2) as pipe:
        pipe.submit(np.arange(20, dtype=np.float32).reshape(5, 4))
        ids, _, st = pipe.drain()
    assert st.batches == 3 and ex.calls == 3
    assert len(ex.threads) == 1 and next(iter(ex.threads)).startswith("serve-dispatch")
    np.testing.assert_array_equal(ids[:, 0], np.arange(0, 20, 4))


def test_dispatch_thread_exception_surfaces_and_requeues():
    """The second batch's dispatch raises on the dispatch thread: drain()
    raises it, and every row whose result was not recorded is back in the
    queue, in submission order; a retried drain serves them."""
    ex = _StubExecutor(d=4, fail_at=1)
    q = np.arange(24, dtype=np.float32).reshape(6, 4)
    with ServePipeline(ex, k=2, max_batch=2) as pipe:
        pipe.submit(q)
        with pytest.raises(RuntimeError, match="dispatch exploded"):
            pipe.drain()
        # Batch 0 was recorded before batch 1's failure surfaced; rows 2-5
        # were not.
        assert pipe.pending() == 4
        np.testing.assert_array_equal(np.stack([r[0] for r in pipe._queue]), q[2:])
        ids, _, st = pipe.drain()
    assert st.queries == 4 and st.batches == 2
    np.testing.assert_array_equal(ids[:, 0], q[2:, 0].astype(np.int32))


# ------------------------------------------------- drain vs the reference
@pytest.mark.parametrize("variant", ["inmem", "base"])
def test_drain_matches_reference_pipeline(port_index, variant):
    data, idx, tidx = port_index
    q = uniform_queries(data, 20, seed=5)
    gt = brute_force_knn(data, q, K, device="cpu")
    hio = FULL if variant == "base" else None
    jhio = None
    if hio is not None:
        from repro.runtime.hostio import HostIOConfig as JHostIOConfig

        jhio = JHostIOConfig(workers=2, hot_cache_rows=64, prefetch=True)
    jex = idx.executor(variant, hostio=jhio)
    with JServePipeline(jex, k=K, cfg=JSearchConfig(t=16, bloom_z=8192), max_batch=8,
                        kernel_mode="reference") as jpipe:
        jpipe.submit(q, gt_ids=gt)
        jids, _, jst = jpipe.drain()
    ex = tidx.executor(variant, hostio=hio)
    with ServePipeline(ex, k=K, cfg=SearchConfig(t=16, bloom_z=8192), max_batch=8,
                       kernel_mode="reference") as pipe:
        pipe.submit(q, gt_ids=gt)
        ids, dists, st = pipe.drain()
    np.testing.assert_array_equal(ids, np.asarray(jids))
    assert ids.dtype == np.int32 and dists.dtype == np.float32
    assert st.batches == jst.batches == 3 and st.queries == jst.queries == 20
    assert st.mean_recall == jst.mean_recall
    assert (st.hostio is None) == (jst.hostio is None)
    if st.hostio is not None:
        assert set(st.hostio) == set(jst.hostio)
        assert st.hostio["prefetch_misses"] == 0 and st.hostio["requests"] > 0


# ------------------------------------------------------------ stats hygiene
def test_hostio_snapshot_not_aliased(port_index):
    data, _, tidx = port_index
    q = np.asarray(data[:6] + 0.01, np.float32)
    ex = SearchExecutor.from_index(tidx, "base", hostio=FULL)
    rt = ex.hostio_runtime
    with ServePipeline(ex, k=K, cfg=CFG, max_batch=8) as pipe:
        pipe.submit(q)
        _, _, st1 = pipe.drain()
        live = rt.stats()
        assert st1.hostio == live and st1.hostio is not live
        st1.hostio["requests"] = -999
        st1.hostio["cache_hit_rate"] = float("nan")
        st1.hostio.clear()
        assert rt.stats()["requests"] == live["requests"]
        pipe.submit(q)
        _, _, st2 = pipe.drain()
        assert st2.hostio["requests"] >= live["requests"] > 0
        assert 0.0 <= st2.hostio["cache_hit_rate"] <= 1.0


def test_percentiles_empty_and_single_row_windows(port_index):
    data, _, tidx = port_index
    with ServePipeline(SearchExecutor.from_index(tidx, "inmem"), k=K, cfg=CFG,
                       max_batch=4) as pipe:
        ids, dists, st = pipe.drain()
        assert ids.shape == (0, K) and dists.shape == (0, K)
        assert st.queries == 0 and st.batches == 0
        assert st.p50_ms == 0.0 and st.p95_ms == 0.0
        assert st.qps == 0.0 and st.mean_recall is None
        pipe.submit(np.asarray(data[0], np.float32))
        _, _, st = pipe.drain()
        assert st.queries == 1 and st.p50_ms == st.p95_ms > 0.0 and np.isfinite(st.p50_ms)


def test_result_cache_hits_bit_identical_and_hit_only_window(port_index):
    data, _, tidx = port_index
    q = uniform_queries(data, 12, seed=98)
    with ServePipeline(tidx.executor("inmem"), k=K, cfg=SearchConfig(t=32, bloom_z=8192),
                       max_batch=8, result_cache_size=32) as pipe:
        pipe.submit(q)
        ids1, d1, s1 = pipe.drain()
        assert s1.result_cache_hits == 0 and s1.batches == 2
        pipe.submit(q)
        ids2, d2, s2 = pipe.drain()
        np.testing.assert_array_equal(ids2, ids1)
        np.testing.assert_array_equal(d2, d1)
        assert s2.result_cache_hits == s2.queries == 12 and s2.result_cache_hit_rate == 1.0
        assert s2.batches == 0 and 0.0 < s2.p50_ms <= s2.p95_ms
        q3 = np.concatenate([q[:6], uniform_queries(data, 6, seed=99)])
        pipe.submit(q3)
        ids3, _, s3 = pipe.drain()
        assert s3.result_cache_hits == 6
        np.testing.assert_array_equal(ids3[:6], ids1[:6])


def test_result_cache_lru_eviction_and_default_off(port_index):
    data, _, tidx = port_index
    cfg = SearchConfig(t=24, bloom_z=8192)
    qa = uniform_queries(data, 8, seed=100)
    with ServePipeline(tidx.executor("inmem"), k=K, cfg=cfg, max_batch=8,
                       result_cache_size=4) as pipe:
        pipe.submit(qa)
        pipe.drain()
        assert pipe.result_cache_len == 4
        pipe.submit(qa[-4:])
        assert pipe.drain()[2].result_cache_hits == 4
        pipe.submit(qa[:4])
        assert pipe.drain()[2].result_cache_hits == 0
    with ServePipeline(tidx.executor("inmem"), k=K, cfg=cfg, max_batch=8) as pipe:
        pipe.submit(qa)
        pipe.drain()
        pipe.submit(qa)
        assert pipe.drain()[2].result_cache_hits == 0 and pipe.result_cache_len == 0
    with pytest.raises(ValueError):
        ServePipeline(tidx.executor("inmem"), result_cache_size=-1)


def test_result_cache_scoped_to_mutation_epoch():
    ex = _StubExecutor(d=4)
    ex.mutation_epoch = 0
    q = np.ones((3, 4), np.float32)
    with ServePipeline(ex, k=2, max_batch=8, result_cache_size=8) as pipe:
        pipe.submit(q)
        pipe.drain()
        pipe.submit(q)
        assert pipe.drain()[2].result_cache_hits == 3
        ex.mutation_epoch = 1
        pipe.submit(q)
        assert pipe.drain()[2].result_cache_hits == 0


# ----------------------------------------------------- admission control
def test_submit_validates_shape_dtype_and_content():
    with ServePipeline(_StubExecutor(d=8), k=3, max_batch=4) as pipe:
        ok = np.zeros((2, 8), np.float32)
        for bad, err in ((np.zeros((2, 2, 2), np.float32), ValueError),
                         (np.array([["a"] * 8], dtype=object), TypeError),
                         (np.zeros((1, 8), np.complex64), TypeError),
                         (np.full((1, 8), np.nan, np.float32), ValueError),
                         (np.zeros((2, 7), np.float32), ValueError)):
            with pytest.raises(err):
                pipe.submit(bad)
        with pytest.raises(ValueError):
            pipe.submit(ok, gt_ids=np.zeros((3, 5), np.int32))
        with pytest.raises(TypeError):
            pipe.submit(ok, gt_ids=np.zeros((2, 5), np.float32))
        with pytest.raises(ValueError):
            pipe.submit(ok, deadline_s=-0.5)
        assert pipe.pending() == 0
        assert pipe.submit(np.zeros(8, np.float32), gt_ids=np.arange(3)) == 1
        assert pipe.submit(np.zeros((2, 8), np.int64)) == 2
        assert pipe.submit(np.zeros((2, 16), np.float64)[:, ::2]) == 2
        ids, _, stats = pipe.drain()
    assert ids.shape == (5, 3) and (ids >= 0).all()
    assert stats.queries == 5 and stats.shed_queries == 0


def test_bounded_queue_sheds_at_submit_and_counts_once():
    with ServePipeline(_StubExecutor(d=4), k=2, max_batch=8, max_queue=4) as pipe:
        q = np.zeros((3, 4), np.float32)
        assert pipe.submit(q) == 3 and pipe.submit(q) == 1 and pipe.submit(q) == 0
        assert pipe.pending() == 4
        ids, _, stats = pipe.drain()
        assert stats.queries == 4 and stats.shed_queries == 5 and (ids >= 0).all()
        pipe.submit(q)
        _, _, stats = pipe.drain()
        assert stats.shed_queries == 0 and stats.queries == 3


def test_deadlines_drop_expired_rows_at_dispatch():
    with ServePipeline(_StubExecutor(d=4), k=2, max_batch=8) as pipe:
        assert pipe.submit(np.ones((3, 4), np.float32), deadline_s=30.0) == 3
        assert pipe.submit(np.full((2, 4), 2.0, np.float32), deadline_s=1e-4) == 2
        time.sleep(0.01)
        ids, dists, stats = pipe.drain()
    assert stats.expired_queries == 2 and stats.queries == 5
    assert (ids[:3] >= 0).all() and (ids[3:] == -1).all() and np.isinf(dists[3:]).all()
    assert stats.qps * max(stats.wall_s - stats.compile_s, 1e-9) == pytest.approx(3.0, abs=1e-6)


@settings(max_examples=20, deadline=None)
@given(batches=st.lists(st.integers(0, 7), min_size=1, max_size=10), max_queue=st.integers(1, 9))
def test_shedding_is_at_most_once_property(batches, max_queue):
    """Offered = served + shed, exactly: nothing lost, nothing double-shed."""
    with ServePipeline(_StubExecutor(d=4), k=2, max_batch=3, max_queue=max_queue) as pipe:
        accepted = sum(pipe.submit(np.full((b, 4), i, np.float32)) for i, b in enumerate(batches))
        assert pipe.pending() == accepted <= max_queue
        ids, _, stats = pipe.drain()
    assert stats.queries == accepted and stats.shed_queries == sum(batches) - accepted
    assert ids.shape[0] == accepted and (ids >= 0).all() and stats.expired_queries == 0


def test_telemetry_spans_and_window(port_index):
    from repro_torch.runtime.telemetry import Telemetry, Tracer

    data, _, tidx = port_index
    tel = Telemetry(tracer=Tracer())
    ex = SearchExecutor.from_index(tidx, "base", hostio=FULL)
    with ServePipeline(ex, k=K, cfg=SearchConfig(t=16, bloom_z=8192), max_batch=4,
                       telemetry=tel) as pipe:
        pipe.submit(uniform_queries(data, 6, seed=4))
        _, _, st = pipe.drain()
    names = [e["name"] for e in tel.tracer.events()]
    assert names.count("request") == 6 and names.count("dispatch") == 2 and names.count("device") == 2
    assert st.telemetry["bang_serve_queries_total"]["value"] == 6.0
    assert tel.registry.counter("bang_hostio_requests_total").value == st.hostio["requests"] > 0
    assert isinstance(st, ServeStats)


def test_serve_ann_torch_example_runs_on_cpu(capsys):
    """examples/serve_ann_torch.py at a tiny n: BangIndex.build, then the
    pipeline over host-I/O base with every serving flag."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "serve_ann_torch.py"
    spec = importlib.util.spec_from_file_location("serve_ann_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    before = len(_dispatch_threads())
    out = mod.main(["--device", "cpu", "--n", "400", "--dim", "16", "--m", "4", "--R", "8",
                    "--L-build", "16", "--batches", "2", "--batch-size", "8", "--max-batch", "8",
                    "--variant", "base", "--host-workers", "2", "--hot-cache-rows", "32",
                    "--prefetch", "--result-cache", "16", "--max-queue", "64",
                    "--deadline-ms", "60000"])
    st = out["stats"]
    assert st.queries == 16 and st.batches == 2 and st.shed_queries == st.expired_queries == 0
    assert st.mean_recall is not None and st.mean_recall > 0.5
    assert st.hostio["prefetch_hits"] > 0 and st.hostio["prefetch_misses"] == 0
    text = capsys.readouterr().out
    assert "[serve] TOTAL 16 queries" in text and "host-I/O:" in text
    assert len(_dispatch_threads()) == before
    with pytest.raises(SystemExit):
        mod.main(["--device", "cpu", "--prefetch"])          # prefetch needs workers


def test_serve_ann_torch_example_mutate_and_autotune(capsys, tmp_path):
    """The example's --autotune (sweep, winners saved, then applied from
    the file alone) and --mutate (deletes and inserts before every batch, a
    background consolidation halfway) at a tiny n on the CPU."""
    import importlib.util
    import json
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "serve_ann_torch.py"
    spec = importlib.util.spec_from_file_location("serve_ann_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    before = len(_dispatch_threads())
    common = ["--device", "cpu", "--n", "400", "--dim", "16", "--m", "4", "--R", "8",
              "--L-build", "16", "--batch-size", "8", "--max-batch", "8", "--t", "16", "--k", "5"]
    cache = tmp_path / "winners.json"
    out = mod.main(common + ["--batches", "1", "--autotune", "--autotune-cache", str(cache)])
    (key,) = json.loads(cache.read_text())["winners"]
    assert key.startswith("cpu|bucket=8|R=8|m=4") and len(out["autotune"]) == 1
    # The saved file is applied without a sweep.
    out = mod.main(common + ["--batches", "1", "--autotune-cache", str(cache)])
    assert out["autotune"].winners == json.loads(cache.read_text())["winners"]
    out = mod.main(common + ["--batches", "4", "--mutate", "--result-cache", "16"])
    st = out["stats"]
    assert st.mutation is not None and st.queries == 8 and st.mean_recall > 0.5
    text = capsys.readouterr().out
    assert "winner cpu|bucket=8" in text and "background consolidation started" in text
    assert "[serve] TOTAL 32 queries" in text and "generation 1 (1 consolidation(s))" in text
    assert len(_dispatch_threads()) == before
    with pytest.raises(SystemExit):
        mod.main(["--device", "cpu", "--mutate", "--autotune"])
