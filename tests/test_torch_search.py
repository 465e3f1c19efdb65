"""The slice as a whole: the port's inmem search vs the reference's, on the
reference's own index converted with `repro_torch.convert`.

Ids must be bit-identical, `n_iters`/`n_hops` equal and the re-ranked
distances within rtol 1e-6, atol 1e-5 (the re-rank sums in another order
than the reference's Pallas kernel).
"""
import numpy as np
import pytest
import torch

from repro.core import SearchConfig as JSearchConfig
from repro.data import uniform_queries
from repro_torch.convert import index_from_reference
from repro_torch.core import SearchConfig, brute_force_knn, recall_at_k
from repro_torch.runtime import SearchExecutor

K = 5
INMEM_RECALL_FLOOR = 0.92   # tests/test_recall_regression.py RECALL_FLOORS["inmem"]


@pytest.fixture(scope="module")
def port_index(small_ann_index):
    data, idx = small_ann_index
    arrays = {
        "codebooks": np.asarray(idx.codec.codebooks),
        "codes": np.asarray(idx.codes),
        "adjacency": idx.graph.adjacency,
        "medoid": idx.graph.medoid,
        "data": idx.data_np,
    }
    return data, idx, index_from_reference(arrays, device="cpu")


@pytest.mark.parametrize("batch", [5, 12])      # -> buckets 8 and 16
@pytest.mark.parametrize("eager", [True, False])
def test_search_matches_reference_fused(port_index, batch, eager):
    data, idx, tidx = port_index
    queries = uniform_queries(data, batch, seed=100 + batch)
    jcfg = JSearchConfig(t=32, bloom_z=4096, eager=eager)
    jids, jd, jstats = idx.search(queries, K, cfg=jcfg, kernel_mode="fused", return_stats=True)
    jex = idx.executor("inmem")
    jh = jex.dispatch(queries, K, cfg=jcfg, kernel_mode="fused")
    jhops = np.asarray(jh.n_hops)[:batch]
    cfg = SearchConfig(t=32, bloom_z=4096, eager=eager)
    for mode in ("fused", "reference"):
        ids, d, stats = tidx.search(queries, K, cfg=cfg, kernel_mode=mode, return_stats=True)
        assert ids.device.type == "cpu" and ids.shape == (batch, K)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-5)
        assert stats.n_iters == jstats.n_iters
        h = tidx.executor("inmem").dispatch(queries, K, cfg=cfg, kernel_mode=mode)
        np.testing.assert_array_equal(h.n_hops[:batch].numpy(), jhops)
        assert h.n_iters == int(np.asarray(jh.n_iters))


def test_recall_floor_and_ground_truth(port_index):
    """The setup of tests/test_recall_regression.py, on the port."""
    data, _, tidx = port_index
    queries = uniform_queries(data, 32, seed=17)
    gt = brute_force_knn(data, queries, 10, device="cpu")
    from repro.core import brute_force_knn as jbrute_force_knn

    np.testing.assert_array_equal(gt, jbrute_force_knn(data, queries, 10))
    ids, _ = tidx.search(queries, 10, cfg=SearchConfig(t=64, bloom_z=8192), kernel_mode="fused")
    r = recall_at_k(ids.numpy(), gt)
    assert r >= INMEM_RECALL_FLOOR, f"recall@10 {r:.3f} < {INMEM_RECALL_FLOOR}"


def test_executor_builds_once_per_bucket_and_cfg(port_index):
    data, _, tidx = port_index
    ex = SearchExecutor.from_index(tidx)
    cfg = SearchConfig(t=16, bloom_z=4096)
    for B in (3, 5, 8):                       # one bucket: 8
        ex.search(uniform_queries(data, B, seed=B), K, cfg=cfg, kernel_mode="fused")
    assert ex.n_traces == 1 and ex.cache_size == 1
    ex.search(uniform_queries(data, 12, seed=1), K, cfg=cfg, kernel_mode="fused")  # bucket 16
    ex.search(uniform_queries(data, 4, seed=2), K, cfg=cfg, kernel_mode="reference")
    assert ex.n_traces == 3 and set(ex.trace_counts.values()) == {1}
    with pytest.raises(ValueError, match="kernel_mode"):
        ex.search(uniform_queries(data, 4, seed=2), K, cfg=cfg, kernel_mode="warp")
    with pytest.raises(NotImplementedError):
        ex.search(uniform_queries(data, 4, seed=2), K, cfg=cfg, kernel_mode="staged")
    with pytest.raises(NotImplementedError):
        tidx.executor("base")


def test_padded_lanes_do_not_change_real_lanes(port_index):
    data, _, tidx = port_index
    cfg = SearchConfig(t=16, bloom_z=4096)
    q = uniform_queries(data, 8, seed=9)
    full, _ = tidx.search(q, K, cfg=cfg, kernel_mode="fused")
    part, _ = tidx.search(q[:5], K, cfg=cfg, kernel_mode="fused")
    np.testing.assert_array_equal(part.numpy(), full[:5].numpy())
    assert torch.equal(tidx.search(q[:5], K, cfg=cfg, kernel_mode="fused")[0], part)
