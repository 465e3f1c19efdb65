"""The port's search vs the reference's executor, on the reference's own
index converted with `repro_torch.convert`: the inmem, base and exact
variants, in the fused and staged kernel modes.

Ids must be bit-identical and `n_iters`/`n_hops` equal. Distances are
compared within rtol 1e-6, atol 1e-5, the parity bound for float tables
(the fixture's PQ tables are not integer-valued), each against the
reference's distances in the same kernel mode: the reference re-ranks in
its Pallas kernel's order in the kernel modes and in XLA:CPU's in
"reference" mode, and the port follows each (ROADMAP C4); the exact
variant's distances follow XLA:CPU's order as probed (bit-equal on this
fixture).
"""
import numpy as np
import pytest
import torch

from repro.core import SearchConfig as JSearchConfig
from repro.data import uniform_queries
from repro_torch.convert import index_from_reference
from repro_torch.core import SearchConfig, brute_force_knn, recall_at_k
from repro_torch.runtime import SearchExecutor

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core

K = 5
# tests/test_recall_regression.py RECALL_FLOORS
RECALL_FLOORS = {"inmem": 0.92, "base": 0.92, "exact": 0.95}


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
    jd_by_mode = {"fused": jd, "reference": idx.search(queries, K, cfg=jcfg, kernel_mode="reference")[1]}
    jex = idx.executor("inmem")
    jh = jex.dispatch(queries, K, cfg=jcfg, kernel_mode="fused")
    jhops = np.asarray(jh.n_hops)[:batch]
    cfg = SearchConfig(t=32, bloom_z=4096, eager=eager)
    for mode in ("fused", "reference"):
        ids, d, stats = tidx.search(queries, K, cfg=cfg, kernel_mode=mode, return_stats=True)
        assert ids.device.type == "cpu" and ids.shape == (batch, K)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd_by_mode[mode]), rtol=1e-6, atol=1e-5)
        assert stats.n_iters == jstats.n_iters
        h = tidx.executor("inmem").dispatch(queries, K, cfg=cfg, kernel_mode=mode)
        np.testing.assert_array_equal(h.n_hops[:batch].numpy(), jhops)
        assert h.n_iters == int(np.asarray(jh.n_iters))


def _parity(port_index, variant, mode, batch, eager=True):
    """The port's and the reference's executors on the same queries."""
    data, idx, tidx = port_index
    queries = uniform_queries(data, batch, seed=100 + batch)
    jcfg = JSearchConfig(t=32, bloom_z=4096, eager=eager)
    jids, jd, jstats = idx.search(queries, K, cfg=jcfg, variant=variant, kernel_mode=mode,
                                  return_stats=True)
    jh = idx.executor(variant).dispatch(queries, K, cfg=jcfg, kernel_mode=mode)
    cfg = SearchConfig(t=32, bloom_z=4096, eager=eager)
    ids, d, stats = tidx.search(queries, K, cfg=cfg, variant=variant, kernel_mode=mode,
                                return_stats=True)
    assert ids.device.type == "cpu" and ids.shape == (batch, K)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-5)
    assert stats.n_iters == jstats.n_iters
    h = tidx.executor(variant).dispatch(queries, K, cfg=cfg, kernel_mode=mode)
    np.testing.assert_array_equal(h.n_hops[:batch].numpy(), np.asarray(jh.n_hops)[:batch])
    assert h.n_iters == int(np.asarray(jh.n_iters))
    return ids, d


@pytest.mark.parametrize("variant,mode,eager", [
    ("inmem", "staged", True),
    ("inmem", "staged", False),
    ("base", "fused", True),
    ("base", "staged", True),
    ("exact", "fused", True),
    ("exact", "fused", False),
    ("exact", "staged", True),
    ("exact", "reference", True),
])
def test_variants_and_modes_match_reference(port_index, variant, mode, eager):
    _parity(port_index, variant, mode, 12, eager)


def test_base_variant_identical_to_inmem(port_index):
    """As the reference's tests/test_search.py pins: moving the graph and
    the vectors to the host changes no id and no distance."""
    data, _, tidx = port_index
    q = uniform_queries(data, 12, seed=3)
    cfg = SearchConfig(t=32, bloom_z=4096)
    for mode in ("fused", "staged"):
        a = tidx.search(q, K, cfg=cfg, variant="base", kernel_mode=mode)
        b = tidx.search(q, K, cfg=cfg, variant="inmem", kernel_mode=mode)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_vectors_kept_on_the_host_only(port_index, small_ann_index):
    """`keep_device_data=False` (the reference's `data_dev=None`): inmem
    re-ranks from the host vectors with the same result; exact, which needs
    them on the device, is refused."""
    data, idx = small_ann_index
    arrays = {"codebooks": np.asarray(idx.codec.codebooks), "codes": np.asarray(idx.codes),
              "adjacency": idx.graph.adjacency, "medoid": idx.graph.medoid, "data": idx.data_np}
    host_only = index_from_reference(arrays, device="cpu", keep_device_data=False)
    assert host_only.data_dev is None
    q = uniform_queries(data, 8, seed=4)
    cfg = SearchConfig(t=16, bloom_z=4096)
    a = host_only.search(q, K, cfg=cfg, kernel_mode="fused")
    b = port_index[2].search(q, K, cfg=cfg, kernel_mode="fused")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="exact"):
        host_only.executor("exact")


def _recall(port_index, variant):
    data, _, tidx = port_index
    queries = uniform_queries(data, 32, seed=17)
    gt = brute_force_knn(data, queries, 10, device="cpu")
    ids, _ = tidx.search(queries, 10, cfg=SearchConfig(t=64, bloom_z=8192), variant=variant,
                         kernel_mode="fused")
    r = recall_at_k(ids.numpy(), gt)
    floor = RECALL_FLOORS[variant]
    assert r >= floor, f"recall@10 of {variant} {r:.3f} < {floor}"
    return data, queries, gt


def test_recall_floor_and_ground_truth(port_index):
    """The setup of tests/test_recall_regression.py, on the port."""
    data, queries, gt = _recall(port_index, "inmem")
    from repro.core import brute_force_knn as jbrute_force_knn

    np.testing.assert_array_equal(gt, jbrute_force_knn(data, queries, 10))


@pytest.mark.parametrize("variant", ["base", "exact"])
def test_recall_floor_base_and_exact(port_index, variant):
    _recall(port_index, variant)


def test_kernel_mode_resolves_by_device(port_index):
    """No kernel_mode: "fused" for a search on a CUDA device, "reference" on
    the CPU; an explicit mode wins. The executor resolves it before the
    cache key is formed."""
    cfg = SearchConfig()
    assert cfg.resolved_kernel_mode(torch.device("cuda")) == "fused"
    assert cfg.resolved_kernel_mode("cuda:0") == "fused"
    assert cfg.resolved_kernel_mode("cpu") == "reference"
    assert SearchConfig(kernel_mode="staged").resolved_kernel_mode("cuda") == "staged"
    with pytest.raises(ValueError, match="kernel_mode"):
        SearchConfig(kernel_mode="warp").resolved_kernel_mode("cpu")
    assert not hasattr(cfg, "use_kernels")
    data, _, tidx = port_index
    ex = SearchExecutor.from_index(tidx)
    q = uniform_queries(data, 8, seed=5)
    ids, _ = ex.search(q, K, cfg=SearchConfig(t=16, bloom_z=4096))
    (key,) = ex.trace_counts
    assert key[4].kernel_mode == "reference"
    ref, _ = ex.search(q, K, cfg=SearchConfig(t=16, bloom_z=4096), kernel_mode="reference")
    assert torch.equal(ids, ref) and ex.n_traces == 1


def test_host_neighbor_fn_rows_and_link_bytes(port_index):
    """Base's neighbour source: the adjacency rows of the frontier, -1 rows
    for inactive lanes, None once no lane is active; (B + B*R)*4 bytes cross
    the link per hop (the frontier down, the rows up)."""
    from repro_torch.core.search import host_neighbor_fn
    from repro_torch.core.worklist import INVALID_ID

    _, idx, tidx = port_index
    adj = tidx.graph.adjacency
    fn = host_neighbor_fn(adj, "cpu")
    u = torch.tensor([3, INVALID_ID, 0, 7], dtype=torch.int32)
    active = torch.tensor([True, False, True, True])
    rows = fn.fetch(u, active)
    np.testing.assert_array_equal(rows[[0, 2, 3]].numpy(), np.asarray(idx.graph.adjacency)[[3, 0, 7]])
    assert (rows[1] == -1).all()
    assert fn.fetch(u, torch.zeros(4, dtype=torch.bool)) is None
    assert fn.rows.bytes_sent == rows.numel() * 4               # rows up, once
    assert fn.frontier_bytes == 2 * u.numel() * 4               # the frontier down, per fetch


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
    ex.search(uniform_queries(data, 4, seed=2), K, cfg=cfg, kernel_mode="staged")
    assert ex.n_traces == 4 and set(ex.trace_counts.values()) == {1}
    for variant in ("base", "exact"):
        assert tidx.executor(variant).variant == variant
    with pytest.raises(ValueError, match="variant"):
        tidx.executor("sharded-exact")


def test_padded_lanes_do_not_change_real_lanes(port_index):
    data, _, tidx = port_index
    cfg = SearchConfig(t=16, bloom_z=4096)
    q = uniform_queries(data, 8, seed=9)
    full, _ = tidx.search(q, K, cfg=cfg, kernel_mode="fused")
    part, _ = tidx.search(q[:5], K, cfg=cfg, kernel_mode="fused")
    np.testing.assert_array_equal(part.numpy(), full[:5].numpy())
    assert torch.equal(tidx.search(q[:5], K, cfg=cfg, kernel_mode="fused")[0], part)
