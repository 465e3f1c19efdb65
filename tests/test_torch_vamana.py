"""Port vs reference: the index build -- Vamana graph, k-means, PQ error,
the merge-path oracle and `BangIndex.build` -- on the same numpy inputs.

Graphs are compared bit for bit (tolerance 0): the port's build makes the
reference's decisions with other bookkeeping. The reference graph on the
fixture's data is the session fixture's; no second reference build of it
runs here.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BangIndex as JBangIndex
from repro.core import kmeans as jkm
from repro.core import pq as jpq
from repro.core import vamana as jv
from repro.core import worklist as jwl
from repro.data import gaussian_mixture, uniform_queries
from repro_torch import BangIndex, SearchConfig, brute_force_knn, recall_at_k
from repro_torch.core import kmeans as tkm
from repro_torch.core import pq as tpq
from repro_torch.core import vamana as tv
from repro_torch.core import worklist as twl

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core

K = 10
# tests/test_recall_regression.py's floors for the single-device variants.
RECALL_FLOORS = {"inmem": 0.92, "base": 0.92, "exact": 0.95}


@pytest.fixture(scope="module")
def port_index(small_ann_index):
    """The port's index over the fixture's data, with its parameters."""
    data, _ = small_ann_index
    return BangIndex.build(data, m=8, R=16, L_build=24, kmeans_iters=6, device="cpu")


def _d128():
    return gaussian_mixture(300, 128, n_clusters=8, seed=7)


# ------------------------------------------------------------------ graph
def test_build_graph_matches_reference_on_fixture(small_ann_index, port_index):
    _, ref = small_ann_index
    g = port_index.graph
    assert g.adjacency.dtype == torch.int32 and g.adjacency.device.type == "cpu"
    np.testing.assert_array_equal(g.adjacency.numpy(), ref.graph.adjacency)
    assert g.medoid == ref.graph.medoid
    assert (g.n, g.R) == (ref.graph.n, ref.graph.R)
    assert g.degree_stats() == ref.graph.degree_stats()


@pytest.mark.parametrize("two_pass", [True, False])
def test_build_vamana_matches_reference_d128(two_pass):
    data = _d128()
    ref = jv.build_vamana(data, R=32, L=64, alpha=1.2, seed=1, two_pass=two_pass)
    out = tv.build_vamana(data, R=32, L=64, alpha=1.2, seed=1, two_pass=two_pass)
    np.testing.assert_array_equal(out.adjacency.numpy(), ref.adjacency)
    assert out.medoid == ref.medoid
    assert out.degree_stats() == ref.degree_stats()


def test_build_vamana_refuses_non_finite_data():
    data = _d128()[:40].copy()
    data[3, 5] = np.nan
    with pytest.raises(ValueError, match="finite"):
        tv.build_vamana(data, R=8, L=16)


@pytest.mark.parametrize("alpha,R", [(1.0, 6), (1.2, 8), (1.2, 60), (2.0, 4)])
def test_robust_prune_matches_reference(alpha, R):
    rng = np.random.default_rng(40 + R)
    data = rng.standard_normal((80, 12)).astype(np.float32)
    # Candidates with duplicates and p itself among them.
    cand = np.concatenate([rng.integers(0, 80, 50), [3, 3, 17]]).astype(np.int32)
    d = np.einsum("nd,nd->n", data[cand] - data[3], data[cand] - data[3])
    np.testing.assert_array_equal(
        tv.robust_prune(data, 3, cand, d, alpha, R), jv.robust_prune(data, 3, cand, d, alpha, R)
    )


@pytest.mark.parametrize("start,L", [(0, 8), (5, 24), (311, 40)])
def test_greedy_search_matches_reference(small_ann_index, start, L):
    data, ref = small_ann_index
    adj = ref.graph.adjacency
    rng = np.random.default_rng(start)
    for q in (data[start + 7] + 0.01, rng.standard_normal(data.shape[1]).astype(np.float32)):
        ids, ds = tv.greedy_search(data, torch.from_numpy(adj), start, q, L)
        rids, rds = jv.greedy_search(data, adj, start, q, L)
        np.testing.assert_array_equal(ids, rids)
        np.testing.assert_array_equal(ds, rds)
        assert ds.dtype == np.float32 and ids.dtype == np.int32


def test_greedy_search_with_duplicate_neighbours_matches_reference():
    """Rows holding an id twice (as the random initial graph does): both
    copies join the worklist in the reference, and here."""
    rng = np.random.default_rng(9)
    data = rng.standard_normal((60, 6)).astype(np.float32)
    adj = rng.integers(0, 60, (60, 10)).astype(np.int32)
    adj[:, 1] = adj[:, 0]
    adj[::7, 9] = -1
    for L in (4, 12):
        out = tv.greedy_search(data, adj, 2, data[40], L)
        ref = jv.greedy_search(data, adj, 2, data[40], L)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)


def test_find_medoid_and_fully_connected_match_reference(small_ann_index):
    data, _ = small_ann_index
    for x in (data, _d128(), np.random.default_rng(1).standard_normal((200, 8)).astype(np.float32)):
        assert tv.find_medoid(x) == jv.find_medoid(x)
    for n in (2, 6, 17):
        g, r = tv.build_fully_connected(n), jv.build_fully_connected(n)
        np.testing.assert_array_equal(g.adjacency.numpy(), r.adjacency)
        assert g.medoid == r.medoid


# -------------------------------------------------------- k-means and PQ
@pytest.mark.parametrize("n,d,k,iters", [(500, 8, 16, 5), (300, 4, 32, 3), (1000, 16, 64, 4)])
def test_kmeans_matches_reference(n, d, k, iters):
    x = gaussian_mixture(n, d, n_clusters=6, seed=n)
    rc, ra = jkm.kmeans(jnp.asarray(x), k, iters)
    c, a = tkm.kmeans(torch.from_numpy(x), k, iters)
    assert c.shape == (k, d) and a.shape == (n,)
    np.testing.assert_allclose(c.numpy(), np.asarray(rc), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ra))


def test_kmeans_with_a_generator_is_seeded():
    x = torch.from_numpy(gaussian_mixture(200, 4, n_clusters=5, seed=2))
    runs = [tkm.kmeans(x, 8, 3, generator=torch.Generator().manual_seed(5)) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    c, a = tkm.kmeans(x[:5], 8, 2, generator=torch.Generator().manual_seed(5))   # n < k
    assert c.shape == (8, 4) and bool(torch.isfinite(c).all()) and int(a.max()) < 8


def test_quantization_error_matches_reference():
    rng = np.random.default_rng(31)
    cb = rng.standard_normal((8, 256, 4)).astype(np.float32)
    x = rng.standard_normal((700, 30)).astype(np.float32)   # d padded to 32
    ref = jpq.quantization_error(jpq.PQCodec(jnp.asarray(cb)), jnp.asarray(x))
    out = tpq.quantization_error(tpq.PQCodec(torch.from_numpy(cb)), torch.from_numpy(x))
    assert isinstance(out, float)
    np.testing.assert_allclose(out, ref, rtol=1e-5)


@pytest.mark.parametrize("B,n1,n2", [(1, 1, 1), (3, 16, 9), (4, 64, 64), (2, 5, 40)])
def test_merge_path_reference_matches_reference(B, n1, n2):
    """Integer-valued distances, so ties on distance are many and broken by
    id (no subnormals: ROADMAP C1)."""
    rng = np.random.default_rng(B * 100 + n1)

    def sorted_list(n):
        d = rng.integers(0, 8, (B, n)).astype(np.float32)
        i = rng.integers(0, 50, (B, n)).astype(np.int32)
        order = np.lexsort((i, d), axis=-1)
        return np.take_along_axis(d, order, -1), np.take_along_axis(i, order, -1)

    (d1, i1), (d2, i2) = sorted_list(n1), sorted_list(n2)
    d1[:, -1], i1[:, -1] = np.inf, 2**31 - 1          # a padding slot
    rd, ri = jwl.merge_path_reference(*(jnp.asarray(a) for a in (d1, i1, d2, i2)))
    od, oi = twl.merge_path_reference(*(torch.from_numpy(a) for a in (d1, i1, d2, i2)))
    np.testing.assert_array_equal(od.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(oi.numpy(), np.asarray(ri))


# ------------------------------------------------------------ BangIndex.build
def test_build_signature_is_the_references_plus_device():
    ref = inspect.signature(JBangIndex.build).parameters
    out = inspect.signature(BangIndex.build).parameters
    assert list(out) == [*ref, "device"]
    assert all(out[p].default == ref[p].default for p in ref if p != "data")
    assert out["device"].default == "cuda"


def test_build_pq_matches_reference(small_ann_index, port_index):
    data, ref = small_ann_index
    np.testing.assert_allclose(port_index.codec.codebooks.numpy(), np.asarray(ref.codec.codebooks),
                               rtol=1e-4, atol=1e-5)
    # The codes are exactly the port's own encoding; against the
    # reference's codes they may differ on near-ties of the codebooks.
    codes = port_index.codes
    assert torch.equal(codes, tpq.pq_encode(port_index.codec, torch.from_numpy(data)))
    differ = float((codes.numpy() != np.asarray(ref.codes)).mean())
    assert differ < 0.01, f"{differ:.4%} of the code entries differ from the reference's"
    assert torch.equal(port_index.data_host, torch.from_numpy(data))
    assert port_index.data_dev is not None and port_index.device.type == "cpu"


@pytest.mark.parametrize("variant", sorted(RECALL_FLOORS))
def test_built_index_clears_recall_floors(small_ann_index, port_index, variant):
    data, _ = small_ann_index
    queries = uniform_queries(data, 32, seed=17)
    gt = brute_force_knn(data, queries, K, device="cpu")
    ids, _ = port_index.search(queries, K, variant=variant, cfg=SearchConfig(t=64, bloom_z=8192))
    r = recall_at_k(ids.numpy(), gt)
    assert r >= RECALL_FLOORS[variant], f"recall@{K} {r:.3f} < {RECALL_FLOORS[variant]} ({variant})"


def test_build_takes_a_graph_and_keeps_data_off_the_device(port_index):
    data = port_index.data_host.numpy()
    idx = BangIndex.build(data, m=8, kmeans_iters=2, graph=port_index.graph, keep_device_data=False,
                          device="cpu")
    assert torch.equal(idx.graph.adjacency, port_index.graph.adjacency)
    assert idx.graph.medoid == port_index.graph.medoid and idx.data_dev is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            BangIndex.build(data, m=8, graph=port_index.graph)
