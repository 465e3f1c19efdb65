"""The port's mesh-sharded search vs the reference's, on the CPU.

Inputs are made by numpy from a seed and handed to both packages. Held
here:

  * ownership (`_owned_at`) and the host shard service against the
    reference's functions, and the exactly-once property;
  * the plain versions of K7 (owner-shard ADC) and K8 (PQ distance table)
    against the Pallas kernels in interpret mode;
  * the sharded re-rank distances against the reference's
    `sharded_exact_dists` inside `shard_map`;
  * the executor, "sharded" and "sharded-base" in the three kernel modes, on
    a one-rank gloo group in this process against the reference's
    `ShardedSearchExecutor` at its (1, 1) mesh, and on 2 and 4 gloo ranks in
    subprocesses against the reference's single-device executor.

Ids, `n_iters` and `n_hops` must be bit-exact; distances are held to
rtol 1e-6, atol 1e-5 (ROADMAP C4). The process group is global state: the
in-process one is made once for this module and destroyed after it, and
every other test file keeps out of torch.distributed.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.compat import make_mesh as jmake_mesh, shard_map
from repro.core import SearchConfig as JSearchConfig
from repro.core import distributed as jdist
from repro.data import uniform_queries
from repro.runtime import ShardedSearchExecutor as JShardedSearchExecutor
from repro_torch.convert import index_from_reference
from repro_torch.core import SearchConfig
from repro_torch.core import distributed as tdist
from repro_torch.core.worklist import INVALID_ID
from repro_torch.distributed import make_mesh
from repro_torch.kernels.pq_table import ops as table_ops
from repro_torch.kernels.search_step import ops as step_ops
from repro_torch.runtime import SHARDED_VARIANTS, ServePipeline, ShardedSearchExecutor
from repro_torch.runtime.hostio import HostIOConfig

SRC = Path(__file__).resolve().parents[1] / "src"
K = 5
RTOL, ATOL = 1e-6, 1e-5
MODES = ("reference", "staged", "fused")


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo group in this process, made for this module and
    destroyed after it."""
    made = not dist.is_initialized()
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    yield mesh
    if made and dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def port_index(small_ann_index):
    data, idx = small_ann_index
    arrays = _arrays(idx)
    return data, idx, arrays, index_from_reference(arrays, device="cpu")


def _arrays(idx) -> dict:
    return {"codebooks": np.asarray(idx.codec.codebooks), "codes": np.asarray(idx.codes),
            "adjacency": np.asarray(idx.graph.adjacency), "medoid": idx.graph.medoid,
            "data": np.asarray(idx.data_np)}


def _draw_ids(rng, S, local_n, size=40):
    """Ids across [-n-7, 2n+7), a fifth of them INVALID."""
    n_total = S * local_n
    ids = rng.integers(-n_total - 7, 2 * n_total + 7, size).astype(np.int32)
    ids[rng.random(size) < 0.2] = INVALID_ID
    return ids


# ------------------------------------------------------------- ownership
@pytest.mark.parametrize("S,local_n", [(1, 1), (3, 7), (8, 64), (5, 13)])
def test_owned_at_matches_reference_and_owns_once(S, local_n):
    rng = np.random.default_rng(S * 100 + local_n)
    ids = _draw_ids(rng, S, local_n)
    owners = np.zeros(len(ids), np.int64)
    for s in range(S):
        rel, own = (x.numpy() for x in tdist._owned_at(s, local_n, torch.from_numpy(ids)))
        jrel, jown = (np.asarray(x) for x in jdist._owned_at(s, local_n, jnp.asarray(ids)))
        np.testing.assert_array_equal(rel, jrel)
        np.testing.assert_array_equal(own, jown)
        assert rel.min() >= 0 and rel.max() < local_n
        np.testing.assert_array_equal(rel[own] + s * local_n, ids[own])
        owners += own
    in_range = (ids >= 0) & (ids < S * local_n) & (ids != INVALID_ID)
    np.testing.assert_array_equal(owners, in_range.astype(np.int64))


@pytest.mark.parametrize("S,local_n,R", [(1, 5, 3), (4, 16, 8), (7, 3, 1)])
def test_host_shard_service_matches_reference(S, local_n, R):
    """Each shard's contribution equals the reference's; only owned lanes
    read the partition, and the sum over shards rebuilds the unsharded
    gather (-1 for every id nobody owns)."""
    rng = np.random.default_rng(S + local_n + R)
    n_total = S * local_n
    adjacency = (np.arange(n_total * R) % (n_total + 1) - 1).astype(np.int32).reshape(n_total, R)
    ids = _draw_ids(rng, S, local_n)
    total = np.zeros((len(ids), R), np.int64)
    for s in range(S):
        part = adjacency[s * local_n : (s + 1) * local_n]
        rel, own = tdist._owned_at(s, local_n, torch.from_numpy(ids))
        out = tdist.host_shard_service(torch.from_numpy(part), rel, own).numpy()
        ref = jdist.host_shard_service(part, rel.numpy(), own.numpy())
        np.testing.assert_array_equal(out, ref)
        assert out[~own.numpy()].sum() == 0
        total += out
    in_range = (ids >= 0) & (ids < n_total) & (ids != INVALID_ID)
    expect = np.where(in_range[:, None], adjacency[np.clip(ids, 0, n_total - 1)], -1)
    np.testing.assert_array_equal(total - 1, expect)


# ---------------------------------------------------------- K7, K8 (CPU)
@pytest.mark.parametrize("tile_rows", [8, 32, 100])
def test_local_adc_ref_matches_pallas(tile_rows):
    """tests/test_kernels.py:344's shapes and draws: integer tables, so the
    sums are exact and the comparison bitwise."""
    from repro.kernels.search_step.search_step import local_adc_dma_pallas, local_adc_pallas

    rng = np.random.default_rng(tile_rows)
    B, R, m, n_loc = 5, 13, 9, 120
    table = rng.integers(0, 1000, (B, m, 256)).astype(np.float32)
    codes = rng.integers(0, 256, (n_loc, m)).astype(np.uint8)
    rel = rng.integers(0, n_loc, (B, R)).astype(np.int32)
    own = rng.random((B, R)) > 0.4
    t = [torch.from_numpy(x) for x in (table, codes, rel, own)]
    out = step_ops.local_adc(*t, tile_rows=tile_rows).numpy()
    np.testing.assert_array_equal(out, step_ops.local_adc(*t).numpy())
    j = [jnp.asarray(x) for x in (table, codes, rel, own)]
    np.testing.assert_array_equal(out, np.asarray(local_adc_pallas(*j, interpret=True)))
    np.testing.assert_array_equal(
        out, np.asarray(local_adc_dma_pallas(*j, tile_rows=tile_rows, interpret=True)))
    assert (out[~own] == 0.0).all()
    with pytest.raises(ValueError, match="tile_rows"):
        step_ops.local_adc(*t, tile_rows=-1)


@pytest.mark.parametrize("B,m,dsub", [(1, 1, 4), (7, 6, 11), (13, 8, 16), (4, 74, 2)])
def test_dist_table_ref_matches_pallas(B, m, dsub):
    """tests/test_kernels.py:39's shapes, within the reference's own bound
    for its kernel (the formula cancels near a centroid)."""
    from repro.core.pq import PQCodec as JPQCodec
    from repro.kernels.pq_table import ops as jtable_ops
    from repro.kernels.pq_table.pq_table import dist_table_pallas
    from repro_torch.core.pq import PQCodec

    rng = np.random.default_rng(B * 10 + m)
    cb = rng.standard_normal((m, 256, dsub)).astype(np.float32)
    q = rng.standard_normal((B, m * dsub)).astype(np.float32)
    out = table_ops.build_dist_table(PQCodec(torch.from_numpy(cb)), torch.from_numpy(q)).numpy()
    assert out.shape == (B, m, 256)
    np.testing.assert_array_equal(
        out, table_ops.dist_table_ref(torch.from_numpy(q.reshape(B, m, dsub)), torch.from_numpy(cb)).numpy())
    for ref in (dist_table_pallas(jnp.asarray(q.reshape(B, m, dsub)), jnp.asarray(cb), interpret=True),
                jtable_ops.build_dist_table(JPQCodec(jnp.asarray(cb)), jnp.asarray(q)),
                jtable_ops.dist_table_ref(jnp.asarray(q.reshape(B, m, dsub)), jnp.asarray(cb))):
        np.testing.assert_allclose(out, np.asarray(ref), rtol=2e-4, atol=2e-4)


# --------------------------------------------------- sharded re-rank (CPU)
@pytest.mark.parametrize("B,C,d,bitwise", [
    (16, 56, 32, True), (8, 56, 32, True), (4, 56, 32, True),   # the fixture's d and C
    (5, 7, 32, False), (16, 104, 128, False), (12, 20, 37, False),
])
def test_sharded_exact_dists_match_reference(one_rank, B, C, d, bitwise):
    """On the CPU the port sums ||q||^2 + ||v||^2 - 2<v,q> in XLA:CPU's
    order as probed (ROADMAP C5, C6): bit-equal at the fixture's d = 32,
    C = 56; elsewhere XLA picks other orders, held within the bound."""
    rng = np.random.default_rng(B + C + d)
    n = 300
    x = (rng.standard_normal((n, d)) * 3).astype(np.float32)
    q = (rng.standard_normal((B, d)) * 3).astype(np.float32)
    ids = rng.integers(0, n, (B, C)).astype(np.int32)
    ids[:, -3:] = INVALID_ID
    jm = jmake_mesh((1, 1), ("data", "model"))
    f = jax.jit(shard_map(lambda a, b, c: jdist.sharded_exact_dists(a, b, c, "model"), mesh=jm,
                          in_specs=(P(), P("model", None), P()), out_specs=P(), check_rep=False))
    ref = np.asarray(f(jnp.asarray(q), jnp.asarray(x), jnp.asarray(ids)))
    out = tdist.sharded_exact_dists(torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(ids),
                                    one_rank.group("model")).numpy()
    assert np.isinf(out[:, -3:]).all() and np.isinf(ref[:, -3:]).all()
    if bitwise:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out[:, :-3], ref[:, :-3], rtol=RTOL, atol=ATOL)


# ------------------------------------------------- executor, one rank
def _reference_run(jex, queries, mode, jcfg):
    ids, d, stats = jex.search(queries, K, cfg=jcfg, kernel_mode=mode, return_stats=True)
    h = jex.dispatch(queries, K, cfg=jcfg, kernel_mode=mode)
    return np.asarray(ids), np.asarray(d), stats.n_iters, np.asarray(h.n_hops)[: len(queries)]


@pytest.mark.parametrize("variant", SHARDED_VARIANTS)
@pytest.mark.parametrize("mode", MODES)
def test_sharded_matches_reference_executor(one_rank, port_index, variant, mode):
    data, idx, _, tidx = port_index
    queries = uniform_queries(data, 12, seed=70)
    jex = JShardedSearchExecutor.from_index(idx, jmake_mesh((1, 1), ("data", "model")), variant=variant)
    jids, jd, jiters, jhops = _reference_run(jex, queries, mode, JSearchConfig(t=32, bloom_z=4096))
    cfg = SearchConfig(t=32, bloom_z=4096)
    ids, d, stats = tidx.search(queries, K, cfg=cfg, variant=variant, mesh=one_rank,
                                kernel_mode=mode, return_stats=True)
    assert ids.dtype == torch.int32 and ids.shape == (12, K)
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_allclose(d.numpy(), jd, rtol=RTOL, atol=ATOL)
    assert stats.n_iters == jiters
    h = tidx.executor(variant, mesh=one_rank).dispatch(queries, K, cfg=cfg, kernel_mode=mode)
    np.testing.assert_array_equal(h.n_hops[:12].numpy(), jhops)
    # The sharded path launches the owner-shard ADC in the fused mode only.
    assert isinstance(tidx.executor(variant, mesh=one_rank), ShardedSearchExecutor)


def test_index_search_routes_and_caches_sharded_executors(one_rank, port_index):
    data, _, _, tidx = port_index
    q = uniform_queries(data, 9, seed=71)
    cfg = SearchConfig(t=16, bloom_z=4096)
    ex = tidx.executor("sharded", mesh=one_rank)
    assert tidx.executor("sharded") is ex                     # the default mesh is (1, 1) here
    assert tidx.executor("sharded-base", mesh=one_rank) is not ex
    a, da = tidx.search(q, K, cfg=cfg, variant="sharded", mesh=one_rank)
    b, db = ex.search(q, K, cfg=cfg)
    assert torch.equal(a, b) and torch.equal(da, db)
    c, _ = tidx.search(q, K, cfg=cfg, variant="sharded-base")
    assert torch.equal(a, c)
    # The mesh search as a function of this rank's state, as the reference's
    # make_sharded_search builds it.
    fn = tdist.make_sharded_search(one_rank, tidx.graph.medoid, K, cfg)
    f_ids, f_d = fn(torch.from_numpy(q), tidx.codec.codebooks, tidx.codes, tidx.graph.adjacency,
                    tidx.data_host)
    assert torch.equal(f_ids, a) and torch.equal(f_d, da)
    with pytest.raises(ValueError, match="mesh"):
        tidx.executor("inmem", mesh=one_rank)
    with pytest.raises(ValueError, match="mesh"):
        tidx.search(q, K, variant="base", mesh=one_rank)


def test_sharded_compile_cache_and_buckets(one_rank, port_index):
    data, idx, arrays, _ = port_index
    tidx = index_from_reference(arrays, device="cpu")
    ex = ShardedSearchExecutor.from_index(tidx, one_rank)
    cfg = SearchConfig(t=16, bloom_z=4096)
    assert ex.n_traces == 0
    _, _, s1 = ex.search(uniform_queries(data, 12, seed=1), K, cfg=cfg, return_stats=True)
    _, _, s2 = ex.search(uniform_queries(data, 15, seed=2), K, cfg=cfg, return_stats=True)
    assert ex.n_traces == 1 and ex.cache_size == 1 and s2.compile_s == 0.0
    assert s1.bucket == s2.bucket == 16 and s1.batch == 12
    ex.search(uniform_queries(data, 20, seed=3), K, cfg=cfg)             # bucket 32
    ex.search(uniform_queries(data, 12, seed=1), K, cfg=SearchConfig(t=24, bloom_z=4096))
    assert ex.n_traces == 3 and set(ex.trace_counts.values()) == {1}
    for b in (1, 3, 8, 11, 17, 64):
        assert ex._bucket_for(b) >= b and ex._bucket_for(b) % ex.n_data_shards == 0
    assert ex.autotune_shape() == (idx.graph.adjacency.shape[1], idx.codes.shape[1], idx.codes.shape[0])


@pytest.mark.parametrize("variant", SHARDED_VARIANTS)
def test_sharded_set_telemetry_changes_no_key_and_no_result(one_rank, port_index, variant):
    """The mesh executor inherits the telemetry seams: the build is counted
    and traced, the dispatch stamped with the per-shard codes block, and
    keys, build counts and results stay those of a detached executor."""
    from repro_torch.runtime.telemetry import Telemetry

    data, idx, arrays, _ = port_index
    tidx = index_from_reference(arrays, device="cpu")
    q = uniform_queries(data, 6, seed=5)
    cfg = SearchConfig(t=16, bloom_z=4096)
    off = ShardedSearchExecutor.from_index(tidx, one_rank, variant=variant)
    on = ShardedSearchExecutor.from_index(tidx, one_rank, variant=variant)
    tel = Telemetry.create(trace=True, profile=True)
    assert off.telemetry is None and on.set_telemetry(tel) is on
    ids_off, d_off = off.search(q, K, cfg=cfg, kernel_mode="fused")
    ids_on, d_on = on.search(q, K, cfg=cfg, kernel_mode="fused")
    assert torch.equal(ids_on, ids_off) and torch.equal(d_on, d_off)
    assert list(on._cache) == list(off._cache) and on.trace_counts == off.trace_counts
    assert tel.registry.counter("bang_serve_compile_seconds_total").value > 0
    assert [e["args"]["kernel_mode"] for e in tel.tracer.events() if e["name"] == "compile"] == ["fused"]
    R, m, n_block = on.autotune_shape()
    assert tel.profiler.summary()["kernel_info"] == {
        "kernel_mode": "fused", "batch": 8, "n": n_block, "m": m, "R": R, "tile_rows": 0}


def test_sharded_base_link_bytes_and_exchange_accounting(one_rank, port_index):
    """Sharded base on one rank: the frontier down and the rows up,
    (B + B*R)*4 bytes a hop, equal to `exchange_bytes_per_hop`; ids and
    hops equal the single-device base variant's."""
    data, idx, arrays, _ = port_index
    tidx = index_from_reference(arrays, device="cpu")
    q = uniform_queries(data, 16, seed=72)
    cfg = SearchConfig(t=32, bloom_z=4096)
    ex = tidx.executor("sharded-base", mesh=one_rank)
    ids, _, stats = ex.search(q, K, cfg=cfg, kernel_mode="fused", return_stats=True)
    base_ids, _, base_stats = tidx.search(q, K, cfg=cfg, variant="base", kernel_mode="fused",
                                          return_stats=True)
    assert torch.equal(ids, base_ids) and stats.n_iters == base_stats.n_iters
    nbr = ex.neighbors
    R = idx.graph.adjacency.shape[1]
    assert nbr.rows.bytes_sent == stats.n_iters * 16 * R * 4
    x = ex.exchange_bytes_per_hop(16)
    assert x["host_link_bytes"] == (16 + 16 * R) * 4 == x["host_ids_out_bytes"] + x["host_rows_in_bytes"]
    assert x["payload_bytes"] == x["collective_bytes"] == 16 * R * 8
    assert x["ring_bytes_per_device"] == 0 and x["model_shards"] == x["data_shards"] == 1
    assert x["hot_cache_rows"] == x["host_bytes_saved_per_hop"] == 0
    assert tidx.executor("sharded", mesh=one_rank).exchange_bytes_per_hop(16)["host_link_bytes"] == 0


def test_unsupported_options_raise(one_rank, port_index):
    data, _, _, tidx = port_index
    # sharded-base takes hostio= (the host-I/O service of this rank's block).
    ex = ShardedSearchExecutor.from_index(tidx, one_rank, variant="sharded-base",
                                          hostio=HostIOConfig(workers=2))
    try:
        q = uniform_queries(data, 6, seed=76)
        cfg = SearchConfig(t=16, bloom_z=4096)
        a, da = ex.search(q, K, cfg=cfg)
        b, db = tidx.search(q, K, cfg=cfg, variant="sharded-base", mesh=one_rank)
        assert torch.equal(a, b) and torch.equal(da, db)
        assert ex.hostio_service.stats()["requests"] > 0
    finally:
        ex.hostio_runtime.stop()
    with pytest.raises(ValueError, match="hostio"):
        ShardedSearchExecutor.from_index(tidx, one_rank, variant="sharded", hostio=HostIOConfig())
    with pytest.raises(ValueError, match="hostio"):
        tidx.executor("sharded", mesh=one_rank, hostio=HostIOConfig())
    with pytest.raises(NotImplementedError, match="mutability slice"):
        ShardedSearchExecutor.from_index(tidx, one_rank, with_tombstones=True)
    with pytest.raises(ValueError, match="variant"):
        ShardedSearchExecutor.from_index(tidx, one_rank, variant="sharded-exact")
    with pytest.raises(ValueError, match="ranks"):
        make_mesh((1, 2), ("data", "model"), "cpu")
    assert make_mesh((1, 1), ("data", "model"), "cpu") is one_rank


@pytest.mark.parametrize("mode", ["reference", "fused"])
def test_sharded_base_hostio_bit_exact(one_rank, port_index, mode):
    """sharded-base with the host-I/O service (worker pool, replicated hot
    cache, prefetched exchange) on the one-rank gloo group equals
    sharded-base without it, ids and distances, and its ids equal the
    reference executor's with the same config."""
    from repro.runtime.hostio import HostIOConfig as JHostIOConfig

    data, idx, _, tidx = port_index
    q = uniform_queries(data, 16, seed=77)
    cfg = SearchConfig(t=32, bloom_z=4096)
    ex = tidx.executor("sharded-base", mesh=one_rank,
                       hostio=HostIOConfig(workers=2, hot_cache_rows=64, prefetch=True))
    try:
        ids, d = ex.search(q, K, cfg=cfg, kernel_mode=mode)
        p_ids, p_d = tidx.search(q, K, cfg=cfg, variant="sharded-base", mesh=one_rank,
                                 kernel_mode=mode)
        assert torch.equal(ids, p_ids) and torch.equal(d, p_d)
        s = ex.hostio_runtime.stats()
        assert s["prefetch_hits"] > 0 and s["prefetch_misses"] == 0 and s["cache_hit_rate"] > 0
        x = ex.exchange_bytes_per_hop(16)
        assert x["hot_cache_rows"] == 64 and x["hot_cache_hit_rate"] == s["cache_hit_rate"]
        assert x["host_link_bytes"] == (x["host_ids_out_bytes"] + x["host_rows_in_bytes"]
                                        - x["host_bytes_saved_per_hop"]) > 0
    finally:
        ex.hostio_runtime.stop()
    jex = JShardedSearchExecutor.from_index(
        idx, jmake_mesh((1, 1), ("data", "model")), variant="sharded-base",
        hostio=JHostIOConfig(workers=2, hot_cache_rows=64, prefetch=True))
    try:
        jids, _ = jex.search(q, K, cfg=JSearchConfig(t=32, bloom_z=4096), kernel_mode=mode)
    finally:
        jex.hostio_runtime.stop()
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


def test_serve_pipeline_over_sharded_base_hostio(one_rank, port_index):
    """The pipeline drives the mesh executor unchanged: drain()'s ids equal
    the executor's own, and the hits of a repeat drain are bit-identical."""
    data, _, arrays, _ = port_index
    tidx = index_from_reference(arrays, device="cpu")
    q = uniform_queries(data, 20, seed=78)
    cfg = SearchConfig(t=16, bloom_z=4096)
    ex = tidx.executor("sharded-base", mesh=one_rank, hostio=HostIOConfig(workers=2, prefetch=True))
    with ServePipeline(ex, k=K, cfg=cfg, max_batch=8, result_cache_size=32) as pipe:
        ids_direct, _ = ex.search(q, K, cfg=cfg)
        pipe.submit(q)
        ids, dists, st = pipe.drain()
        np.testing.assert_array_equal(ids, ids_direct.numpy())
        assert st.batches == 3 and st.hostio["requests"] > 0
        pipe.submit(q)
        ids2, dists2, st2 = pipe.drain()
        np.testing.assert_array_equal(ids2, ids)
        np.testing.assert_array_equal(dists2, dists)
        assert st2.result_cache_hits == 20 and st2.batches == 0
    assert not ex.hostio_service.started


def test_pad_to_multiple_and_local_rows():
    x = torch.arange(10, dtype=torch.int32).reshape(5, 2)
    padded = tdist.pad_to_multiple(x, 3, -1)
    np.testing.assert_array_equal(padded.numpy(), jdist.pad_to_multiple(x.numpy(), 3, -1))
    blocks = [tdist.local_rows(x, s, 3, -1) for s in range(3)]
    assert torch.equal(torch.cat(blocks), padded)
    assert tdist.local_rows(x, 0, 1, -1).data_ptr() == x.data_ptr()     # a view, no copy
    assert tdist.pad_to_multiple(x, 5, -1) is x


# ---------------------------------------------------- several gloo ranks
RANK = r'''
import datetime, sys
import numpy as np

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import torch
import torch.distributed as dist

rank, world, D, S, work = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{work}/group", rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.convert import index_from_reference
from repro_torch.core import SearchConfig
from repro_torch.distributed import make_mesh
from repro_torch.runtime.hostio import HostIOConfig

index = index_from_reference(dict(np.load(f"{work}/index.npz")), device="cpu")
mesh = make_mesh((D, S), ("data", "model"), "cpu")
queries = np.load(f"{work}/queries.npy")
cfg = SearchConfig(t=32, bloom_z=4096)
hio = HostIOConfig(workers=2, hot_cache_rows=64, prefetch=True)
for variant, hostio in (("sharded", None), ("sharded-base", None), ("sharded-base", hio)):
    ex = index.executor(variant, mesh=mesh, hostio=hostio)
    assert ex.n_data_shards == D and ex.n_model_shards == S
    for mode in ("fused", "reference"):
        ref = np.load(f"{work}/{mode}.npz")
        ids, dists, stats = ex.search(queries, 5, cfg=cfg, kernel_mode=mode, return_stats=True)
        assert np.array_equal(ids.numpy(), ref["ids"]), (variant, mode, "ids")
        np.testing.assert_allclose(dists.numpy(), ref["dists"], rtol=1e-6, atol=1e-5)
        assert stats.n_iters == int(ref["n_iters"]), (variant, mode, stats.n_iters)
        h = ex.dispatch(queries, 5, cfg=cfg, kernel_mode=mode)
        assert np.array_equal(h.n_hops[: len(queries)].numpy(), ref["n_hops"]), (variant, mode, "hops")
    if hostio is not None:
        s = ex.hostio_runtime.stats()
        assert s["prefetch_hits"] > 0 and s["prefetch_misses"] == 0, s
        ex.hostio_runtime.stop()
dist.destroy_process_group()
open(f"{work}/ok.{rank}", "w").write("OK")
'''

LAUNCH = r'''
import subprocess, sys
script, world, D, S, work = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
procs = [subprocess.Popen([sys.executable, script, str(r), str(world), D, S, work]) for r in range(world)]
rc = 0
try:
    for p in procs:
        rc |= p.wait(timeout=100)
finally:
    for p in procs:
        if p.poll() is None:
            p.kill()
sys.exit(rc)
'''


@pytest.fixture(scope="module")
def rank_inputs(port_index, tmp_path_factory):
    """The fixture's arrays, queries and the reference single-device
    executor's results, saved for ranks that import no JAX."""
    data, idx, arrays, _ = port_index
    work = tmp_path_factory.mktemp("ranks")
    np.savez(work / "index.npz", **arrays)
    queries = uniform_queries(data, 12, seed=73)
    np.save(work / "queries.npy", queries)
    jcfg = JSearchConfig(t=32, bloom_z=4096)
    jex = idx.executor("inmem")
    for mode in ("fused", "reference"):
        ids, d, iters, hops = _reference_run(jex, queries, mode, jcfg)
        np.savez(work / f"{mode}.npz", ids=ids, dists=d, n_iters=iters, n_hops=hops)
    (work / "rank.py").write_text(textwrap.dedent(RANK))
    return work


@pytest.mark.parametrize("D,S", [(1, 2), (2, 2)])
def test_sharded_on_several_gloo_ranks(rank_inputs, tmp_path, D, S):
    """Meshes (1, 2) and (2, 2): each rank returns the whole batch, equal to
    the reference's single-device executor, in both variants (sharded-base
    also with the host-I/O service of each rank's block) and in the fused
    and reference modes."""
    work = tmp_path / "run"
    work.mkdir()
    for f in rank_inputs.iterdir():
        (work / f.name).symlink_to(f)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run(
        [sys.executable, "-c", LAUNCH, str(work / "rank.py"), str(D * S), str(D), str(S), str(work)],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, f"stdout:\n{res.stdout}\nstderr:\n{res.stderr[-4000:]}"
    # Each rank marks its own file (their stdout would interleave).
    assert sorted(f.name for f in work.glob("ok.*")) == [f"ok.{r}" for r in range(D * S)]
