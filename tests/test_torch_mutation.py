"""The port's streaming mutability (`repro_torch.runtime.mutation`) vs the
reference's, on the CPU.

Both packages wrap the same index -- the reference's `mut_base` build
(`tests/test_mutation.py`), carried across with
`repro_torch.convert.index_from_reference` -- in a `MutableBangIndex`, and
the same inserts, deletes and consolidations, made from a seed with numpy,
go through both. Held here:

  * ids bit-exact and distances within rtol 1e-6, atol 1e-5 after inserts,
    deletes and consolidations, on inmem, base (inline and host I/O),
    exact, sharded and sharded-base in all three kernel modes;
  * a consolidation's adjacency, tombstone bitmap, codes and
    `mutation_stats()` equal the reference's;
  * the reference file's properties, on the port: an insert is found, a
    delete is never returned (also through `ServePipeline`'s result cache
    and the host-I/O hot cache with `refresh`), a delta point killed and
    inserted again, a drain bit-exact across `max_batch` and the cache, ids
    stable across a fold, the recall floor mid-consolidation, the medoid
    refused, `rerank=False` refused while delta points are live, no
    pipeline built on a delete, and the counters.

Integer draws only (ROADMAP C3). The mesh cells run on a one-rank gloo group
made for this module and destroyed after it; no other test of this file
touches torch.distributed.
"""
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import BangIndex as JBangIndex
from repro.core import SearchConfig as JSearchConfig
from repro.data import gaussian_mixture
from repro.runtime import MutableBangIndex as JMutableBangIndex
from repro.runtime import ServePipeline as JServePipeline
from repro_torch.convert import index_from_reference
from repro_torch.core import SearchConfig, brute_force_knn, recall_at_k
from repro_torch.distributed import make_mesh
from repro_torch.runtime import MutableBangIndex, ServePipeline, Telemetry
from repro_torch.runtime.hostio import HostIOConfig

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core

K = 5
T = 32
CFG = SearchConfig(t=T, bloom_z=4096)
JCFG = JSearchConfig(t=T, bloom_z=4096)
RTOL, ATOL = 1e-6, 1e-5
MODES = ("reference", "staged", "fused")


@pytest.fixture(scope="module")
def mut_base():
    """(data, reference BangIndex, port BangIndex): the reference file's
    fixture and its carried-across copy. Neither index is ever mutated:
    consolidation builds a new one, so each test wraps fresh layers."""
    data = gaussian_mixture(240, 8, n_clusters=8, seed=7)
    idx = JBangIndex.build(data, m=4, R=8, L_build=16, kmeans_iters=4)
    arrays = {"codebooks": np.asarray(idx.codec.codebooks), "codes": np.asarray(idx.codes),
              "adjacency": np.asarray(idx.graph.adjacency), "medoid": idx.graph.medoid,
              "data": np.asarray(idx.data_np)}
    return data, idx, index_from_reference(arrays, device="cpu")


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo group in this process, made for this module and
    destroyed after it."""
    made = not dist.is_initialized()
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    yield mesh
    if made and dist.is_initialized():
        dist.destroy_process_group()


def _pair(mut_base):
    _, idx, tidx = mut_base
    return JMutableBangIndex(idx), MutableBangIndex(tidx)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(jout, tout, msg=""):
    """The port's (ids, dists) equal the reference's: ids bit-exact,
    distances within the parity bound."""
    np.testing.assert_array_equal(_np(tout[0]), _np(jout[0]), err_msg=msg)
    np.testing.assert_allclose(_np(tout[1]), _np(jout[1]), rtol=RTOL, atol=ATOL, err_msg=msg)


def _search_both(jm, tm, q, **kw):
    jout = jm.search(q, k=K, t=T, cfg=JCFG, **kw)
    tout = tm.search(q, k=K, t=T, cfg=CFG, **kw)
    _same(jout, tout, str(kw))
    return _np(tout[0]), _np(tout[1])


def _victim(ids, medoid, *avoid):
    """The first result id that is neither the medoid nor in `avoid`."""
    for i in np.asarray(ids).ravel():
        if int(i) != medoid and int(i) not in avoid:
            return int(i)
    raise AssertionError("no victim")


# ------------------------------------------------------ insert and delete
@pytest.mark.parametrize("seed", [1, 77, 4242])
def test_insert_found_matches_reference(mut_base, seed):
    data, idx, _ = mut_base
    jm, tm = _pair(mut_base)
    rng = np.random.default_rng(seed)
    vec = data[int(rng.integers(len(data)))] + (rng.integers(-5, 6, data.shape[1]) / 100).astype(np.float32)
    gid = tm.insert(vec)
    np.testing.assert_array_equal(gid, jm.insert(vec))
    ids, dists = _search_both(jm, tm, vec[None])
    assert ids[0, 0] == gid[0]
    np.testing.assert_allclose(dists[0, 0], 0.0, atol=1e-5)


@pytest.mark.parametrize("seed", [2, 314, 9001])
def test_delete_never_returned_matches_reference(mut_base, seed):
    data, idx, _ = mut_base
    jm, tm = _pair(mut_base)
    rng = np.random.default_rng(seed)
    q = data[rng.integers(len(data), size=6)] + np.float32(0.01)
    ids0, _ = _search_both(jm, tm, q)
    medoid = int(idx.graph.medoid)
    victims = [int(i) for i in np.unique(ids0[:, 0]) if int(i) != medoid][:3]
    assert victims
    jm.delete(victims)
    tm.delete(victims)
    np.testing.assert_array_equal(tm._tombstones, jm._tombstones)
    ids1, _ = _search_both(jm, tm, q)
    assert not set(victims) & set(ids1.ravel().tolist())


def test_delta_point_delete_and_reinsert(mut_base):
    data, _, _ = mut_base
    jm, tm = _pair(mut_base)
    vec = data[3] + np.float32(0.2)
    g1 = int(tm.insert(vec)[0])
    assert g1 == int(jm.insert(vec)[0])
    ids, _ = _search_both(jm, tm, vec[None])
    assert ids[0, 0] == g1
    jm.delete([g1])
    tm.delete([g1])
    ids, _ = _search_both(jm, tm, vec[None])
    assert g1 not in ids.ravel().tolist()
    # The same vector again: a new id, the old one stays dead.
    g2 = int(tm.insert(vec)[0])
    assert g2 == int(jm.insert(vec)[0]) and g2 != g1
    ids, _ = _search_both(jm, tm, vec[None])
    assert ids[0, 0] == g2


def test_medoid_and_unknown_id_refused(mut_base):
    _, idx, _ = mut_base
    _, tm = _pair(mut_base)
    with pytest.raises(ValueError, match="medoid"):
        tm.delete([int(idx.graph.medoid)])
    with pytest.raises(ValueError, match="unknown id"):
        tm.delete([10**6])
    assert tm.epoch == 0 and not tm._tombstones.any()


def test_rerank_false_refused_with_live_delta(mut_base):
    data, _, _ = mut_base
    jm, tm = _pair(mut_base)
    # No delta yet: rerank=False is served (tombstones need no fusion).
    _search_both(jm, tm, data[:2], rerank=False)
    tm.insert(data[0] + np.float32(0.5))
    jm.insert(data[0] + np.float32(0.5))
    with pytest.raises(ValueError, match="rerank=False"):
        tm.search(data[:2], k=K, t=T, cfg=CFG, rerank=False)
    # The exact variant's worklist holds exact distances: always served.
    _search_both(jm, tm, data[:2], variant="exact", rerank=False)


# ---------------------------------------------------------- serving paths
def test_delete_invalidates_result_cache(mut_base):
    """A cached drain() result never serves a deleted id, as the
    reference's pipeline; both drains give the same rows."""
    data, idx, _ = mut_base
    jm, tm = _pair(mut_base)
    q = data[:8] + np.float32(0.01)
    jpipe = JServePipeline(jm.executor("inmem"), k=K, cfg=JCFG, max_batch=4, result_cache_size=64)
    with ServePipeline(tm.executor("inmem"), k=K, cfg=CFG, max_batch=4,
                       result_cache_size=64) as pipe:
        try:
            outs = []
            for p in (jpipe, pipe):
                p.submit(q)
                outs.append(p.drain())
            _same(outs[0], outs[1])
            ids0 = outs[1][0]
            pipe.submit(q)
            ids1, _, st = pipe.drain()
            assert st.result_cache_hits == len(q)
            np.testing.assert_array_equal(ids1, ids0)
            victim = _victim(ids0[:, 0], int(idx.graph.medoid))
            jm.delete([victim])
            tm.delete([victim])
            outs = []
            for p in (jpipe, pipe):
                p.submit(q)
                outs.append(p.drain())
            _same(outs[0], outs[1])
            ids2, _, st = outs[1]
            assert st.result_cache_hits == 0
            assert victim not in ids2.ravel().tolist()
            assert st.mutation is not None and st.mutation["tombstones"] == 1
        finally:
            jpipe.close()


@pytest.mark.parametrize("max_batch,cache", [(4, 0), (16, 0), (7, 32), (24, 8)])
def test_drain_bit_exact_across_batching_and_cache(mut_base, max_batch, cache):
    """drain() across a mutation epoch equals the reference's drain and the
    port's own drain at max_batch 4 without a cache, bit for bit."""
    data, idx, _ = mut_base
    q = data[10:34] + np.float32(0.01)
    outs = {}
    for name, cls, pipe_cls, cfg, mb, cs in (
            ("ref", JMutableBangIndex, JServePipeline, JCFG, max_batch, cache),
            ("port", MutableBangIndex, ServePipeline, CFG, max_batch, cache),
            ("port-base", MutableBangIndex, ServePipeline, CFG, 4, 0)):
        mut = cls(idx if name == "ref" else mut_base[2])
        pipe = pipe_cls(mut.executor("inmem"), k=K, cfg=cfg, max_batch=mb, result_cache_size=cs)
        try:
            pipe.submit(q[:12])
            ids_a, dists_a, _ = pipe.drain()
            mut.insert(data[5] + np.float32(0.3))
            mut.delete([_victim(ids_a[:, 0], int(idx.graph.medoid))])
            pipe.submit(q)
            ids_b, dists_b, _ = pipe.drain()
        finally:
            pipe.close()
        outs[name] = (ids_a, dists_a, ids_b, dists_b)
    _same(outs["ref"][:2], outs["port"][:2])
    _same(outs["ref"][2:], outs["port"][2:])
    for a, b in zip(outs["port"], outs["port-base"]):
        np.testing.assert_array_equal(a, b)


def test_tombstones_flow_through_hot_adjacency_cache(mut_base):
    """Deletes hold through host-I/O base, and consolidation refreshes the
    hot cache's device rows (a delete-only fold keeps the shape)."""
    data, idx, _ = mut_base
    jm, tm = _pair(mut_base)
    hio = HostIOConfig(workers=1, hot_cache_rows=64)
    ex = tm.executor("base", hostio=hio)
    try:
        with ServePipeline(ex, k=K, cfg=CFG, max_batch=8) as pipe:
            q = data[:8] + np.float32(0.01)
            pipe.submit(q)
            ids0, _, _ = pipe.drain()
            victim = _victim(ids0[:, 0], int(idx.graph.medoid))
            tm.delete([victim])
            jm.delete([victim])
            pipe.submit(q)
            ids1, d1, _ = pipe.drain()
            assert victim not in ids1.ravel()
            _same(jm.search(q, k=K, t=T, cfg=JCFG, variant="base"), (ids1, d1))
            cache = ex.hostio_runtime.cache
            rows_before = cache._rows.clone()
            tm.consolidate()
            jm.consolidate()
            # The same cache object, its rows refreshed to the consolidated
            # adjacency of the same hot ids.
            np.testing.assert_array_equal(
                cache._rows.numpy(), tm.index.graph.adjacency.numpy()[cache.hot_ids])
            assert cache.refreshes == 1
            if victim in cache.hot_ids:
                assert not torch.equal(cache._rows, rows_before)
            pipe.submit(q)
            ids2, d2, _ = pipe.drain()
            assert victim not in ids2.ravel()
        _same(jm.search(q, k=K, t=T, cfg=JCFG, variant="base"), (ids2, d2))
    finally:
        tm.close()
        jm.close()


# ------------------------------------------------------------ consolidation
@pytest.mark.parametrize("n_insert,n_delete", [(0, 4), (5, 0), (6, 5)])
def test_consolidation_matches_reference(mut_base, n_insert, n_delete):
    """The same mutations, then a fold in both packages: adjacency,
    tombstones, codes, data, medoid and mutation_stats equal; searches after
    it equal; ids stay stable across the fold."""
    data, idx, _ = mut_base
    jm, tm = _pair(mut_base)
    rng = np.random.default_rng(100 * n_insert + n_delete)
    vecs = data[rng.integers(len(data), size=n_insert)] + (
        rng.integers(-20, 21, (n_insert, data.shape[1])) / 100).astype(np.float32)
    if n_insert:
        np.testing.assert_array_equal(tm.insert(vecs), jm.insert(vecs))
    medoid = int(idx.graph.medoid)
    victims = [int(i) for i in rng.permutation(len(data))[: n_delete + 1] if int(i) != medoid][:n_delete]
    if n_insert > 1:
        victims.append(len(data) + 1)          # a delta point dies before the fold
    if victims:
        tm.delete(victims)
        jm.delete(victims)
    q = data[rng.integers(len(data), size=8)] + np.float32(0.01)
    _search_both(jm, tm, q)
    ts, js = tm.consolidate(), jm.consolidate()
    assert ts == js
    assert ts["generation"] == 1 and ts["delta_points"] == 0
    new, jnew = tm.index, jm.index
    np.testing.assert_array_equal(new.graph.adjacency.numpy(), np.asarray(jnew.graph.adjacency))
    assert new.graph.medoid == jnew.graph.medoid
    np.testing.assert_array_equal(new.codes.numpy(), np.asarray(jnew.codes))
    np.testing.assert_array_equal(new.data_host.numpy(), np.asarray(jnew.data_np))
    np.testing.assert_array_equal(tm._tombstones, jm._tombstones)
    adj = new.graph.adjacency.numpy()
    for v in victims:
        assert (adj[v] == -1).all() and v not in adj[adj >= 0]
    ids, _ = _search_both(jm, tm, q)
    assert not set(victims) & set(ids.ravel().tolist())
    for variant in ("base", "exact"):
        _search_both(jm, tm, q, variant=variant)
    # Ids stay stable: the next insert continues the id space.
    g = int(tm.insert(data[2])[0])
    assert g == new.n == int(jm.insert(data[2])[0])
    assert set(tm.last_consolidation) == {"relink_s", "insert_s", "encode_s", "swap_s", "total_s"}


class _GatedLock:
    """The index lock, with the fold's second acquisition (the swap) held
    back until `release` is set: mutations made meanwhile land between the
    snapshot and the swap."""

    def __init__(self, lock, reached, release):
        self._lock, self._reached, self._release, self._fold_enters = lock, reached, release, 0

    def __enter__(self):
        if threading.current_thread().name == "fold":
            self._fold_enters += 1
            if self._fold_enters == 2:
                self._reached.set()
                self._release.wait(30)
        return self._lock.__enter__()

    def __exit__(self, *exc):
        return self._lock.__exit__(*exc)


def test_post_snapshot_mutations_reconciled(mut_base):
    """Mutations that land between the snapshot and the swap -- a base
    delete, a folded delta point killed, a new insert -- are reconciled as
    the reference reconciles them: the same bitmap and stats, the late
    insert keeps its global id and is found."""
    data, _, _ = mut_base
    out = {}
    for name, mut in zip(("ref", "port"), _pair(mut_base)):
        g = mut.insert(data[[4, 9]] + np.float32(0.1))
        mut.delete([7])
        lock, reached, release = mut._lock, threading.Event(), threading.Event()
        mut._lock = _GatedLock(lock, reached, release)
        errors = []

        def fold(mut=mut, errors=errors):
            try:
                mut.consolidate()
            except BaseException as e:  # surfaced below
                errors.append(e)

        th = threading.Thread(target=fold, name="fold")
        th.start()
        assert reached.wait(60)
        with lock:
            mut.delete([11, int(g[1])])
            late = int(mut.insert(data[20] + np.float32(0.2))[0])
        release.set()
        th.join(60)
        mut._lock = lock
        assert not errors and mut.generation == 1
        q = data[20:21] + np.float32(0.2)
        res = mut.search(q, k=K, t=T, cfg=JCFG if name == "ref" else CFG)
        out[name] = (mut._tombstones.copy(), mut.mutation_stats(), late, res)
    (jt, js, jl, jres), (tt, ts, tl, tres) = out["ref"], out["port"]
    np.testing.assert_array_equal(tt, jt)
    assert ts == js and tl == jl
    _same(jres, tres)
    assert _np(tres[0])[0, 0] == tl
    assert tt[7] and tt[11] and tt[len(data) + 1] and not tt[len(data)]


def test_recall_floor_holds_mid_consolidation(mut_base):
    data, idx, _ = mut_base
    _, tm = _pair(mut_base)
    rng = np.random.default_rng(11)
    tm.insert(data[rng.integers(len(data), size=6)] + np.float32(0.1))
    ids0, _ = tm.search(data[:8] + np.float32(0.01), k=K, t=T, cfg=CFG)
    medoid = int(idx.graph.medoid)
    victims = [int(i) for i in np.unique(ids0[:, -1].numpy()) if int(i) != medoid][:4]
    tm.delete(victims)
    q = data[40:56] + np.float32(0.01)
    live_ids, live_vecs = tm.live_points()
    gt = live_ids[brute_force_knn(live_vecs, q, K, device="cpu")]
    th = tm.consolidate_async()
    floors = []
    while True:
        alive = th.is_alive()
        ids, _ = tm.search(q, k=K, t=T, cfg=CFG)
        floors.append(recall_at_k(ids.numpy(), gt))
        if not alive:
            break
    th.join(60)
    assert tm.consolidate_error is None and tm.generation == 1
    assert len(floors) >= 2 and min(floors) >= 0.9
    ids, _ = tm.search(q, k=K, t=T, cfg=CFG)
    assert recall_at_k(ids.numpy(), gt) >= 0.9


def test_consolidate_async_failure_surfaces(mut_base):
    _, tm = _pair(mut_base)

    def broken():
        raise RuntimeError("fold failed")

    tm.consolidate = broken
    tm.consolidate_async().join(10)
    assert isinstance(tm.consolidate_error, RuntimeError)
    with pytest.raises(RuntimeError, match="fold failed"):
        tm.consolidate_async()
    assert tm.consolidate_error is None


# ------------------------------------------- variants x kernel modes matrix
def _mutate(mut, data, idx):
    q = data[60:66] + np.float32(0.01)
    gid = int(mut.insert(q[0].copy())[0])
    ids0, _ = mut.search(q, k=K, t=T, cfg=JCFG if isinstance(mut, JMutableBangIndex) else CFG)
    victim = _victim(_np(ids0)[1], int(idx.graph.medoid), gid)
    mut.delete([victim])
    return q, gid, victim


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", ["inmem", "base", "exact"])
def test_mutation_parity_across_variants_and_modes(mut_base, variant, mode):
    """After an insert and a delete: each single-device variant in each
    kernel mode equals the reference's same cell."""
    data, idx, _ = mut_base
    jm, tm = _pair(mut_base)
    q, gid, victim = _mutate(jm, data, idx)
    assert _mutate(tm, data, idx)[1:] == (gid, victim)
    ids, _ = _search_both(jm, tm, q, variant=variant, kernel_mode=mode)
    assert ids[0, 0] == gid and victim not in ids.ravel()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", ["sharded", "sharded-base"])
def test_mutation_parity_on_the_mesh(mut_base, one_rank, variant, mode):
    """The mesh variants on a one-rank gloo group, with the tombstones
    replicated over the padded id space: equal to the reference's sharded
    executor at its (1, 1) mesh and to the port's inmem results."""
    from repro.compat import make_mesh as jmake_mesh

    data, idx, _ = mut_base
    jm, tm = _pair(mut_base)
    q, gid, victim = _mutate(jm, data, idx)
    assert _mutate(tm, data, idx)[1:] == (gid, victim)
    jmesh = jmake_mesh((1, 1), ("data", "model"))
    jout = jm.search(q, k=K, t=T, cfg=JCFG, variant=variant, mesh=jmesh, kernel_mode=mode)
    tout = tm.search(q, k=K, t=T, cfg=CFG, variant=variant, mesh=one_rank, kernel_mode=mode)
    _same(jout, tout, f"{variant}/{mode}")
    inmem = tm.search(q, k=K, t=T, cfg=CFG, kernel_mode=mode)
    np.testing.assert_array_equal(tout[0].numpy(), inmem[0].numpy())
    assert tout[0][0, 0] == gid and victim not in tout[0].numpy().ravel()
    ex = tm.executor(variant, mesh=one_rank)._inner()
    assert ex._tomb_dev.shape == (ex._tombstone_len,) and not ex._tomb_dev[idx.n:].any()


# ------------------------------------------------ no rebuild, one bitmap
@pytest.mark.parametrize("variant", ["inmem", "base", "exact"])
def test_tombstone_updates_build_nothing(mut_base, variant):
    """The bitmap is an argument of the pipeline: deletes build no pipeline,
    and the executor writes one device bitmap in place."""
    data, idx, _ = mut_base
    _, tm = _pair(mut_base)
    ex = tm.executor(variant)
    q = data[:4] + np.float32(0.01)
    tm.search(q, k=K, t=T, cfg=CFG, variant=variant)
    traces = dict(ex.trace_counts)
    inner = ex._inner()
    buf = inner._tomb_dev
    for i in (3, 9, 27):
        if i != int(idx.graph.medoid):
            tm.delete([i])
        ids, _ = tm.search(q, k=K, t=T, cfg=CFG, variant=variant)
        assert i not in ids.numpy().ravel()
    assert dict(ex.trace_counts) == traces
    assert inner._tomb_dev is buf and torch.equal(buf, torch.from_numpy(tm._tombstones))


def test_executor_refuses_tombstones_without_the_flag(mut_base):
    data, _, tidx = mut_base
    from repro_torch.runtime import SearchExecutor

    ex = SearchExecutor.from_index(tidx, "inmem")
    with pytest.raises(ValueError, match="with_tombstones"):
        ex.search(data[:2], K, cfg=CFG, tombstones=np.zeros(tidx.n, np.bool_))
    ex = SearchExecutor.from_index(tidx, "inmem", with_tombstones=True)
    with pytest.raises(ValueError, match="tombstones must be"):
        ex.search(data[:2], K, cfg=CFG, tombstones=np.zeros(tidx.n + 1, np.bool_))


# ------------------------------------------------------------- accounting
def test_mutation_counters_in_exchange_stats_and_telemetry(mut_base):
    data, idx, _ = mut_base
    jm, tm = _pair(mut_base)
    tel = Telemetry()
    tm.set_telemetry(tel)
    medoid = int(idx.graph.medoid)
    victims = [i for i in range(4) if i != medoid][:2]
    for m in (jm, tm):
        m.insert(data[:3] + np.float32(0.1))
        m.delete(victims)
    x = tm.executor("inmem").exchange_bytes_per_hop(8)
    assert x == jm.executor("inmem").exchange_bytes_per_hop(8)
    assert x["delta_points"] == 3 and x["tombstone_fraction"] == pytest.approx(2 / idx.n)
    s = tm.mutation_stats()
    assert s == jm.mutation_stats()
    assert s["epoch"] == 2 and s["generation"] == 0 and s["tombstones"] == 2 and s["delta_total"] == 3
    tm.consolidate()
    reg = tel.registry
    assert reg.counter("bang_mutation_inserts_total").value == 3
    assert reg.counter("bang_mutation_deletes_total").value == 2
    assert reg.counter("bang_mutation_consolidations_total").value == 1
    assert reg.gauge("bang_mutation_epoch").value == 3
    assert reg.gauge("bang_mutation_generation").value == 1
    # Every inner executor made after the swap carries the bundle.
    assert tm.executor("inmem")._inner().telemetry is tel
