"""`chip_smoke.py`, rehearsed on the CPU at a tiny size.

The script's phases run here with the kernels' plain versions: the same
checks (base ids equal to inmem's, staged ids equal to fused ids, exact
fused ids equal to its reference mode's, exact re-rank distances, the mesh
paths equal to inmem and base on a one-rank gloo group, the distance-table
entry point, card vs CPU ids) at n = 3,000, d = 32, m = 8 instead of the
card's sizes, and the Vamana cell at n = 800, R = 16, L_build = 32. Nothing
launches on the CPU, so the wrappers are counted by stand-ins, times come
from the host clock, and the device profile is left out.
"""
import importlib.util
import time
from pathlib import Path

import pytest
import torch

from repro_torch import SearchConfig
from repro_torch.kernels import common
from repro_torch.kernels.bitonic import ops as bitonic_ops
from repro_torch.kernels.pq_adc import ops as adc_ops
from repro_torch.kernels.pq_table import ops as table_ops
from repro_torch.kernels.rerank_l2 import ops as rr_ops
from repro_torch.kernels.search_step import ops as step_ops

SCRIPT = Path(__file__).resolve().parents[1] / "chip_smoke.py"
WRAPPERS = ((step_ops, "fused_step"), (step_ops, "fused_traverse"), (adc_ops, "adc"),
            (rr_ops, "exact_sq_dists"), (bitonic_ops, "sort_kv"), (bitonic_ops, "merge_worklist"),
            (step_ops, "local_adc"), (table_ops, "dist_table"))


def _counted(fn):
    def wrapper(*args, **kwargs):
        wrapper.launches += 1
        return fn(*args, **kwargs)

    wrapper.launches = 0
    return wrapper


def _host_time_ms(fn, arg_sets, reps=20):
    t0 = time.perf_counter()
    fn(*arg_sets[0])
    return (time.perf_counter() - t0) * 1e3


@pytest.fixture
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, value in (("N", 3000), ("D", 32), ("M", 8), ("N_QUERIES", 80), ("BATCH", 32),
                        ("VAMANA_N", 800), ("VAMANA_QUERIES", 30), ("VAMANA_R", 16), ("VAMANA_L", 32),
                        ("PATH_BATCHES", {"inmem": 3, "base": 2, "exact": 2, "sharded": 3,
                                          "sharded-base": 2}),
                        # A tenth of the rehearsal graph's 800 rows, as 1,500 of 15,000.
                        ("VAMANA_HOSTIO", dict(mod.VAMANA_HOSTIO, hot_cache_rows=80)),
                        ("time_ms", _host_time_ms)):
        monkeypatch.setattr(mod, name, value)
    # On the CPU the sharded re-rank follows XLA:CPU's order outside the
    # re-rank kernel's wrapper (it launches K3 on the card only).
    kernels = dict(mod.PATH_KERNELS)
    for name in ("sharded", "sharded-base", "sharded-base-hostio"):
        kernels[name] = tuple(k for k in kernels[name] if k != "rerank_l2")
    monkeypatch.setattr(mod, "PATH_KERNELS", kernels)
    # Device tracing has nothing to trace here (and takes seconds on the host).
    monkeypatch.setattr(mod, "profile_batch", lambda *args, **kwargs: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for ops, name in WRAPPERS:
        monkeypatch.setattr(ops, name, _counted(getattr(ops, name)))
    return mod


def test_chip_smoke_phases_on_cpu(smoke):
    cpu = torch.device("cpu")
    rows = smoke.check_kernels(cpu)
    assert [r["name"] for r in rows] == ["search_step", "pq_adc", "rerank_l2", "bitonic_sort",
                                         "bitonic_merge", "fused_traverse", "local_adc", "dist_table"]
    assert all(r["max_abs_err"] == 0.0 and r["bound_ms"] > 0 for r in rows)
    assert rows[1]["at_r64"]["max_abs_err"] == 0.0
    # K2's regimes over R, the measured crossover and the times on each side
    # of the wrapper's.
    adc = rows[1]
    assert [e["R"] for e in adc["regimes"]] == list(smoke.ADC_SWEEP_R)
    assert all(e["global_ms"] > 0 and e["shared_ms"] > 0 and e["bound_ms"] > 0 for e in adc["regimes"])
    assert "crossover_r_measured" in adc
    below, above = adc["below_crossover"], adc["above_crossover"]
    assert below["R"] < adc_ops.SHARED_TABLE_MIN_R <= above["R"]
    assert not below["shared_table"] and above["shared_table"]
    assert below["ms"] == below["global_ms"] and above["ms"] == above["shared_ms"]
    # K4's and K6's block shapes and their sweeps across the two regimes,
    # and the launch floor beside every bound.
    sort, trav = rows[3], rows[5]
    assert [e["rows"] for e in sort["by_rows_a_block"]] == [0, *smoke.WARPS_SWEEP]
    assert [(e["n"], bitonic_ops.sort_rows(common.next_pow2(e["n"])) > 0) for e in sort["by_n"]] == [
        (64, True), (512, True), (513, False), (1000, False)]
    assert [e["warps"] for e in trav["by_warps_a_block"]] == [0, *smoke.WARPS_SWEEP]
    assert [(e["t"], e["P"], step_ops.traverse_warps(e["P"]) > 0) for e in trav["by_t"]] == [
        (16, 128, True), (64, 128, True), (152, 256, True), (448, 512, True), (500, 1024, False)]
    merge = rows[4]
    assert [e["rows"] for e in merge["by_rows_a_block"]] == [0, *smoke.WARPS_SWEEP]
    assert all(e["ms"] > 0 and e["warm_ms"] > 0 for e in merge["by_rows_a_block"])
    assert [(e["t"], e["p"], bitonic_ops.merge_rows(e["p"]) > 0) for e in merge["by_t"]] == [
        (16, 128, True), (64, 128, True), (152, 256, True), (448, 512, True), (500, 1024, False)]
    assert bitonic_ops.MERGE_ROWS in smoke.WARPS_SWEEP
    assert all(e["ms"] > 0 and e["bound_ms"] > 0
               for e in sort["by_n"] + trav["by_t"] + merge["by_t"])
    # K8's tiles, and its general regime (queries 0).
    table = rows[7]
    assert [e["queries"] for e in table["by_tile"]] == [0, *smoke.TABLE_SWEEP_QUERIES]
    assert all(e["ms"] > 0 for e in table["by_tile"])
    assert table_ops.TABLE_QUERIES in smoke.TABLE_SWEEP_QUERIES
    # The line carries measured numbers: the wrappers' block shapes and tiles
    # are constants, printed in the log only.
    for r in rows:
        entries = [r, *r.get("by_n", []), *r.get("by_t", [])]
        assert not any({"rows", "warps", "rows_a_block", "warps_a_block", "queries_a_tile",
                        "persistent"} & e.keys() for e in entries)
    assert all(r["launch_floor_ms"] > 0 for r in rows)
    assert rows[6]["shards"]["S"] == 4 and 0 < rows[6]["shards"]["bound_ms"] < rows[6]["bound_ms"]
    assert rows[7]["library_ms"] > 0 and rows[6]["library_ms"] is None
    res = smoke.main_path(cpu, "cpu")
    assert not torch.distributed.is_initialized()        # the one-rank group is gone
    paths = res["paths"]
    inmem, base, exact, staged = (paths[p] for p in ("inmem", "base", "exact", "staged"))
    assert inmem["launches"] == {
        "search_step": sum(inmem["n_iters"]), "pq_adc": 3, "rerank_l2": 3,
        "bitonic_sort": 0, "bitonic_merge": 0, "fused_traverse": 0, "local_adc": 0,
        "dist_table": 0}
    # The mesh paths: K7 on every hop and the medoid, K6 on every hop, no K1;
    # two all-reduces a hop and two a batch.
    for name, nb in (("sharded", 3), ("sharded-base", 2)):
        sh = paths[name]
        hops = sum(sh["n_iters"])
        assert sh["launches"]["local_adc"] == hops + nb and sh["launches"]["fused_traverse"] == hops
        assert sh["launches"]["search_step"] == 0 and sh["launches"]["rerank_l2"] == 0
        assert sh["all_reduces"] == 2 * hops + 2 * nb and sh["all_reduces_per_hop"] == 2.0
        assert sh["allreduce_host_ms_per_batch"] > 0.0
        assert sh["exchange_bytes_per_hop"]["collective_bytes"] == smoke.BATCH * smoke.R * 8
        assert sh["recall_at_10"] == inmem["recall_at_10"] or nb != inmem["n_batches"]
    assert paths["sharded-base"]["link_bytes_per_hop"] == (smoke.BATCH + smoke.BATCH * smoke.R) * 4
    assert paths["sharded"]["exchange_bytes_per_hop"]["host_link_bytes"] == 0
    assert res["pq_table"]["launches"]["dist_table"] == 3 and res["pq_table"]["max_abs_diff"] < 2e-4
    assert base["launches"]["search_step"] == sum(base["n_iters"]) and base["launches"]["rerank_l2"] == 2
    assert exact["launches"]["fused_traverse"] == sum(exact["n_iters"])
    assert exact["launches"]["search_step"] == exact["launches"]["rerank_l2"] == 0
    n = staged["n_iters"][0]
    assert staged["launches"]["bitonic_sort"] == staged["launches"]["bitonic_merge"] == n
    assert staged["launches"]["pq_adc"] == n + 1 and staged["launches"]["search_step"] == 0
    # The frontier down and the adjacency rows up, per hop.
    assert base["link_bytes_per_hop"] == (smoke.BATCH + smoke.BATCH * smoke.R) * 4
    assert 0.0 < base["host_gather_share"] < 1.0
    assert base["recall_at_10"] == inmem["recall_at_10"] or base["n_batches"] != inmem["n_batches"]
    for r in paths.values():
        assert 0.0 < r["recall_at_10"] <= 1.0
        assert r["device_busy_ms_per_batch"] is None     # no device on the CPU
    assert res["nn_contrast"] > 1.0
    assert smoke.small_vs_cpu(cpu) > 0.5


def test_chip_smoke_refuses_without_a_card(smoke, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_vamana_cell_on_cpu(smoke):
    from repro_torch.core.vamana import build_vamana
    from repro_torch.data import gaussian_mixture

    res = smoke.vamana_cell(torch.device("cpu"), "cpu")
    build, paths = res["build"], res["paths"]
    assert build["total_s"] >= build["pq_s"] + build["graph_s"] > 0
    # The cell's graph is the host build of the same data and parameters.
    data = gaussian_mixture(smoke.VAMANA_N + smoke.VAMANA_QUERIES, smoke.D, seed=smoke.SEED,
                            intrinsic_dim=smoke.INTRINSIC_DIM)[: smoke.VAMANA_N]
    g = build_vamana(data, R=16, L=32, alpha=smoke.VAMANA_ALPHA, seed=smoke.SEED)
    assert (build["mean_degree"], build["max_degree"]) == g.degree_stats()
    assert build["medoid"] == g.medoid and build["pq_error"] > 0
    assert list(paths) == ["vamana-inmem", "vamana-base", "vamana-exact", "vamana-base-hostio"]
    hostio = paths.pop("vamana-base-hostio")
    for name, r in paths.items():
        assert r["n_batches"] == 1 and 0.5 < r["recall_at_10"] <= 1.0
        assert 0 < r["mean_hops"] <= r["n_iters"][0] < SearchConfig().iters()
        assert 0 < r["p95_hops"] <= r["n_iters"][0]
        assert r["device_busy_ms_per_batch"] is None
    inmem, base, exact = paths.values()
    # Host-I/O base on the same graph: base's recall and launches, and a hot
    # cache that some lanes hit.
    assert hostio["launches"] == base["launches"] and hostio["recall_at_10"] == base["recall_at_10"]
    assert 0.0 < hostio["cache_hit_rate"] < 1.0
    hops = inmem["n_iters"][0]
    assert inmem["launches"]["search_step"] == hops and inmem["launches"]["pq_adc"] == 1
    assert inmem["launches"]["rerank_l2"] == 1 and inmem["launches"]["fused_traverse"] == 0
    assert base["launches"] == inmem["launches"] and base["recall_at_10"] == inmem["recall_at_10"]
    assert exact["launches"]["fused_traverse"] == exact["n_iters"][0]
    assert exact["launches"]["search_step"] == exact["launches"]["rerank_l2"] == 0


def test_chip_smoke_hostio_phase_on_cpu(smoke, monkeypatch):
    """Phase 4b at the rehearsal's size: the host-I/O paths equal their plain
    twins, launch K1 (or K7 and K6) every hop, count no miss, hedge or
    degraded lane, and split each hop in three; the pipelines' ids and recall
    equal the plain path's and their repeats hit the result cache."""
    cpu = torch.device("cpu")
    # 200 hot rows of the 3,000: the card's 65,536 would cache the whole graph.
    configs = tuple((name, {**kw, "hot_cache_rows": 200} if kw.get("hot_cache_rows") else kw)
                    for name, kw in smoke.HOSTIO_CONFIGS)
    monkeypatch.setattr(smoke, "HOSTIO_CONFIGS", configs)
    monkeypatch.setattr(smoke, "HOSTIO_FULL", dict(smoke.HOSTIO_FULL, hot_cache_rows=200))
    res = smoke.main_path(cpu, "cpu")
    base = res["paths"]["base"]
    assert base["hop_split_ms"]["total_ms"] > 0 and base["hop_split_ms"]["wait_ms"] > 0
    paths = smoke.hostio_phase(cpu, "cpu", res["ctx"])
    assert not torch.distributed.is_initialized()
    assert list(paths) == [name for name, _ in configs] + ["sharded-base-hostio", "serve-inmem",
                                                           "serve-base-hostio"]
    for name, _ in configs:
        r = paths[name]
        hops = sum(r["n_iters"])
        assert r["launches"]["search_step"] == hops and r["launches"]["rerank_l2"] == r["n_batches"] == 2
        assert r["hostio"]["requests"] == hops and r["hostio"]["prefetch_misses"] == 0
        assert r["hop_split_ms"]["total_ms"] > 0 and r["recall_at_10"] == base["recall_at_10"]
        assert r["host_link_bytes"] == r["exchange_bytes_per_hop"]["host_link_bytes"]
    assert paths["base-hostio-w1"]["hostio"]["prefetch_issued"] == 0
    full = paths["base-hostio-w4-c64k-p"]["hostio"]
    assert full["prefetch_hits"] == full["requests"] and 0 < full["cache_hit_rate"] < 1
    assert full["hot_cache_rows"] == 200 and 0.0 < full["overlap_fraction"] <= 1.0
    sb = paths["sharded-base-hostio"]
    hops = sum(sb["n_iters"])
    assert sb["launches"]["local_adc"] == hops + 2 and sb["launches"]["fused_traverse"] == hops
    for name in ("serve-inmem", "serve-base-hostio"):
        r = paths[name]
        assert r["recall_at_10"] == res["paths"]["inmem"]["recall_at_10"]
        assert r["cache_repeat_hit_rate"] == 1.0 and 0 < r["p50_ms"] <= r["p95_ms"]
        assert r["launches"]["search_step"] > 0 and r["qps"] > 0
    assert "overlap_fraction" in paths["serve-base-hostio"]
