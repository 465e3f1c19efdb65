"""`chip_smoke.py`, rehearsed on the CPU at a tiny size.

The script's ANN phases (3-5b; its LM phases 7-14:
tests/test_torch_chip_smoke_lm.py) run here with the kernels' plain
versions, the script loaded by `_chip_smoke.load_smoke`: the same
checks (base ids equal to inmem's, staged ids equal to fused ids, exact
fused ids equal to its reference mode's, exact re-rank distances, the mesh
paths equal to inmem and base on a one-rank gloo group, the distance-table
entry point, card vs CPU ids) at n = 3,000, d = 32, m = 8 instead of the
card's sizes, the autotuner's phase (4c) on that index, and the Vamana cell
at n = 800, R = 16, L_build = 32 with its mutation phase (5b) at 8 inserts
and 8 deletes a round. Nothing launches on the CPU, so the wrappers are
counted by stand-ins, times come from the host clock, and the device
profile is left out.
"""
import pytest
import torch

from repro_torch import SearchConfig
from repro_torch.kernels import common
from repro_torch.kernels.bitonic import ops as bitonic_ops
from repro_torch.kernels.pq_adc import ops as adc_ops
from repro_torch.kernels.pq_table import ops as table_ops
from repro_torch.kernels.search_step import ops as step_ops

from _chip_smoke import load_smoke

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core


@pytest.fixture
def smoke(monkeypatch):
    return load_smoke(monkeypatch)


@pytest.mark.parametrize("phase", ["kernels", "paths"])
def test_chip_smoke_phases_on_cpu(smoke, phase):
    """Phase 3 ("kernels": each kernel against its plain version, its
    sweeps and regimes) and phases 4 and 4c ("paths": the main paths on
    one index, the distance-table entry point, the small index card
    against CPU, and the autotuner on phase 4's executor)."""
    cpu = torch.device("cpu")
    if phase == "paths":
        _main_paths(smoke, cpu)
        return
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


def _main_paths(smoke, cpu):
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
    # Phase 4c on the same index: one winner for bucket BATCH over eager
    # True and False, and the tuned executor's search counted as a path.
    tuned = smoke.autotune_phase(cpu, "cpu", res["ctx"])["autotune-inmem"]
    assert [(c["eager"], c["codes_tile_rows"]) for c in tuned["sweep"]] == [(True, 0), (False, 0)]
    assert all(len(c["per_hop_us"]) == 2 for c in tuned["sweep"])
    assert tuned["winner"]["per_hop_us"] == min(min(c["per_hop_us"]) for c in tuned["sweep"])
    assert tuned["device_kind"] == "cpu" and tuned["n_batches"] == 1
    assert tuned["launches"]["search_step"] == tuned["n_iters"][0] and tuned["launches"]["rerank_l2"] == 1


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
    # The cell's graph is the host build of the same data and parameters;
    # the draw also holds the queries and phase 5b's inserts.
    data = gaussian_mixture(smoke.VAMANA_N + smoke.VAMANA_QUERIES + 2 * smoke.MUT_INSERTS, smoke.D,
                            seed=smoke.SEED, intrinsic_dim=smoke.INTRINSIC_DIM)[: smoke.VAMANA_N]
    assert res["ctx"]["fresh"].shape == (2 * smoke.MUT_INSERTS, smoke.D)
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

    # Phase 5b on the cell's index, its checks made inside the phase.
    mut = smoke.mutation_phase(torch.device("cpu"), "cpu", res["ctx"])
    assert not torch.distributed.is_initialized()        # the one-rank group is gone
    mpaths, info = mut["paths"], mut["info"]
    stages = ("inmem", "base", "exact", "sharded", "staged", "inserts")
    assert list(mpaths) == ([f"mutable-{v}" for v in stages] + [f"consolidated-{v}" for v in stages]
                            + ["mutable-during-fold", "serve-mutable-inmem"])
    assert mpaths["mutable-inserts"]["recall_at_10"] == 1.0          # the exact delta scan
    folded = mpaths["consolidated-inserts"]
    assert folded["in_degree_mean"] >= 1 and folded["out_degree_mean"] >= 1
    assert 0 < folded["recall_at_10"] <= folded["in_top10"] <= 1
    assert 0 < folded["base_own_id_at_rank0"] <= 1
    assert 0 < info["second_round_own_id_at_rank0"] <= 1
    for stage in ("mutable", "consolidated"):
        assert 0.5 < mpaths[f"{stage}-inmem"]["recall_at_10"] <= 1.0
        r = mpaths[f"{stage}-inmem"]
        lk = r["launches"]
        assert r["n_batches"] == len(r["n_iters"]) == len(r["batch_wall_ms"]) == 2
        assert lk["search_step"] == sum(r["n_iters"]) and lk["rerank_l2"] == 2
        # The delta fusion runs on the host while delta points are live.
        assert (r["fuse_ms_per_batch"] > 0) == (stage == "mutable")
        assert mpaths[f"{stage}-exact"]["launches"]["fused_traverse"] > 0
        sh = mpaths[f"{stage}-sharded"]["launches"]
        assert sh["local_adc"] > 0 and sh["fused_traverse"] > 0 and sh["search_step"] == 0
        st = mpaths[f"{stage}-staged"]["launches"]
        assert st["bitonic_sort"] == st["bitonic_merge"] > 0 and st["search_step"] == 0
    fold = info["consolidate_s"]
    assert set(fold) == {"relink_s", "insert_s", "encode_s", "swap_s", "total_s"}
    assert fold["total_s"] >= fold["relink_s"] + fold["insert_s"] + fold["encode_s"]
    # On the CPU the re-encode is the CPU pq_encode itself.
    assert info["codes_rows_differing_from_cpu"] == 0
    assert info["codes_rows"] == smoke.VAMANA_N + smoke.MUT_INSERTS
    assert info["consolidated_stats"]["generation"] == 1 and info["consolidated_stats"]["delta_points"] == 0
    assert info["batches_during_fold"] >= 1 and info["qps_before_fold"] > 0 and info["qps_during_fold"] > 0
    assert info["final_stats"]["generation"] == 2
    assert info["final_stats"]["base_n"] == smoke.VAMANA_N + 2 * smoke.MUT_INSERTS
    assert mpaths["serve-mutable-inmem"]["launches"]["search_step"] > 0


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


def test_code_gaps_reports_each_differing_code(smoke):
    """Phase 5b's C10 check: one line for each (row, subspace) whose codes
    differ, with both centroids' float64 squared distances and the gap in
    float32 ulps; none where the codes agree."""
    import numpy as np

    rng = np.random.default_rng(0)
    cb = torch.from_numpy(rng.standard_normal((2, 256, 4)).astype(np.float32))
    data = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 256, (5, 2)).astype(np.uint8))
    assert smoke.code_gaps(cb, data, codes, codes.clone()) == []
    other = codes.clone()
    other[3, 1] = (int(codes[3, 1]) + 1) % 256
    (gap,) = smoke.code_gaps(cb, data, codes, other)
    x = data[3, 4:].double()
    d2 = [float(((x - cb[1, int(c)].double()) ** 2).sum()) for c in (codes[3, 1], other[3, 1])]
    assert (gap["row"], gap["subspace"]) == (3, 1) and gap["card_d2"] == d2[0] and gap["cpu_d2"] == d2[1]
    assert gap["gap"] == abs(d2[0] - d2[1]) and gap["ulp_at_d2"] == float(np.spacing(np.float32(max(d2))))
    assert gap["gap_in_ulps_of_terms"] == gap["gap"] / gap["ulp_at_terms"]
