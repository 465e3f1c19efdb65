"""`chip_smoke.py`, rehearsed on the CPU at a tiny size.

The script's phases run here with the kernels' plain versions: the same
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
                        ("MUT_INSERTS", 8), ("MUT_DELETES", 8), ("MUT_BATCHES", 2),
                        ("PATH_BATCHES", {"inmem": 3, "base": 2, "exact": 2, "sharded": 3,
                                          "sharded-base": 2}),
                        # A tenth of the rehearsal graph's 800 rows, as 1,500 of 15,000.
                        ("VAMANA_HOSTIO", dict(mod.VAMANA_HOSTIO, hot_cache_rows=80)),
                        ("time_ms", _host_time_ms)):
        monkeypatch.setattr(mod, name, value)
    # On the CPU the sharded re-rank follows XLA:CPU's order outside the
    # re-rank kernel's wrapper (it launches K3 on the card only).
    kernels = dict(mod.PATH_KERNELS)
    for name in ("sharded", "sharded-base", "sharded-base-hostio", "mutable-sharded",
                 "consolidated-sharded"):
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


def test_chip_smoke_lm_phase_on_cpu(smoke, monkeypatch):
    """Phase 7 at the reduced configs: 7a's batch prefilled and decoded,
    7b's long request exact and BANG-KV from one state, 7e-7g (mamba2,
    zamba2 with its exact and BANG-KV steps from one state, whisper with
    its encoder), 7c's prefill-decode checks (glm4-9b, phi3.5-moe, mamba2,
    zamba2, whisper, and BANG-KV with a covering top-L where there is
    attention), 7d's card-against-CPU check for four families (CPU against
    CPU here), and no port kernel launched."""
    import repro_torch.configs as configs

    monkeypatch.setattr(smoke, "lm_config", lambda name, **kw: configs.get(name).reduced(**kw))
    for name, value in (("LM_PROMPT", 32), ("LM_DECODE", 4), ("LM_LONG", 64),
                        ("LM_LONG_DECODE", 3), ("LM_FIT_ITERS", 3), ("ENCDEC_PROMPT", 12)):
        monkeypatch.setattr(smoke, name, value)
    out = smoke.lm_phase(torch.device("cpu"), "cpu")
    assert out["arch"] == "glm4-9b-reduced" and out["params"] > 0 and out["param_bytes"] > 0
    serve, long = out["serve"], out["long"]
    assert serve["requests"] == smoke.LM_REQUESTS and len(serve["step_ms"]) == 4
    # K and V: L, B, the prompt, the steps and one profiled step, Hkv, hd, bf16.
    assert serve["kv_cache_bytes"] == 2 * 4 * 4 * (32 + 4 + 1) * 2 * 16 * 2
    assert serve["tokens_per_s"] > 0 and serve["memory"] is None
    for stats in (serve, long["exact_decode"], long["bangkv_decode"]):
        assert stats["device_busy_ms_per_step"] is stats["idle_share"] is None   # no card
    assert long["s_long"] == 64 and long["fit_iters"] == 3
    assert len(long["exact_decode"]["step_ms"]) == len(long["bangkv_decode"]["step_ms"]) == 3
    assert len(long["logit_corr"]) == len(long["argmax_agree"]) == 3
    assert all(-1.0 <= c <= 1.0 for c in long["logit_corr"])
    assert long["scan_bytes_per_key"] == {"bangkv_codes": 4, "exact_k": 32}

    ssm = out["ssm"]
    assert ssm["arch"] == "mamba2-2.7b-reduced" and ssm["params"] > 0
    assert ssm["serve"]["requests"] == 4 and ssm["long"]["prompt_tokens"] == 64
    # conv window (bf16) and state (float32) of every layer: the same bytes
    # a request at 32 and 64 tokens.
    cfg = configs.get("mamba2-2.7b").reduced()
    conv_ch = cfg.ssm_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    assert ssm["cache_bytes_per_request"] == cfg.n_layers * (
        (cfg.ssm_conv - 1) * conv_ch * 2 + cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4)
    hyb = out["hybrid"]
    assert hyb["arch"] == "zamba2-2.7b-reduced" and hyb["n_groups"] == 2
    assert len(hyb["serve"]["step_ms"]) == 4 and len(hyb["logit_corr"]) == len(hyb["argmax_agree"]) == 3
    assert all(-1.0 <= c <= 1.0 for c in hyb["logit_corr"])
    assert all(0.0 <= a <= 1.0 for a in hyb["argmax_agree"])
    enc = out["encdec"]
    assert enc["arch"] == "whisper-medium-reduced" and enc["serve"]["prompt_tokens"] == 12
    assert enc["serve"]["encoder_ms"] > 0 and len(enc["serve"]["step_ms"]) == 4
    for st in (ssm["serve"], ssm["long"], hyb["serve"], enc["serve"]):
        assert st["idle_share"] is None and st["prefill_tokens_per_s"] > 0 and st["memory"] is None

    dense, moe, mamba, zamba, whisper = out["consistency"]
    assert dense["arch"] == "glm4-9b-reduced" and moe["arch"] == "phi3.5-moe-42b-a6.6b-reduced"
    for c in (dense, moe, whisper):
        assert c["layers"] == smoke.LM_CUT_LAYERS and c["dtype"] == "float32"
        assert c["max_abs_diff"] < 1e-5 and c["bangkv_cover_max_abs_diff"] < 1e-5
    assert whisper["encoder_layers"] == smoke.LM_CUT_LAYERS
    # The SSM's prefill window is rounded through bf16, as the reference's:
    # within 7c's 2e-2 bound, not equal.
    assert mamba["bangkv_cover_max_abs_diff"] is None and mamba["max_abs_diff"] < 2e-2
    assert zamba["layers"] == smoke.HYBRID_CUT_LAYERS and zamba["max_abs_diff"] < 2e-2
    assert zamba["bangkv_cover_max_abs_diff"] < 2e-2
    assert moe["capacity_factor"] == 16.0 and moe["default_capacity_factor"] == 1.25
    assert 0.0 < moe["dropped_frac_default_capacity"] < 1.0 and "dropped_frac_default_capacity" not in dense
    cpus = {c["arch"]: c for c in out["card_vs_cpu"]}
    assert sorted(cpus) == ["glm4-9b-reduced", "mamba2-2.7b-reduced", "whisper-medium-reduced",
                            "zamba2-2.7b-reduced"]
    for name, cpu in cpus.items():
        assert cpu["prefill_max_abs_diff"] == cpu["exact_decode_max_abs_diff"] == 0.0
        if name != "mamba2-2.7b-reduced":
            assert cpu["bangkv_decode_max_abs_diff"] == 0.0 and cpu["top_l_overlap"] == 1.0
            assert cpu["prefill_k_max_abs_diff"] == cpu["prefill_v_max_abs_diff"] == 0.0
        if name in ("mamba2-2.7b-reduced", "zamba2-2.7b-reduced"):
            # The SSM families decode from both devices' prefill states.
            assert cpu["own_state_exact_decode_max_abs_diff"] == 0.0
            assert cpu["prefill_conv_entries_differing"] == 0 and cpu["prefill_conv_entries"] > 0
            assert cpu["prefill_ssm_state_max_abs_diff"] == 0.0
    assert "top_l_overlap" not in cpus["mamba2-2.7b-reduced"]
    assert "own_state_exact_decode_max_abs_diff" not in cpus["glm4-9b-reduced"]
    assert out["kernel_launches"] == dict.fromkeys(smoke.kernel_counters(), 0)
    assert out["phase_s"] > 0 and out["memory_before"] is None


def test_chip_smoke_train_phase_on_cpu(smoke, monkeypatch):
    """Phase 8 at the reduced configs: 8a's run (8 steps, the optimizer
    alone), 8b's five cut-depth families (3 steps each), 8c's card against
    CPU (CPU against CPU here: every difference 0), 8d's failure and resume
    bit-equal, and no port kernel launched."""
    import repro_torch.configs as configs

    monkeypatch.setattr(smoke, "lm_config", lambda name, **kw: configs.get(name).reduced(**kw))
    for name, value in (("TRAIN_SEQ", 32), ("ENCDEC_TRAIN_TOKENS", 12)):
        monkeypatch.setattr(smoke, name, value)
    out = smoke.train_phase(torch.device("cpu"), "cpu")
    full = out["full"]
    assert full["arch"] == "granite-3-2b-reduced" and full["steps"] == 8 == len(full["losses"])
    assert full["seq_len"] == 32 and full["batch"] == smoke.TRAIN_BATCH
    assert full["lrs"][0] == 0.0 and max(full["lrs"]) == pytest.approx(smoke.TRAIN_PEAK_LR)
    assert all(l > 0 for l in full["losses"]) and all(g > 0 for g in full["grad_norms"])
    cfg = configs.get("granite-3-2b").reduced()
    assert full["model_flops_per_step"] == 6 * cfg.param_count() * 2 * 32
    assert full["optimizer_ms"] > 0 and full["tokens_per_s"] > 0 and full["mfu"] > 0
    # Parameters (bf16 weights, float32 norms and codebooks) and the AdamW
    # state (mu, nu, master: 12 bytes a parameter).
    n = full["params"]
    assert 2 * n < full["param_bytes"] < 4 * n and full["state_bytes"] == full["param_bytes"] + 12 * n
    assert full["idle_share"] is None and full["memory"] is None
    cut = {c["arch"]: c for c in out["cut"]}
    assert sorted(cut) == ["internvl2-1b-reduced", "mamba2-2.7b-reduced", "phi3.5-moe-42b-a6.6b-reduced",
                           "whisper-medium-reduced", "zamba2-2.7b-reduced"]
    assert cut["phi3.5-moe-42b-a6.6b-reduced"]["layers"] == smoke.MOE_TRAIN_LAYERS
    assert cut["zamba2-2.7b-reduced"]["layers"] == smoke.HYBRID_CUT_LAYERS
    assert cut["whisper-medium-reduced"]["encoder_layers"] == smoke.LM_CUT_LAYERS
    assert cut["whisper-medium-reduced"]["seq_len"] == 12
    for c in cut.values():
        assert c["steps"] == len(c["losses"]) == smoke.CUT_TRAIN_STEPS and c["dtype"] == "bfloat16"
    assert cut["phi3.5-moe-42b-a6.6b-reduced"]["metrics_last"]["load_balance"] > 0
    assert [c["arch"] for c in out["card_vs_cpu"]] == [
        "granite-3-2b-reduced", "phi3.5-moe-42b-a6.6b-reduced", "mamba2-2.7b-reduced",
        "zamba2-2.7b-reduced", "whisper-medium-reduced"]
    for c in out["card_vs_cpu"]:
        assert c["loss_abs_diff"] == c["grad_norm_abs_diff"] == c["losses_max_abs_diff"] == 0.0
        assert c["master_max_abs_diff"] == 0.0 and c["master_entries"] > 0
    res = out["resume"]
    assert res["bit_equal"] and res["resumed_losses"] == res["whole_losses"][6:]
    assert out["kernel_launches"] == dict.fromkeys(smoke.kernel_counters(), 0)
    assert out["phase_s"] > 0

def test_chip_smoke_mesh_phase_on_cpu(smoke, monkeypatch):
    """Phase 9 at reduced granite on a one-rank gloo mesh in this process
    (made and destroyed by the phase): 9a's mesh steps and plain steps,
    losses and parameters bit-equal, the collectives counted; 9b's
    compressed_psum bit-equal to ef_int8_compress; no port kernel
    launched."""
    import torch.distributed as dist

    import repro_torch.configs as configs

    monkeypatch.setattr(smoke, "lm_config", lambda name, **kw: configs.get(name).reduced(**kw))
    monkeypatch.setattr(smoke, "TRAIN_SEQ", 32)
    out = smoke.mesh_phase(torch.device("cpu"), "cpu")
    assert not dist.is_initialized()
    assert out["arch"] == "granite-3-2b-reduced" and out["mesh"] == {"data": 1, "model": 1}
    assert out["backend"] == "gloo" and out["seq_len"] == 32 and out["lr"] == 1e-4
    ms, plain = out["mesh_step"], out["plain_step"]
    assert len(ms["losses"]) == len(plain["losses"]) == smoke.MESH_STEPS
    assert ms["losses"] == plain["losses"] and all(l > 0 for l in ms["losses"])
    assert out["parity"]["bit_equal"] and out["parity"]["param_entries"] > 0
    assert out["parity"]["param_entries_differing"] == 0
    counts = ms["collectives_per_step"]
    assert counts["all_gather"] > 0 and counts["all_reduce"] > 0
    assert ms["device_profile"] is None and ms["idle_share"] is None and ms["memory"] is None
    assert out["compressed_psum"]["bit_equal_to_ef_int8"] and out["compressed_psum"]["entries"] > 0
    assert out["kernel_launches"] == dict.fromkeys(smoke.kernel_counters(), 0)
    assert out["phase_s"] > 0 and out["mesh_over_plain"] > 0


def test_chip_smoke_mesh_serve_phase_on_cpu(smoke, monkeypatch):
    """Phase 10 at reduced glm4-9b on a one-rank gloo mesh in this process
    (made and destroyed by the phase), from the state of a reduced 7b run:
    10a's mesh prefill and exact-KV steps and 10b's BANG-KV steps with the
    hierarchical top-L bit-equal to the plain path's (logits, tokens,
    caches, every layer's top-L ids), the collectives counted, no port
    kernel launched."""
    import torch.distributed as dist

    import repro_torch.configs as configs

    monkeypatch.setattr(smoke, "lm_config", lambda name, **kw: configs.get(name).reduced(**kw))
    for name, value in (("LM_PROMPT", 32), ("LM_DECODE", 4), ("LM_LONG", 64),
                        ("LM_LONG_DECODE", 3), ("LM_FIT_ITERS", 3)):
        monkeypatch.setattr(smoke, name, value)
    ctx = smoke.lm_serve(torch.device("cpu"), "cpu")["ctx"]
    assert ctx["bang"].k.shape[2] == 64 + 3 + 1 and int(ctx["bang"].index[0]) == 64
    out = smoke.mesh_serve_phase(torch.device("cpu"), "cpu", ctx)
    assert not dist.is_initialized()
    assert out["arch"] == "glm4-9b-reduced" and out["mesh"] == {"data": 1, "model": 1}
    assert out["backend"] == "gloo" and out["hier_topk"]
    exact, bang = out["exact"], out["bangkv"]
    for run in (exact["plain"], exact["mesh"]):
        assert len(run["step_ms"]) == 4 and run["prefill_ms"] > 0 and run["memory"] is None
    for run in (bang["plain"], bang["mesh"]):
        assert len(run["step_ms"]) == 3 and run["memory"] is None
    cfg = configs.get("glm4-9b").reduced()
    assert bang["top_l_ids_compared"] == 3 * cfg.n_layers * cfg.n_heads * cfg.bangkv_topl
    for counts in (exact["mesh"]["collectives_per_step"], bang["mesh"]["collectives_per_step"],
                   exact["mesh"]["prefill_collectives"]):
        assert counts["all_gather"] > 0 and counts["all_reduce"] > 0
    # The hierarchical top-L gathers its candidates' scores and ids a layer.
    assert (bang["mesh"]["collectives_per_step"]["all_gather"]
            == exact["mesh"]["collectives_per_step"]["all_gather"] + 2 * cfg.n_layers)
    assert exact["mesh"]["device_profile"] is bang["mesh"]["device_profile"] is None
    assert sorted(out["collective_host_us"]) == ["all_gather", "all_reduce", "dist.all_gather",
                                                 "dist.all_reduce"]
    assert out["collectives_host_ms_per_step"] > 0
    assert exact["mesh_over_plain"] > 0 and bang["mesh_over_plain"] > 0
    assert out["kernel_launches"] == dict.fromkeys(smoke.kernel_counters(), 0)
    assert out["phase_s"] > 0


def test_chip_smoke_mesh_moe_phase_on_cpu(smoke, monkeypatch):
    """Phase 11 at reduced phi3.5-moe and llama4-scout (2 layers each) on a
    one-rank gloo mesh in this process (made and destroyed by the phase):
    11a's mesh and plain training steps, losses and parameters bit-equal;
    11b's and 11c's mesh prefill and exact-KV steps bit-equal to the plain
    path's (logits, tokens, caches, every layer's dropped fraction), the
    collectives counted, the depth cuts recorded, no port kernel
    launched."""
    import torch.distributed as dist

    import repro_torch.configs as configs

    monkeypatch.setattr(smoke, "lm_config", lambda name, **kw: configs.get(name).reduced(**kw))
    for name, value in (("TRAIN_SEQ", 32), ("LM_PROMPT", 32), ("LM_DECODE", 4), ("SCOUT_DECODE", 3),
                        ("MOE_SERVE_LAYERS", 2), ("SCOUT_SERVE_LAYERS", 2)):
        monkeypatch.setattr(smoke, name, value)
    out = smoke.mesh_moe_phase(torch.device("cpu"), "cpu")
    assert not dist.is_initialized()
    assert out["mesh"] == {"data": 1, "model": 1} and out["backend"] == "gloo"
    train = out["train"]
    assert train["arch"] == "phi3.5-moe-42b-a6.6b-reduced" and train["layers"] == 2
    assert train["layers_published"] == 4 and train["seq_len"] == 32 and train["lr"] == 1e-4
    assert train["mesh_step"]["losses"] == train["plain_step"]["losses"]
    assert len(train["mesh_step"]["losses"]) == smoke.MESH_STEPS
    assert train["parity"]["bit_equal"] and train["parity"]["param_entries"] > 0
    assert all(m["load_balance"] > 0 for m in train["mesh_step"]["metrics"])
    for key, arch, steps in (("phi_serve", "phi3.5-moe-42b-a6.6b-reduced", 4),
                             ("scout_serve", "llama4-scout-17b-a16e-reduced", 3)):
        run = out[key]
        assert run["arch"] == arch and run["layers"] == 2 and run["steps"] == steps
        for path in (run["plain"], run["mesh"]):
            assert len(path["step_ms"]) == steps and path["prefill_ms"] > 0 and path["memory"] is None
            assert 0.0 <= path["dropped_frac_decode"] < 1.0
        assert run["plain"]["dropped_frac_decode"] == run["mesh"]["dropped_frac_decode"]
        for counts in (run["mesh"]["collectives_per_step"], run["mesh"]["prefill_collectives"]):
            assert counts["all_gather"] > 0 and counts["all_reduce"] > 0
        assert run["mesh"]["device_profile"] is None and run["mesh_over_plain"] > 0
    counts = train["mesh_step"]["collectives_per_step"]
    assert counts["all_gather"] > 0 and counts["all_reduce"] > 0
    assert out["kernel_launches"] == dict.fromkeys(smoke.kernel_counters(), 0)
    assert out["phase_s"] > 0


def test_chip_smoke_mesh_ssm_phase_on_cpu(smoke, monkeypatch):
    """Phase 12 at reduced mamba2 and zamba2 on a one-rank gloo mesh in
    this process (made and destroyed by the phase): 12a's mesh and plain
    training steps, losses and parameters bit-equal; 12b's and 12c's mesh
    prefill and exact-KV steps (and 12c's BANG-KV steps with the
    hierarchical top-L) bit-equal to the plain path's (logits, tokens,
    every cache tensor, top-L ids), the collectives counted, no port kernel
    launched."""
    import torch.distributed as dist

    import repro_torch.configs as configs

    monkeypatch.setattr(smoke, "lm_config", lambda name, **kw: configs.get(name).reduced(**kw))
    for name, value in (("TRAIN_SEQ", 32), ("LM_PROMPT", 32), ("LM_DECODE", 4), ("LM_LONG_DECODE", 3),
                        ("HYBRID_CUT_LAYERS", 4), ("LM_FIT_ITERS", 2)):
        monkeypatch.setattr(smoke, name, value)
    out = smoke.mesh_ssm_phase(torch.device("cpu"), "cpu")
    assert not dist.is_initialized()
    assert out["mesh"] == {"data": 1, "model": 1} and out["backend"] == "gloo"
    for key, arch in (("ssm_train", "mamba2-2.7b-reduced"), ("hybrid_train", "zamba2-2.7b-reduced")):
        train = out[key]
        assert train["arch"] == arch and train["layers"] == 4 and train["seq_len"] == 32
        assert train["mesh_step"]["losses"] == train["plain_step"]["losses"]
        assert len(train["mesh_step"]["losses"]) == smoke.MESH_STEPS
        assert train["parity"]["bit_equal"] and train["parity"]["param_entries"] > 0
        counts = train["mesh_step"]["collectives_per_step"]
        assert counts["all_gather"] > 0 and counts["all_reduce"] > 0
    for key, arch, bang in (("ssm_serve", "mamba2-2.7b-reduced", 0),
                            ("hybrid_serve", "zamba2-2.7b-reduced", 3)):
        run = out[key]
        assert run["arch"] == arch and run["steps"] == 4 and run["bangkv_steps"] == bang
        for path in (run["plain"], run["mesh"]):
            assert len(path["step_ms"]) == 4 and path["prefill_ms"] > 0 and path["memory"] is None
            assert ("bangkv" in path) == bool(bang)
        # logits, tokens and every cache field (conv, state; k, v, index),
        # zamba2's BANG-KV logits, top-L ids and caches (codes too)
        assert run["tensors_compared"] == (3 + 2 if not bang else 3 + 5 + 2 + 6)
        for counts in (run["mesh"]["collectives_per_step"], run["mesh"]["prefill_collectives"]):
            assert counts["all_gather"] > 0 and counts["all_reduce"] > 0
        assert run["mesh"]["device_profile"] is None and run["mesh_over_plain"] > 0
    assert out["hybrid_serve"]["mesh"]["bangkv"]["collectives_per_step"]["all_gather"] > 0
    assert out["kernel_launches"] == dict.fromkeys(smoke.kernel_counters(), 0)
    assert out["phase_s"] > 0


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
