"""`chip_smoke.py`'s LM phases (7-14), rehearsed on the CPU at reduced
configs.

Each phase runs here with the reduced config of each architecture (a few
layers, narrow widths), a short sequence and a one-rank gloo group in
this process where it runs on a mesh (made and destroyed by the phase);
the same checks as on the card (bit-equality with the plain path, the
collectives counted, no port kernel launched). Phase 14's dry run runs in
a subprocess of its own, on reduced configs. The ANN phases:
tests/test_torch_chip_smoke.py.
"""
import pytest
import torch

from _chip_smoke import load_smoke

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core


@pytest.fixture
def smoke(monkeypatch):
    return load_smoke(monkeypatch)


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


def test_chip_smoke_mesh_encdec_phase_on_cpu(smoke, monkeypatch):
    """Phase 13 at reduced whisper on a one-rank gloo mesh in this process
    (made and destroyed by the phase): 13a's mesh and plain training steps
    with frames, losses and parameters bit-equal; 13b's mesh prefill and
    exact-KV steps and 13c's exact-KV then BANG-KV steps with the
    hierarchical top-L bit-equal to the plain path's (logits, tokens, the
    self caches, the cross K and V, top-L ids), the collectives counted, no
    port kernel launched."""
    import torch.distributed as dist

    import repro_torch.configs as configs

    monkeypatch.setattr(smoke, "lm_config", lambda name, **kw: configs.get(name).reduced(**kw))
    for name, value in (("ENCDEC_TRAIN_TOKENS", 32), ("ENCDEC_PROMPT", 16), ("ENCDEC_BANG_PROMPT", 24),
                        ("LM_DECODE", 4), ("LM_LONG_DECODE", 3), ("LM_FIT_ITERS", 2)):
        monkeypatch.setattr(smoke, name, value)
    out = smoke.mesh_encdec_phase(torch.device("cpu"), "cpu")
    assert not dist.is_initialized()
    assert out["mesh"] == {"data": 1, "model": 1} and out["backend"] == "gloo"
    train = out["train"]
    assert train["arch"] == "whisper-medium-reduced" and train["seq_len"] == 32
    assert train["layers"] == train["layers_published"] and train["encoder_layers"] == 2
    assert train["frames"] == 4
    assert train["mesh_step"]["losses"] == train["plain_step"]["losses"]
    assert len(train["mesh_step"]["losses"]) == smoke.MESH_STEPS
    assert train["parity"]["bit_equal"] and train["parity"]["param_entries"] > 0
    counts = train["mesh_step"]["collectives_per_step"]
    assert counts["all_gather"] > 0 and counts["all_reduce"] > 0
    for key, prompt, steps, bang in (("serve", 16, 4, 0), ("bangkv", 24, smoke.ENCDEC_BANG_EXACT, 3)):
        run = out[key]
        assert run["arch"] == "whisper-medium-reduced" and run["frames"] == 4
        assert run["prompt"] == prompt and run["steps"] == steps and run["bangkv_steps"] == bang
        for path in (run["plain"], run["mesh"]):
            assert len(path["step_ms"]) == steps and path["prefill_ms"] > 0 and path["memory"] is None
            assert ("bangkv" in path) == bool(bang)
        # logits, tokens, the self caches (k, v, index) and the cross K and
        # V; with BANG-KV its logits, top-L ids and caches (codes too)
        assert run["tensors_compared"] == (3 + 5 if not bang else 3 + 5 + 2 + 6)
        for counts in (run["mesh"]["collectives_per_step"], run["mesh"]["prefill_collectives"]):
            assert counts["all_gather"] > 0 and counts["all_reduce"] > 0
        assert run["mesh"]["device_profile"] is None and run["mesh_over_plain"] > 0
    assert out["bangkv"]["mesh"]["bangkv"]["collectives_per_step"]["all_gather"] > 0
    assert out["kernel_launches"] == dict.fromkeys(smoke.kernel_counters(), 0)
    assert out["phase_s"] > 0


def test_chip_smoke_launch_phase_on_cpu(smoke, monkeypatch):
    """Phase 14 at a rehearsal's size: 14a the serve CLI at n = 400 (2
    batches of 32), its lines' recall above a floor; 14b reduced
    granite-3-2b on a one-rank gloo ("pod", "data", "model") mesh in this
    process (made and destroyed by the phase), training, prefill and
    decode bit-equal to the plain path, no port kernel launched; 14c the
    dry run's subprocess on reduced configs of every family on the fake
    2 x 16 x 16 group, and the sharded search at the reference's shapes."""
    import torch.distributed as dist

    import repro_torch.configs as configs

    monkeypatch.setattr(smoke, "lm_config", lambda name, **kw: configs.get(name).reduced(**kw))
    for name, value in (("TRAIN_SEQ", 32), ("SERVE_ARGS", ("--n", "400", "--batches", "2", "--batch-size", "32")),
                        ("SERVE_REFERENCE_RECALL", (0.5, 0.5))):
        monkeypatch.setattr(smoke, name, value)
    out = smoke.launch_phase(torch.device("cpu"), "cpu")
    assert not dist.is_initialized()
    rows = out["serve"]["batches"]
    assert [r["batch"] for r in rows] == [0, 1] and all(r["qps"] > 0 and r["recall_at_10"] >= 0.5 for r in rows)
    # The CPU's search runs the reference mode: no wrapper (the card's runs K1-K3).
    assert out["serve"]["kernel_launches"] == dict.fromkeys(smoke.kernel_counters(), 0)
    pod = out["pod_mesh"]
    assert pod["mesh"] == {"pod": 1, "data": 1, "model": 1} and pod["backend"] == "gloo"
    assert pod["train"]["bit_equal"] and pod["serve"]["bit_equal"] and pod["train"]["param_entries"] > 0
    counts = pod["train"]["collectives_per_step"]
    assert counts["all_gather"] > 0 and counts["all_reduce"] > 0
    assert pod["kernel_launches"] == dict.fromkeys(smoke.kernel_counters(), 0)
    dry = out["dryrun"]
    assert [c["arch"] for c in dry["cells"]] == [a for a, _ in smoke.DRYRUN_CELLS]
    for c in dry["cells"]:
        assert c["mesh"] == "pod2x16x16" and c["peak_bytes"] >= c["argument_bytes"] > 0 and c["fits"]
        assert c["dominant"] in ("compute", "memory", "collective") and c["collectives"]["all-gather"] > 0
    sh = dry["sharded"]
    assert sh["n_loc"] == 125_000 and sh["queries_a_rank"] == 320
    assert sh["bytes_a_rank"]["codes"] == 125_000 * 32 and sh["bytes_a_rank"]["adjacency"] == 125_000 * 64 * 4
    assert sh["collectives"]["hop"]["all-reduce"]["count"] == 2
    assert out["phase_s"] > 0
