"""`chip_smoke.py`, rehearsed on the CPU at a tiny size.

The script's phases run here with the kernels' plain versions: the same
checks (base ids equal to inmem's, staged ids equal to fused ids, exact
fused ids equal to its reference mode's, exact re-rank distances, card vs
CPU ids) at n = 3,000, d = 32, m = 8 instead of the card's sizes. Nothing
launches on the CPU, so the wrappers are counted by stand-ins, times come
from the host clock, and the device profile is left out.
"""
import importlib.util
import time
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.bitonic import ops as bitonic_ops
from repro_torch.kernels.pq_adc import ops as adc_ops
from repro_torch.kernels.rerank_l2 import ops as rr_ops
from repro_torch.kernels.search_step import ops as step_ops

SCRIPT = Path(__file__).resolve().parents[1] / "chip_smoke.py"
WRAPPERS = ((step_ops, "fused_step"), (step_ops, "fused_traverse"), (adc_ops, "adc"),
            (rr_ops, "exact_sq_dists"), (bitonic_ops, "sort_kv"), (bitonic_ops, "merge_worklist"))


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
                        ("PATH_BATCHES", {"inmem": 3, "base": 2, "exact": 2}),
                        ("time_ms", _host_time_ms)):
        monkeypatch.setattr(mod, name, value)
    # Device tracing has nothing to trace here (and takes seconds on the host).
    monkeypatch.setattr(mod, "profile_batch", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for ops, name in WRAPPERS:
        monkeypatch.setattr(ops, name, _counted(getattr(ops, name)))
    return mod


def test_chip_smoke_phases_on_cpu(smoke):
    cpu = torch.device("cpu")
    rows = smoke.check_kernels(cpu)
    assert [r["name"] for r in rows] == ["search_step", "pq_adc", "rerank_l2", "bitonic_sort",
                                         "bitonic_merge", "fused_traverse"]
    assert all(r["max_abs_err"] == 0.0 and r["bound_ms"] > 0 for r in rows)
    assert rows[1]["at_r64"]["max_abs_err"] == 0.0
    res = smoke.main_path(cpu, "cpu")
    paths = res["paths"]
    inmem, base, exact, staged = (paths[p] for p in ("inmem", "base", "exact", "staged"))
    assert inmem["launches"] == {
        "search_step": sum(inmem["n_iters"]), "pq_adc": 3, "rerank_l2": 3,
        "bitonic_sort": 0, "bitonic_merge": 0, "fused_traverse": 0}
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
