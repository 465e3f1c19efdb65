"""`chip_smoke.py`, rehearsed on the CPU at a tiny size.

The script's phases run here with the kernels' plain versions: the same
checks (ids equal to the plain path, exact re-rank distances, card vs CPU
ids) at n = 3,000, d = 32, m = 8 instead of the card's sizes. Nothing
launches on the CPU, so the wrappers are counted by stand-ins, times come
from the host clock, and the device profile is left out.
"""
import importlib.util
import time
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.pq_adc import ops as adc_ops
from repro_torch.kernels.rerank_l2 import ops as rr_ops
from repro_torch.kernels.search_step import ops as step_ops

SCRIPT = Path(__file__).resolve().parents[1] / "chip_smoke.py"


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
    for name, value in (("N", 3000), ("D", 32), ("M", 8), ("N_QUERIES", 64), ("BATCH", 32),
                        ("time_ms", _host_time_ms)):
        monkeypatch.setattr(mod, name, value)
    # Device tracing has nothing to trace here (and takes seconds on the host).
    monkeypatch.setattr(mod, "profile_batch", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for ops, name in ((step_ops, "fused_step"), (adc_ops, "adc"), (rr_ops, "exact_sq_dists")):
        monkeypatch.setattr(ops, name, _counted(getattr(ops, name)))
    return mod


def test_chip_smoke_phases_on_cpu(smoke):
    cpu = torch.device("cpu")
    rows = smoke.check_kernels(cpu)
    assert [r["name"] for r in rows] == ["search_step", "pq_adc", "rerank_l2"]
    assert all(r["max_abs_err"] == 0.0 and r["bound_ms"] > 0 for r in rows)
    res = smoke.main_path(cpu, "cpu")
    assert res["launches"] == {"search_step": 2 * res["mean_n_iters"], "pq_adc": 2, "rerank_l2": 2}
    assert 0.0 < res["recall_at_10"] <= 1.0 and res["nn_contrast"] > 1.0
    assert res["device_busy_ms_per_batch"] is None     # no device on the CPU
    assert smoke.small_vs_cpu(cpu) > 0.5


def test_chip_smoke_refuses_without_a_card(smoke, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out
