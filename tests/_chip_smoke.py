"""`chip_smoke.py` loaded for its CPU rehearsal
(tests/test_torch_chip_smoke.py, tests/test_torch_chip_smoke_lm.py).

`load_smoke` imports the script as a module with the ANN phases' sizes cut
to n = 3,000, d = 32, m = 8 and the Vamana cell to n = 800, R = 16,
L_build = 32; each kernel wrapper counted by a stand-in (nothing launches
on the CPU), times taken on the host clock and the device profile left
out.
"""
import importlib.util
import time
from pathlib import Path

import torch

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


def load_smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, value in (("N", 3000), ("D", 32), ("M", 8), ("N_QUERIES", 80), ("BATCH", 32),
                        ("VAMANA_N", 800), ("VAMANA_QUERIES", 30), ("VAMANA_R", 16), ("VAMANA_L", 32),
                        ("MUT_INSERTS", 8), ("MUT_DELETES", 8), ("MUT_BATCHES", 2),
                        ("PATH_BATCHES", {"inmem": 3, "base": 2, "exact": 2, "sharded": 3,
                                          "sharded-base": 2}),
                        # A tenth of the rehearsal graph's 800 rows, as 600 of 6,000.
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
