"""The port stands alone: every module of `repro_torch` imports with JAX and
the reference package blocked, and entry points default to the card."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"

BLOCKED_IMPORT = r'''
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
import torch.distributed as dist
assert not dist.is_initialized(), "importing the port made a process group"
print(" ".join(names))
'''

# Modules of the second slice: the bitonic kernels, the pinned host gather.
SECOND_SLICE = {
    "repro_torch.kernels.bitonic", "repro_torch.kernels.bitonic.ops",
    "repro_torch.kernels.bitonic.ref", "repro_torch.core.hostrows",
}
# Modules of the third slice: the mesh, the sharded search and executor, the
# distance-table kernel.
THIRD_SLICE = {
    "repro_torch.distributed", "repro_torch.distributed.mesh", "repro_torch.core.distributed",
    "repro_torch.runtime.sharded", "repro_torch.kernels.pq_table",
    "repro_torch.kernels.pq_table.ops", "repro_torch.kernels.pq_table.ref",
}
# Modules of the eighth slice: the host-side resilience and telemetry
# subsystems (the index build extends modules already listed).
EIGHTH_SLICE = {
    "repro_torch.runtime.resilience", "repro_torch.runtime.resilience.faults",
    "repro_torch.runtime.resilience.policy", "repro_torch.runtime.telemetry",
    "repro_torch.runtime.telemetry.registry", "repro_torch.runtime.telemetry.tracing",
    "repro_torch.runtime.telemetry.flightrecorder", "repro_torch.runtime.telemetry.profile",
}

# Modules of the ninth slice: the host-I/O subsystem and the serve pipeline.
NINTH_SLICE = {
    "repro_torch.runtime.hostio", "repro_torch.runtime.hostio.service",
    "repro_torch.runtime.hostio.cache", "repro_torch.runtime.hostio.prefetch",
    "repro_torch.runtime.serving",
}


def test_every_module_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run(
        [sys.executable, "-c", BLOCKED_IMPORT], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 44 and SECOND_SLICE | THIRD_SLICE | EIGHTH_SLICE | NINTH_SLICE <= names   # every module was walked


def test_from_arrays_defaults_to_cuda():
    import numpy as np
    from repro_torch import BangIndex

    rng = np.random.default_rng(0)
    args = (
        rng.standard_normal((2, 256, 2)).astype(np.float32),       # codebooks
        rng.integers(0, 256, (10, 2)).astype(np.uint8),            # codes
        rng.integers(-1, 10, (10, 3)).astype(np.int32),            # adjacency
        0,                                                         # medoid
        rng.standard_normal((10, 4)).astype(np.float32),           # data
    )
    if torch.cuda.is_available():
        assert BangIndex.from_arrays(*args).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            BangIndex.from_arrays(*args)
    idx = BangIndex.from_arrays(*args, device="cpu")
    assert idx.codes.device.type == "cpu" and idx.graph.medoid == 0
    with pytest.raises(ValueError, match="medoid"):
        BangIndex.from_arrays(*args[:3], 10, args[4], device="cpu")


def test_hostio_entry_points_default_to_cuda():
    import numpy as np
    from repro_torch.runtime.hostio import HostIOConfig, HostIORuntime, HotAdjacencyCache

    adj = np.zeros((4, 2), np.int32)
    if torch.cuda.is_available():
        assert HotAdjacencyCache(adj, 2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            HotAdjacencyCache(adj, 2)
        with pytest.raises(RuntimeError, match="CUDA"):
            HostIORuntime(HostIOConfig(), [adj], adj)
    rt = HostIORuntime(HostIOConfig(hot_cache_rows=2), [adj], adj, device="cpu")
    assert rt.cache.device.type == "cpu" and not rt.service.started
