"""The port stands alone: every module of `repro_torch` imports with JAX and
the reference package blocked, and entry points default to the card."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core

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

# Modules of the tenth slice: streaming mutability and the autotuner.
TENTH_SLICE = {"repro_torch.runtime.mutation", "repro_torch.kernels.autotune"}

# Modules of the eleventh slice: the configs and the decoder LM's serve path.
ELEVENTH_SLICE = {
    "repro_torch.configs", "repro_torch.configs.base", "repro_torch.configs.gemma3_27b",
    "repro_torch.configs.glm4_9b", "repro_torch.configs.granite_3_2b",
    "repro_torch.configs.internvl2_1b", "repro_torch.configs.llama4_scout",
    "repro_torch.configs.mamba2_2p7b", "repro_torch.configs.phi35_moe",
    "repro_torch.configs.phi3_medium_14b", "repro_torch.configs.whisper_medium",
    "repro_torch.configs.zamba2_2p7b", "repro_torch.models", "repro_torch.models.layers",
    "repro_torch.models.ffn", "repro_torch.models.attention", "repro_torch.models.moe",
    "repro_torch.models.retrieval_attention", "repro_torch.models.transformer",
}

# Modules of the twelfth slice: the Mamba2 / SSD blocks (ssm and hybrid).
TWELFTH_SLICE = {"repro_torch.models.ssm"}

# Modules of the thirteenth slice: training.
THIRTEENTH_SLICE = {
    "repro_torch.tree", "repro_torch.optim", "repro_torch.optim.adamw",
    "repro_torch.optim.schedule", "repro_torch.optim.compression", "repro_torch.checkpoint",
    "repro_torch.checkpoint.ckpt", "repro_torch.data.tokens", "repro_torch.runtime.train_loop",
    "repro_torch.launch", "repro_torch.launch.train",
}

# Modules of the fourteenth slice: the sharding rules, the mesh step's
# collectives, the launch layer's mesh and specs.
FOURTEENTH_SLICE = {
    "repro_torch.distributed.partitioning", "repro_torch.distributed.collectives",
    "repro_torch.launch.mesh", "repro_torch.launch.specs",
}

# Modules of the nineteenth slice: the launch slice's serve CLI and dry run.
NINETEENTH_SLICE = {"repro_torch.launch.serve", "repro_torch.launch.dryrun"}


def test_every_module_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run(
        [sys.executable, "-c", BLOCKED_IMPORT], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    slices = (SECOND_SLICE | THIRD_SLICE | EIGHTH_SLICE | NINTH_SLICE | TENTH_SLICE | ELEVENTH_SLICE
              | TWELFTH_SLICE | THIRTEENTH_SLICE | FOURTEENTH_SLICE | NINETEENTH_SLICE)
    assert len(names) >= 80 and slices <= names   # every module was walked


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


def test_mutable_index_and_autotune_follow_the_index_device():
    """A `MutableBangIndex` serves on its index's device, which defaults to
    the card, and so do the executors it builds after a consolidation; the
    autotuner's device kind defaults to the card too."""
    import numpy as np
    from repro_torch import BangIndex
    from repro_torch.kernels import autotune
    from repro_torch.runtime import MutableBangIndex

    if torch.cuda.is_available():
        assert autotune.device_kind() == torch.cuda.get_device_name(0)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            autotune.device_kind()
    assert autotune.device_kind("cpu") == "cpu"
    rng = np.random.default_rng(1)
    data = rng.standard_normal((40, 4)).astype(np.float32)
    codes = rng.integers(0, 256, (40, 2)).astype(np.uint8)
    adj = np.stack([np.roll(np.arange(40), -s) for s in (1, 2, 3)], 1).astype(np.int32)
    idx = BangIndex.from_arrays(rng.standard_normal((2, 256, 2)).astype(np.float32), codes, adj, 0,
                                data, device="cpu")
    mut = MutableBangIndex(idx)
    for variant in ("inmem", "base", "exact"):
        assert mut.executor(variant)._inner().device.type == "cpu"
    mut.insert(data[1] + 0.5)
    mut.delete([3])
    mut.consolidate()
    assert mut.index.device.type == "cpu" and mut.index.codes.device.type == "cpu"
    assert mut.executor("inmem")._inner().device.type == "cpu"
    assert not mut.index.graph.adjacency.is_pinned()


@pytest.mark.parametrize("name", ["glm4-9b", "mamba2-2.7b", "zamba2-2.7b", "whisper-medium"])
def test_lm_defaults_to_cuda(name):
    """`LM(cfg)`, `init_params` and the BANG-KV cache draw on the card by
    default, every family: with no card they raise and never fall back to
    the CPU."""
    import repro_torch.configs as configs
    from repro_torch.models import LM, init_params
    from repro_torch.models.retrieval_attention import bangkv_init

    cfg = configs.get(name).reduced(dtype="float32")
    if torch.cuda.is_available():
        assert LM(cfg).device.type == "cuda"
    else:
        for make in (lambda: LM(cfg), lambda: init_params(cfg),
                     lambda: bangkv_init(1, 8, 2, 16, 4)):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
    lm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    caches, leaves = [lm.init_decode_caches(1, 8)], []
    while caches:
        c = caches.pop()
        (caches if isinstance(c, tuple) else leaves).extend(c if isinstance(c, tuple) else [c])
    assert lm.device.type == "cpu" and leaves and all(x.device.type == "cpu" for x in leaves)


def test_training_defaults_to_cuda():
    """`train_loop` and the training CLI run on the card unless asked for
    the CPU: with no card they raise and never fall back to the CPU."""
    import repro_torch.configs as configs
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime import TrainLoopConfig, train_loop

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = configs.get("granite-3-2b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        train_loop(cfg, TrainLoopConfig(steps=1, seq_len=8, global_batch=1, log_every=0))
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "granite-3-2b", "--reduced", "--steps", "1"])


def test_mesh_step_defaults_to_cuda():
    """The mesh of the training step (`launch.mesh.make_test_mesh`) is made
    on the card unless asked for the CPU: with no card it raises before any
    process group exists, and never falls back to gloo on the CPU."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for shape in ((1, 1), (1, 1, 1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_test_mesh(shape)
    assert not dist.is_initialized()


def test_serve_cli_defaults_to_cuda():
    """The ANN serve CLI builds its index on the card unless asked for the
    CPU: with no card it raises and never falls back to the CPU."""
    from repro_torch.launch import serve

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--n", "64", "--batches", "1", "--batch-size", "8"])
