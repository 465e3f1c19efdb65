"""Meshes for launching: the production mesh's shape and the card's constants.

The port of the reference package's `launch/mesh.py`. The production mesh
is 16 x 16 ("data", "model") for one pod of 256 chips, or 2 x 16 x 16
("pod", "data", "model") for two, `pod` pure data parallelism (the weights
whole over it, the batch cut over pod x data). One H100 host holds no 256
ranks, so `make_production_mesh` returns the shape-only `AbstractMesh`:
the sharding rules (`distributed.partitioning`) run on it and nothing is
launched. `launch.dryrun` runs the steps shape-only on it instead, as rank
0 of a fake process group of its ranks (`dryrun.fake_mesh`).
`make_test_mesh` is the runnable mesh of `distributed.make_mesh`, (D, S)
or (P, D, S), over the default process group (gloo ranks on the CPU in the
tests, NCCL on cards).
"""
from __future__ import annotations

from ..distributed.mesh import AXES, POD_AXES, AbstractMesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16 x 16 single pod (256 ranks) or 2 x 16 x 16 two-pod (512 ranks),
    shape only."""
    if multi_pod:
        return AbstractMesh({"pod": 2, "data": 16, "model": 16})
    return AbstractMesh({"data": 16, "model": 16})


def make_test_mesh(shape=(2, 2), axes=None, device="cuda"):
    """A runnable (D, S) ("data", "model") or (P, D, S) ("pod", "data",
    "model") mesh over the default process group."""
    return make_mesh(shape, axes or (POD_AXES if len(shape) == 3 else AXES), device)


# One NVIDIA H100 SXM 80 GB (roofline denominators; NVIDIA's data sheet):
# dense bf16 tensor-core peak, HBM3 bandwidth, and NVLink to the host's
# other cards, each way.
PEAK_FLOPS_BF16 = 989e12     # per card
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW_PER_DIRECTION = 450e9   # bytes/s per card, each way
