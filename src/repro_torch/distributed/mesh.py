"""A ("data", "model") mesh of ranks over `torch.distributed`.

The counterpart of the reference's `repro.compat.make_mesh` and the test
mesh of `repro.launch.mesh`. Rank r of a (D, S) mesh sits at data index
r // S and model index r % S. Its model group holds the S ranks of its data
row (the index state is row-sharded over them, and the owner-shard
all-reduces run there); its data group holds the D ranks of its model
column (each searches its own slice of the batch, and the results are
all-gathered there).

Each rank drives one device: `cuda:{local_rank}` on a card, the CPU
otherwise. With no default process group, a (1, 1) mesh makes a one-rank
group through `dist.HashStore()` (NCCL on a CUDA device, gloo on the CPU),
as the reference's default `make_mesh((1, n_devices))` needs no launcher.
Several ranks come from a launcher (`torchrun --nproc-per-node=N`), or
from `dist.init_process_group` called by the program, before `make_mesh`.

`AbstractMesh` is the counterpart of JAX's shape-only mesh: axis names and
sizes, no process group. The sharding rules (`distributed.partitioning`)
read only axis sizes, so they run on it for meshes no host here holds (the
production 16 x 16 and 2 x 16 x 16 of `launch.mesh`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import torch
import torch.distributed as dist

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a (D, S) mesh: the two process groups it belongs
    to, its coordinates and its device. `shape` maps axis names to sizes, as
    the reference's `Mesh.shape` does."""

    shape: dict
    device: torch.device
    groups: dict = dataclasses.field(repr=False)
    _world: object = dataclasses.field(repr=False, default=None)

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        return dist.get_rank(self.groups[axis])

    def group(self, axis: str):
        return self.groups[axis]

    def alive(self) -> bool:
        """True while the default process group this mesh was made on
        still exists."""
        return dist.is_initialized() and _default_group() is self._world


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes with no ranks behind them:
    `AbstractMesh({"pod": 2, "data": 16, "model": 16})`. `shape` maps axis
    names to sizes in mesh order, as `Mesh.shape` does."""

    shape: dict


def _default_group():
    return dist.distributed_c10d._get_default_group()


def local_device(device: str | torch.device) -> torch.device:
    """The device this rank drives: `cuda:{LOCAL_RANK}` (or the rank modulo
    the cards present) for a CUDA mesh, the CPU otherwise."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu'")
    if dev.index is not None:
        return dev
    rank = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", rank % torch.cuda.device_count())


_MESHES: dict = {}


def make_mesh(
    axis_shapes: Sequence[int],
    axis_names: Sequence[str] = AXES,
    device: str | torch.device = "cuda",
) -> Mesh:
    """The (D, S) ("data", "model") mesh over the default process group,
    made once per group and shape and reused after. With no default group,
    a one-rank group is made for a (1, 1) mesh; a larger mesh needs the
    group to exist with D * S ranks."""
    shape = tuple(int(s) for s in axis_shapes)
    names = tuple(axis_names)
    if names != AXES or len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"need a mesh of positive shape over axes {AXES}, got {shape} over {names}")
    D, S = shape
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if D * S != 1:
            raise RuntimeError(
                f"a ({D}, {S}) mesh needs {D * S} ranks: start them with a launcher "
                "(torchrun) or dist.init_process_group before make_mesh"
            )
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = _default_group()
    if dist.get_world_size() != D * S:
        raise ValueError(f"a ({D}, {S}) mesh needs {D * S} ranks, the group has {dist.get_world_size()}")
    key = (shape, dev)
    mesh = _MESHES.get(key)
    if mesh is not None and mesh.alive():
        return mesh
    rank = dist.get_rank()
    # Every rank makes every group, in the same order, as new_group requires.
    model = [dist.new_group([d * S + s for s in range(S)]) for d in range(D)]
    data = [dist.new_group([d * S + s for d in range(D)]) for s in range(S)]
    mesh = Mesh(shape=dict(zip(names, shape)), device=dev,
                groups={"data": data[rank % S], "model": model[rank // S]}, _world=world)
    _MESHES[key] = mesh
    return mesh


def default_mesh(device: str | torch.device) -> Mesh:
    """The reference's default mesh, (1, every rank) over `device`: the
    whole index spread over the ranks of the default group, or one rank
    when there is none."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((1, world), AXES, device)
