"""A ("data", "model") or ("pod", "data", "model") mesh of ranks over
`torch.distributed`.

The counterpart of the reference's `repro.compat.make_mesh` and the meshes
of `repro.launch.mesh`. Rank r of a (P, D, S) mesh sits at pod r // (D S),
data index (r // S) % D and model index r % S; a (D, S) mesh is the (1, D,
S) one with no `pod` axis. Its model group holds the S ranks of its data
row (the index state and the LM's Megatron blocks are cut over them, and
the owner-shard all-reduces run there); its data group holds the D ranks
of its model column within its pod (the LM's FSDP blocks are cut over
them); its pod group the P ranks at its (data, model) place in every pod.
`group("batch")` is the pod x data group, the batch's axes (`DP_AXES`):
each of its ranks searches or steps on its own slice of the batch, the
results are all-gathered and the gradients summed there. Without a `pod`
axis it is the data group itself. `pod` is pure data parallelism: the
parameters are replicated across pods.

Each rank drives one device: `cuda:{local_rank}` on a card, the CPU
otherwise. With no default process group, a one-rank mesh makes a one-rank
group through `dist.HashStore()` (NCCL on a CUDA device, gloo on the CPU),
as the reference's default `make_mesh((1, n_devices))` needs no launcher.
Several ranks come from a launcher (`torchrun --nproc-per-node=N`), or
from `dist.init_process_group` called by the program, before `make_mesh`;
a fake group (`backend="fake"`, `launch.dryrun`) gives a rank of a mesh no
host holds, for a shape-only run.

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
POD_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a (D, S) or (P, D, S) mesh: the process groups it
    belongs to (one an axis, and "batch": pod x data), its coordinates and
    its device. `shape` maps axis names to sizes, as the reference's
    `Mesh.shape` does."""

    shape: dict
    device: torch.device
    groups: dict = dataclasses.field(repr=False)
    _world: object = dataclasses.field(repr=False, default=None)

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis` ("batch": pod * D + data)."""
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
    """The (D, S) ("data", "model") or (P, D, S) ("pod", "data", "model")
    mesh over the default process group, made once per group, shape and
    device and reused after. With no default group, a one-rank group is
    made for a mesh of one rank; a larger mesh needs the group to exist
    with as many ranks as the mesh."""
    shape = tuple(int(s) for s in axis_shapes)
    names = tuple(axis_names)
    if names not in (AXES, POD_AXES) or len(shape) != len(names) or min(shape) < 1:
        raise ValueError(f"need a mesh of positive shape over axes {AXES} or {POD_AXES}, "
                         f"got {shape} over {names}")
    Pn, D, S = shape if names == POD_AXES else (1, *shape)
    size = Pn * D * S
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if size != 1:
            raise RuntimeError(
                f"a {shape} mesh needs {size} ranks: start them with a launcher "
                "(torchrun) or dist.init_process_group before make_mesh"
            )
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = _default_group()
    if dist.get_world_size() != size:
        raise ValueError(f"a {shape} mesh needs {size} ranks, the group has {dist.get_world_size()}")
    key = (shape, names, dev)
    mesh = _MESHES.get(key)
    if mesh is not None and mesh.alive():
        return mesh
    rank = dist.get_rank()
    p, d, s = rank // (D * S), (rank // S) % D, rank % S

    def at(p_, d_, s_):
        return p_ * D * S + d_ * S + s_

    # Every rank makes every group, in the same order, as new_group requires:
    # model, data, then pod and batch on a pod mesh.
    model = {(a, b): dist.new_group([at(a, b, c) for c in range(S)]) for a in range(Pn) for b in range(D)}
    data = {(a, c): dist.new_group([at(a, b, c) for b in range(D)]) for a in range(Pn) for c in range(S)}
    groups = {"data": data[p, s], "model": model[p, d]}
    if names == POD_AXES:
        pod = {(b, c): dist.new_group([at(a, b, c) for a in range(Pn)]) for b in range(D) for c in range(S)}
        batch = {c: dist.new_group([at(a, b, c) for a in range(Pn) for b in range(D)]) for c in range(S)}
        groups.update(pod=pod[d, s], batch=batch[s])
    else:
        groups["batch"] = groups["data"]
    mesh = Mesh(shape=dict(zip(names, shape)), device=dev, groups=groups, _world=world)
    _MESHES[key] = mesh
    return mesh


def default_mesh(device: str | torch.device) -> Mesh:
    """The reference's default mesh, (1, every rank) over `device`: the
    whole index spread over the ranks of the default group, or one rank
    when there is none."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((1, world), AXES, device)
