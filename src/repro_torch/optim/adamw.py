"""AdamW with float32 master weights and global-norm clipping.

The port of the reference package's `optim/adamw.py`. Model parameters live
in bf16 (forward and backward bandwidth); the optimizer carries float32
master copies and float32 (mu, nu): 12 bytes a parameter. The state holds
one tensor a parameter in dicts keyed by the parameter's path in its tree
(`tree.flat_dict`: "layers/0/attn/wq"), and `adamw_update` updates the
state and the parameters in place -- the counterpart of the reference's
donated buffers.

Every leaf of the tree is updated, as the reference updates every leaf of
its pytree: a parameter whose gradient is None (the BANG-KV codebooks,
which the loss does not read) is updated as if its gradient were zero, so
only weight decay moves it -- unlike `torch.optim.AdamW`, which skips it.
The clip, the bias correction and the master copies follow the reference,
which `torch.optim` does not; its update is per-leaf torch ops.

On a mesh (the mesh training step) the parameters, gradients and state are
this rank's blocks and the update is elementwise on them; only the global
norm reads across the mesh: each rank sums the squares of its own blocks,
counting a block only on the first rank of every mesh axis its partition
spec leaves it whole on (each parameter once, not once a replica), and the
sums are all-reduced over `model`, then over `data`, then over `pod`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..distributed.partitioning import dim_axes
from ..tree import flat_dict


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor     # () int32, on the parameters' device
    mu: dict               # {path: float32 tensor}
    nu: dict
    master: dict           # float32 copies of the parameters


def adamw_init(params) -> AdamWState:
    """Zero moments and float32 master copies of `params` (a `ParamTree`, or
    any tree of tensors), on each parameter's device."""
    flat = flat_dict(params)
    dev = next(iter(flat.values())).device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu={k: zeros(p) for k, p in flat.items()},
        nu={k: zeros(p) for k, p in flat.items()},
        master={k: p.detach().to(torch.float32, copy=True) for k, p in flat.items()},
    )


def global_norm(tensors, *, mesh=None, specs=None) -> torch.Tensor:
    """sqrt of the sum of every entry squared, in float32 (None entries are
    zeros), the leaves' sums added in order as the reference's.

    With `mesh` (a runnable `Mesh`), `tensors` are this rank's blocks and
    `specs` their partition specs, in the same order: a block enters this
    rank's sum only where the rank is first on every axis the spec does not
    name, and the sums are all-reduced over `model`, then over `data`,
    then over `pod` where the mesh has it (every rank calls it)."""
    tensors = list(tensors)
    dev = next((x.device for x in tensors if x is not None), None)
    if dev is None:
        raise ValueError("no gradient to take the norm of")
    if mesh is not None:
        tensors = [x if x is not None and _counts_here(x, spec, mesh) else None
                   for x, spec in zip(tensors, specs)]
    total = None
    for x in tensors:
        if x is None:
            continue
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    if mesh is not None:
        if total is None:   # this rank holds no block it counts
            total = torch.zeros((), dtype=torch.float32, device=dev)
        for axis in ("model", "data", "pod"):
            if axis in mesh.shape:
                dist.all_reduce(total, group=mesh.group(axis))
    return torch.sqrt(total)


def _counts_here(x: torch.Tensor, spec, mesh) -> bool:
    """Whether this rank's block of a tensor under `spec` enters its sum:
    the rank is first along every mesh axis the spec does not name."""
    named = {n for names in dim_axes(spec, x.dim(), mesh) for n in names}
    return all(mesh.index(axis) == 0 for axis in mesh.shape if axis not in named)


@torch.no_grad()
def adamw_update(grads: dict, state: AdamWState, params, lr, cfg: AdamWConfig = AdamWConfig(), *,
                 mesh=None, specs: dict | None = None):
    """One optimizer step: `grads` {path: tensor or None} in `params`' flat
    layout (`tree.flat_dict`). Updates `state` and `params` in place and
    returns (params, state with the new step, metrics): grad_norm is the
    norm before clipping, lr the step size as a float32 scalar. On a mesh
    every tensor is this rank's block and `specs` {path: partition spec}
    says how each was cut (the global norm counts each parameter once)."""
    flat = flat_dict(params)
    gnorm = global_norm((grads.get(k) for k in flat), mesh=mesh,
                        specs=None if specs is None else [specs[k] for k in flat])
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    stepf = step.float()
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
    for k, p in flat.items():
        g, mu, nu, master = grads.get(k), state.mu[k], state.nu[k], state.master[k]
        if g is None:          # a zero gradient
            mu.mul_(cfg.b1)
            nu.mul_(cfg.b2)
        else:
            g = g.float() * scale
            mu.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            nu.mul_(cfg.b2).add_(g.mul(1 - cfg.b2).mul_(g))
        upd = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        upd.add_(cfg.weight_decay * master)
        master.sub_(lr * upd)
        p.copy_(master)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, state._replace(step=step), metrics
