"""Input specs, partition specs and the mesh training step of every
(arch x shape) cell.

The port of the reference package's `launch/specs.py`. `batch_specs`,
`param_specs` and `cache_specs` return tensors on the `meta` device --
shapes and dtypes, no storage -- the counterpart of the reference's
`ShapeDtypeStruct`s. `step_and_specs` binds the step of a cell and its
placements on a mesh; the training step is ported (ROADMAP A8e-1), prefill
and decode on a mesh wait for ROADMAP A8e-2.

The training step holds this rank's blocks of the parameters and of
AdamW's master copies and moments, and this rank's slice of the batch, and
updates the blocks in place::

    step, (p_specs, opt_specs, b_specs), (p_place, opt_place, b_place) = \\
        step_and_specs(cfg, shape, mesh)
    params = shard_tree(full_params, p_place, mesh)      # distributed.partitioning
    opt_state = adamw_init(params)                       # the blocks' state
    batch = shard_tree(full_batch, b_place, mesh)
    params, opt_state, loss = step(params, opt_state, batch)

The loss is the mean over the global batch on every rank. Each rank's loss
is the mean over its slice, so the gradients are averaged over `data`: the
backward runs on loss / (data ranks), the gradient of a weight the rules
shard over `data` is summed over `data` by its gather's backward, and every
other gradient by one all-reduce over `data` after the backward. Where the
batch does not divide the data ranks it is replicated over them (as the
reference's `_batch_pspec_tree`), each rank's loss is the global one, and
the same average holds. AdamW runs at lr 1e-4, as the reference's.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..distributed.collectives import MeshContext, check_mesh_family
from ..distributed.mesh import Mesh
from ..distributed.partitioning import P, batch_pspec, dim_axes, param_pspecs
from ..models.transformer import LM, init_params, lm_loss
from ..optim import adamw_init, adamw_update
from ..tree import flat_dict

LR = 1e-4


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def uses_bangkv(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    """long_500k decode uses the paper's machinery on every attention arch."""
    return (shape.name == "long_500k" and shape.kind == "decode" and cfg.n_heads > 0
            and cfg.family != "ssm")


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Token, label and frontend tensors (meta) of a train or prefill batch."""
    B, S = shape.global_batch, shape.seq_len
    specs: dict[str, Any] = {}
    if cfg.frontend == "vision_stub":
        s_text = S - cfg.frontend_len
        specs["tokens"] = _meta((B, s_text), torch.int32)
        specs["frontend"] = _meta((B, cfg.frontend_len, cfg.d_model), torch.float32)
        if shape.kind == "train":
            specs["labels"] = _meta((B, s_text), torch.int32)
    elif cfg.frontend == "audio_stub":
        specs["tokens"] = _meta((B, S), torch.int32)
        specs["frontend"] = _meta((B, cfg.frontend_len, cfg.d_model), torch.float32)
        if shape.kind == "train":
            specs["labels"] = _meta((B, S), torch.int32)
    else:
        specs["tokens"] = _meta((B, S), torch.int32)
        if shape.kind == "train":
            specs["labels"] = _meta((B, S), torch.int32)
    return specs


def param_specs(cfg: ModelConfig):
    """The parameter tree (a `ParamTree`) on the meta device."""
    return init_params(cfg, device="meta")


def cache_specs(cfg: ModelConfig, shape: ShapeSpec) -> Any:
    """The decode caches of a decode cell (meta), filled to seq_len - 1."""
    lm = LM(cfg, param_specs(cfg))
    return lm.init_decode_caches(shape.global_batch, shape.seq_len, bangkv=uses_bangkv(cfg, shape),
                                 fill=shape.seq_len - 1, memory_len=cfg.frontend_len)


def _data_ranks(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        n *= mesh.shape.get(a, 1)
    return n


def _batch_pspec_tree(specs: dict, mesh) -> dict:
    """Batch over the data-parallel axes where the batch divides their
    ranks, else replicated."""
    bp = batch_pspec(mesh)
    dp = _data_ranks(mesh)
    return {k: P(*([None] * v.dim())) if v.shape[0] % dp else P(bp[0], *([None] * (v.dim() - 1)))
            for k, v in specs.items()}


def _train_step(cfg: ModelConfig, mesh, p_place) -> Callable:
    specs = flat_dict(p_place)
    # The parameters the rules leave whole over `data`: their gradients
    # are summed over `data` after the backward.
    whole = {k for k, sp in specs.items() if not any("data" in a for a in dim_axes(sp, len(sp), mesh))}
    n_data = _data_ranks(mesh)
    mc = MeshContext(mesh, cfg) if isinstance(mesh, Mesh) else None

    def train_step(params, opt_state, batch):
        if mc is None:
            raise TypeError("the training step runs on a runnable Mesh, not a shape-only one")
        flat = flat_dict(params)
        for p in flat.values():
            p.grad = None
        params.requires_grad_(True)
        loss, _ = lm_loss(cfg, params, batch, mesh=mc)
        (loss / n_data).backward()
        grads = {}
        for k, p in flat.items():
            if p.grad is not None and k in whole:
                mc.sum_over_data(p.grad)   # each data rank holds a part of the sum
            grads[k] = p.grad
        params, opt_state, _ = adamw_update(grads, opt_state, params, LR, mesh=mesh, specs=specs)
        total = mc.sum_over_data(loss.detach().clone())
        return params, opt_state, total / n_data

    train_step.mesh_context = mc   # its `counts` of collectives issued, by kind
    return train_step


def step_and_specs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> tuple[Callable, tuple, tuple]:
    """(step, arg specs, placements) of one cell on `mesh`. For `kind ==
    "train"`: `train_step(params, opt_state, batch) -> (params, opt_state,
    loss)`, the meta (params, AdamW state, batch), and their partition
    specs (`param_pspecs`, the batch's over the data axes). The rules run on
    a shape-only `AbstractMesh` too; the step runs on a runnable `Mesh`
    only. The moe, ssm, hybrid and encdec families on a mesh of more than
    one rank raise, and so do prefill and decode (ROADMAP A8e-2)."""
    if shape.kind != "train":
        raise NotImplementedError(f"{shape.kind} on a mesh waits for ROADMAP A8e-2")
    check_mesh_family(cfg, mesh)
    p_specs = param_specs(cfg)
    opt_specs = adamw_init(p_specs)
    b_specs = batch_specs(cfg, shape)
    p_place = param_pspecs(p_specs, mesh)
    placements = (p_place, param_pspecs(opt_specs, mesh), _batch_pspec_tree(b_specs, mesh))
    return _train_step(cfg, mesh, p_place), (p_specs, opt_specs, b_specs), placements
