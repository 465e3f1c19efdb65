"""Input specs, partition specs and the mesh training step of every
(arch x shape) cell.

The port of the reference package's `launch/specs.py`. `batch_specs`,
`param_specs` and `cache_specs` return tensors on the `meta` device --
shapes and dtypes, no storage -- the counterpart of the reference's
`ShapeDtypeStruct`s. `step_and_specs` binds the step of a cell and its
placements on a mesh: the training step (ROADMAP A8e-1) and the prefill
and decode steps, for every family (moe: its experts over `model`,
`_MOE_RULES`, ROADMAP A8e-2a; ssm and hybrid: the Mamba2 block's widths
over `model`, A8e-2b; encdec: whisper's encoder and cross-attention over
`model`, A8e-2c).

The training step holds this rank's blocks of the parameters and of
AdamW's master copies and moments, and this rank's slice of the batch, and
updates the blocks in place::

    step, (p_specs, opt_specs, b_specs), (p_place, opt_place, b_place) = \\
        step_and_specs(cfg, shape, mesh)
    params = shard_tree(full_params, p_place, mesh)      # distributed.partitioning
    opt_state = adamw_init(params)                       # the blocks' state
    batch = shard_tree(full_batch, b_place, mesh)
    params, opt_state, loss = step(params, opt_state, batch)

The mesh is (D, S) over ("data", "model") or (P, D, S) over ("pod",
"data", "model"); `pod` is pure data parallelism, as the reference's rules
make it: the weights are whole over it, and the batch's ranks are pod x
data. The loss is the mean over the global batch on every rank. Each
rank's loss is the mean over its slice, so the gradients are averaged over
the batch's ranks: the backward runs on loss / (batch ranks), the gradient
of a weight the rules shard over `data` is summed over `data` by its
gather's backward and then over `pod` by one all-reduce, and every other
gradient by one all-reduce over pod x data after the backward. Where the
batch does not divide the batch's ranks it is replicated over them (as
the reference's `_batch_pspec_tree`), each rank's loss is the global one,
and the same average holds. An MoE layer's load-balance and router-z terms
are the global batch's on every batch rank: their sums are all-reduced
over pod x data forward and backward (`MeshContext.sum_data`), so under
the same average each rank's tokens take their gradient once. The step
keeps the last step's metrics (`train_step.metrics`: ce averaged over the
batch's ranks with the loss, load_balance, router_z and dropped_frac the
global batch's). AdamW runs at lr 1e-4, as the reference's.

The prefill and decode steps hold the same blocks of the parameters, this
rank's slice of the batch (or of the decode tokens) and this rank's blocks
of the decode caches (`cache_pspecs`: the sequence over `model`, the batch
over pod x data where it divides)::

    prefill, _, (p_place, b_place) = step_and_specs(cfg, prefill_shape, mesh)
    logits, caches = prefill(params, shard_tree(full_batch, b_place, mesh), s_max=S + n)
    serve, _, (p_place, c_place, tok_place) = step_and_specs(cfg, decode_shape, mesh)
    logits, caches = serve(params, caches, shard_tensor(tokens, tok_place, mesh))

The logits are this rank's requests' (B / data ranks, 1, V), the whole
vocabulary gathered over `model`. The decode step's caches hold
`decode_shape.seq_len` positions in all, and it decodes with BANG-KV
where `uses_bangkv` (long_500k: zamba2's shared-block caches too, not
mamba2, which has none) -- with the hierarchical top-L when the config
asks for it (`opt_hier_topk`). An MoE layer's capacity and slots are the
global batch's: each step's `MeshContext` knows from the shape's global
batch whether the batch is cut over pod x data (long_500k's one request
is replicated over the batch's ranks). An SSM layer's caches are this rank's
channels of the conv window and heads of the state. Whisper's prefill
batch carries its frames (`frontend`, over pod x data with the tokens), and
its decode caches the cross K and V of `frontend_len` frames, cut over
the batch only: every `model` rank holds every frame and KV head.

The steps run on a runnable `Mesh` only. On a fake process group
(`backend="fake"`) under `FakeTensorMode` a `Mesh` of the production
shape runs them shape-only, every layer at the cell's global shapes, as
rank 0 (`launch.dryrun`): its collectives are counted and move nothing.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..distributed.collectives import MeshContext, check_mesh_family
from ..distributed.mesh import Mesh
from ..distributed.partitioning import P, batch_pspec, cache_pspecs, dim_axes, param_pspecs
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


def _train_step(cfg: ModelConfig, shape: ShapeSpec, mesh, p_place) -> Callable:
    specs = flat_dict(p_place)
    # The parameters the rules leave whole over `data`: their gradients
    # are summed over the batch's ranks (pod x data) after the backward;
    # the others over `pod` only.
    whole = {k for k, sp in specs.items() if not any("data" in a for a in dim_axes(sp, len(sp), mesh))}
    n_data = _data_ranks(mesh)
    mc = _context(cfg, shape, mesh)

    def train_step(params, opt_state, batch):
        _runnable(mc)
        flat = flat_dict(params)
        for p in flat.values():
            p.grad = None
        params.requires_grad_(True)
        loss, metrics = lm_loss(cfg, params, batch, mesh=mc)
        (loss / n_data).backward()
        grads = {}
        for k, p in flat.items():
            if p.grad is not None and k in whole:
                mc.sum_over_data(p.grad)   # each batch rank holds a part of the sum
            elif p.grad is not None and mc.has_pod:
                mc.sum_over_pod(p.grad)    # summed over `data` by its gather's backward
            grads[k] = p.grad
        params, opt_state, _ = adamw_update(grads, opt_state, params, LR, mesh=mesh, specs=specs)
        total = mc.sum_over_data(torch.stack([loss.detach(), metrics["ce"]])) / n_data
        train_step.metrics = dict(metrics, ce=total[1])
        return params, opt_state, total[0]

    train_step.mesh_context = mc   # its `counts` of collectives issued, by kind
    train_step.metrics = None
    return train_step


def _context(cfg: ModelConfig, shape: ShapeSpec, mesh) -> MeshContext | None:
    return MeshContext(mesh, cfg, shape.global_batch) if isinstance(mesh, Mesh) else None


def _runnable(mc) -> None:
    if mc is None:
        raise TypeError("the step runs on a runnable Mesh, not a shape-only one")


def _prefill_step(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Callable:
    mc = _context(cfg, shape, mesh)

    def prefill_step(params, batch, s_max: int | None = None):
        """(this rank's logits (B_r, 1, V), its blocks of caches of `s_max`
        positions, the prompt's length when None)."""
        _runnable(mc)
        return LM(cfg, params).prefill(batch, s_max=s_max, mesh=mc)

    prefill_step.mesh_context = mc
    return prefill_step


def _serve_step(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Callable:
    mc = _context(cfg, shape, mesh)
    bangkv = uses_bangkv(cfg, shape)

    def serve_step(params, caches, tokens):
        """One decode step of this rank's requests: (logits (B_r, 1, V),
        its blocks of the caches, updated in place)."""
        _runnable(mc)
        return LM(cfg, params).decode_step(caches, tokens, bangkv=bangkv, mesh=mc,
                                           s_max=shape.seq_len)

    serve_step.mesh_context = mc
    serve_step.bangkv = bangkv
    return serve_step


def step_and_specs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> tuple[Callable, tuple, tuple]:
    """(step, arg specs, placements) of one cell on `mesh`, as the
    reference's. For `kind == "train"`: `train_step(params, opt_state,
    batch) -> (params, opt_state, loss)`, the meta (params, AdamW state,
    batch), and their partition specs (`param_pspecs`, the batch's over the
    data axes). "prefill": `prefill_step(params, batch, s_max=None) ->
    (logits, caches)`, the meta (params, batch) and their specs. "decode":
    `serve_step(params, caches, tokens) -> (logits, caches)`, the meta
    (params, caches filled to seq_len - 1, tokens (B, 1)), and their specs
    (`cache_pspecs`; the tokens over the data axes where the batch divides
    them). The rules run on a shape-only `AbstractMesh` too; the step runs
    on a runnable `Mesh` only. Every family of `configs.ARCHS` runs on any
    mesh."""
    check_mesh_family(cfg, mesh, shape.kind)
    p_specs = param_specs(cfg)
    p_place = param_pspecs(p_specs, mesh)
    if shape.kind == "train":
        opt_specs = adamw_init(p_specs)
        b_specs = batch_specs(cfg, shape)
        placements = (p_place, param_pspecs(opt_specs, mesh), _batch_pspec_tree(b_specs, mesh))
        return _train_step(cfg, shape, mesh, p_place), (p_specs, opt_specs, b_specs), placements
    if shape.kind == "prefill":
        b_specs = batch_specs(cfg, shape)
        return (_prefill_step(cfg, shape, mesh), (p_specs, b_specs),
                (p_place, _batch_pspec_tree(b_specs, mesh)))
    divisible = shape.global_batch % _data_ranks(mesh) == 0
    c_specs = cache_specs(cfg, shape)
    tok_specs = _meta((shape.global_batch, 1), torch.int32)
    tok_place = P(batch_pspec(mesh)[0], None) if divisible else P(None, None)
    placements = (p_place, cache_pspecs(c_specs, mesh, batch_divisible=divisible), tok_place)
    return _serve_step(cfg, shape, mesh), (p_specs, c_specs, tok_specs), placements
