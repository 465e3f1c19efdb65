"""The collectives of the mesh steps: training, prefill and decode.

The reference marks its Megatron-TP + FSDP design with `constrain` hints
(`models/attention.py`, `models/ffn.py`) and GSPMD inserts the collectives.
The port writes them out at the counterpart of every `constrain` site, on
plain tensors that each hold this rank's block, as autograd Functions over
a mesh's `data` and `model` groups:

  * `gather` -- forward: all-gather of the blocks along a dim (a weight
    stored sharded, gathered before its use); backward: all-reduce (SUM) of
    the full gradient over the group, then this rank's slice. The same path
    on gloo and NCCL (gloo has no reduce-scatter). Where every rank of the
    group computes the same thing with the gathered weight (`partial=False`),
    each already holds the whole gradient and the backward only slices.
  * `gather_blocks` -- `gather` over `model` for an activation cut there
    in contiguous blocks: a Mamba2 block's projection and conv output
    (`models.ssm.SSMLayout`).
  * `to_model` -- forward: identity; backward: all-reduce over `model`. A
    replicated activation (or weight) entering a computation split over
    `model`, each rank's gradient a part of the sum.
  * `from_model` -- forward: all-reduce over `model`; backward: identity.
    The partial sums of a row-parallel projection (and of an MoE block's
    experts, each `model` rank holding E/M of them).
  * `sum_data` -- forward and backward: all-reduce over `data`. The sums
    behind an MoE block's auxiliary means over the global batch (router
    probabilities and z): each data rank's loss holds the global term once
    (divided by the data ranks), so the sum of every rank's gradient is
    the gradient of its share. `gather_data` all-gathers the per-expert
    assignment counts (no gradient), from which each rank's slots start.
  * `vocab_parallel_embed` and `vocab_parallel_cross_entropy`: the embedding
    lookup and the sequence-chunked cross-entropy with the vocabulary split
    over `model` (the reference's logits are `model`-sharded,
    `models/layers.py:82-85`): the logsumexp takes its max and its sum
    across `model`, and the gold logit comes from the rank that owns it.

Serving on a mesh (prefill and decode, under `torch.no_grad()`) needs no
autograd Function: `MeshContext.gather_model` all-gathers a decode step's
query heads and its new K and V over `model`, and the vocabulary-parallel
logits (`layers.logits_head`); `reduce_model` all-reduces (MAX or SUM) the
softmax's max and sum and the partial attention outputs of a decode over
a cache cut over the sequence (`SeqBlock`: this rank's block of it).

Every collective is called whatever the group's size: a one-rank group
still launches it. `MeshContext` holds a mesh, the config's full widths (a
block's shape does not say whether its dim was cut) and the count of the
collectives it issued, by kind.
"""
from __future__ import annotations

import collections
from typing import NamedTuple

import torch
import torch.distributed as dist

from .partitioning import dim_axes, spec_for

# The families the mesh steps cover, training and serving (prefill and
# decode) alike: dense and vlm (ROADMAP A8e-1, A8e-2), moe (A8e-2a), ssm
# and hybrid (A8e-2b), audio, whisper's encoder-decoder (A8e-2c). Every
# family of `configs.ARCHS`.
MESH_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")
MESH_ARCH_KINDS = ("decoder", "encdec")
STEP_KINDS = ("train", "prefill", "decode")


def check_mesh_family(cfg, mesh, kind: str = "train") -> None:
    """Raise for a step kind other than "train", "prefill" and "decode",
    and, on a mesh of more than one rank, for a family or architecture kind
    outside `MESH_FAMILIES` and `MESH_ARCH_KINDS` (no config of
    `configs.ARCHS`)."""
    if kind not in STEP_KINDS:
        raise ValueError(f"step kind {kind!r} is not one of {STEP_KINDS}")
    n = 1
    for s in mesh.shape.values():
        n *= s
    if n > 1 and (cfg.family not in MESH_FAMILIES or cfg.arch_kind not in MESH_ARCH_KINDS):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family ({cfg.arch_kind}) has no mesh {kind} step on "
            f"{dict(mesh.shape)}")


def _all_reduce(x: torch.Tensor, mc: "MeshContext", axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    mc.count("all_reduce")
    dist.all_reduce(x, op=op, group=mc.group(axis))
    return x


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, mc: "MeshContext", axis: str, partial: bool):
        group = mc.group(axis)
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        mc.count("all_gather")
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.dim, ctx.mc, ctx.axis, ctx.partial = dim, mc, axis, partial
        ctx.n, ctx.r = n, dist.get_rank(group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = _all_reduce(g.contiguous().clone(), ctx.mc, ctx.axis)
        return g.chunk(ctx.n, ctx.dim)[ctx.r].contiguous(), None, None, None, None


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mc: "MeshContext"):
        ctx.mc = mc
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.mc, "model"), None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mc: "MeshContext"):
        return _all_reduce(x.contiguous().clone(), mc, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mc: "MeshContext"):
        ctx.mc = mc
        return _all_reduce(x.contiguous().clone(), mc, "data")

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.mc, "data"), None


class MeshContext:
    """The mesh step's view of a (data, model) `Mesh` for one config: its
    groups, this rank's coordinates, the full shape of every weight the
    step gathers, whether the batch is cut over `data` (`global_batch`
    divides the data ranks; otherwise each holds all of it; None: cut),
    and a count of the collectives issued.

    A weight is keyed by its leaf name, an MoE block's by its path within
    the block: "moe/w_gate", "moe/w_up" (E, D, F), "moe/w_down" (E, F, D)
    and "moe/router" (D, E) under `_MOE_RULES`, the shared expert's
    "shared/w_gate", "shared/w_up" (D, n_shared F), "shared/w_down" under
    the dense rules; "w_gate" is the dense FFN's. A Mamba2 block's are
    "ssm/in_proj" (D, 2 di + 2 G N + H), "ssm/out_proj" (di, D),
    "ssm/conv_w" (K, di + 2 G N), "ssm/conv_b", "ssm/A_log", "ssm/D" (the
    skip, (H,)), "ssm/dt_bias" and "ssm/norm_w" (di,); zamba2's shared
    attention block's are the dense ones, and so are whisper's: its
    encoder's, its cross block's ("wq" ... "wo" of the dense shapes) and
    their FFNs'; its norms' are whole."""

    def __init__(self, mesh, cfg, global_batch: int | None = None):
        self.mesh = mesh
        self.cfg = cfg
        self.n_data = mesh.shape["data"]
        self.n_model = mesh.shape["model"]
        self.data_index = mesh.index("data")
        self.model_index = mesh.index("model")
        self.batch_cut = global_batch is None or global_batch % self.n_data == 0
        self.counts: collections.Counter = collections.Counter()
        H, Hkv, hd, D, F, V = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model, cfg.d_ff,
                               cfg.vocab_size)
        shapes = {"wq": (D, H * hd), "wk": (D, Hkv * hd), "wv": (D, Hkv * hd), "wo": (H * hd, D),
                  "w_gate": (D, F), "w_up": (D, F), "w_down": (F, D), "embed": (V, D),
                  "lm_head": (D, V)}
        paths = {name: [name] for name in shapes}
        if cfg.n_experts:
            E, Fs = cfg.n_experts, cfg.n_shared_experts * F
            for name, shape in (("w_gate", (E, D, F)), ("w_up", (E, D, F)), ("w_down", (E, F, D)),
                                ("router", (D, E))):
                shapes["moe/" + name], paths["moe/" + name] = shape, ["moe", name]
            for name, shape in (("w_gate", (D, Fs)), ("w_up", (D, Fs)), ("w_down", (Fs, D))):
                shapes["shared/" + name], paths["shared/" + name] = shape, ["moe", "shared", name]
        if cfg.family in ("ssm", "hybrid"):
            di = cfg.ssm_expand * D
            Hs, gn = di // cfg.ssm_head_dim, cfg.ssm_groups * cfg.ssm_state
            ch = di + 2 * gn
            for name, shape in (("in_proj", (D, 2 * di + 2 * gn + Hs)), ("out_proj", (di, D)),
                                ("conv_w", (cfg.ssm_conv, ch)), ("conv_b", (ch,)), ("A_log", (Hs,)),
                                ("D", (Hs,)), ("dt_bias", (Hs,)), ("norm_w", (di,))):
                shapes["ssm/" + name], paths["ssm/" + name] = shape, ["ssm", name]
        # Each dim's axes in the stored spec of every weight the step gathers.
        self._axes = {name: dim_axes(spec_for(paths[name], shape, mesh), len(shape), mesh)
                      for name, shape in shapes.items()}

    def group(self, axis: str):
        return self.mesh.group(axis)

    def count(self, kind: str) -> None:
        self.counts[kind] += 1

    def model_sharded(self, name: str, dim: int) -> bool:
        return "model" in self._axes[name][dim]

    def weight(self, w: torch.Tensor, name: str, use: str = "shard") -> torch.Tensor:
        """The weight `name` at its use: every dim the rules cut over `data`
        gathered (the reference's FSDP gather-before-use). Over `model`:
        "shard" keeps this rank's block; "partial" gathers it whole for a
        computation each rank of `model` does a part of (or, where the rules
        left it whole, sums its gradient over `model`); "replicated" gathers
        it whole for a computation every rank of `model` repeats."""
        axes = self._axes[name]
        for d, names in enumerate(axes):
            if "data" in names:
                w = _Gather.apply(w, d, self, "data", True)
        if use == "shard":
            return w
        for d, names in enumerate(axes):
            if "model" in names:
                return _Gather.apply(w, d, self, "model", use == "partial")
        return self.to_model(w) if use == "partial" else w

    def to_model(self, x: torch.Tensor) -> torch.Tensor:
        return _ToModel.apply(x, self)

    def gather_blocks(self, x: torch.Tensor, dim: int, partial: bool) -> torch.Tensor:
        """Every `model` rank's block `x` of an activation concatenated
        along `dim`, in rank order; backward: this rank's slice of the
        gradient, summed over `model` first when `partial` (every `model`
        rank uses a part of the whole)."""
        return _Gather.apply(x, dim, self, "model", partial)

    def from_model(self, x: torch.Tensor) -> torch.Tensor:
        return _FromModel.apply(x, self)

    def sum_over_data(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce (SUM) of `x` over `data`, in place."""
        return _all_reduce(x, self, "data")

    def sum_data(self, x: torch.Tensor) -> torch.Tensor:
        """`x` summed over `data`, its gradient summed over `data` too."""
        return _SumData.apply(x, self)

    def gather_data(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's `x` stacked in rank order (no gradient)."""
        group = self.group("data")
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        self.count("all_gather")
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.stack(parts)

    # Serving: no gradient flows, so plain collectives.
    def gather_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every `model` rank's `x` concatenated along `dim`, in rank order."""
        group = self.group("model")
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        self.count("all_gather")
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    def reduce_model(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """All-reduce of `x` over `model` ("sum" or "max"), in place."""
        return _all_reduce(x, self, "model", dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)

    def seq_block(self, s_max: int) -> "SeqBlock":
        """This rank's block of a decode cache of `s_max` positions, cut
        over `model` where `s_max` divides by its ranks (`cache_pspecs`)."""
        if s_max % self.n_model == 0:
            n = s_max // self.n_model
            return SeqBlock(self, self.model_index * n, n, True, True)
        return SeqBlock(self, 0, s_max, False, self.model_index == 0)

    def vocab_block(self, name: str) -> tuple[int, int] | None:
        """(first id, ids) of this rank's vocabulary block when the rules
        split the table `name` over `model`; None when it is whole."""
        dim = 0 if name == "embed" else 1
        if not self.model_sharded(name, dim):
            return None
        n = self.cfg.vocab_size // self.n_model
        return self.model_index * n, n


class SeqBlock(NamedTuple):
    """This rank's block of a decode cache's sequence on a mesh: positions
    [lo, lo + length). `cut`: the sequence is cut over `model`, each rank
    holding its own block; otherwise every `model` rank holds all of it (a
    replica kept equal by every rank's writes) and only the first counts
    its positions in the attention (`scored`), so the sums over `model`
    count each position once."""

    mesh: MeshContext
    lo: int
    length: int
    cut: bool
    scored: bool


def vocab_parallel_embed(tokens: torch.Tensor, table: torch.Tensor, lo: int,
                         mc: MeshContext) -> torch.Tensor:
    """`layers.embed` with the table's rows [lo, lo + V/M) on this rank: the
    rows it owns looked up, the others zero, summed over `model`."""
    local = tokens - lo
    inside = (local >= 0) & (local < table.shape[0])
    h = table[local.clamp(0, table.shape[0] - 1)].masked_fill(~inside[..., None], 0)
    return mc.from_model(h)


class _VocabParallelCrossEntropy(torch.autograd.Function):
    """`layers._ChunkedCrossEntropy` with the table's rows [lo, lo + V/M) on
    this rank: each chunk's logits over its block, the logsumexp's max (MAX)
    and sum of exponentials (SUM) all-reduced over `model`, and the gold
    logit (SUM, zero on the ranks that do not own the label). Backward is
    local: softmax - onehot over the block; `h`'s gradient is this block's
    part of the sum (the caller passes `h` through `MeshContext.to_model`).
    With one rank the operations are those of `_ChunkedCrossEntropy`."""

    @staticmethod
    def forward(ctx, h, table, labels, c: int, lo: int, mc: MeshContext):
        B, S, _ = h.shape
        Vl = table.shape[0]
        cdt = torch.promote_types(h.dtype, torch.float32)
        tf = table.to(cdt)
        local = labels - lo
        inside = (local >= 0) & (local < Vl)
        local = local.clamp(0, Vl - 1)
        total = torch.zeros((), dtype=cdt, device=h.device)
        logz = torch.empty((B, S), dtype=cdt, device=h.device)
        for s0 in range(0, S, c):
            logits = h[:, s0:s0 + c].to(cdt) @ tf.T                  # (B, c, V/M)
            m = _all_reduce(logits.amax(dim=-1), mc, "model", dist.ReduceOp.MAX)
            lz = _all_reduce((logits - m[..., None]).exp_().sum(dim=-1), mc, "model")
            lz = lz.log_().add_(m)
            gold = logits.gather(-1, local[:, s0:s0 + c, None])[..., 0]
            gold = _all_reduce(gold.masked_fill_(~inside[:, s0:s0 + c], 0), mc, "model")
            total = total + (lz - gold).sum()
            logz[:, s0:s0 + c] = lz
        ctx.save_for_backward(h, table, local, inside, logz)
        ctx.c = c
        return total

    @staticmethod
    def backward(ctx, grad):
        h, table, local, inside, logz = ctx.saved_tensors
        c = ctx.c
        B, S, D = h.shape
        cdt = logz.dtype
        tf = table.to(cdt)
        want_h, want_t = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        dh = torch.empty_like(h) if want_h else None
        dt = torch.zeros(tf.shape, dtype=cdt, device=h.device) if want_t else None
        g = grad.to(cdt)
        for s0 in range(0, S, c):
            hc = h[:, s0:s0 + c].to(cdt)
            p = hc @ tf.T                                             # (B, c, V/M)
            p.sub_(logz[:, s0:s0 + c, None]).exp_()                   # softmax
            minus = torch.full((B, hc.shape[1], 1), -1.0, dtype=cdt, device=h.device)
            p.scatter_add_(-1, local[:, s0:s0 + c, None],
                           minus.masked_fill_(~inside[:, s0:s0 + c, None], 0))
            p.mul_(g)
            if want_h:
                dh[:, s0:s0 + c] = p @ tf
            if want_t:
                dt.addmm_(p.reshape(-1, p.shape[-1]).T, hc.reshape(-1, D))
        return dh, (dt.to(table.dtype) if want_t else None), None, None, None, None


def vocab_parallel_cross_entropy(h: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
                                 chunk: int, lo: int, mc: MeshContext) -> torch.Tensor:
    """`layers.unembed_chunked` with this rank's rows [lo, lo + V/M) of the
    (V, D) table: the same chunks, the same dropped tail, the mean over the
    kept tokens of this rank's batch."""
    B, S, _ = h.shape
    n_chunks = max(S // chunk, 1)
    c = S // n_chunks
    keep = n_chunks * c
    total = _VocabParallelCrossEntropy.apply(mc.to_model(h[:, :keep]), table,
                                             labels[:, :keep].long(), c, lo, mc)
    return total / (B * keep)
