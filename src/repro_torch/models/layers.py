"""Shared layer primitives: norms, RoPE, embeddings, initialisers, the
sequence-chunked cross-entropy.

The port of the reference package's `models/layers.py`. Parameters live in
`nn.Module`s (`ParamTree`), indexed by the reference's names; the layer math
is plain functions on tensors, computed on their inputs' device. Compute
dtype is bf16 by default; norms and softmax accumulate in float32.

`embed`, `unembed_chunked` and the serve path's `logits_head` take an
optional mesh (a `distributed.collectives.MeshContext`, the mesh steps):
the table is then this rank's block of the parameter, gathered over `data`
at its use, and where the rules split the vocabulary over `model` the
lookup, the cross-entropy and the logits are vocabulary-parallel; where
they leave it whole (granite's odd 49,155) each runs on the whole table on
every `model` rank.
"""
from __future__ import annotations

import torch
from torch import nn

from ..distributed.collectives import vocab_parallel_cross_entropy, vocab_parallel_embed


class ParamTree(nn.Module):
    """A tree of parameters with the reference's pytree names.

    Nested dicts become `ParamTree`s and lists `nn.ModuleList`s, so
    `p["attn"]["wq"]` and `"shared" in p` read as they do on the reference's
    dicts. The leaves are frozen unless `requires_grad`: the serve path
    computes no gradients, and training makes them trainable
    (`params.requires_grad_()`, as `runtime.train_loop` does).
    """

    def __init__(self, tree: dict, *, requires_grad: bool = False):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value, requires_grad=requires_grad))
            elif isinstance(value, (list, tuple)):
                self.add_module(name, nn.ModuleList(ParamTree(v, requires_grad=requires_grad)
                                                    for v in value))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=requires_grad))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def truncated_normal_init(shape, generator: torch.Generator, scale: float = 0.02,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times `scale`: drawn in float32 on the
    generator's device, then cast."""
    x = torch.empty(shape, dtype=torch.float32, device=generator.device)
    nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return x.mul_(scale).to(dtype)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + weight.float())).to(x.dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    normed = (xf - mu) * torch.rsqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(x.dtype)


def norm(x: torch.Tensor, p, kind: str, eps: float) -> torch.Tensor:
    if kind == "layernorm":
        return layernorm(x, p["w"], p["b"], eps)
    return rmsnorm(x, p["w"], eps)


def norm_params(d: int, kind: str, device=None) -> dict:
    if kind == "layernorm":
        return {"w": torch.ones((d,), dtype=torch.float32, device=device),
                "b": torch.zeros((d,), dtype=torch.float32, device=device)}
    return {"w": torch.zeros((d,), dtype=torch.float32, device=device)}  # rmsnorm stores (1+w)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) float32. The power is taken in float64 and rounded once,
    which gives the correctly rounded float32 power that the reference's XLA
    computes (float32 `pow` is an ulp off at some exponents, and at position
    32,768 an ulp of a frequency moves the angle by 2e-3). The base stays a
    Python number: a tensor made from it on the card would wait for the
    device at every call."""
    e = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(float(theta), e.double()).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), positions: broadcastable to (..., S). Rotates the
    two halves of the head dimension, as the reference's `jnp.split`."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)                    # (hd/2,)
    angles = positions[..., :, None, None].float() * freqs           # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor, mesh=None) -> torch.Tensor:
    if mesh is not None:
        block = mesh.vocab_block("embed")
        table = mesh.weight(table, "embed", "replicated" if block is None else "shard")
        if block is not None:
            return vocab_parallel_embed(tokens, table, block[0], mesh)
    return table[tokens]


class _ChunkedCrossEntropy(torch.autograd.Function):
    """Sum over tokens of logsumexp(logits) - logits[label], logits = h @ table.T
    computed a chunk of `c` positions at a time, in float32 (float64 for a
    float64 `h`). Forward keeps each position's logsumexp and drops the
    chunk's logits; backward recomputes one chunk's logits at a time and
    turns them in place into softmax - onehot, so autograd never holds
    more than one (B, c, V) buffer: at granite-3-2b's (2, 1,024, 49,155)
    chunk 403 MB of float32 logits, beside the table cast to float32 and
    its float32 gradient (403 MB each)."""

    @staticmethod
    def forward(ctx, h, table, labels, c: int):
        B, S, _ = h.shape
        cdt = torch.promote_types(h.dtype, torch.float32)
        tf = table.to(cdt)
        total = torch.zeros((), dtype=cdt, device=h.device)
        logz = torch.empty((B, S), dtype=cdt, device=h.device)
        for s0 in range(0, S, c):
            logits = h[:, s0:s0 + c].to(cdt) @ tf.T                  # (B, c, V)
            lz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, labels[:, s0:s0 + c, None])[..., 0]
            total = total + (lz - gold).sum()
            logz[:, s0:s0 + c] = lz
        ctx.save_for_backward(h, table, labels, logz)
        ctx.c = c
        return total

    @staticmethod
    def backward(ctx, grad):
        h, table, labels, logz = ctx.saved_tensors
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
            p = hc @ tf.T                                             # (B, c, V)
            p.sub_(logz[:, s0:s0 + c, None]).exp_()                   # softmax
            p.scatter_add_(-1, labels[:, s0:s0 + c, None],
                           torch.full((B, hc.shape[1], 1), -1.0, dtype=cdt, device=h.device))
            p.mul_(g)
            if want_h:
                dh[:, s0:s0 + c] = p @ tf
            if want_t:
                dt.addmm_(p.reshape(-1, p.shape[-1]).T, hc.reshape(-1, D))
        return dh, (dt.to(table.dtype) if want_t else None), None, None


def unembed_chunked(h: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
                    chunk: int, mesh=None, name: str = "embed") -> torch.Tensor:
    """Sequence-chunked cross-entropy: never materialises (B, S, V) at once.

    h: (B, S, D), table: (V, D) (the tied embedding, or the head transposed),
    labels (B, S) -> the mean cross-entropy over the n_chunks * c tokens it
    keeps: S is cut into n_chunks = max(S // chunk, 1) chunks of c = S //
    n_chunks positions, and the last S - n_chunks * c positions are dropped
    when `chunk` does not divide S, as the reference's scan drops them. The
    logits are float32; under autograd one chunk's (B, c, V) logits live at a
    time (`_ChunkedCrossEntropy` recomputes them in backward).

    With `mesh`, `table` is this rank's block of the parameter `name`:
    "embed" (V, D), or "lm_head" (D, V), which is used transposed."""
    if mesh is not None:
        block = mesh.vocab_block(name)
        table = mesh.weight(table, name, "replicated" if block is None else "shard")
        table = table.T if name == "lm_head" else table
        if block is not None:
            return vocab_parallel_cross_entropy(h, table, labels, chunk, block[0], mesh)
    B, S, _ = h.shape
    n_chunks = max(S // chunk, 1)
    c = S // n_chunks
    keep = n_chunks * c
    total = _ChunkedCrossEntropy.apply(h[:, :keep], table, labels[:, :keep].long(), c)
    return total / (B * keep)


def logits_head(h: torch.Tensor, table: torch.Tensor, name: str = "embed", mesh=None) -> torch.Tensor:
    """float32 logits (B, S, V) of h (B, S, D) against the head `name`: the
    tied "embed" (V, D), used transposed, or "lm_head" (D, V). Both are
    cast to float32 on every call, as the reference does (2.5 GB for
    glm4-9b's 151,552 x 4,096).

    With `mesh` (serving on a mesh) `table` is this rank's block of the
    parameter: where the vocabulary is split over `model`, this rank's
    block of the logits, gathered over `model` in vocabulary order."""
    block = None
    if mesh is not None:
        block = mesh.vocab_block(name)
        table = mesh.weight(table, name, "replicated" if block is None else "shard")
    head = table.T if name == "embed" else table
    logits = h.float() @ head.float()
    return logits if block is None else mesh.gather_model(logits, -1)
