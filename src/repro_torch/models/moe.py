"""Top-k MoE with capacity-bounded scatter dispatch.

The port of the reference package's `models/moe.py`: tokens rank
themselves within their routed expert by a cumsum over the routing one-hot
(token-major, GShard semantics); tokens past the expert capacity are
dropped (their contribution falls back to the residual stream). The
(E, C, D) expert buffers are built by a scatter (`index_put_` with
`accumulate=True`; a dropped token adds a zero row to slot C-1) and
consumed by batched matmuls. The aux terms are sums over the tokens
divided by T: the per-expert counts (f), the router probabilities (P) and
logsumexp^2 (router z); the kept assignments are each expert's count capped
at C.

With a mesh (`distributed.collectives.MeshContext`: the mesh steps of
`launch.specs`) the reference's `constrain` sites become collectives and
the block keeps the one-device semantics of the global batch:

  * over the batch's ranks, `data` (and `pod`, pod-major, where the mesh
    has it; each rank a contiguous block of the batch's rows, so of the
    token-major order): C is the capacity of the global T; each expert's
    slots continue from the assignments routed to it on the batch ranks
    before this one (an all-gather of the per-expert counts, every routed
    assignment counted), so `keep` is the one-device keep; the sums of P
    and router z are all-reduced (their backward all-reduces too: with
    the loss divided by the batch ranks, each rank's tokens get the whole
    gradient of the global terms once). Where the batch is replicated
    over them (it does not divide the ranks) the rank holds every token
    and nothing is exchanged.
  * over `model` (expert parallelism, `_MOE_RULES`): a rank holds E/M
    experts, gathered over `data` at their use; it scatters the tokens
    routed to them into an (E/M, C, D) buffer, runs their products and
    combines their outputs into a partial (T, D), summed over `model` with
    the shared expert's row-parallel partial. Routing is replicated over
    `model`: the combine's share of the gradients of x and of the gate
    values is summed over `model` (`to_model`), the aux terms' share is
    not. Where E does not divide `model` every rank runs every expert and
    nothing is summed for them.

On one rank every collective is a copy and the operations are the plain
path's. Router top-k ties follow ROADMAP C2: a stable descending sort
takes the lowest expert id first among equal probabilities, as
`jax.lax.top_k` does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .ffn import swiglu
from .layers import truncated_normal_init


class MoEAux(NamedTuple):
    load_balance: torch.Tensor   # scalar
    router_z: torch.Tensor       # scalar
    dropped_frac: torch.Tensor   # scalar, fraction of routed assignments dropped


def moe_params(generator: torch.Generator, d_model: int, d_ff: int, n_experts: int,
               n_shared: int, dtype) -> dict:
    g = generator
    p = {
        "router": truncated_normal_init((d_model, n_experts), g, scale=0.01, dtype=torch.float32),
        "w_gate": truncated_normal_init((n_experts, d_model, d_ff), g, dtype=dtype),
        "w_up": truncated_normal_init((n_experts, d_model, d_ff), g, dtype=dtype),
        "w_down": truncated_normal_init((n_experts, d_ff, d_model), g, dtype=dtype),
    }
    if n_shared:
        p["shared"] = {
            "w_gate": truncated_normal_init((d_model, n_shared * d_ff), g, dtype=dtype),
            "w_up": truncated_normal_init((d_model, n_shared * d_ff), g, dtype=dtype),
            "w_down": truncated_normal_init((n_shared * d_ff, d_model), g, dtype=dtype),
        }
    return p


def capacity(T: int, top_k: int, capacity_factor: float, n_experts: int) -> int:
    """Slots per expert: rounded up to a multiple of 128 from 128 tokens on."""
    C = max(int(T * top_k * capacity_factor / n_experts), 1)
    return -(-C // 128) * 128 if T >= 128 else C


def stable_top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, the lowest
    index first among ties (`jax.lax.top_k`'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Routing(NamedTuple):
    logits: torch.Tensor       # (T, E) float32 router logits
    probs: torch.Tensor        # (T, E)
    gate_vals: torch.Tensor    # (T, k) renormalised over the k chosen
    expert_idx: torch.Tensor   # (T, k)
    onehot: torch.Tensor       # (T, k, E) int32
    pos: torch.Tensor          # (T, k) slot within the expert
    keep: torch.Tensor         # (T, k) pos < C
    counts: torch.Tensor       # (E,) int32 assignments routed to each expert, over every token


def route(router: torch.Tensor, xt: torch.Tensor, top_k: int, C: int, mesh=None) -> Routing:
    """Top-k routing of (T, D) tokens, each (token, slot) ranked within its
    expert by a cumsum over the flattened one-hot, token-major. With `mesh`
    (its batch cut over pod x data) `xt` is this batch rank's block of the
    global tokens: its slots start after the assignments of the ranks
    before it, and `counts` are the global counts."""
    T = xt.shape[0]
    E = router.shape[1]
    logits = xt.to(torch.promote_types(xt.dtype, torch.float32)) @ router   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = stable_top_k(probs, top_k)                  # (T, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(expert_idx, E).to(torch.int32)  # (T, k, E)
    flat = onehot.reshape(T * top_k, E)
    counts = flat.sum(dim=0, dtype=torch.int32)                         # (E,)
    pos_in_expert = torch.cumsum(flat, dim=0, dtype=torch.int32) - flat
    if mesh is not None and mesh.batch_cut:
        ranks = mesh.gather_data(counts)                                # (batch ranks, E)
        pos_in_expert = pos_in_expert + ranks[:mesh.batch_index].sum(dim=0, dtype=torch.int32)
        counts = ranks.sum(dim=0, dtype=torch.int32)
    pos = (pos_in_expert * flat).sum(dim=-1).reshape(T, top_k)          # (T, k)
    return Routing(logits, probs, gate_vals, expert_idx, onehot, pos, pos < C, counts)


def moe_block(
    p,
    x: torch.Tensor,                 # (B, S, D)
    *,
    n_experts: int,
    top_k: int,
    capacity_factor: float,
    bf16_compute: bool = False,      # opt_moe_bf16: bf16 buffers, f32 products
    mesh=None,
) -> tuple[torch.Tensor, MoEAux]:
    """(y (B, S, D), aux). With `mesh` (a `MeshContext`): `p` holds this
    rank's blocks, x is this rank's slice of the batch, and y and aux are
    those of the one-device block on the global batch."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    E = n_experts
    n_tok = T * mesh.n_batch if mesh is not None and mesh.batch_cut else T   # the global T
    C = capacity(n_tok, top_k, capacity_factor, E)
    router, wg, wu, wd = p["router"], p["w_gate"], p["w_up"], p["w_down"]
    split, e0 = False, 0
    if mesh is not None:
        router = mesh.weight(router, "moe/router", "replicated")
        wg, wu, wd = (mesh.weight(w, f"moe/{n}", "shard")
                      for w, n in ((wg, "w_gate"), (wu, "w_up"), (wd, "w_down")))
        split = mesh.model_sharded("moe/w_gate", 0)   # this rank's experts [e0, e0 + E/M)
        e0 = mesh.model_index * wg.shape[0] if split else 0
    logits, probs, gate_vals, expert_idx, _, pos, keep, counts = route(router, xt, top_k, C, mesh)

    # Scatter tokens into (E, C, D) expert buffers (this rank's experts).
    sel = keep
    safe_e = expert_idx
    if split:
        mine = (expert_idx >= e0) & (expert_idx < e0 + wg.shape[0])
        sel = keep & mine
        safe_e = torch.where(mine, expert_idx - e0, 0)
        xt_e, gate_vals = mesh.to_model(xt), mesh.to_model(gate_vals)
    else:
        xt_e = xt
    safe_e = safe_e.reshape(-1)                                         # (T*k,)
    safe_c = torch.where(sel, pos, C - 1).reshape(-1).long()
    src = xt_e.repeat_interleave(top_k, dim=0)                          # (T*k, D)
    src = torch.where(sel.reshape(-1, 1), src, torch.zeros((), dtype=src.dtype, device=src.device))
    buf = torch.zeros((wg.shape[0], C, D), dtype=x.dtype, device=x.device)
    buf.index_put_((safe_e, safe_c), src, accumulate=True)

    acc = torch.promote_types(x.dtype, torch.float32)   # float32 (float64 for gradcheck)
    cdt = x.dtype if bf16_compute else acc

    def bmm(a, w):
        # The reference's einsum with preferred_element_type=f32: operands in
        # cdt, products and sums in float32.
        return torch.bmm(a.to(cdt).to(acc), w.to(cdt).to(acc))

    gate = torch.nn.functional.silu(bmm(buf, wg)).to(cdt)
    up = bmm(buf, wu).to(cdt)
    out_buf = bmm(gate * up, wd).to(cdt)                                # (E, C, D)

    # Gather back + weighted combine.
    out_tok = out_buf[safe_e, safe_c]                                   # (T*k, D)
    out_tok = torch.where(sel.reshape(-1, 1), out_tok, torch.zeros((), dtype=out_tok.dtype,
                                                                   device=out_tok.device))
    w = (gate_vals * keep).reshape(T * top_k, 1)
    y = (out_tok * w).reshape(T, top_k, D).sum(dim=1)

    if "shared" in p:
        # The shared expert's row-parallel partial joins the experts' sum
        # over `model`; a whole one is added to the sum.
        ys = swiglu(p["shared"], xt, mesh, key="shared/", reduce=False).to(acc)
        shared_split = mesh is not None and mesh.model_sharded("shared/w_down", 0)
        if split and shared_split:
            y = mesh.from_model(y + ys)
        elif split:
            y = mesh.from_model(y) + ys
        elif shared_split:
            y = y + mesh.from_model(ys)
        else:
            y = y + ys
    elif split:
        y = mesh.from_model(y)

    # Switch load-balance loss E * sum_e f_e * P_e and router z, means over
    # the global T; kept assignments: each expert's first C.
    sums = torch.cat([probs.sum(dim=0), (torch.logsumexp(logits, dim=-1) ** 2).sum()[None]])
    if mesh is not None and mesh.batch_cut:
        sums = mesh.sum_data(sums)
    P, zl = sums[:E] / n_tok, sums[E] / n_tok
    f = counts.to(P.dtype) / n_tok                                      # (E,)
    lb = E * (f * P).sum()
    # 1 - kept / (T k) as XLA evaluates the reference's mean: times the
    # float32 reciprocal, the product and the difference rounded once.
    inv = torch.tensor(1.0 / (n_tok * top_k), dtype=torch.float32).item()
    dropped = (1.0 - counts.clamp(max=C).sum().double() * inv).to(P.dtype)
    return y.reshape(B, S, D).to(x.dtype), MoEAux(lb, zl, dropped)
