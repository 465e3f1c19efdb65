"""Top-k MoE with capacity-bounded scatter dispatch.

The port of the reference package's `models/moe.py`: tokens rank
themselves within their routed expert by a cumsum over the routing one-hot
(token-major, GShard semantics); tokens past the expert capacity are
dropped (their contribution falls back to the residual stream). The
(E, C, D) expert buffers are built by a scatter (`index_put_` with
`accumulate=True`; a dropped token adds a zero row to slot C-1) and
consumed by batched matmuls. On one card the reference's expert-parallel
constraints have no counterpart.

Router top-k ties follow ROADMAP C2: a stable descending sort takes the
lowest expert id first among equal probabilities, as `jax.lax.top_k` does.
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


def route(router: torch.Tensor, xt: torch.Tensor, top_k: int, C: int) -> Routing:
    """Top-k routing of (T, D) tokens, each (token, slot) ranked within its
    expert by a cumsum over the flattened one-hot, token-major."""
    T = xt.shape[0]
    E = router.shape[1]
    logits = xt.to(torch.promote_types(xt.dtype, torch.float32)) @ router   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = stable_top_k(probs, top_k)                  # (T, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(expert_idx, E).to(torch.int32)  # (T, k, E)
    flat = onehot.reshape(T * top_k, E)
    pos_in_expert = torch.cumsum(flat, dim=0, dtype=torch.int32) - flat
    pos = (pos_in_expert * flat).sum(dim=-1).reshape(T, top_k)          # (T, k)
    return Routing(logits, probs, gate_vals, expert_idx, onehot, pos, pos < C)


def moe_block(
    p,
    x: torch.Tensor,                 # (B, S, D)
    *,
    n_experts: int,
    top_k: int,
    capacity_factor: float,
    bf16_compute: bool = False,      # opt_moe_bf16: bf16 buffers, f32 products
) -> tuple[torch.Tensor, MoEAux]:
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    E = n_experts
    C = capacity(T, top_k, capacity_factor, E)
    logits, probs, gate_vals, expert_idx, onehot, pos, keep = route(p["router"], xt, top_k, C)
    dropped = 1.0 - keep.float().mean()

    # Scatter tokens into (E, C, D) expert buffers.
    safe_e = expert_idx.reshape(-1)                                     # (T*k,)
    safe_c = torch.where(keep, pos, C - 1).reshape(-1).long()
    src = xt.repeat_interleave(top_k, dim=0)                            # (T*k, D)
    src = torch.where(keep.reshape(-1, 1), src, torch.zeros((), dtype=src.dtype, device=src.device))
    buf = torch.zeros((E, C, D), dtype=x.dtype, device=x.device)
    buf.index_put_((safe_e, safe_c), src, accumulate=True)

    acc = torch.promote_types(x.dtype, torch.float32)   # float32 (float64 for gradcheck)
    cdt = x.dtype if bf16_compute else acc

    def bmm(a, w):
        # The reference's einsum with preferred_element_type=f32: operands in
        # cdt, products and sums in float32.
        return torch.bmm(a.to(cdt).to(acc), w.to(cdt).to(acc))

    gate = torch.nn.functional.silu(bmm(buf, p["w_gate"])).to(cdt)
    up = bmm(buf, p["w_up"]).to(cdt)
    out_buf = bmm(gate * up, p["w_down"]).to(cdt)                       # (E, C, D)

    # Gather back + weighted combine.
    out_tok = out_buf[safe_e, safe_c]                                   # (T*k, D)
    out_tok = torch.where(keep.reshape(-1, 1), out_tok, torch.zeros((), dtype=out_tok.dtype,
                                                                    device=out_tok.device))
    w = (gate_vals * keep).reshape(T * top_k, 1)
    y = (out_tok * w).reshape(T, top_k, D).sum(dim=1)

    if "shared" in p:
        y = y + swiglu(p["shared"], xt).to(acc)

    # Switch load-balance loss: E * sum_e f_e * P_e.
    f = onehot.sum(dim=1).float().mean(dim=0)                           # (E,)
    P = probs.mean(dim=0)
    lb = E * (f * P).sum()
    zl = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return y.reshape(B, S, D).to(x.dtype), MoEAux(lb, zl, dropped)
