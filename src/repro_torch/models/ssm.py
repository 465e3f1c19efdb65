"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060].

The port of the reference package's `models/ssm.py`. Prefill runs the
chunked SSD algorithm: a within-chunk quadratic, attention-like term, and
the state carried across chunks by the same odd/even recursion that
`jax.lax.associative_scan` runs (`_associative_scan`: O(log nc) whole-tensor
steps, the reference's order of products). Decode is the O(1) recurrent
step carrying (conv window, SSM state): the state is (B, H, P, N) float32
whatever the context's length. All recurrence math runs in float32.

Where the port cannot be bit-equal to the reference on the CPU: torch's
float32 `cumsum` there accumulates in float64 and rounds each output, and
XLA:CPU's order is another; `_segsum` then subtracts two cumsums, so the
difference of roundings shows (ROADMAP C12). The rest follows the
reference's order where it is observable: the causal conv sums its K taps
in sequence from tap 0 (a bf16-by-float32 product a tap), the decode conv
is one contraction over the taps, and the gated norm runs on `y` cast to
the model's dtype.

The conv cache: prefill rounds the window's last K-1 projections through
bf16 (the reference stores them as bf16), and the reference's decode
concatenates that window with the new projection in the model's dtype, so a
float32 model carries float32 entries from the second step on. The port
holds the window in `conv_cache_dtype` (bf16 promoted with the model's
dtype) from the start, with the same values, and a decode step updates both
fields of the cache in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import rmsnorm, truncated_normal_init


class SSMCache(NamedTuple):
    conv: torch.Tensor    # (B, K-1, conv_ch) rolling conv window; stacked (L, B, K-1, conv_ch)
    state: torch.Tensor   # (B, H, P, N) float32 SSM state; stacked (L, B, H, P, N)


def conv_cache_dtype(dtype: torch.dtype) -> torch.dtype:
    """The conv window's dtype: the reference's bf16 window concatenated
    with projections in the model's `dtype`."""
    return torch.promote_types(torch.bfloat16, dtype)


def ssm_params(generator: torch.Generator, d_model: int, *, expand: int, state: int, conv: int,
               head_dim: int, groups: int, dtype) -> dict:
    di = expand * d_model
    H = di // head_dim
    conv_ch = di + 2 * groups * state
    dev = generator.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": truncated_normal_init((d_model, 2 * di + 2 * groups * state + H), generator,
                                         dtype=dtype),
        "conv_w": truncated_normal_init((conv, conv_ch), generator, scale=0.1, dtype=torch.float32),
        "conv_b": torch.zeros((conv_ch,), **f32),
        "A_log": torch.zeros((H,), **f32),            # A = -exp(A_log) = -1 init
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.full((H,), -4.6, **f32),    # softplus^-1(0.01)
        "norm_w": torch.zeros((di,), **f32),
        "out_proj": truncated_normal_init((di, d_model), generator, dtype=dtype),
    }


def _split_proj(p, x: torch.Tensor, di: int, gn: int):
    proj = x @ p["in_proj"]
    return proj[..., :di], proj[..., di: 2 * di + 2 * gn], proj[..., 2 * di + 2 * gn:]


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _causal_conv(p, xbc: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d (K taps) + SiLU over the whole sequence: the
    taps summed in sequence from tap 0, each a product in float32."""
    K = p["conv_w"].shape[0]
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = pad[:, 0:S] * p["conv_w"][0]
    for i in range(1, K):
        out = out + pad[:, i: i + S] * p["conv_w"][i]
    return _silu(out.float() + p["conv_b"]).to(xbc.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """L[i, j] = sum_{j < l <= i} a[l] for i >= j, -inf otherwise.

    a: (..., Q) -> (..., Q, Q)."""
    Q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]          # (.., i, j) = sum(j+1..i)
    upper = torch.ones((Q, Q), dtype=torch.bool, device=a.device).triu(1)
    return diff.masked_fill_(upper, float("-inf"))


def _interleave(even: torch.Tensor, odd: torch.Tensor, axis: int) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along `axis` (len(even) - len(odd) is 0 or 1)."""
    n_even, n_odd = even.shape[axis], odd.shape[axis]
    if n_even > n_odd:
        pad = list(odd.shape)
        pad[axis] = 1
        odd = torch.cat([odd, odd.new_zeros(pad)], dim=axis)
    out = torch.stack([even, odd], dim=axis + 1).flatten(axis, axis + 1)
    return out.narrow(axis, 0, n_even + n_odd)


def _associative_scan(fn, elems: tuple, axis: int) -> tuple:
    """Inclusive scan of `elems` (a tuple of tensors) along `axis` with the
    associative `fn`: the odd/even recursion of `jax.lax.associative_scan`,
    step for step, so the products come in the reference's order."""
    n = elems[0].shape[axis]
    if n < 2:
        return elems

    def sl(e, start, stop=None, step=1):
        idx = [slice(None)] * e.dim()
        idx[axis] = slice(start, stop, step)
        return e[tuple(idx)]

    reduced = fn(tuple(sl(e, 0, -1, 2) for e in elems), tuple(sl(e, 1, None, 2) for e in elems))
    odd = _associative_scan(fn, reduced, axis)
    if n % 2 == 0:
        even = fn(tuple(sl(e, 0, -1) for e in odd), tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([sl(e, 0, 1), r], dim=axis) for e, r in zip(elems, even))
    return tuple(_interleave(e, o, axis) for e, o in zip(even, odd))


def _combine(e1: tuple, e2: tuple) -> tuple:
    """state_c = decay_c * state_{c-1} + states_c, composed."""
    d1, s1 = e1
    d2, s2 = e2
    return d1 * d2, s1 * d2[..., None, None] + s2


def ssd_chunked(
    x: torch.Tensor,       # (B, S, H, P) f32
    dt: torch.Tensor,      # (B, S, H)    f32 (softplus applied)
    A: torch.Tensor,       # (H,)         f32 (negative)
    Bm: torch.Tensor,      # (B, S, G, N) f32
    Cm: torch.Tensor,      # (B, S, G, N) f32
    chunk: int,
    init_state: torch.Tensor | None = None,   # (B, H, P, N)
    in_place: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. Returns (y (B, S, H, P), final_state (B, H, P, N)).

    B and C are used once a group, their H/G heads stacked into one product
    (the reference repeats them to every head first: the same dot
    products, without the (B, S, H, N) copies). The serve path forms the
    (B, nc, H, Q, Q) block in place; training (`in_place=False`) forms the
    same values out of place, since exp's backward reads its output."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, S)
    nc = S // Q
    if nc * Q != S:
        raise ValueError(f"seq {S} must divide by ssm chunk {Q}")

    xr = x.reshape(B_, nc, Q, H, P)
    dtr = dt.reshape(B_, nc, Q, H)
    Bg = Bm.reshape(B_, nc, Q, G, N).permute(0, 1, 3, 2, 4)   # (B, nc, G, Q, N)
    Cg = Cm.reshape(B_, nc, Q, G, N).permute(0, 1, 3, 2, 4)

    a_t = (dtr * A).permute(0, 1, 3, 2).contiguous()            # (B, nc, H, Q)
    dt_h = dtr.permute(0, 1, 3, 2)                              # (B, nc, H, Q)

    # Intra-chunk (the "quadratic attention" dual form): exp(segsum) * C.B * dt.
    cb = (Cg @ Bg.transpose(-1, -2))[:, :, :, None]              # (B, nc, G, 1, Q, Q)
    if in_place:
        w = _segsum(a_t).exp_()                                 # (B, nc, H, Q, Q)
        w.view(B_, nc, G, rep, Q, Q).mul_(cb)
        w.mul_(dt_h[..., None, :])
    else:
        w = (_segsum(a_t).exp().view(B_, nc, G, rep, Q, Q) * cb).view(B_, nc, H, Q, Q)
        w = w * dt_h[..., None, :]
    y = (w @ xr.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)  # (B, nc, Q, H, P)
    del w

    # Chunk-final states: sum_q decay_to_end[q] dt[q] x[q] B[q]^T.
    cum_a = torch.cumsum(a_t, dim=-1)                           # (B, nc, H, Q)
    decay_to_end = torch.exp(cum_a[..., -1:] - cum_a)
    xw = xr * (decay_to_end * dt_h).permute(0, 1, 3, 2)[..., None]       # (B, nc, Q, H, P)
    xw = xw.permute(0, 1, 3, 4, 2).reshape(B_, nc, G, rep * P, Q)
    states = (xw @ Bg).reshape(B_, nc, H, P, N)
    del xw

    # Inter-chunk recurrence: state_c = exp(sum a_c) * state_{c-1} + states_c,
    # with the initial state prepended as chunk -1.
    chunk_decay = torch.exp(a_t.sum(-1))                        # (B, nc, H)
    first = (torch.zeros((B_, 1, H, P, N), dtype=torch.float32, device=x.device)
             if init_state is None else init_state[:, None].float())
    decays = torch.cat([torch.ones((B_, 1, H), dtype=torch.float32, device=x.device), chunk_decay], 1)
    _, s_sc = _associative_scan(_combine, (decays, torch.cat([first, states], 1)), axis=1)
    prev_states, final_state = s_sc[:, :-1], s_sc[:, -1]        # state entering chunk c

    # Inter-chunk output: y[i] += C_i . (decay_from_start_to_i * prev_state).
    prev = prev_states.reshape(B_, nc, G, rep, P, N).permute(0, 1, 2, 5, 3, 4)
    y_inter = (Cg @ prev.reshape(B_, nc, G, N, rep * P)).reshape(B_, nc, G, Q, rep, P)
    y_inter = y_inter.permute(0, 1, 3, 2, 4, 5).reshape(B_, nc, Q, H, P)
    y = y + y_inter * torch.exp(cum_a).permute(0, 1, 3, 2)[..., None]
    return y.reshape(B_, S, H, P), final_state


def ssm_block(
    p,
    x: torch.Tensor,                  # (B, S, D)
    *,
    expand: int,
    state: int,
    conv: int,
    head_dim: int,
    groups: int,
    chunk: int,
    cache: SSMCache | None = None,
    return_cache: bool = False,
    train: bool = False,
) -> tuple[torch.Tensor, SSMCache | None]:
    """Full Mamba2 block: in_proj -> conv -> SSD -> gated norm -> out_proj.

    cache=None -> prefill (with `return_cache`, the decode cache of the
    prompt; with `train`, the SSD out of place, for autograd); else one
    decode step (S = 1), which writes the new conv window and state into
    `cache` in place and returns it."""
    B_, S, D = x.shape
    di = expand * D
    H = di // head_dim
    gn = groups * state
    z, xbc, dt_raw = _split_proj(p, x, di, gn)
    K = p["conv_w"].shape[0]
    new_cache = None

    if cache is None:
        xbc_tail = xbc[:, max(S - (K - 1), 0):]                 # prefill conv window
        xbc = _causal_conv(p, xbc)
    else:
        window = torch.cat([cache.conv, xbc.to(cache.conv.dtype)], dim=1)   # (B, K, ch)
        out = torch.einsum("bkc,kc->bc", window.float(), p["conv_w"])
        xbc = _silu(out + p["conv_b"])[:, None, :].to(x.dtype)
        cache.conv.copy_(window[:, 1:])

    xs = xbc[..., :di].float().reshape(B_, S, H, head_dim)
    Bm = xbc[..., di: di + gn].float().reshape(B_, S, groups, state)
    Cm = xbc[..., di + gn:].float().reshape(B_, S, groups, state)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if cache is None:
        y, final_state = ssd_chunked(xs, dt, A, Bm, Cm, chunk, in_place=not train)
        if return_cache:
            tail = F.pad(xbc_tail, (0, 0, (K - 1) - xbc_tail.shape[1], 0))
            tail = tail.to(torch.bfloat16).to(conv_cache_dtype(x.dtype))
            new_cache = SSMCache(tail, final_state)
    else:
        # O(1) recurrent step: state = exp(dt A) state + dt B x^T ; y = C.state
        rep = H // groups
        Bh = Bm[:, 0].repeat_interleave(rep, dim=1)             # (B, H, N)
        Ch = Cm[:, 0].repeat_interleave(rep, dim=1)
        dt0 = dt[:, 0]
        da = torch.exp(dt0 * A)                                 # (B, H)
        dBx = (dt0[..., None] * xs[:, 0])[..., None] * Bh[:, :, None, :]   # (B, H, P, N)
        cache.state.mul_(da[..., None, None]).add_(dBx)
        y = (cache.state @ Ch[..., None])[..., 0][:, None]      # (B, 1, H, P)
        new_cache = cache

    y = y + p["D"][:, None] * xs
    y = y.reshape(B_, S, di)
    y = y * _silu(z.float())
    y = rmsnorm(y.to(x.dtype), p["norm_w"])
    return y @ p["out_proj"], new_cache


def ssm_cache_init(batch: int, *, expand: int, d_model: int, state: int, conv: int,
                   head_dim: int, groups: int, dtype=torch.bfloat16, device=None,
                   layers: int | None = None) -> SSMCache:
    """Zero caches, stacked over `layers` when given; the conv window in
    `conv_cache_dtype(dtype)` (bf16 for a bf16 model, as the reference's)."""
    di = expand * d_model
    H = di // head_dim
    conv_ch = di + 2 * groups * state
    lead = () if layers is None else (layers,)
    return SSMCache(
        conv=torch.zeros((*lead, batch, conv - 1, conv_ch), dtype=conv_cache_dtype(dtype),
                         device=device),
        state=torch.zeros((*lead, batch, H, head_dim, state), dtype=torch.float32, device=device),
    )
