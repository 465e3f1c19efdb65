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

On a mesh the block's widths are cut over `model` (`SSMLayout`): the
projection and the conv output are all-gathered, the SSD runs on this
rank's heads, the gate, the gated norm and out_proj on its block of di.

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

from .layers import truncated_normal_init


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


class SSMLayout:
    """This rank's share of a Mamba2 block: the blocks of the four widths
    the rules cut over `model` -- in_proj's columns [z | x | B | C | dt],
    the conv channels [x | B | C], the heads and di -- each this rank's
    contiguous block where it divides the `model` ranks and whole where it
    does not, independently (`partitioning.spec_for`). With no mesh every
    width is whole and no collective runs.

    The reference writes the block with `constrain` hints on `proj` and on
    `out_proj`, and GSPMD re-lays out everything between; here the re-layout
    is written out, each computation split over `model` where its weights
    are cut and repeated on every `model` rank where they are whole:

      * in_proj: x times this rank's column block, all-gathered over
        `model` (the blocks straddle the segments), or the whole product;
      * the depthwise conv on this rank's channel block, all-gathered;
      * the SSD on this rank's heads, with every group their B and C read;
      * the gate and the gated RMSNorm on this rank's block of di, the mean
        of y^2 a sum over `model` (ROADMAP C18), and the row-parallel
        out_proj, its partial sums all-reduced over `model`.

    Every activation whole on the `model` ranks carries its whole gradient
    there: it passes `to_model` where a split computation takes it, and a
    gather's backward sums over `model` where every part of its output
    feeds a split computation (`partial`). ROADMAP C21."""

    def __init__(self, mesh, d_model: int, *, expand: int, state: int, head_dim: int, groups: int):
        self.mesh = mesh
        self.di = expand * d_model
        self.H = self.di // head_dim
        self.gn = groups * state
        self.conv_ch = self.di + 2 * self.gn

        cut = lambda name, dim: mesh is not None and mesh.model_sharded(name, dim)   # noqa: E731
        self.cut_in = cut("ssm/in_proj", 1)       # in_proj's columns
        self.cut_conv = cut("ssm/conv_w", 1)      # the conv channels
        self.cut_h = cut("ssm/A_log", 0)          # the heads
        self.cut_di = cut("ssm/out_proj", 0)      # di

        def block(n: int, is_cut: bool) -> tuple[int, int]:
            """(first, count) of this rank's block of a width of n."""
            return (mesh.model_index * n // mesh.n_model, n // mesh.n_model) if is_cut else (0, n)

        self.c0, self.cl = block(self.conv_ch, self.cut_conv)
        self.h0, self.hl = block(self.H, self.cut_h)
        self.r0, self.rl = block(self.di, self.cut_di)

    def proj(self, p, x: torch.Tensor):
        """(z, xbc, dt) of x @ in_proj, each whole; z, xbc and dt carry
        their whole gradient where the gate, the conv and the SSD take a
        block of them."""
        mc = self.mesh
        split = (self.cut_di, self.cut_conv, self.cut_h)   # the gate, the conv, the SSD
        partial = self.cut_in and all(split)
        if mc is None:
            proj = x @ p["in_proj"]
        elif self.cut_in:
            blk = mc.to_model(x) @ mc.weight(p["in_proj"], "ssm/in_proj", "shard")
            proj = mc.gather_blocks(blk, -1, partial)
        else:
            proj = x @ mc.weight(p["in_proj"], "ssm/in_proj", "shard")
        di, ch = self.di, self.conv_ch
        segs = (proj[..., :di], proj[..., di:di + ch], proj[..., di + ch:])
        if mc is not None and not partial:
            segs = tuple(mc.to_model(t) if cut else t for t, cut in zip(segs, split))
        return segs

    def conv_out(self, xc: torch.Tensor) -> torch.Tensor:
        """Every channel of the conv's output from this rank's block."""
        mc = self.mesh
        if mc is None:
            return xc
        if self.cut_conv:
            return mc.gather_blocks(xc, -1, self.cut_h)
        return mc.to_model(xc) if self.cut_h else xc

    def groups(self, t: torch.Tensor) -> torch.Tensor:
        """The groups (B, S, G', N) of t (B, S, G, N) that this rank's heads
        read, H/M heads to each (repeated to one a head where the heads'
        block does not meet the groups' bounds)."""
        rep = self.H // t.shape[2]
        h0, hl = self.h0, self.hl
        if hl == self.H:
            return t
        if hl % rep == 0:
            return t[:, :, h0 // rep:(h0 + hl) // rep]
        if rep % hl == 0:
            return t[:, :, h0 // rep:h0 // rep + 1]
        return t.repeat_interleave(rep, dim=2)[:, :, h0:h0 + hl]

    def own_rows(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's block of di of the SSD's output: the heads' block
        itself, or a block of every head's output."""
        if self.mesh is None or self.cut_h or not self.cut_di:
            return y
        return self.mesh.to_model(y)[..., self.r0:self.r0 + self.rl]

    def gated_norm(self, y: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        """`layers.rmsnorm` over all of di, its mean written out as the sum
        of y^2 divided by di. Where di is cut the sum is this rank's
        block's, all-reduced over `model` forward and backward: every
        rank's rows take a part of its gradient."""
        yf = y.float()
        s = (yf * yf).sum(dim=-1, keepdim=True)
        if self.mesh is not None and self.cut_di:
            s = self.mesh.to_model(self.mesh.from_model(s))
        normed = yf * torch.rsqrt(s / self.di + eps)
        return (normed * (1.0 + w.float())).to(y.dtype)

    def out(self, p, y: torch.Tensor) -> torch.Tensor:
        """y @ out_proj: this rank's rows, summed over `model` where di is cut."""
        mc = self.mesh
        if mc is None:
            return y @ p["out_proj"]
        o = y @ mc.weight(p["out_proj"], "ssm/out_proj", "shard")
        return mc.from_model(o) if self.cut_di else o


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
    mesh=None,
) -> tuple[torch.Tensor, SSMCache | None]:
    """Full Mamba2 block: in_proj -> conv -> SSD -> gated norm -> out_proj.

    cache=None -> prefill (with `return_cache`, the decode cache of the
    prompt; with `train`, the SSD out of place, for autograd); else one
    decode step (S = 1), which writes the new conv window and state into
    `cache` in place and returns it. With `mesh` (a `MeshContext`), `p`
    holds this rank's blocks and the caches are this rank's blocks, its
    channels of the conv window and its heads of the state (`SSMLayout`);
    conv_w, conv_b, A_log, D, dt_bias and norm_w are cut over `model` alone,
    so the stored tensor is the block each is used as."""
    B_, S, D = x.shape
    lay = SSMLayout(mesh, D, expand=expand, state=state, head_dim=head_dim, groups=groups)
    di, gn, P = lay.di, lay.gn, head_dim
    z, xbc, dt_raw = lay.proj(p, x)
    z = z[..., lay.r0:lay.r0 + lay.rl]
    xbc = xbc[..., lay.c0:lay.c0 + lay.cl]                      # this rank's channels
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
    xbc = lay.conv_out(xbc)

    h0, hl = lay.h0, lay.hl                                     # this rank's heads
    xs = xbc[..., h0 * P:(h0 + hl) * P].float().reshape(B_, S, hl, P)
    Bm = lay.groups(xbc[..., di: di + gn].float().reshape(B_, S, groups, state))
    Cm = lay.groups(xbc[..., di + gn:].float().reshape(B_, S, groups, state))
    dt = F.softplus(dt_raw[..., h0:h0 + hl].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if cache is None:
        y, final_state = ssd_chunked(xs, dt, A, Bm, Cm, chunk, in_place=not train)
        if return_cache:
            tail = F.pad(xbc_tail, (0, 0, (K - 1) - xbc_tail.shape[1], 0))
            tail = tail.to(torch.bfloat16).to(conv_cache_dtype(x.dtype))
            new_cache = SSMCache(tail, final_state)
    else:
        # O(1) recurrent step: state = exp(dt A) state + dt B x^T ; y = C.state
        rep = hl // Bm.shape[2]
        Bh = Bm[:, 0].repeat_interleave(rep, dim=1)             # (B, H, N)
        Ch = Cm[:, 0].repeat_interleave(rep, dim=1)
        dt0 = dt[:, 0]
        da = torch.exp(dt0 * A)                                 # (B, H)
        dBx = (dt0[..., None] * xs[:, 0])[..., None] * Bh[:, :, None, :]   # (B, H, P, N)
        cache.state.mul_(da[..., None, None]).add_(dBx)
        y = (cache.state @ Ch[..., None])[..., 0][:, None]      # (B, 1, H, P)
        new_cache = cache

    y = y + p["D"][:, None] * xs
    y = lay.own_rows(y.reshape(B_, S, hl * P))
    y = y * _silu(z.float())
    y = lay.gated_norm(y.to(x.dtype), p["norm_w"])
    return lay.out(p, y), new_cache


def ssm_cache_init(batch: int, *, expand: int, d_model: int, state: int, conv: int,
                   head_dim: int, groups: int, dtype=torch.bfloat16, device=None,
                   layers: int | None = None, mesh=None) -> SSMCache:
    """Zero caches, stacked over `layers` when given; the conv window in
    `conv_cache_dtype(dtype)` (bf16 for a bf16 model, as the reference's).
    With `mesh`: this rank's channels of the window and heads of the state
    (`SSMLayout`, as `partitioning.cache_pspecs` cuts them)."""
    lay = SSMLayout(mesh, d_model, expand=expand, state=state, head_dim=head_dim, groups=groups)
    lead = () if layers is None else (layers,)
    return SSMCache(
        conv=torch.zeros((*lead, batch, conv - 1, lay.cl), dtype=conv_cache_dtype(dtype),
                         device=device),
        state=torch.zeros((*lead, batch, lay.hl, head_dim, state), dtype=torch.float32,
                          device=device),
    )
