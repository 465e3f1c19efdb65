"""GQA attention: prefill (chunked causal), decode (KV cache), and whisper's
encoder and cross-attention.

The port of the reference package's `models/attention.py`. Full (S, S)
causal score matrices are never materialised: prefill runs a flash-style loop over query chunks -- scores exist only as
(B, Hkv, G, chunk, S) blocks -- and sliding-window layers apply a band mask
inside the same loop. Scores and probabilities are float32, as the
reference's `preferred_element_type=jnp.float32`; with `bf16_scores` the
inputs are rounded to bf16 first and multiplied in float32 (a bf16 product
is exact in float32), so the sums stay float32 as the reference's do.

Decode attends one query token against the cache. The cache is updated in
place: the new key and value are written at the device index
`cache.index` (no host sync), and the returned cache shares the storage.
Its softmax is written out (`softmax_parts`: the max, exp(s - max), the
sum, the division), as the reference's `jax.nn.softmax` computes it, so
that a decode over a cache cut across ranks takes the same operations.
Whisper's encoder attends bidirectionally (no mask) and its decoder's
`cross_attention` attends to the encoder memory: both one float32 softmax
over every key (`full_attention`), as the reference's einsums.

Training on a mesh (`HeadPlan`, with a `distributed.collectives.MeshContext`)
writes out the reference's `constrain` sites (`_qkv`, the output
projection): Megatron TP over `model` with FSDP gather-before-use over
`data`. Each rank computes the query heads whose columns of `wq` it holds,
the KV heads they read, and multiplies its heads' outputs by its rows of
`wo`; one (B, S, D) all-reduce over `model` sums them. Where a rank's block
of a weight would not hold whole heads, that weight is gathered whole over
`model` at its use and its heads are computed on every `model` rank, as
GSPMD's reshard would. Of the dense, vlm and moe configs, the KV
projections `wk` and `wv` take this route when `model` does not divide
n_kv_heads: glm4-9b (2 KV heads) and internvl2-1b (2) at `model` 4 and 16,
phi3-medium-14b (10) at 4 and 16, granite-3-2b (8), phi3.5-moe (8) and
llama4-scout (8) at 16; the query projection `wq` when `model` does not
divide n_heads: phi3-medium-14b and llama4-scout (40 heads) at 16,
internvl2-1b (14) at 4 and 16. gemma3-27b (32 and 16 heads) never does.
At `model` 2 none does.

Serving on a mesh (with `torch.no_grad()`) runs the same plan. Prefill
computes this rank's heads as training does and returns the roped K and V
of every KV head (this rank's block gathered over `model`, or the whole
projection) for its sequence block of the cache. A decode step gathers the
query heads and the new K and V over `model`; the rank that holds position
`index` in its block of the cache (`collectives.SeqBlock`: the cache's
sequence cut over `model`) writes them; every rank scores its block at its
global positions (the causal mask and the sliding window), takes the
global max (an all-reduce MAX over `model`), exp(s - max), the global sum
(an all-reduce SUM), divides, multiplies by its block of V and all-reduces
the (B, H, hd) partial outputs; then the row-parallel `wo` of its heads. On
a one-rank mesh these are the plain path's operations, and each collective
a copy.

Whisper on a mesh takes the same plan. Its encoder's bidirectional
attention computes this rank's query heads against the KV heads they read,
RoPE at positions 0..M-1, over every frame (`full_attention`), then the
row-parallel `wo`. Its decoder's cross-attention (`cross_attention_block`)
computes this rank's query heads of `cross/wq` and reads their KV heads
out of the cross K and V, which are whole on every `model` rank
(`HeadPlan.kv_heads`), then the row-parallel `cross/wo`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .layers import apply_rope, truncated_normal_init


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_max, Hkv, hd); stacked over layers (L, B, S_max, Hkv, hd)
    v: torch.Tensor       # (B, S_max, Hkv, hd)
    index: torch.Tensor   # () int32 -- current fill level; stacked (L,)


def attn_params(generator: torch.Generator, d_model: int, n_heads: int, n_kv_heads: int,
                head_dim: int, dtype) -> dict:
    return {
        "wq": truncated_normal_init((d_model, n_heads * head_dim), generator, dtype=dtype),
        "wk": truncated_normal_init((d_model, n_kv_heads * head_dim), generator, dtype=dtype),
        "wv": truncated_normal_init((d_model, n_kv_heads * head_dim), generator, dtype=dtype),
        "wo": truncated_normal_init((n_heads * head_dim, d_model), generator, dtype=dtype),
    }


class HeadPlan:
    """Which heads this rank computes in a training attention block on a
    mesh, and how it gets each weight.

    `split`: `wo`'s rows (the heads' outputs) lie over `model`, so the block
    is split over `model` and ends in one all-reduce; otherwise every
    `model` rank computes the whole block with whole weights. Query heads
    [q0, q0 + n_q): this rank's block of `wq` when it holds whole heads, else
    every head (`wq` gathered whole) and `o_cols` picks the columns of the
    output that meet this rank's rows of `wo`. `kv_heads`: the KV heads
    those query heads read, out of every KV head (a slice, or one index a
    query head where they do not group evenly): whisper's cross K and V are
    whole on every `model` rank. `kv`: the same, out of the whole
    projections, or None for this rank's block of `wk` and `wv`."""

    def __init__(self, mesh, n_heads: int, n_kv_heads: int, head_dim: int):
        M, m = mesh.n_model, mesh.model_index
        self.mesh, self.head_dim = mesh, head_dim
        self.split = mesh.model_sharded("wo", 0)
        q_local = self.split and n_heads % M == 0
        kv_local = q_local and n_kv_heads % M == 0
        whole = "partial" if self.split else "replicated"
        self.q_use = "shard" if q_local else whole
        self.kv_use = "shard" if kv_local else whole
        self.q0, self.n_q = (m * n_heads // M, n_heads // M) if q_local else (0, n_heads)
        self.o_cols = None
        if self.split and not q_local:
            cols = n_heads * head_dim // M
            self.o_cols = slice(m * cols, (m + 1) * cols)
        G = n_heads // n_kv_heads
        ids = [(self.q0 + i) // G for i in range(self.n_q)]
        n = ids[-1] - ids[0] + 1
        even = self.n_q % n == 0 and ids == [ids[0] + i // (self.n_q // n) for i in range(self.n_q)]
        self.kv_heads = slice(ids[0], ids[0] + n) if even else ids
        self.kv = None if kv_local else self.kv_heads

    def qkv(self, p, x: torch.Tensor):
        """q of this rank's heads and k, v of the KV heads its projections
        give (this rank's block, or every head where `wk` and `wv` are
        whole: `select_kv` picks those its query heads read) from x (B, S,
        D), replicated over `model` (its gradient summed there when the
        block is split)."""
        mc, hd = self.mesh, self.head_dim
        B, S, _ = x.shape
        if self.split:
            x = mc.to_model(x)
        q = (x @ mc.weight(p["wq"], "wq", self.q_use)).reshape(B, S, self.n_q, hd)
        k = (x @ mc.weight(p["wk"], "wk", self.kv_use)).reshape(B, S, -1, hd)
        v = (x @ mc.weight(p["wv"], "wv", self.kv_use)).reshape(B, S, -1, hd)
        return q, k, v

    def query(self, p, x: torch.Tensor) -> torch.Tensor:
        """q of this rank's heads from x (B, S, D), replicated over `model`
        (its gradient summed there when the block is split): whisper's
        cross-attention, whose K and V come from the encoder memory."""
        mc = self.mesh
        B, S, _ = x.shape
        if self.split:
            x = mc.to_model(x)
        return (x @ mc.weight(p["wq"], "wq", self.q_use)).reshape(B, S, self.n_q, self.head_dim)

    def select_kv(self, t: torch.Tensor) -> torch.Tensor:
        """The KV heads of `qkv`'s k or v that this rank's query heads read."""
        return t if self.kv is None else t[:, :, self.kv]

    def all_q(self, q: torch.Tensor) -> torch.Tensor:
        """Every query head: this rank's gathered over `model` (serving)."""
        return self.mesh.gather_model(q, 2) if self.q_use == "shard" else q

    def all_kv(self, t: torch.Tensor) -> torch.Tensor:
        """Every KV head of `qkv`'s k or v: this rank's block gathered over
        `model`, or the whole projection as it is (serving)."""
        return self.mesh.gather_model(t, 2) if self.kv_use == "shard" else t

    def own_heads(self, out: torch.Tensor) -> torch.Tensor:
        """This rank's query heads of an output over every head."""
        return out[:, :, self.q0:self.q0 + self.n_q]

    def out(self, p, out: torch.Tensor) -> torch.Tensor:
        """The output projection of this rank's heads (B, S, n_q, hd), summed
        over `model` when the block is split."""
        B, S = out.shape[:2]
        o = out.reshape(B, S, -1)
        if self.o_cols is not None:
            o = o[..., self.o_cols]
        mc = self.mesh
        y = o @ mc.weight(p["wo"], "wo", "shard" if self.split else "replicated")
        return mc.from_model(y) if self.split else y


def _qkv(p, x: torch.Tensor, n_heads: int, n_kv_heads: int, head_dim: int):
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(B, S, n_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(B, S, n_kv_heads, head_dim)
    return q, k, v


def chunked_causal_attention(
    q: torch.Tensor,               # (B, S, H, hd), rope applied
    k: torch.Tensor,               # (B, S, Hkv, hd)
    v: torch.Tensor,               # (B, S, Hkv, hd)
    *,
    chunk: int,
    window: torch.Tensor | int,    # >= S means full causal
    bf16_scores: bool = False,
    band: int | None = None,       # static key band per query chunk (local layers)
) -> torch.Tensor:
    """Causal attention over query chunks (flash-style).

    With `band` set (local layers, static window), each query chunk only
    multiplies against the `band` keys that can pass its sliding-window
    mask: a (c, band) score block instead of (c, S).
    """
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = hd ** -0.5
    n_chunks = max(S // chunk, 1)
    c = S // n_chunks
    if n_chunks * c != S:
        raise ValueError(f"seq {S} must divide by attn chunk {chunk}")
    acc = torch.promote_types(q.dtype, torch.float32)   # float32 (float64 for gradcheck)
    in_dt = torch.bfloat16 if bf16_scores else acc
    dev = q.device

    qg = q.reshape(B, n_chunks, c, Hkv, G, hd).permute(1, 0, 3, 4, 2, 5)
    # (n_chunks, B, Hkv, G, c, hd); keys and values rounded to in_dt once
    kT = k.permute(0, 2, 3, 1).to(in_dt).to(acc)       # (B, Hkv, hd, S)
    vT = v.permute(0, 2, 1, 3).to(in_dt).to(acc)       # (B, Hkv, S, hd)
    kv_pos = torch.arange(S, dtype=torch.int32, device=dev)

    outs = []
    for ci in range(n_chunks):
        if band is not None and band < S:
            start = min(max(ci * c - (band - c), 0), S - band)
            kT_c, vT_c = kT[..., start:start + band], vT[:, :, start:start + band]
            pos_c = start + torch.arange(band, dtype=torch.int32, device=dev)
        else:
            kT_c, vT_c, pos_c = kT, vT, kv_pos
        qc = qg[ci].to(in_dt).to(acc).reshape(B, Hkv, G * c, hd)
        scores = (qc @ kT_c).reshape(B, Hkv, G, c, -1) * scale   # (B, Hkv, G, c, S|band)
        q_pos = ci * c + torch.arange(c, dtype=torch.int32, device=dev)
        causal = (pos_c[None, :] <= q_pos[:, None]) & (pos_c[None, :] > q_pos[:, None] - window)
        scores.masked_fill_(~causal, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out = probs.to(in_dt).to(acc).reshape(B, Hkv, G * c, -1) @ vT_c
        outs.append(out.reshape(B, Hkv, G, c, hd).to(q.dtype))
    # (n_chunks, B, Hkv, G, c, hd) -> (B, S, H, hd)
    return torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, S, H, hd)


def softmax_parts(scores: torch.Tensor, seq=None) -> torch.Tensor:
    """Softmax over the last dim, written out: m = max, e = exp(s - m),
    e / sum(e), as `jax.nn.softmax`. With `seq` (a `SeqBlock`: the scores of
    this rank's block of the sequence) the max and the sum are all-reduced
    over `model`; a block with no valid score takes -inf as its max, and
    its exp(s - m) are 0. Writes into `scores`' storage."""
    m = scores.amax(dim=-1, keepdim=True)
    if seq is not None:
        m = seq.mesh.reduce_model(m, "max")
    e = scores.sub_(m).exp_()
    z = e.sum(dim=-1, keepdim=True)
    if seq is not None:
        z = seq.mesh.reduce_model(z)
    return e.div_(z)


def decode_attention(
    q: torch.Tensor,        # (B, 1, H, hd), rope applied
    cache: KVCache,
    *,
    window: torch.Tensor | int,
    seq=None,
) -> torch.Tensor:
    """One-token attention against the cache's first `cache.index` slots.
    With `seq` (a `SeqBlock`), `cache` is this rank's block of the
    sequence, at global positions seq.lo + 0, 1, ...: the softmax combines
    over `model` and the partial outputs are summed there."""
    B, _, H, hd = q.shape
    Hkv = cache.k.shape[2]
    G = H // Hkv
    S = cache.k.shape[1]
    scale = hd ** -0.5
    lo = 0 if seq is None else seq.lo
    qg = q.reshape(B, Hkv, G, hd).float()
    scores = (qg @ cache.k.float().permute(0, 2, 3, 1)) * scale      # (B, Hkv, G, S)
    pos = torch.arange(lo, lo + S, dtype=torch.int32, device=q.device)
    valid = (pos[None, :] < cache.index) & (pos[None, :] >= cache.index - window)
    if seq is not None and not seq.scored:
        valid = torch.zeros_like(valid)
    scores.masked_fill_(~valid[:, None, None, :], float("-inf"))
    probs = softmax_parts(scores, seq)
    out = probs @ cache.v.float().permute(0, 2, 1, 3)                 # (B, Hkv, G, hd)
    if seq is not None:
        out = seq.mesh.reduce_model(out)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def full_attention(
    q: torch.Tensor,        # (B, S, H, hd)
    k: torch.Tensor,        # (B, M, Hkv, hd)
    v: torch.Tensor,        # (B, M, Hkv, hd)
) -> torch.Tensor:
    """Unmasked attention of every query to every key, in float32 (float64
    for float64 inputs): the reference's "bskgd,bmkd->bksgm" scores,
    softmax, and weighted sum of V. Returns (B, S, H, hd) in q's dtype."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = hd ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.to(acc).reshape(B, S, Hkv, G, hd).permute(0, 2, 1, 3, 4).reshape(B, Hkv, S * G, hd)
    scores = (qg @ k.to(acc).permute(0, 2, 3, 1)) * scale            # (B, Hkv, S*G, M)
    probs = torch.softmax(scores, dim=-1)
    out = probs @ v.to(acc).permute(0, 2, 1, 3)                      # (B, Hkv, S*G, hd)
    return out.reshape(B, Hkv, S, G, hd).permute(0, 2, 1, 3, 4).reshape(B, S, H, hd).to(q.dtype)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Whisper's decoder into the encoder memory: q (B, S, H, hd), with no
    RoPE, against k, v (B, M, Hkv, hd)."""
    return full_attention(q, k, v)


def cross_attention_block(p, x: torch.Tensor, memory_kv: tuple, *, n_heads: int, n_kv_heads: int,
                          head_dim: int, mesh=None) -> torch.Tensor:
    """Whisper's cross sublayer after its norm: the query of x (B, S, D)
    against the encoder memory's K and V (B, M, Hkv, hd), then `wo`. With
    `mesh` this rank computes its query heads (`HeadPlan`), reads the KV
    heads they take from the K and V, which every `model` rank holds whole,
    and multiplies by its rows of `wo`: one all-reduce over `model`."""
    ck, cv = memory_kv
    if mesh is None:
        B, S, _ = x.shape
        q = (x @ p["wq"]).reshape(B, S, n_heads, head_dim)
        return cross_attention(q, ck, cv).reshape(B, S, -1) @ p["wo"]
    plan = HeadPlan(mesh, n_heads, n_kv_heads, head_dim)
    out = cross_attention(plan.query(p, x), ck[:, :, plan.kv_heads], cv[:, :, plan.kv_heads])
    return plan.out(p, out)


def write_at_index(buf: torch.Tensor, val: torch.Tensor, index: torch.Tensor, seq=None) -> None:
    """buf[:, index] = val in place, at a device index (no host sync): the
    counterpart of the reference's `dynamic_update_slice_in_dim(..., axis=1)`.
    The caller sizes the cache; an index past its end is an error. With
    `seq` (a `SeqBlock`), `buf` is this rank's block of the sequence and is
    written only where it holds position `index` (the slot it would take is
    written back with its own value elsewhere)."""
    if seq is None:
        buf.index_copy_(1, index.reshape(1).long(), val.to(buf.dtype))
        return
    local = index.reshape(1).long() - seq.lo
    at = local.clamp(0, seq.length - 1)
    here = (local >= 0) & (local < seq.length)
    buf.index_copy_(1, at, torch.where(here, val.to(buf.dtype), buf.index_select(1, at)))


def attention_block(
    p,
    x: torch.Tensor,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    attn_chunk: int,
    window: torch.Tensor | int,
    causal: bool = True,
    cache: KVCache | None = None,
    bf16_scores: bool = False,
    window_skip: bool = False,
    mesh=None,
    seq=None,
    return_kv: bool = True,
) -> tuple[torch.Tensor, KVCache | tuple | None]:
    """Full attention sublayer. cache=None -> prefill (causal, or the
    encoder's bidirectional attention with `causal=False`); else decode.

    Prefill returns the roped (k, v) for the caller to assemble the decode
    cache (training drops them); decode writes the new key and value into `cache` in place and
    returns it with `index + 1`. With a static int `window`, `window_skip`
    activates the banded local-attention path. With `mesh` (a
    `MeshContext`) this rank computes its heads (`HeadPlan`): without a
    cache (causal, or whisper's encoder) it returns (y, None), or with
    `return_kv` the roped K and V of every KV head (prefill); a decode step
    takes its cache's block of the sequence from `seq` (a `SeqBlock`).
    """
    B, S, _ = x.shape
    plan = None
    if mesh is not None:
        if (cache is not None) != (seq is not None) or (cache is not None and not causal):
            raise ValueError("a decode on a mesh is causal and takes its SeqBlock")
        plan = HeadPlan(mesh, n_heads, n_kv_heads, head_dim)
    q, k, v = _qkv(p, x, n_heads, n_kv_heads, head_dim) if plan is None else plan.qkv(p, x)

    if cache is None:
        pos = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
        kq, vq = (k, v) if plan is None else (plan.select_kv(k), plan.select_kv(v))
        if causal:
            c = min(attn_chunk, S)
            band = None
            if window_skip and isinstance(window, int) and window + c < S:
                band = min(S, -(-(window + c) // c) * c)   # round up to chunks
            out = chunked_causal_attention(q, kq, vq, chunk=c, window=window,
                                           bf16_scores=bf16_scores, band=band)
        else:   # encoder: full bidirectional (no mask)
            out = full_attention(q, kq, vq)
        new_cache = (k, v)   # roped k -- prefill assembles the decode cache
        if plan is not None:
            new_cache = (plan.all_kv(k), plan.all_kv(v)) if return_kv else None
    else:
        pos = cache.index.reshape(1, 1).expand(B, 1)   # query position
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
        if plan is not None:
            q, k, v = plan.all_q(q), plan.all_kv(k), plan.all_kv(v)
        write_at_index(cache.k, k, cache.index, seq)
        write_at_index(cache.v, v, cache.index, seq)
        new_cache = KVCache(cache.k, cache.v, cache.index + 1)
        out = decode_attention(q, new_cache, window=window, seq=seq)
        if plan is not None:
            out = plan.own_heads(out)

    if plan is not None:
        return plan.out(p, out), new_cache
    y = out.reshape(B, S, n_heads * head_dim) @ p["wo"]
    return y, new_cache
