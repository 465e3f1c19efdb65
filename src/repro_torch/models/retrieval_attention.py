"""BANG-KV: the paper's pipeline as long-context decode attention.

The port of the reference package's `models/retrieval_attention.py`.
Exact attention over a long KV cache reads every full-precision key each
step. BANG's three stages map onto decode attention:

  Stage 1 (PQDistTable)  per new query token, a (H, m, 256) table of
                         q-subvector x centroid dot products -- PQ adapted
                         from L2 to inner products, since attention scores
                         are inner products.
  Stage 2 (ADC search)   approximate scores for ALL cached keys from the
                         uint8 codes (m bytes a key against 2·hd for a
                         full-precision key), then a top-L selection.
  Stage 3 (re-rank)      exact scores on the retrieved L keys' full vectors
                         plus an exact recent window; one joint softmax and
                         weighted sum over the union.

All three stages are PyTorch ops here, as they are `jnp` outside any Pallas
kernel in the reference: the table a matmul, the scan a gather plus a sum,
the selection a sort. Fusing the scan into a kernel is later work (ROADMAP
P8). Query head h shares the codebooks and codes of KV head h // G
(`repeat_interleave`, the reference's `jnp.repeat`). The ADC sums add the m
looked-up entries in sequence, the order XLA:CPU reduces them in, so equal
codes give equal scores on any device. Top-L ties follow ROADMAP C2: a
stable descending sort takes the lowest position first, as
`jax.lax.top_k` does -- ties are the rule while the history is shorter
than L, where every slot outside the retrieval region scores -inf.

The decode writes the new key, value and codes into the cache in place,
at the device index, before the scan, so the window always holds one
finite score. Stage 3's joint softmax is written out
(`attention.softmax_parts`), as the reference's `jax.nn.softmax`.

On a mesh (`seq`, a `collectives.SeqBlock`: the cache's sequence cut over
`model`) the codebooks are a replicated parameter; the owner of `index`
writes the new codes, key and value; each rank scans its block of codes;
the hierarchical top-L (`hier_topk`, the reference's shard-local then
global selection) takes each rank's top-L of its block, all-gathers the
(B, H, M, L) scores and global positions over `model` and takes the
global top-L of those, the same ids as the flat selection, ties included
(`_retrieve_top_l`); without `hier_topk` the scores are all-gathered and
selected flat. Stage 3 scores the retrieved and window rows each rank
holds, masks the others, and combines the softmax and the outputs over
`model` as the exact decode does. `fit_bangkv_caches` on a mesh fits the
codebooks on the keys gathered from every rank, so they are the same on
every rank, and each rank encodes its own block.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.kmeans import kmeans_per_subspace
from ..distributed.partitioning import P, batch_pspec, gather_tensor
from ..kernels.common import resolve_device
from .attention import HeadPlan, KVCache, softmax_parts, write_at_index
from .layers import apply_rope, truncated_normal_init

N_CENTROIDS = 256


class BangKVCache(NamedTuple):
    codes: torch.Tensor   # (B, S_max, Hkv, m) uint8 -- PQ codes of keys (near memory)
    k: torch.Tensor       # (B, S_max, Hkv, hd)      -- full keys (far memory)
    v: torch.Tensor       # (B, S_max, Hkv, hd)      -- full values (far memory)
    index: torch.Tensor   # () int32; stacked over layers (L,)


def bangkv_codebook_params(generator: torch.Generator, n_kv_heads: int, head_dim: int,
                           m: int) -> torch.Tensor:
    """Per-KV-head PQ codebooks (Hkv, m, 256, hd/m), trained offline or from
    prefill keys (`fit_codebooks`); random init is shape/flow-correct."""
    dsub = head_dim // m
    return truncated_normal_init((n_kv_heads, m, N_CENTROIDS, dsub), generator, scale=1.0,
                                 dtype=torch.float32)


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in sequence, x[..., 0] + x[..., 1] + ...: the
    order XLA:CPU reduces a short last axis in, the same on every device."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def encode_keys(codebooks: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """PQ-encode keys: (B, S, Hkv, hd) -> (B, S, Hkv, m) uint8 (L2 argmin of
    ||k||² + ||c||² - 2<k, c>, the reference's terms in its order; both
    argmins take the first index of an exact tie)."""
    B, S, Hkv, hd = k.shape
    m, dsub = codebooks.shape[1], codebooks.shape[3]
    ks = k.float().reshape(B, S, Hkv, m, dsub)
    d2 = (
        _sum_last(ks * ks)[..., None]
        + _sum_last(codebooks * codebooks)[None, None]
        - 2.0 * torch.einsum("bshjd,hjcd->bshjc", ks, codebooks)
    )
    return torch.argmin(d2, dim=-1).to(torch.uint8)


def fit_codebooks(k: torch.Tensor, m: int, iters: int = 8) -> torch.Tensor:
    """Train per-head codebooks on (B, S, Hkv, hd) prefill keys: the port's
    `kmeans_per_subspace` over all Hkv·m subspaces in one batched call (the
    reference's `vmap` over heads). -> (Hkv, m, 256, hd/m) float32."""
    B, S, Hkv, hd = k.shape
    dsub = hd // m
    flat = k.float().permute(2, 0, 1, 3).reshape(Hkv, B * S, m, dsub)
    x_sub = flat.permute(0, 2, 1, 3).reshape(Hkv * m, B * S, dsub)
    return kmeans_per_subspace(x_sub, N_CENTROIDS, iters).reshape(Hkv, m, N_CENTROIDS, dsub)


def bangkv_init(batch: int, s_max: int, n_kv_heads: int, head_dim: int, m: int,
                dtype=torch.bfloat16, device="cuda") -> BangKVCache:
    device = resolve_device(device)
    return BangKVCache(
        codes=torch.zeros((batch, s_max, n_kv_heads, m), dtype=torch.uint8, device=device),
        k=torch.zeros((batch, s_max, n_kv_heads, head_dim), dtype=dtype, device=device),
        v=torch.zeros((batch, s_max, n_kv_heads, head_dim), dtype=dtype, device=device),
        index=torch.zeros((), dtype=torch.int32, device=device),
    )


def fit_bangkv_caches(caches: KVCache, fill: int, m: int, iters: int = 12, *, seq=None,
                      batch_cut: bool = False) -> tuple[torch.Tensor, BangKVCache]:
    """Stage 0 for a prefilled stack: per layer, codebooks fitted on the
    first `fill` keys of every request and those keys encoded (the rest of
    the codes stay 0 until decode writes them), as the reference's
    `examples/long_context_decode.py` does. Returns the (L, Hkv, m, 256,
    hd/m) codebooks and a `BangKVCache` that shares `caches.k` and
    `caches.v`: clone them first where the exact cache decodes too.

    On a mesh, `caches` are this rank's blocks (`seq`: its block of the
    sequence; `batch_cut`: the batch cut over pod x data): each layer's keys
    are gathered from every rank (a collective), so every rank fits the
    codebooks a single device would, and encodes its own block."""
    L, B, S = caches.k.shape[:3]
    Hkv = caches.k.shape[3]
    dev = caches.k.device
    lo = 0 if seq is None else seq.lo
    held = min(max(fill - lo, 0), S)   # this block's positions below `fill`
    spec = None
    if seq is not None:
        spec = P(batch_pspec(seq.mesh.mesh)[0] if batch_cut else None, "model" if seq.cut else None)
    cbs = []
    codes = torch.zeros((L, B, S, Hkv, m), dtype=torch.uint8, device=dev)
    for layer in range(L):
        kl = caches.k[layer]
        full = kl if seq is None else gather_tensor(kl, spec, seq.mesh.mesh)
        cb = fit_codebooks(full[:, :fill], m, iters=iters)
        codes[layer, :, :held] = encode_keys(cb, kl[:, :held])
        cbs.append(cb)
    index = torch.full((L,), fill, dtype=torch.int32, device=dev)
    return torch.stack(cbs), BangKVCache(codes, caches.k, caches.v, index)


def _local_top_l(approx: torch.Tensor, top_l: int, lo: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A block's candidates: its min(L, block) highest scores (B, H, n) and
    their global positions (lo + the position in the block), the lowest
    position first among ties."""
    vals, ids = torch.sort(approx, dim=-1, descending=True, stable=True)
    n = min(top_l, approx.shape[-1])
    return vals[..., :n], ids[..., :n] + lo


def _merge_top_l(vals: torch.Tensor, ids: torch.Tensor, top_l: int) -> torch.Tensor:
    """The global top-L of the blocks' candidates (B, H, M * n), laid out
    block after block in position order: a stable descending sort of the
    scores, then their positions."""
    order = torch.sort(vals, dim=-1, descending=True, stable=True)[1][..., :top_l]
    return ids.gather(-1, order)


def _retrieve_top_l(approx: torch.Tensor, top_l: int, hier: bool = False, seq=None) -> torch.Tensor:
    """Stage-2 selection: (B, H, S) scores -> (B, H, L) positions, the
    highest first, the lowest position first among ties (ROADMAP C2). With
    `seq` (a `SeqBlock` of a cache cut over `model`), `approx` is this
    rank's block of the scores; `hier` takes each block's top-L and the
    global top-L of the gathered (B, H, M, L) candidates, else the scores
    are gathered and selected flat.

    The hierarchical selection gives the flat one's ids, ties included.
    Order the positions by (score descending, position ascending): the
    flat selection is the first L. Each of them is beaten by fewer than L
    positions overall, so by fewer than L of its own block, and is among
    its block's candidates. The candidates come block after block, each
    block's in that order, and the blocks in position order, so equal
    scores stand in position order; the stable descending sort of their
    scores is that order, and its first L are the flat selection's."""
    total = approx.shape[-1] * (seq.mesh.n_model if seq is not None and seq.cut else 1)
    if top_l > total:
        raise ValueError(f"top_l {top_l} exceeds the cache length {total}")
    if seq is not None and seq.cut:
        mc = seq.mesh
        if hier:
            vals, ids = _local_top_l(approx, top_l, seq.lo)
            return _merge_top_l(mc.gather_model(vals, -1), mc.gather_model(ids, -1), top_l)
        approx = mc.gather_model(approx, -1)
    return torch.sort(approx, dim=-1, descending=True, stable=True)[1][..., :top_l]


def bangkv_decode_attention(
    codebooks: torch.Tensor,   # (Hkv, m, 256, dsub)
    q: torch.Tensor,           # (B, 1, H, hd), rope applied
    cache: BangKVCache,        # with the NEW key already written
    *,
    top_l: int,
    window: int,
    hier_topk: bool = False,
    adc_lite: bool = False,    # opt_adc_lite: bf16 ADC table
    return_top_idx: bool = False,
    seq=None,
):
    """Stages 1-3 for one decode step. Returns (B, 1, H, hd), and the (B, H,
    L) retrieved positions with `return_top_idx`. With `seq` (a
    `SeqBlock`), `cache` is this rank's block of the sequence."""
    B, _, H, hd = q.shape
    _, S, Hkv, m = cache.codes.shape
    G = H // Hkv
    dsub = hd // m
    scale = hd ** -0.5
    dev = q.device
    lo = 0 if seq is None else seq.lo

    # ---- Stage 1: per-(query-head) dot-product PQDistTable.
    qf = q.float().reshape(B, H, m, dsub)
    cb_per_q = codebooks.repeat_interleave(G, dim=0)                   # (H, m, 256, dsub)
    table = torch.einsum("bhjd,hjcd->bhjc", qf, cb_per_q)               # (B, H, m, 256)

    # ---- Stage 2: ADC scores for every cached key, from codes alone. The
    # bf16 table (adc_lite) needs no clip: uint8 codes lie in [0, 256).
    idx_q = cache.codes.long().repeat_interleave(G, dim=2)              # (B, S, H, m)
    tbl = table.to(torch.bfloat16) if adc_lite else table
    gathered = torch.gather(tbl[:, None].expand(B, S, H, m, N_CENTROIDS), 4,
                            idx_q[..., None])[..., 0]                  # (B, S, H, m)
    approx = _sum_last(gathered.float()).transpose(1, 2)                # (B, H, S)

    pos = torch.arange(lo, lo + S, dtype=torch.int32, device=dev)
    in_window = (pos >= cache.index - window) & (pos < cache.index)
    valid_hist = (pos < cache.index) & ~in_window                       # retrieval region
    approx = approx.masked_fill(~valid_hist, float("-inf"))

    top_idx = _retrieve_top_l(approx, top_l, hier_topk, seq)            # (B, H, L)

    # ---- Stage 3: exact re-rank over retrieved ∪ recent-window keys. On a
    # mesh each rank reads the rows its block holds and masks the others.
    kv_head = (torch.arange(H, device=dev) // G)[None, :, None]
    b_idx = torch.arange(B, device=dev)[:, None, None]
    at = top_idx if seq is None else (top_idx - lo).clamp(0, S - 1)
    k_sel = cache.k[b_idx, at, kv_head].float()                         # (B, H, L, hd)
    v_sel = cache.v[b_idx, at, kv_head].float()
    qh = q.float().reshape(B, H, hd)
    s_ret = torch.einsum("bhd,bhld->bhl", qh, k_sel) * scale            # (B, H, L)
    # A retrieved slot is invalid when history < L: the retrieval region is
    # exactly pos < index - window.
    ret_valid = top_idx < (cache.index - window)
    if seq is not None:
        ret_valid = ret_valid & _held(top_idx, seq, S)
    s_ret = s_ret.masked_fill(~ret_valid, float("-inf"))

    # The exact recent window (includes the new key); indices below 0 are
    # clamped and masked.
    w_idx = cache.index - window + torch.arange(window, dtype=torch.int32, device=dev)
    w_valid = w_idx >= 0
    if seq is not None:
        w_valid = w_valid & _held(w_idx, seq, S)
    w_safe = (w_idx - lo).clamp(0, S - 1).long()
    k_win = cache.k[:, w_safe].float()                                  # (B, W, Hkv, hd)
    v_win = cache.v[:, w_safe].float()
    qg = qh.reshape(B, Hkv, G, hd)
    s_win = torch.einsum("bkgd,bwkd->bkgw", qg, k_win) * scale
    s_win = s_win.masked_fill(~w_valid, float("-inf")).reshape(B, H, window)

    # One joint softmax over [retrieved, window].
    p_all = softmax_parts(torch.cat([s_ret, s_win], dim=-1), seq)      # (B, H, L+W)
    p_ret, p_win = p_all[..., :top_l], p_all[..., top_l:]
    out = torch.einsum("bhl,bhld->bhd", p_ret, v_sel)
    out = out + torch.einsum(
        "bkgw,bwkd->bkgd", p_win.reshape(B, Hkv, G, window), v_win
    ).reshape(B, H, hd)
    if seq is not None:
        out = seq.mesh.reduce_model(out)
    out = out.reshape(B, 1, H, hd).to(q.dtype)
    return (out, top_idx) if return_top_idx else out


def _held(positions: torch.Tensor, seq, S: int) -> torch.Tensor:
    """Which global positions this rank's block holds and counts."""
    if not seq.scored:
        return torch.zeros_like(positions, dtype=torch.bool)
    return (positions >= seq.lo) & (positions < seq.lo + S)


def bangkv_attention_block(
    p,                          # attention params (wq/wk/wv/wo)
    codebooks: torch.Tensor,
    x: torch.Tensor,            # (B, 1, D)
    cache: BangKVCache,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    top_l: int,
    window: int,
    hier_topk: bool = False,
    adc_lite: bool = False,
    mesh=None,
    seq=None,
) -> tuple[torch.Tensor, BangKVCache]:
    """Decode attention sublayer with the BANG-KV cache, updated in place.
    With `mesh` (a `MeshContext`) and `seq` (this rank's block of the
    cache's sequence): this rank's heads (`attention.HeadPlan`), every
    head gathered over `model` for the retrieval, its heads through the
    row-parallel `wo`."""
    B = x.shape[0]
    plan = None if mesh is None else HeadPlan(mesh, n_heads, n_kv_heads, head_dim)
    if plan is None:
        q = (x @ p["wq"]).reshape(B, 1, n_heads, head_dim)
        k = (x @ p["wk"]).reshape(B, 1, n_kv_heads, head_dim)
        v = (x @ p["wv"]).reshape(B, 1, n_kv_heads, head_dim)
    else:
        q, k, v = plan.qkv(p, x)
    pos = cache.index.reshape(1, 1).expand(B, 1)
    q = apply_rope(q, pos, rope_theta)
    k = apply_rope(k, pos, rope_theta)
    if plan is not None:
        q, k, v = plan.all_q(q), plan.all_kv(k), plan.all_kv(v)

    codes_new = encode_keys(codebooks, k)                               # (B, 1, Hkv, m)
    for buf, val in ((cache.codes, codes_new), (cache.k, k), (cache.v, v)):
        write_at_index(buf, val, cache.index, seq)
    new_cache = BangKVCache(cache.codes, cache.k, cache.v, cache.index + 1)
    out = bangkv_decode_attention(
        codebooks, q, new_cache, top_l=top_l, window=window,
        hier_topk=hier_topk, adc_lite=adc_lite, seq=seq,
    )
    if plan is not None:
        return plan.out(p, plan.own_heads(out)), new_cache
    y = out.reshape(B, 1, n_heads * head_dim) @ p["wo"]
    return y, new_cache
