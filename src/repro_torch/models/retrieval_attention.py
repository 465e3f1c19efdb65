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

On one card the reference's hierarchical top-L (`hier_topk`, shard-local
then global over the `model` axis) takes the same ids as the flat one: the
flat selection serves both until the mesh LM (ROADMAP A7). The decode
writes the new key, value and codes into the cache in place, at the device
index, before the scan, so the window always holds one finite score.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.kmeans import kmeans_per_subspace
from ..kernels.common import resolve_device
from .attention import KVCache, write_at_index
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


def fit_bangkv_caches(caches: KVCache, fill: int, m: int, iters: int = 12
                      ) -> tuple[torch.Tensor, BangKVCache]:
    """Stage 0 for a prefilled stack: per layer, codebooks fitted on the
    first `fill` keys of every request and those keys encoded (the rest of
    the codes stay 0 until decode writes them), as the reference's
    `examples/long_context_decode.py` does. Returns the (L, Hkv, m, 256,
    hd/m) codebooks and a `BangKVCache` that shares `caches.k` and
    `caches.v`: clone them first where the exact cache decodes too."""
    L, B, S = caches.k.shape[:3]
    Hkv = caches.k.shape[3]
    cbs = []
    codes = torch.zeros((L, B, S, Hkv, m), dtype=torch.uint8, device=caches.k.device)
    for layer in range(L):
        kl = caches.k[layer, :, :fill]
        cb = fit_codebooks(kl, m, iters=iters)
        codes[layer, :, :fill] = encode_keys(cb, kl)
        cbs.append(cb)
    index = torch.full((L,), fill, dtype=torch.int32, device=caches.k.device)
    return torch.stack(cbs), BangKVCache(codes, caches.k, caches.v, index)


def _retrieve_top_l(approx: torch.Tensor, top_l: int, hier: bool = False) -> torch.Tensor:
    """Stage-2 selection: (B, H, S) scores -> (B, H, L) positions, the
    highest first, the lowest position first among ties. `hier` selects the
    same ids on one card (see the module docstring)."""
    if top_l > approx.shape[-1]:
        raise ValueError(f"top_l {top_l} exceeds the cache length {approx.shape[-1]}")
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
):
    """Stages 1-3 for one decode step. Returns (B, 1, H, hd), and the (B, H,
    L) retrieved positions with `return_top_idx`."""
    B, _, H, hd = q.shape
    _, S, Hkv, m = cache.codes.shape
    G = H // Hkv
    dsub = hd // m
    scale = hd ** -0.5
    dev = q.device

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

    pos = torch.arange(S, dtype=torch.int32, device=dev)
    in_window = (pos >= cache.index - window) & (pos < cache.index)
    valid_hist = (pos < cache.index) & ~in_window                       # retrieval region
    approx = approx.masked_fill(~valid_hist, float("-inf"))

    top_idx = _retrieve_top_l(approx, top_l, hier_topk)                 # (B, H, L)

    # ---- Stage 3: exact re-rank over retrieved ∪ recent-window keys.
    kv_head = (torch.arange(H, device=dev) // G)[None, :, None]
    b_idx = torch.arange(B, device=dev)[:, None, None]
    k_sel = cache.k[b_idx, top_idx, kv_head].float()                    # (B, H, L, hd)
    v_sel = cache.v[b_idx, top_idx, kv_head].float()
    qh = q.float().reshape(B, H, hd)
    s_ret = torch.einsum("bhd,bhld->bhl", qh, k_sel) * scale            # (B, H, L)
    # A retrieved slot is invalid when history < L: the retrieval region is
    # exactly pos < index - window.
    ret_valid = top_idx < (cache.index - window)
    s_ret = s_ret.masked_fill(~ret_valid, float("-inf"))

    # The exact recent window (includes the new key); indices below 0 are
    # clamped and masked.
    w_idx = cache.index - window + torch.arange(window, dtype=torch.int32, device=dev)
    w_valid = w_idx >= 0
    w_safe = w_idx.clamp(0, S - 1).long()
    k_win = cache.k[:, w_safe].float()                                  # (B, W, Hkv, hd)
    v_win = cache.v[:, w_safe].float()
    qg = qh.reshape(B, Hkv, G, hd)
    s_win = torch.einsum("bkgd,bwkd->bkgw", qg, k_win) * scale
    s_win = s_win.masked_fill(~w_valid, float("-inf")).reshape(B, H, window)

    # One joint softmax over [retrieved, window].
    p_all = torch.softmax(torch.cat([s_ret, s_win], dim=-1), dim=-1)   # (B, H, L+W)
    p_ret, p_win = p_all[..., :top_l], p_all[..., top_l:]
    out = torch.einsum("bhl,bhld->bhd", p_ret, v_sel)
    out = out + torch.einsum(
        "bkgw,bwkd->bkgd", p_win.reshape(B, Hkv, G, window), v_win
    ).reshape(B, H, hd)
    out = out.reshape(B, 1, H, hd).to(q.dtype)
    return (out, top_idx) if return_top_idx else out


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
) -> tuple[torch.Tensor, BangKVCache]:
    """Decode attention sublayer with the BANG-KV cache, updated in place."""
    B = x.shape[0]
    q = (x @ p["wq"]).reshape(B, 1, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(B, 1, n_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(B, 1, n_kv_heads, head_dim)
    pos = cache.index.reshape(1, 1).expand(B, 1)
    q = apply_rope(q, pos, rope_theta)
    k = apply_rope(k, pos, rope_theta)

    codes_new = encode_keys(codebooks, k)                               # (B, 1, Hkv, m)
    for buf, val in ((cache.codes, codes_new), (cache.k, k), (cache.v, v)):
        write_at_index(buf, val, cache.index)
    new_cache = BangKVCache(cache.codes, cache.k, cache.v, cache.index + 1)
    out = bangkv_decode_attention(
        codebooks, q, new_cache, top_l=top_l, window=window,
        hier_topk=hier_topk, adc_lite=adc_lite,
    )
    y = out.reshape(B, 1, n_heads * head_dim) @ p["wo"]
    return y, new_cache
