"""The LM's serve path: the decoder families assembled from the layers.

The port of the reference package's `models/transformer.py` for the
families that share its `_dense_layer` and decoder stack -- dense, moe and
vlm: `init_params`, the per-layer flags, `_dense_layer`, `decoder_stack`
and `LM` with `prefill`, `decode_step` (exact KV or BANG-KV) and
`init_decode_caches`. The stack is one Python loop over the layers, the
counterpart of both the reference's `lax.scan` and its unrolled stack; the
per-layer window and RoPE base are Python numbers (`static_layer_flags`).

Caches keep the reference's stacked layout -- K and V (L, B, S, Hkv, hd),
BANG-KV codes (L, B, S, Hkv, m) uint8, `index` (L,) int32 -- so carrying one
across is a copy. A decode step writes the new entries into the caches in
place at the device index (no host sync per layer or step) and returns
caches that share their storage, with `index + 1`.

Waiting for later slices (ROADMAP A8): the ssm and hybrid families
(mamba2, zamba2), encdec (whisper: the encoder, cross-attention), and
training (`LM.loss`, `unembed_chunked`). `LM(cfg)` for those raises.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels.common import resolve_device
from . import retrieval_attention as bkv
from .attention import KVCache, attention_block, attn_params
from .ffn import ffn_params, swiglu
from .layers import ParamTree, embed, norm, norm_params, truncated_normal_init
from .moe import MoEAux, moe_block, moe_params

DECODER_FAMILIES = ("dense", "moe", "vlm")


def check_family(cfg: ModelConfig) -> None:
    """Raise for an architecture this slice does not serve."""
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family (Mamba2 layers, models/ssm.py) is not "
            "ported yet: ROADMAP A8, ssm and hybrid")
    if cfg.arch_kind == "encdec" or cfg.family not in DECODER_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family (the encoder, cross-attention) is not "
            "ported yet: ROADMAP A8, encdec")


def _pick_chunk(S: int, target: int) -> int:
    """Largest divisor of S that is <= target (chunked attention tiling)."""
    c = min(target, S)
    while S % c:
        c -= 1
    return c


def _zero_aux(device) -> MoEAux:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return MoEAux(z, z, z)


# ---------------------------------------------------------------------------
# Parameter initialisation
# ---------------------------------------------------------------------------

def _dense_layer_params(cfg: ModelConfig, g: torch.Generator, dtype) -> dict:
    dev = g.device
    p = {
        "attn_norm": norm_params(cfg.d_model, cfg.norm_kind, dev),
        "attn": attn_params(g, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dtype),
        "ffn_norm": norm_params(cfg.d_model, cfg.norm_kind, dev),
    }
    if cfg.n_experts:
        p["moe"] = moe_params(g, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.n_shared_experts, dtype)
    else:
        p["ffn"] = ffn_params(g, cfg.d_model, cfg.d_ff, dtype)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device: str | torch.device = "cuda") -> ParamTree:
    """Random parameters, drawn on `device` from `generator` (a generator on
    that device; seed 0 when None): nothing passes through host memory, so
    glm4-9b's 18.8 GB of bf16 are made on the card. The tree has the
    reference's names, with the stacked layer axis as a list of layers."""
    check_family(cfg)
    dev = resolve_device(device)
    g = torch.Generator(dev).manual_seed(0) if generator is None else generator
    if g.device.type != dev.type:
        raise ValueError(f"generator on {g.device}, parameters asked on {dev}")
    dtype = getattr(torch, cfg.dtype)
    params: dict[str, Any] = {
        "embed": truncated_normal_init((cfg.vocab_size, cfg.d_model), g, dtype=dtype),
        "final_norm": norm_params(cfg.d_model, cfg.norm_kind, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = truncated_normal_init((cfg.d_model, cfg.vocab_size), g, dtype=dtype)
    params["layers"] = [_dense_layer_params(cfg, g, dtype) for _ in range(cfg.n_layers)]
    params["bangkv_codebooks"] = torch.stack([
        bkv.bangkv_codebook_params(g, cfg.n_kv_heads, cfg.head_dim, cfg.bangkv_m)
        for _ in range(cfg.n_layers)
    ])
    return ParamTree(params)


def layer_flags(cfg: ModelConfig, s_ref: int, device=None) -> dict:
    """Per-layer (window, rope_theta) tensors (gemma3 5:1), as the
    reference's scan takes them."""
    wins, thetas = static_layer_flags(cfg, s_ref)
    return {"window": torch.tensor(wins, dtype=torch.int32, device=device),
            "theta": torch.tensor(thetas, dtype=torch.float32, device=device)}


def static_layer_flags(cfg: ModelConfig, s_ref: int) -> tuple[list, list]:
    """Python (window, theta) per layer: global layers attend to all s_ref
    positions with the config's RoPE base, local ones to the sliding window
    with base 10,000."""
    wins, thetas = [], []
    for i in range(cfg.n_layers):
        if cfg.local_global_ratio and cfg.sliding_window:
            r = cfg.local_global_ratio
            is_global = (i % (r + 1)) == r
            wins.append(s_ref + 1 if is_global else cfg.sliding_window)
            thetas.append(cfg.rope_theta if is_global else 10_000.0)
        else:
            wins.append(cfg.sliding_window or s_ref + 1)
            thetas.append(cfg.rope_theta)
    return wins, thetas


# ---------------------------------------------------------------------------
# Layer body and stack
# ---------------------------------------------------------------------------

def _dense_layer(cfg: ModelConfig, p, h, window, theta, cache, mode: str, codebooks=None):
    """One dense/moe decoder layer. Returns (h, new_cache, aux)."""
    aux = _zero_aux(h.device)
    x = norm(h, p["attn_norm"], cfg.norm_kind, cfg.norm_eps)
    if mode == "decode_bangkv":
        y, new_cache = bkv.bangkv_attention_block(
            p["attn"], codebooks, x, cache,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=theta, top_l=cfg.bangkv_topl, window=cfg.bangkv_window,
            hier_topk=cfg.opt_hier_topk, adc_lite=cfg.opt_adc_lite,
        )
    else:
        y, new_cache = attention_block(
            p["attn"], x,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=theta, attn_chunk=_pick_chunk(x.shape[1], cfg.attn_chunk),
            window=window, cache=cache if mode == "decode" else None,
            bf16_scores=cfg.opt_attn_bf16, window_skip=cfg.opt_window_skip,
        )
    h = h + y

    x = norm(h, p["ffn_norm"], cfg.norm_kind, cfg.norm_eps)
    if cfg.n_experts:
        y, aux = moe_block(
            p["moe"], x, n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
            capacity_factor=cfg.capacity_factor, bf16_compute=cfg.opt_moe_bf16,
        )
    else:
        y = swiglu(p["ffn"], x)
    return h + y, new_cache, aux


def decoder_stack(cfg: ModelConfig, params, h: torch.Tensor, *, mode: str, caches=None,
                  s_max: int | None = None):
    """Run the decoder layers. Returns (h, aux summed over layers, caches).

    mode "prefill": caches are made here, (L, B, s_max or S, Hkv, hd) with
    the prompt's roped K and V in the first S slots and index S.
    "decode" / "decode_bangkv": `caches` (a `KVCache` / `BangKVCache`
    stack) are updated in place."""
    check_family(cfg)
    if mode not in ("prefill", "decode", "decode_bangkv"):
        raise NotImplementedError(f"mode {mode!r}: training waits for a later slice (ROADMAP A8)")
    B, S, _ = h.shape
    decode = mode != "prefill"
    s_ref = caches.k.shape[2] if decode else S
    wins, thetas = static_layer_flags(cfg, s_ref)
    aux = _zero_aux(h.device)
    if not decode:
        s_max = S if s_max is None else s_max
        if s_max < S:
            raise ValueError(f"s_max {s_max} is shorter than the {S} prefilled positions")
        shape = (cfg.n_layers, B, s_max, cfg.n_kv_heads, cfg.head_dim)
        k_all = torch.zeros(shape, dtype=h.dtype, device=h.device)
        v_all = torch.zeros(shape, dtype=h.dtype, device=h.device)
    for i in range(cfg.n_layers):
        cache_i = type(caches)(*(t[i] for t in caches)) if decode else None
        cb_i = params["bangkv_codebooks"][i] if mode == "decode_bangkv" else None
        h, c_i, aux_i = _dense_layer(cfg, params["layers"][i], h, wins[i], thetas[i], cache_i,
                                     mode, codebooks=cb_i)
        aux = MoEAux(*(a + b for a, b in zip(aux, aux_i)))
        if not decode:
            k_all[i, :, :S], v_all[i, :, :S] = c_i
    if decode:
        new_caches = caches._replace(index=caches.index + 1)
    else:
        new_caches = KVCache(k_all, v_all,
                             torch.full((cfg.n_layers,), S, dtype=torch.int32, device=h.device))
    return h, aux, new_caches


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------

class LM(nn.Module):
    """One decoder architecture's parameters and its serve path.

    `LM(cfg)` draws random parameters on the card (`device="cuda"`, which
    raises where there is none); the tests pass `device="cpu"`, or
    parameters carried across from the reference
    (`convert.lm_params_from_reference`)."""

    def __init__(self, cfg: ModelConfig, params: ParamTree | None = None, *,
                 device: str | torch.device = "cuda", generator: torch.Generator | None = None):
        check_family(cfg)
        super().__init__()
        self.cfg = cfg
        self.params = init_params(cfg, generator, device) if params is None else params

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    @torch.no_grad()
    def set_codebooks(self, codebooks: torch.Tensor) -> None:
        """Replace the (L, Hkv, m, 256, hd/m) BANG-KV codebooks (fitted on
        prefill keys: `retrieval_attention.fit_bangkv_caches`)."""
        self.params["bangkv_codebooks"].copy_(codebooks)

    # ---------------------------------------------------------------- embed
    def _embed_inputs(self, tokens: torch.Tensor, frontend: torch.Tensor | None):
        h = embed(tokens.long(), self.params["embed"])
        if self.cfg.frontend == "vision_stub" and frontend is not None:
            h = torch.cat([frontend.to(h.dtype), h], dim=1)
        return h

    def _logits_head(self, h: torch.Tensor) -> torch.Tensor:
        """float32 logits. The head is cast to float32 on every call, as the
        reference does (2.5 GB for glm4-9b's 151,552 x 4096)."""
        p = self.params
        head = p["embed"].T if self.cfg.tie_embeddings else p["lm_head"]   # (D, V)
        return h.float() @ head.float()

    # --------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, batch: dict, *, s_max: int | None = None):
        """Forward the prompt; return last-position logits (B, 1, V) and the
        decode caches, sized for `s_max` positions, a vlm's frontend
        included (the prompt's length when None, as the reference's)."""
        cfg = self.cfg
        h = self._embed_inputs(batch["tokens"], batch.get("frontend"))
        h, _, caches = decoder_stack(cfg, self.params, h, mode="prefill", s_max=s_max)
        h = norm(h, self.params["final_norm"], cfg.norm_kind, cfg.norm_eps)
        return self._logits_head(h[:, -1:]), caches

    # ---------------------------------------------------------------- decode
    @torch.no_grad()
    def decode_step(self, caches, tokens: torch.Tensor, *, bangkv: bool = False):
        """One decode step. tokens (B, 1). Returns (logits (B, 1, V), caches):
        the caches are updated in place and returned with index + 1."""
        cfg = self.cfg
        mode = "decode_bangkv" if bangkv else "decode"
        h = embed(tokens.long(), self.params["embed"])
        h, _, new_caches = decoder_stack(cfg, self.params, h, mode=mode, caches=caches)
        h = norm(h, self.params["final_norm"], cfg.norm_kind, cfg.norm_eps)
        return self._logits_head(h), new_caches

    # ----------------------------------------------------------- cache init
    def init_decode_caches(self, batch: int, s_max: int, *, bangkv: bool = False, fill: int = 0):
        """Zero caches at fill level `fill`, on the model's device."""
        cfg, dev = self.cfg, self.device
        L = cfg.n_layers
        kv_shape = (L, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
        k = torch.zeros(kv_shape, dtype=self.dtype, device=dev)
        v = torch.zeros(kv_shape, dtype=self.dtype, device=dev)
        index = torch.full((L,), fill, dtype=torch.int32, device=dev)
        if not bangkv:
            return KVCache(k, v, index)
        codes = torch.zeros((L, batch, s_max, cfg.n_kv_heads, cfg.bangkv_m), dtype=torch.uint8,
                            device=dev)
        return bkv.BangKVCache(codes, k, v, index)
