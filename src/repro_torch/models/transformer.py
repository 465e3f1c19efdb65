"""The LM: every architecture family assembled from the layers, served and
trained.

The port of the reference package's `models/transformer.py`: `init_params`,
the per-layer flags, `_dense_layer` (with whisper's cross-attention),
`_ssm_layer`, the stacks -- the decoders (dense, moe, vlm), the Mamba2 stack
(ssm), zamba2's SSM groups with one weight-shared attention block after
each (hybrid), whisper's encoder and its decoder with cross-attention
(encdec) -- and `LM` with `loss`, `prefill`, `decode_step` (exact KV or
BANG-KV) and `init_decode_caches`. Each stack is one Python loop over the
layers, the counterpart of both the reference's `lax.scan` and its unrolled
stack; the per-layer window and RoPE base are Python numbers
(`static_layer_flags`).

Training (`mode="train"`, `LM.loss`) runs the same layers with full causal
attention and no caches, then the sequence-chunked cross-entropy
(`layers.unembed_chunked`). Remat goes where the reference's `_scan_stack`
puts it: with `cfg.remat`, each scanned layer body -- a decoder layer, an
SSM layer, whisper's decoder layer -- runs under
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`, so only the layer
boundaries are kept and a layer's activations are recomputed in backward;
zamba2's shared attention block and whisper's encoder are not
rematerialised, as the reference's are not.

On a mesh (`lm_loss(..., mesh=)`, a `distributed.collectives.MeshContext`:
the mesh training step of `launch.specs`), the dense, vlm, moe, ssm and
hybrid families hold this rank's blocks of the parameters and its slice
of the batch; the embedding, each layer's attention and FFN, and the
cross-entropy gather their weights at their use and run Megatron TP over
`model` (`models.attention.HeadPlan`, `ffn.swiglu`, `layers.embed`,
`layers.unembed_chunked`); an MoE layer runs its experts in parallel over
`model` and routes on the global batch (`moe.moe_block`), so the loss's
load_balance, router_z and dropped_frac are the global batch's; a Mamba2
layer cuts its projection's columns, conv channels, heads and di over
`model` (`ssm.SSMLayout`); zamba2's shared attention block gathers its
weights at each of its calls. Whisper's encoder runs its layers the same
way over this rank's frames, and its memory comes out whole over `model`;
`cross_kv` gathers `cross/wk` and `cross/wv` whole over `model` and
projects every KV head on every `model` rank, so each decoder layer's
cross-attention reads its heads' K and V (`attention.cross_attention_block`),
and the memory's gradient, a part on each `model` rank, is summed there by
one `to_model`. Under remat the gathers run inside the rematerialised
layer body, so a gathered weight is gathered again in backward and never
held across layers.

Serving on a mesh (`LM.prefill`, `LM.decode_step` and
`LM.init_decode_caches` with `mesh=`, the prefill and decode steps of
`launch.specs`; every family) takes the same blocks of the parameters and
this rank's slice of the batch. The decode caches are this rank's blocks
in the `cache_pspecs` layout: the batch over `data` where it divides, the
sequence over `model` where `s_max` divides (`collectives.SeqBlock`), an
SSM layer's conv window over its channels and its state over its heads,
whisper's cross K and V whole over `model`.
Prefill runs the training stack's forward and writes this rank's block of
the sequence of every KV head; a decode step attends over the sequence
cut across `model` (`attention.decode_attention`,
`retrieval_attention.bangkv_decode_attention` with the hierarchical
top-L); the logits are vocabulary-parallel (`layers.logits_head`). A
vlm's prefill carries its patches, whisper's its frames.

Caches keep the reference's stacked layout -- K and V (L, B, S, Hkv, hd),
BANG-KV codes (L, B, S, Hkv, m) uint8, `index` (L,) int32, the SSM's conv
window (L, B, K-1, conv_ch) and state (L, B, H, P, N); hybrid's
`(SSMCache, KVCache | BangKVCache (n_groups, ...))`, encdec's
`(self caches, (cross_k, cross_v) (L, B, M, Hkv, hd))` -- so carrying one
across is a copy. A decode step writes the new entries into the caches in
place at the device index (no host sync per layer or step) and returns
caches that share their storage, with `index + 1`.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..distributed.collectives import check_mesh_family
from ..kernels.common import resolve_device
from . import retrieval_attention as bkv
from .attention import KVCache, attention_block, attn_params, cross_attention_block
from .ffn import ffn_params, swiglu
from .layers import (ParamTree, embed, logits_head, norm, norm_params, truncated_normal_init,
                     unembed_chunked)
from .moe import MoEAux, moe_block, moe_params
from .ssm import SSMCache, ssm_block, ssm_cache_init, ssm_params

SERVE_FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")
MODES = ("train", "prefill", "decode", "decode_bangkv")


def check_family(cfg: ModelConfig) -> None:
    """Raise for an architecture that no serve or train path of the port
    supports."""
    if cfg.family not in SERVE_FAMILIES or cfg.arch_kind not in ("decoder", "encdec"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} ({cfg.arch_kind}) has no serve path")


def _pick_chunk(S: int, target: int) -> int:
    """Largest divisor of S that is <= target (chunked attention and SSD tiling)."""
    c = min(target, S)
    while S % c:
        c -= 1
    return c


def _zero_aux(device) -> MoEAux:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return MoEAux(z, z, z)


def _add_aux(a: MoEAux, b: MoEAux) -> MoEAux:
    return MoEAux(*(x + y for x, y in zip(a, b)))


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


def _ssm_layer_params(cfg: ModelConfig, g: torch.Generator, dtype) -> dict:
    return {
        "norm": norm_params(cfg.d_model, cfg.norm_kind, g.device),
        "ssm": ssm_params(g, cfg.d_model, expand=cfg.ssm_expand, state=cfg.ssm_state,
                          conv=cfg.ssm_conv, head_dim=cfg.ssm_head_dim, groups=cfg.ssm_groups,
                          dtype=dtype),
    }


def _encdec_decoder_layer_params(cfg: ModelConfig, g: torch.Generator, dtype) -> dict:
    p = _dense_layer_params(cfg, g, dtype)
    p["cross_norm"] = norm_params(cfg.d_model, cfg.norm_kind, g.device)
    p["cross"] = attn_params(g, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dtype)
    return p


def _codebooks(cfg: ModelConfig, g: torch.Generator, n: int) -> torch.Tensor:
    return torch.stack([bkv.bangkv_codebook_params(g, cfg.n_kv_heads, cfg.head_dim, cfg.bangkv_m)
                        for _ in range(n)])


class _MetaGenerator(torch.Generator):
    """A CPU generator that says it lies on the `meta` device, so the
    initialisers make meta tensors (no storage, nothing drawn)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device: str | torch.device = "cuda") -> ParamTree:
    """Random parameters, drawn on `device` from `generator` (a generator on
    that device; seed 0 when None): nothing passes through host memory, so
    glm4-9b's 18.8 GB of bf16 are made on the card. The tree has the
    reference's names, with each stacked layer axis as a list of layers:
    `layers` (and whisper's `encoder.layers`), zamba2's one `shared_attn`
    block, and BANG-KV codebooks for every attention cache (none for
    mamba2). On `device="meta"` the tree holds shapes and dtypes only."""
    check_family(cfg)
    if torch.device(device).type == "meta":   # shapes and dtypes only (`launch.specs`)
        dev = torch.device("meta")
        g = _MetaGenerator() if generator is None else generator
    else:
        dev = resolve_device(device)
        g = torch.Generator(dev).manual_seed(0) if generator is None else generator
    if g.device.type != dev.type:
        raise ValueError(f"generator on {g.device}, parameters asked on {dev}")
    dtype = getattr(torch, cfg.dtype)
    L = cfg.n_layers
    params: dict[str, Any] = {
        "embed": truncated_normal_init((cfg.vocab_size, cfg.d_model), g, dtype=dtype),
        "final_norm": norm_params(cfg.d_model, cfg.norm_kind, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = truncated_normal_init((cfg.d_model, cfg.vocab_size), g, dtype=dtype)
    if cfg.family in ("ssm", "hybrid"):
        params["layers"] = [_ssm_layer_params(cfg, g, dtype) for _ in range(L)]
        if cfg.family == "hybrid":
            params["shared_attn"] = _dense_layer_params(cfg, g, dtype)
            params["bangkv_codebooks"] = _codebooks(cfg, g, L // cfg.hybrid_attn_every)
    elif cfg.arch_kind == "encdec":
        params["layers"] = [_encdec_decoder_layer_params(cfg, g, dtype) for _ in range(L)]
        params["encoder"] = {
            "layers": [_dense_layer_params(cfg, g, dtype) for _ in range(cfg.n_encoder_layers)],
            "final_norm": norm_params(cfg.d_model, cfg.norm_kind, dev),
        }
        params["bangkv_codebooks"] = _codebooks(cfg, g, L)
    else:
        params["layers"] = [_dense_layer_params(cfg, g, dtype) for _ in range(L)]
        params["bangkv_codebooks"] = _codebooks(cfg, g, L)
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
# Layer bodies
# ---------------------------------------------------------------------------

def _dense_layer(cfg: ModelConfig, p, h, window, theta, cache, mode: str, codebooks=None,
                 cross_mem=None, mesh=None, seq=None):
    """One dense/moe decoder layer (whisper's with its cross-attention into
    `cross_mem` = (k, v) (B, M, Hkv, hd)). Returns (h, new_cache, aux).
    `mesh`: the layer on a mesh (`seq`: its decode cache's block of the
    sequence)."""
    aux = _zero_aux(h.device)
    x = norm(h, p["attn_norm"], cfg.norm_kind, cfg.norm_eps)
    if mode == "decode_bangkv":
        y, new_cache = bkv.bangkv_attention_block(
            p["attn"], codebooks, x, cache,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=theta, top_l=cfg.bangkv_topl, window=cfg.bangkv_window,
            hier_topk=cfg.opt_hier_topk, adc_lite=cfg.opt_adc_lite, mesh=mesh, seq=seq,
        )
    else:
        y, new_cache = attention_block(
            p["attn"], x,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=theta, attn_chunk=_pick_chunk(x.shape[1], cfg.attn_chunk),
            window=window, cache=cache if mode == "decode" else None,
            bf16_scores=cfg.opt_attn_bf16, window_skip=cfg.opt_window_skip, mesh=mesh,
            seq=seq, return_kv=mode != "train",
        )
        if mode == "train":
            new_cache = None   # training keeps no K and V
    h = h + y

    if cross_mem is not None:   # whisper's decoder: no RoPE on the cross query
        x = norm(h, p["cross_norm"], cfg.norm_kind, cfg.norm_eps)
        h = h + cross_attention_block(p["cross"], x, cross_mem, n_heads=cfg.n_heads,
                                      n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim, mesh=mesh)

    x = norm(h, p["ffn_norm"], cfg.norm_kind, cfg.norm_eps)
    if cfg.n_experts:
        y, aux = moe_block(
            p["moe"], x, n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
            capacity_factor=cfg.capacity_factor, bf16_compute=cfg.opt_moe_bf16, mesh=mesh,
        )
    else:
        y = swiglu(p["ffn"], x, mesh)
    return h + y, new_cache, aux


def _ssm_layer(cfg: ModelConfig, p, h, cache, mode: str, mesh=None):
    """One Mamba2 layer. Returns (h, cache): prefill's new cache, the decode
    step's `cache`, updated in place, or None in training. `mesh`: the
    layer on a mesh (`ssm.SSMLayout`), its caches this rank's blocks."""
    x = norm(h, p["norm"], cfg.norm_kind, cfg.norm_eps)
    y, new_cache = ssm_block(
        p["ssm"], x,
        expand=cfg.ssm_expand, state=cfg.ssm_state, conv=cfg.ssm_conv,
        head_dim=cfg.ssm_head_dim, groups=cfg.ssm_groups,
        chunk=_pick_chunk(x.shape[1], cfg.ssm_chunk),
        cache=cache if mode.startswith("decode") else None,
        return_cache=(mode == "prefill"), train=(mode == "train"), mesh=mesh,
    )
    return h + y, new_cache


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------

def _remat(cfg: ModelConfig, mode: str, scanned: bool = True) -> bool:
    """Whether a layer body is rematerialised: in training with
    `cfg.remat`, where the reference scans the layers (it does not
    rematerialise its unrolled dense stack, `scan_layers=False`)."""
    return mode == "train" and cfg.remat and scanned


def _call(remat: bool, fn, *args):
    """fn(*args), under activation checkpointing when `remat`. The layers
    draw no random numbers, so no RNG state is saved."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _layer(caches, i: int):
    """Layer i's view of a stacked cache (a NamedTuple of (L, ...) tensors)."""
    return type(caches)(*(t[i] for t in caches))


def _kv_buffers(n: int, B: int, s_max: int, S: int, cfg: ModelConfig, like: torch.Tensor):
    if s_max < S:
        raise ValueError(f"s_max {s_max} is shorter than the {S} prefilled positions")
    shape = (n, B, s_max, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=like.dtype, device=like.device),
            torch.zeros(shape, dtype=like.dtype, device=like.device))


def _ssm_layers(cfg: ModelConfig, layers, h, mode: str, caches: SSMCache | None,
                out: SSMCache | None, lo: int, hi: int, mesh=None):
    """SSM layers lo..hi-1: decode updates `caches` in place; prefill writes
    each layer's new cache into the stacked `out`; training keeps none and
    rematerialises each layer with `cfg.remat` (on a mesh the recompute
    issues the layer's collectives again)."""
    if mode == "train":
        for i in range(lo, hi):
            h = _call(_remat(cfg, mode),
                      lambda h, p=layers[i]: _ssm_layer(cfg, p, h, None, mode, mesh)[0], h)
        return h
    for i in range(lo, hi):
        h, c_i = _ssm_layer(cfg, layers[i], h, _layer(caches, i) if caches is not None else None,
                            mode, mesh)
        if out is not None:
            out.conv[i], out.state[i] = c_i
    return h


def _ssm_prefill_buffers(cfg: ModelConfig, h: torch.Tensor, mesh=None) -> SSMCache:
    return ssm_cache_init(h.shape[0], expand=cfg.ssm_expand, d_model=cfg.d_model,
                          state=cfg.ssm_state, conv=cfg.ssm_conv, head_dim=cfg.ssm_head_dim,
                          groups=cfg.ssm_groups, dtype=h.dtype, device=h.device,
                          layers=cfg.n_layers, mesh=mesh)


def _ssm_stack(cfg: ModelConfig, params, h, mode: str, caches, mesh=None):
    """Mamba2's prefill and decode: (h, aux, caches)."""
    decode = mode != "prefill"
    out = None if decode else _ssm_prefill_buffers(cfg, h, mesh)
    h = _ssm_layers(cfg, params["layers"], h, mode, caches if decode else None, out,
                    0, cfg.n_layers, mesh)
    return h, _zero_aux(h.device), caches if decode else out


def _hybrid_stack(cfg: ModelConfig, params, h, *, mode: str, caches, s_max: int | None,
                  mesh=None, seq=None):
    """Zamba2: groups of `hybrid_attn_every` Mamba2 layers, each followed by
    the one shared attention block (the same weights, a cache of its own
    per call, window s_ref + 1, the config's RoPE base).

    caches = (SSM caches (L, ...), attention caches (n_groups, ...)); none
    in training, where the SSM layers are rematerialised and the shared
    block is not (as the reference's `_hybrid_stack`). On a mesh (`mesh`,
    and in serving `seq`, the attention caches' block of `s_max`
    positions): the shared block's weights are gathered at each of its
    calls (their gradients add up over the calls) and the caches are this
    rank's blocks."""
    every = cfg.hybrid_attn_every
    n_groups = cfg.n_layers // every
    B, S, _ = h.shape
    aux = _zero_aux(h.device)
    if mode == "train":
        for g in range(n_groups):
            h = _ssm_layers(cfg, params["layers"], h, mode, None, None, g * every, (g + 1) * every,
                            mesh)
            h, _, aux_g = _dense_layer(cfg, params["shared_attn"], h, S + 1, cfg.rope_theta, None,
                                       mode, mesh=mesh)
            aux = _add_aux(aux, aux_g)
        return h, aux, None
    decode = mode != "prefill"
    if decode:
        ssm_c, attn_c = caches
        s_ref, ssm_out = attn_c.k.shape[2] if seq is None else s_max, None
    else:
        ssm_c, attn_c, s_ref = None, None, S
        ssm_out = _ssm_prefill_buffers(cfg, h, mesh)
        if seq is None:
            k_all, v_all = _kv_buffers(n_groups, B, S if s_max is None else s_max, S, cfg, h)
            lo, n = 0, S
        else:   # this rank's block of the sequence, the prompt's positions in it
            k_all, v_all = _kv_buffers(n_groups, B, seq.length, 0, cfg, h)
            lo, n = seq.lo, min(seq.lo + seq.length, S) - seq.lo
    for g in range(n_groups):
        h = _ssm_layers(cfg, params["layers"], h, mode, ssm_c, ssm_out, g * every, (g + 1) * every,
                        mesh)
        cb = params["bangkv_codebooks"][g] if mode == "decode_bangkv" else None
        h, a_new, aux_g = _dense_layer(cfg, params["shared_attn"], h, s_ref + 1, cfg.rope_theta,
                                       _layer(attn_c, g) if decode else None, mode, codebooks=cb,
                                       mesh=mesh, seq=seq if decode else None)
        aux = _add_aux(aux, aux_g)
        if not decode and n > 0:
            k_all[g, :, :n], v_all[g, :, :n] = (t[:, lo:lo + n] for t in a_new)
    if decode:
        return h, aux, (ssm_c, attn_c._replace(index=attn_c.index + 1))
    index = torch.full((n_groups,), S, dtype=torch.int32, device=h.device)
    return h, aux, (ssm_out, KVCache(k_all, v_all, index))


def decoder_stack(cfg: ModelConfig, params, h: torch.Tensor, *, mode: str, caches=None,
                  s_max: int | None = None, cross_mem=None, mesh=None):
    """Run the decoder layers. Returns (h, aux summed over layers, caches).

    mode "train": full causal attention, no caches (None), each layer
    rematerialised with `cfg.remat`. "prefill": caches are made here --
    attention caches (L, B, s_max or S, Hkv, hd) with the prompt's roped K
    and V in the first S slots and index S, SSM caches with the prompt's
    conv window and final state. "decode" / "decode_bangkv": `caches` are
    updated in place. Whisper's decoder takes `cross_mem` = (cross_k,
    cross_v) (L, B, M, Hkv, hd). `mesh` (a `MeshContext`): this rank's part
    of a stack on a mesh (every family; whisper's cross K and V whole over
    `model`); in decode, `s_max` is then the attention caches' full length
    (their block's times the `model` ranks when None)."""
    check_family(cfg)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    if mode == "train":
        return _train_stack(cfg, params, h, cross_mem, _mesh_for(cfg, mesh))
    mesh = _mesh_for(cfg, mesh, "prefill" if mode == "prefill" else "decode")
    if mesh is not None:
        return _mesh_serve_stack(cfg, params, h, mode=mode, caches=caches, s_max=s_max,
                                 cross_mem=cross_mem, mesh=mesh)
    if cfg.family == "ssm":
        return _ssm_stack(cfg, params, h, mode, caches)
    if cfg.family == "hybrid":
        return _hybrid_stack(cfg, params, h, mode=mode, caches=caches, s_max=s_max)

    decode = mode != "prefill"
    B, S, _ = h.shape
    s_ref = caches.k.shape[2] if decode else S
    wins, thetas = static_layer_flags(cfg, s_ref)
    aux = _zero_aux(h.device)
    if not decode:
        k_all, v_all = _kv_buffers(cfg.n_layers, B, S if s_max is None else s_max, S, cfg, h)
    for i in range(cfg.n_layers):
        cb_i = params["bangkv_codebooks"][i] if mode == "decode_bangkv" else None
        h, c_i, aux_i = _dense_layer(cfg, params["layers"][i], h, wins[i], thetas[i],
                                     _layer(caches, i) if decode else None, mode,
                                     codebooks=cb_i, cross_mem=_cross_layer(cross_mem, i))
        aux = _add_aux(aux, aux_i)
        if not decode:
            k_all[i, :, :S], v_all[i, :, :S] = c_i
    if decode:
        return h, aux, caches._replace(index=caches.index + 1)
    index = torch.full((cfg.n_layers,), S, dtype=torch.int32, device=h.device)
    return h, aux, KVCache(k_all, v_all, index)


def _cross_layer(cross_mem, i: int):
    """Layer i's (cross_k, cross_v) of whisper's stacks; None elsewhere."""
    return None if cross_mem is None else (cross_mem[0][i], cross_mem[1][i])


def _mesh_for(cfg: ModelConfig, mesh, kind: str = "train"):
    """`mesh` (a `MeshContext` or None), after `check_mesh_family` for the
    step of `kind`."""
    if mesh is not None:
        check_mesh_family(cfg, mesh.mesh, kind)
    return mesh


def _mesh_serve_stack(cfg: ModelConfig, params, h: torch.Tensor, *, mode: str, caches, s_max,
                      cross_mem, mesh):
    """decoder_stack's prefill and decode on a mesh: h is this rank's slice
    of the batch. Prefill makes this rank's blocks of the caches, `s_max`
    positions in all (the prompt's length when None): its block of the
    sequence of every KV head, its channels of an SSM layer's conv window
    and its heads of the state. Decode updates them in place. Whisper's
    `caches` are its self-attention caches, and `cross_mem` its cross K
    and V of this rank's requests."""
    if cfg.family == "ssm":
        return _ssm_stack(cfg, params, h, mode, caches, mesh)
    B, S, _ = h.shape
    L = cfg.n_layers
    decode = mode != "prefill"
    kv = (caches[1] if cfg.family == "hybrid" else caches) if decode else None   # the attention caches
    if decode:
        s_max = kv.k.shape[2] * mesh.n_model if s_max is None else s_max
    elif s_max is None:
        s_max = S
    elif s_max < S:
        raise ValueError(f"s_max {s_max} is shorter than the {S} prefilled positions")
    seq = mesh.seq_block(s_max)
    if decode and kv.k.shape[2] != seq.length:
        raise ValueError(f"a cache block of {kv.k.shape[2]} positions: {s_max} positions "
                         f"over {mesh.n_model} model ranks give blocks of {seq.length}")
    if cfg.family == "hybrid":
        return _hybrid_stack(cfg, params, h, mode=mode, caches=caches, s_max=s_max, mesh=mesh,
                             seq=seq)
    wins, thetas = static_layer_flags(cfg, s_max if decode else S)
    aux = _zero_aux(h.device)
    if decode:
        for i in range(L):
            cb_i = params["bangkv_codebooks"][i] if mode == "decode_bangkv" else None
            h, _, aux_i = _dense_layer(cfg, params["layers"][i], h, wins[i], thetas[i],
                                       _layer(caches, i), mode, codebooks=cb_i,
                                       cross_mem=_cross_layer(cross_mem, i), mesh=mesh, seq=seq)
            aux = _add_aux(aux, aux_i)
        return h, aux, caches._replace(index=caches.index + 1)
    shape = (L, B, seq.length, cfg.n_kv_heads, cfg.head_dim)
    k_all = torch.zeros(shape, dtype=h.dtype, device=h.device)
    v_all = torch.zeros(shape, dtype=h.dtype, device=h.device)
    n = min(seq.lo + seq.length, S) - seq.lo   # prompt positions in this block
    for i in range(L):
        h, (k, v), aux_i = _dense_layer(cfg, params["layers"][i], h, wins[i], thetas[i], None,
                                        mode, cross_mem=_cross_layer(cross_mem, i), mesh=mesh)
        aux = _add_aux(aux, aux_i)
        if n > 0:
            k_all[i, :, :n], v_all[i, :, :n] = k[:, seq.lo:seq.lo + n], v[:, seq.lo:seq.lo + n]
    index = torch.full((L,), S, dtype=torch.int32, device=h.device)
    return h, aux, KVCache(k_all, v_all, index)


def _train_stack(cfg: ModelConfig, params, h: torch.Tensor, cross_mem, mesh=None):
    """decoder_stack's training mode: (h, aux summed over layers, None)."""
    if cfg.family == "ssm":
        h = _ssm_layers(cfg, params["layers"], h, "train", None, None, 0, cfg.n_layers, mesh)
        return h, _zero_aux(h.device), None
    if cfg.family == "hybrid":
        return _hybrid_stack(cfg, params, h, mode="train", caches=None, s_max=None, mesh=mesh)
    wins, thetas = static_layer_flags(cfg, h.shape[1])
    remat = _remat(cfg, "train", cfg.scan_layers)
    aux = _zero_aux(h.device)
    for i in range(cfg.n_layers):
        def body(h, p=params["layers"][i], w=wins[i], th=thetas[i], cm=_cross_layer(cross_mem, i)):
            h, _, aux_i = _dense_layer(cfg, p, h, w, th, None, "train", cross_mem=cm, mesh=mesh)
            return h, aux_i

        h, aux_i = _call(remat, body, h)
        aux = _add_aux(aux, aux_i)
    return h, aux, None


def encoder_stack(cfg: ModelConfig, params, mem: torch.Tensor, mesh=None) -> torch.Tensor:
    """Whisper's encoder: bidirectional attention over the frame embeddings
    (RoPE on q and k at positions 0..M-1), a SwiGLU FFN, the final norm.
    Never rematerialised (the reference scans it in mode "encode"). With
    `mesh`, `mem` is this rank's requests' frames and each layer runs its
    heads and its block of d_ff over `model`; the memory comes out whole
    over `model`."""
    enc = params["encoder"]
    S = mem.shape[1]
    h = mem
    for p in enc["layers"]:
        z = norm(h, p["attn_norm"], cfg.norm_kind, cfg.norm_eps)
        y, _ = attention_block(
            p["attn"], z,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, attn_chunk=_pick_chunk(S, cfg.attn_chunk),
            window=S + 1, causal=False, mesh=mesh, return_kv=False,
        )
        h = h + y
        z = norm(h, p["ffn_norm"], cfg.norm_kind, cfg.norm_eps)
        h = h + swiglu(p["ffn"], z, mesh)
    return norm(h, enc["final_norm"], cfg.norm_kind, cfg.norm_eps)


def cross_kv(cfg: ModelConfig, params, memory: torch.Tensor, mesh=None):
    """Each decoder layer's cross-attention K and V of the encoder memory:
    two (L, B, M, Hkv, hd) stacks.

    With `mesh`, `memory` is this rank's requests' and whole over `model`,
    and so are the K and V: `cross/wk` and `cross/wv` are gathered whole
    over `model` at their use and every `model` rank projects every KV
    head. That moves the weight, D x Hkv hd, where projecting this rank's
    columns and gathering the result would move B x M x Hkv hd (whisper's
    1,500 frames exceed its d_model of 1,024, so at any batch), and gives
    the plain path's K and V; the projection's FLOPs (whisper-medium's:
    about a tenth of the encoder's) repeat on each `model` rank. Where the
    decoder's heads are split, each rank's gradient of K and V is a part
    (its query heads'), so the weights' gradients are summed over `model`
    by their gathers and the memory's by one `to_model`."""
    B, M, _ = memory.shape
    shape = (B, M, cfg.n_kv_heads, cfg.head_dim)
    weight = lambda w, name: w   # noqa: E731
    if mesh is not None:
        use = "partial" if mesh.model_sharded("wo", 0) else "replicated"
        if use == "partial":
            memory = mesh.to_model(memory)
        weight = lambda w, name: mesh.weight(w, name, use)   # noqa: E731
    layers = [p["cross"] for p in params["layers"]]
    ks = torch.stack([(memory @ weight(p["wk"], "wk")).reshape(shape) for p in layers])
    vs = torch.stack([(memory @ weight(p["wv"], "wv")).reshape(shape) for p in layers])
    return ks, vs


# ---------------------------------------------------------------------------
# Decode state
# ---------------------------------------------------------------------------

def attention_caches(cfg: ModelConfig, caches):
    """The attention stack of a decode state, the one BANG-KV retrieves
    from: a decoder's caches, zamba2's shared-block caches (one a group),
    whisper's self-attention caches; None for mamba2."""
    if cfg.family == "ssm":
        return None
    if cfg.family == "hybrid":
        return caches[1]
    if cfg.arch_kind == "encdec":
        return caches[0]
    return caches


def with_attention_caches(cfg: ModelConfig, caches, kv):
    """The decode state `caches` with `kv` in place of its attention stack."""
    if cfg.family == "hybrid":
        return (caches[0], kv)
    if cfg.arch_kind == "encdec":
        return (kv, caches[1])
    return kv


def clone_caches(caches):
    """A copy of the decode state that a decode step writes in place, to
    decode two paths from one prefill (whisper's cross K and V are only
    read, and stay shared)."""
    if hasattr(caches, "_fields"):
        return type(caches)(*(t.clone() for t in caches))
    if isinstance(caches[0], torch.Tensor):
        return caches
    return tuple(clone_caches(c) for c in caches)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def embed_inputs(cfg: ModelConfig, params, tokens: torch.Tensor,
                 frontend: torch.Tensor | None, mesh=None) -> torch.Tensor:
    """Token embeddings, a vlm's patch embeddings (`frontend`) prepended.
    On a mesh, tokens and patches are this rank's slice of the batch."""
    h = embed(tokens.long(), params["embed"], mesh)
    if cfg.frontend == "vision_stub" and frontend is not None:
        h = torch.cat([frontend.to(h.dtype), h], dim=1)
    return h


def lm_loss(cfg: ModelConfig, params, batch: dict, mesh=None) -> tuple[torch.Tensor, dict]:
    """The training loss of `batch` ("tokens", "labels" (B, S); "frontend"
    (B, M, D) for whisper's frames or a vlm's patches) and its metrics.

    Whisper runs the encoder and every layer's cross K and V, then the
    decoder; a vlm drops the patch positions after the final norm. loss =
    ce + 0.01 load_balance + 0.001 router_z, the MoE terms summed over the
    layers (0 for the other families); the metrics ce, load_balance,
    router_z and dropped_frac come back detached.

    With `mesh` (a `MeshContext`), `params` are this rank's blocks and
    `batch` its slice of the batch: the loss's ce is the mean over this
    slice, its MoE terms and their metrics the global batch's."""
    mesh = _mesh_for(cfg, mesh)
    tokens, labels = batch["tokens"], batch["labels"]
    frontend = batch.get("frontend")
    cm = None
    if cfg.arch_kind == "encdec":
        memory = encoder_stack(cfg, params, frontend.to(getattr(torch, cfg.dtype)), mesh)
        cm = cross_kv(cfg, params, memory, mesh)
    h = embed_inputs(cfg, params, tokens, frontend, mesh)
    h, aux, _ = decoder_stack(cfg, params, h, mode="train", cross_mem=cm, mesh=mesh)
    h = norm(h, params["final_norm"], cfg.norm_kind, cfg.norm_eps)
    if cfg.frontend == "vision_stub" and frontend is not None:
        h = h[:, frontend.shape[1]:]
    chunk = _pick_chunk(h.shape[1], cfg.loss_chunk)
    if mesh is None:
        table = params["embed"] if cfg.tie_embeddings else params["lm_head"].T
        ce = unembed_chunked(h, table, labels, chunk)
    else:
        name = "embed" if cfg.tie_embeddings else "lm_head"
        ce = unembed_chunked(h, params[name], labels, chunk, mesh, name)
    loss = ce + 0.01 * aux.load_balance + 0.001 * aux.router_z
    metrics = {"ce": ce, "load_balance": aux.load_balance, "router_z": aux.router_z,
               "dropped_frac": aux.dropped_frac}
    return loss, {k: v.detach() for k, v in metrics.items()}


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------

class LM(nn.Module):
    """One architecture's parameters, its training loss and its serve path.

    `LM(cfg)` draws random parameters on the card (`device="cuda"`, which
    raises where there is none); the tests pass `device="cpu"`, or
    parameters carried across from the reference
    (`convert.lm_params_from_reference`). The parameters are frozen until
    training makes them trainable (`lm.params.requires_grad_()`); the serve
    entry points compute no gradients either way."""

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
        """Replace the (n, Hkv, m, 256, hd/m) BANG-KV codebooks, one set an
        attention cache (fitted on prefill keys:
        `retrieval_attention.fit_bangkv_caches`)."""
        if "bangkv_codebooks" not in self.params:
            raise ValueError(f"{self.cfg.name} has no attention: no BANG-KV codebooks")
        self.params["bangkv_codebooks"].copy_(codebooks)

    def _logits_head(self, h: torch.Tensor, mesh=None) -> torch.Tensor:
        """float32 logits (`layers.logits_head`)."""
        name = "embed" if self.cfg.tie_embeddings else "lm_head"
        return logits_head(h, self.params[name], name, mesh)

    @torch.no_grad()
    def encode(self, frontend: torch.Tensor, mesh=None):
        """Whisper: the encoder over (B, M, D) frame embeddings, then every
        decoder layer's cross K and V (L, B, M, Hkv, hd). With `mesh` (a
        `MeshContext`): this rank's requests, the K and V whole over
        `model`."""
        mesh = _mesh_for(self.cfg, mesh, "prefill")
        memory = encoder_stack(self.cfg, self.params, frontend.to(self.dtype), mesh)
        return cross_kv(self.cfg, self.params, memory, mesh)

    # ----------------------------------------------------------------- train
    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """(loss, metrics) of a training batch (`lm_loss`); gradients flow
        to the parameters that require them."""
        return lm_loss(self.cfg, self.params, batch)

    # --------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, batch: dict, *, s_max: int | None = None, mesh=None):
        """Forward the prompt; return last-position logits (B, 1, V) and the
        decode caches, their attention caches sized for `s_max` positions,
        a vlm's frontend included (the prompt's length when None, as the
        reference's). Whisper encodes `batch["frontend"]` first and returns
        `(self caches, (cross_k, cross_v))`. With `mesh` (a `MeshContext`;
        the parameters this rank's blocks, `batch` its slice): this rank's
        requests' logits and its blocks of the caches (whisper's cross K and
        V whole over `model`)."""
        cfg = self.cfg
        mesh = _mesh_for(cfg, mesh, "prefill")
        cm = self.encode(batch["frontend"], mesh) if cfg.arch_kind == "encdec" else None
        h = embed_inputs(cfg, self.params, batch["tokens"], batch.get("frontend"), mesh)
        h, _, caches = decoder_stack(cfg, self.params, h, mode="prefill", s_max=s_max,
                                     cross_mem=cm, mesh=mesh)
        if cm is not None:
            caches = (caches, cm)
        h = norm(h, self.params["final_norm"], cfg.norm_kind, cfg.norm_eps)
        return self._logits_head(h[:, -1:], mesh), caches

    # ---------------------------------------------------------------- decode
    @torch.no_grad()
    def decode_step(self, caches, tokens: torch.Tensor, *, bangkv: bool = False, mesh=None,
                    s_max: int | None = None):
        """One decode step. tokens (B, 1). Returns (logits (B, 1, V), caches):
        the caches are updated in place and returned with index + 1. An SSM
        layer has no KV: `bangkv` changes only the attention layers. With
        `mesh` (a `MeshContext`): this rank's requests and blocks of the
        caches, `s_max` positions in all (the blocks' length times the
        `model` ranks when None)."""
        cfg = self.cfg
        mode = "decode_bangkv" if bangkv else "decode"
        mesh = _mesh_for(cfg, mesh, "decode")
        h = embed(tokens.long(), self.params["embed"], mesh)
        encdec = cfg.arch_kind == "encdec"
        own, cross = caches if encdec else (caches, None)
        h, _, new_caches = decoder_stack(cfg, self.params, h, mode=mode, caches=own, s_max=s_max,
                                         cross_mem=cross, mesh=mesh)
        if encdec:
            new_caches = (new_caches, cross)
        h = norm(h, self.params["final_norm"], cfg.norm_kind, cfg.norm_eps)
        return self._logits_head(h, mesh), new_caches

    # ----------------------------------------------------------- cache init
    def init_decode_caches(self, batch: int, s_max: int, *, bangkv: bool = False, fill: int = 0,
                           memory_len: int = 0, mesh=None):
        """Zero caches at fill level `fill`, on the model's device, in the
        layout `prefill` returns (whisper's cross K and V `memory_len` long,
        the config's `frontend_len` when 0). With `mesh` (a `MeshContext`):
        this rank's blocks of the caches of `batch` requests and `s_max`
        positions (`cache_pspecs`; whisper's cross K and V cut over the
        batch only)."""
        cfg, dev = self.cfg, self.device
        L = cfg.n_layers
        mesh = _mesh_for(cfg, mesh, "decode")
        if mesh is not None:
            batch = batch // mesh.n_batch if batch % mesh.n_batch == 0 else batch
            s_max = mesh.seq_block(s_max).length

        def attn(n: int):
            shape = (n, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
            k = torch.zeros(shape, dtype=self.dtype, device=dev)
            v = torch.zeros(shape, dtype=self.dtype, device=dev)
            index = torch.full((n,), fill, dtype=torch.int32, device=dev)
            if not bangkv:
                return KVCache(k, v, index)
            codes = torch.zeros((*shape[:4], cfg.bangkv_m), dtype=torch.uint8, device=dev)
            return bkv.BangKVCache(codes, k, v, index)

        def ssm():
            return ssm_cache_init(batch, expand=cfg.ssm_expand, d_model=cfg.d_model,
                                  state=cfg.ssm_state, conv=cfg.ssm_conv,
                                  head_dim=cfg.ssm_head_dim, groups=cfg.ssm_groups,
                                  dtype=self.dtype, device=dev, layers=L, mesh=mesh)

        if cfg.family == "ssm":
            return ssm()
        if cfg.family == "hybrid":
            return (ssm(), attn(L // cfg.hybrid_attn_every))
        if cfg.arch_kind == "encdec":
            shape = (L, batch, memory_len or cfg.frontend_len, cfg.n_kv_heads, cfg.head_dim)
            cross = (torch.zeros(shape, dtype=self.dtype, device=dev),
                     torch.zeros(shape, dtype=self.dtype, device=dev))
            return (attn(L), cross)
        return attn(L)
