"""State carried across from the reference package.

The port builds its own indexes (`BangIndex.build`); an index the reference
package has built need not be built again. `index_from_reference` takes it,
handed over as numpy arrays, and returns the port's `BangIndex` over the
same state::

    arrays = {
        "codebooks": np.asarray(idx.codec.codebooks),  # (m, 256, dsub) f32
        "codes": np.asarray(idx.codes),                # (n, m) uint8
        "adjacency": idx.graph.adjacency,              # (n, R) int32 host array, -1 padded
        "medoid": idx.graph.medoid,                    # int
        "data": idx.data_np,                           # (n, d) f32 host array
    }
    index = index_from_reference(arrays, device="cuda")

The host arrays (`graph.adjacency`, `data_np`) become the port's host
tables, pinned on a CUDA index, which the "base" variant serves from;
`keep_device_data` mirrors the reference's `data_dev` (None when the
reference index was built with `keep_device_data=False`).

The LM's state crosses the same way: `lm_params_from_reference` takes the
reference's parameter pytree (`LM(cfg).init(key)`, leaves as numpy arrays,
the layers stacked on a leading L axis) and returns the port's parameter
tree for `repro_torch.models.LM(cfg, params)`; `kv_caches_from_reference`,
`bangkv_caches_from_reference` and `ssm_caches_from_reference` carry decode
caches across, and `lm_caches_from_reference` any family's (hybrid's and
whisper's tuples too), so both packages can decode from one state::

    params = lm_params_from_reference(jax.tree.map(np.asarray, ref_params), cfg)
    lm = LM(cfg, params)
    caches = lm_caches_from_reference(jax.tree.map(np.asarray, ref_caches), cfg)

Training state crosses too: a gradient tree has the parameters' structure,
so `lm_params_from_reference` carries the reference's `jax.grad` output
across as it is; `adamw_state_from_reference` and
`compression_state_from_reference` carry the optimizer's moments and master
copies and the int8 error-feedback residuals, keyed by the port's parameter
paths (`tree.flat_dict`).
"""
from __future__ import annotations

import numpy as np
import torch

from .configs.base import ModelConfig
from .core.bang import BangIndex
from .kernels.common import resolve_device
from .models.attention import KVCache
from .models.layers import ParamTree
from .models.retrieval_attention import BangKVCache
from .models.ssm import SSMCache, conv_cache_dtype
from .models.transformer import check_family
from .optim import AdamWState, CompressionState
from .tree import flat_dict

KEYS = ("codebooks", "codes", "adjacency", "medoid", "data")


def index_from_reference(
    arrays: dict[str, np.ndarray],
    *,
    device: str | torch.device = "cuda",
    keep_device_data: bool = True,
) -> BangIndex:
    missing = [k for k in KEYS if k not in arrays]
    if missing:
        raise KeyError(f"reference arrays lack {missing}")
    return BangIndex.from_arrays(
        np.asarray(arrays["codebooks"], np.float32),
        np.asarray(arrays["codes"], np.uint8),
        np.asarray(arrays["adjacency"], np.int32),
        int(arrays["medoid"]),
        np.asarray(arrays["data"], np.float32),
        device=device,
        keep_device_data=keep_device_data,
    )


def _tensor(a, device: torch.device) -> torch.Tensor:
    """A numpy array (bfloat16 ones included, as numpy holds JAX's) on `device`."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _tree(tree, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _split_layers(tree: dict, n: int, dev: torch.device) -> list:
    """A stacked (n, ...) subtree as n subtrees, one a layer."""
    return [_tree(tree, lambda a, i=i: _tensor(np.asarray(a)[i], dev)) for i in range(n)]


def lm_params_from_reference(params: dict, cfg: ModelConfig, *,
                             device: str | torch.device = "cuda") -> ParamTree:
    """The reference's LM parameters on the port's modules: the stacked
    (L, ...) `layers` leaves (attention, norms, the FFN or the MoE `router`,
    `w_*` and `shared` weights, the SSM's, whisper's `cross_*`) split into
    one subtree a layer, and so whisper's `encoder.layers`; the embedding,
    head, final norms, zamba2's unstacked `shared_attn` and the (n, Hkv, m,
    256, dsub) `bangkv_codebooks` as they are."""
    check_family(cfg)
    dev = resolve_device(device)
    leaf = lambda a: _tensor(a, dev)  # noqa: E731
    out = {k: leaf(params[k]) for k in ("embed", "lm_head", "bangkv_codebooks") if k in params}
    out["final_norm"] = _tree(params["final_norm"], leaf)
    out["layers"] = _split_layers(params["layers"], cfg.n_layers, dev)
    if "shared_attn" in params:
        out["shared_attn"] = _tree(params["shared_attn"], leaf)
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {"layers": _split_layers(enc["layers"], cfg.n_encoder_layers, dev),
                          "final_norm": _tree(enc["final_norm"], leaf)}
    return ParamTree(out)


def kv_caches_from_reference(caches, *, device: str | torch.device = "cuda") -> KVCache:
    """A reference `KVCache` stack (k, v (L, B, S, Hkv, hd), index (L,))."""
    dev = resolve_device(device)
    return KVCache(_tensor(caches.k, dev), _tensor(caches.v, dev),
                   _tensor(np.asarray(caches.index, np.int32), dev))


def bangkv_caches_from_reference(caches, *, device: str | torch.device = "cuda") -> BangKVCache:
    """A reference `BangKVCache` stack (codes (L, B, S, Hkv, m) uint8, k, v,
    index (L,))."""
    dev = resolve_device(device)
    return BangKVCache(_tensor(np.asarray(caches.codes, np.uint8), dev), _tensor(caches.k, dev),
                       _tensor(caches.v, dev), _tensor(np.asarray(caches.index, np.int32), dev))


def ssm_caches_from_reference(caches, *, dtype=torch.bfloat16,
                              device: str | torch.device = "cuda") -> SSMCache:
    """A reference `SSMCache` stack (conv (L, B, K-1, conv_ch), state (L, B,
    H, P, N) float32) for a model of `dtype`: the conv window in
    `conv_cache_dtype(dtype)`, which holds the reference's values exactly
    (its prefill window is bf16, its decode window the promoted dtype)."""
    dev = resolve_device(device)
    return SSMCache(_tensor(caches.conv, dev).to(conv_cache_dtype(dtype)),
                    _tensor(np.asarray(caches.state, np.float32), dev))


def lm_caches_from_reference(caches, cfg: ModelConfig, *, device: str | torch.device = "cuda"):
    """Any family's reference decode caches, in the layout `LM.prefill`
    returns: a `KVCache` or `BangKVCache` stack, mamba2's `SSMCache`,
    zamba2's `(SSMCache, KVCache | BangKVCache)`, whisper's `(self caches,
    (cross_k, cross_v))`."""
    check_family(cfg)

    def attn(c):
        if hasattr(c, "codes"):
            return bangkv_caches_from_reference(c, device=device)
        return kv_caches_from_reference(c, device=device)

    dtype = getattr(torch, cfg.dtype)
    if cfg.family == "ssm":
        return ssm_caches_from_reference(caches, dtype=dtype, device=device)
    if cfg.family == "hybrid":
        return (ssm_caches_from_reference(caches[0], dtype=dtype, device=device), attn(caches[1]))
    if cfg.arch_kind == "encdec":
        dev = resolve_device(device)
        self_c, (ck, cv) = caches
        return (attn(self_c), (_tensor(ck, dev), _tensor(cv, dev)))
    return attn(caches)


def _flat_from_reference(tree: dict, cfg: ModelConfig, dev) -> dict:
    """A reference tree of the parameters' structure, as {path: tensor}."""
    return {k: v.detach() for k, v in flat_dict(lm_params_from_reference(tree, cfg,
                                                                         device=dev)).items()}


def adamw_state_from_reference(state, cfg: ModelConfig, *,
                               device: str | torch.device = "cuda") -> AdamWState:
    """A reference `AdamWState` (step, and mu, nu, master trees of the
    parameters' structure, float32) as the port's."""
    dev = resolve_device(device)
    return AdamWState(
        step=_tensor(np.asarray(state.step, np.int32), dev),
        mu=_flat_from_reference(state.mu, cfg, dev),
        nu=_flat_from_reference(state.nu, cfg, dev),
        master=_flat_from_reference(state.master, cfg, dev),
    )


def compression_state_from_reference(state, cfg: ModelConfig, *,
                                     device: str | torch.device = "cuda") -> CompressionState:
    """A reference `CompressionState` (residuals of the parameters'
    structure) as the port's."""
    return CompressionState(err=_flat_from_reference(state.err, cfg, resolve_device(device)))
