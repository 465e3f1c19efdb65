"""Sharding rules: parameter, batch and cache partition specs over a mesh.

The port of the reference package's `distributed/partitioning.py`.

Strategy (the reference's DESIGN.md section 6):
  * 2D parameter sharding -- FSDP over `data` x Megatron TP over `model`;
    `pod` is pure data parallelism (parameters replicated across pods).
  * MoE experts shard over `model` (expert parallelism).
  * Decode KV caches shard the sequence over `model` and the batch over
    (`pod`, `data`).
  * A dim that does not divide its axis size stays whole on that axis
    (granite's vocabulary of 49,155 is odd).

Rules key off the leaf name (and the "moe"/"shared" path hints), with role
strings: "D" -> the data axis, "M" -> the model axis, "E" -> the model axis
(experts), None -> replicated; a rule covers a leaf's innermost dims.

A spec is a `P`: a tuple of entries, each None, an axis name or a tuple of
names, equal to `tuple(reference_spec)`. The rules read only axis sizes,
so they take the runnable `Mesh` or a shape-only `AbstractMesh`. The port
keeps one tensor a layer where the reference stacks a leaf (L, ...), so a
per-layer tensor's spec is the reference's with its leading stacked None
dropped (the rule's arity against the tensor's ndim does that by itself).
The optimizer state's dicts are keyed by path ("layers/3/attn/wq"): a key
is split at '/' and its last part is the leaf's name.

`shard_tensor` cuts this rank's block of a full tensor and `gather_tensor`
rebuilds the full tensor from every rank's block (a collective: every rank
of the mesh calls it). Both take the spec as the rules give it, fitted to
the full tensor's shape. `shard_caches` and `gather_caches` do so for the
decode caches (`KVCache`, `BangKVCache`, `SSMCache`) by `cache_pspecs`.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from ..tree import flat_dict, flatten_with_path, map_with_path, path_key, unflatten

# leaf name -> dim roles (innermost `len(rule)` dims)
_RULES: dict[str, tuple] = {
    "embed": ("M", "D"),          # (V, D): vocab over model, d_model over data
    "lm_head": ("D", "M"),        # (D, V)
    "wq": ("D", "M"),
    "wk": ("D", "M"),
    "wv": ("D", "M"),
    "wo": ("M", "D"),
    "w_gate": ("D", "M"),
    "w_up": ("D", "M"),
    "w_down": ("M", "D"),
    "router": ("D", None),
    "in_proj": ("D", "M"),
    "out_proj": ("M", "D"),
    "conv_w": (None, "M"),
    "conv_b": ("M",),
    "A_log": ("M",),
    "D": ("M",),
    "dt_bias": ("M",),
    "norm_w": ("M",),
    "w": (None,),
    "b": (None,),
    "bangkv_codebooks": (None, None, None, None),
}

_MOE_RULES: dict[str, tuple] = {
    "w_gate": ("E", "D", None),   # (E, D, F)
    "w_up": ("E", "D", None),
    "w_down": ("E", None, "D"),   # (E, F, D)
}

DP_AXES = ("pod", "data")   # batch axes, in mesh order
TP_AXIS = "model"


class P:
    """A partition spec: one entry a dim (None, an axis name, or a tuple of
    axis names), trailing dims replicated. Equal to a tuple of the same
    entries, so `P(None, "data") == tuple(jax_spec)`. A leaf of a tree
    (`tree.flatten_with_path` does not descend into it)."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, (P, tuple)):
            return self.entries == tuple(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


def _axis_size(mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


def _role_axis(role, data_axis: str, model_axis: str):
    if role is None:
        return None
    return {"D": data_axis, "M": model_axis, "E": model_axis}[role]


def _names(path: tuple) -> list[str]:
    """A tree path's names, keys of the form "layers/3/attn/wq" split at '/'."""
    return [n for key in path for n in str(key).split("/")]


def spec_for(names: list[str], shape: tuple, mesh, *, data_axis: str = "data",
             model_axis: str = "model") -> P:
    """The spec of a leaf named by `names` (its path) of `shape`."""
    name = names[-1]
    in_moe = "moe" in names and "shared" not in names
    rule = _MOE_RULES.get(name) if in_moe else None
    if rule is None:
        rule = _RULES.get(name)
    if rule is None:
        return P()
    pad = len(shape) - len(rule)
    if pad < 0:   # rule longer than the leaf (a scalar) -> replicate
        return P()
    axes = []
    for i, role in enumerate(rule):
        ax = _role_axis(role, data_axis, model_axis)
        if ax is not None and shape[pad + i] % _axis_size(mesh, ax) != 0:
            ax = None   # uneven -> whole on this axis
        axes.append(ax)
    return P(*([None] * pad + axes))


def param_pspecs(params: Any, mesh, *, data_axis: str = "data", model_axis: str = "model") -> Any:
    """The spec tree of a parameter tree (a `ParamTree` gives nested dicts
    and lists) or of an optimizer state (its dicts keyed by path)."""
    return map_with_path(
        lambda path, leaf: spec_for(_names(path), tuple(leaf.shape), mesh, data_axis=data_axis,
                                    model_axis=model_axis) if hasattr(leaf, "shape") else P(),
        params)


def batch_pspec(mesh) -> P:
    """(B, ...) batch arrays: batch over every data-parallel axis present."""
    dp = tuple(a for a in DP_AXES if a in mesh.shape)
    return P(dp if len(dp) > 1 else (dp[0] if dp else None))


def cache_pspecs(cache: Any, mesh, *, batch_divisible: bool, model_axis: str = "model") -> Any:
    """Decode-cache specs: batch over the data-parallel axes (if divisible),
    sequence over model. KV and BANG-KV caches (k, v, codes (L, B, S, H,
    ...)), SSM caches (conv (L, B, K-1, ch), state (L, B, H, P, N)), and
    whisper's unnamed cross K and V (L, B, M, Hkv, hd)."""
    dp = tuple(a for a in DP_AXES if a in mesh.shape)
    dp_spec = dp if len(dp) > 1 else (dp[0] if dp else None)
    bspec = dp_spec if batch_divisible else None
    msize = _axis_size(mesh, model_axis)

    def spec(path, leaf):
        name = _names(path)[-1] if path else ""
        shape = tuple(getattr(leaf, "shape", ()))
        if name in ("k", "v", "codes"):            # (L, B, S, H, hd|m)
            return P(None, bspec, model_axis if shape[2] % msize == 0 else None, None, None)
        if name == "index":
            return P()
        if name == "conv":                          # (L, B, K-1, ch)
            return P(None, bspec, None, model_axis if shape[3] % msize == 0 else None)
        if name == "state":                         # (L, B, H, P, N)
            return P(None, bspec, model_axis if shape[2] % msize == 0 else None, None, None)
        if len(shape) == 5:                         # unnamed (L, B, M, Hkv, hd): cross K/V
            return P(None, bspec, None, None, None)
        return P()

    return map_with_path(spec, cache)


# ---------------------------------------------------------------------------
# This rank's blocks
# ---------------------------------------------------------------------------

def dim_axes(spec: P, ndim: int, mesh) -> list[tuple[str, ...]]:
    """Each dim's axes under `spec`, those absent from `mesh` dropped."""
    out = []
    for i in range(ndim):
        entry = spec[i] if i < len(spec) else None
        names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        out.append(tuple(n for n in names if n in mesh.shape))
    return out


def fit_spec(spec: P, shape: tuple, mesh) -> P:
    """`spec` with the axes absent from `mesh` dropped and every dim that
    does not divide its axes' size left whole, as the reference's
    `constrain` fits a spec."""
    entries = []
    for dim, names in zip(shape, dim_axes(spec, len(shape), mesh)):
        total = 1
        for n in names:
            total *= mesh.shape[n]
        if not names or dim % total:
            entries.append(None)
        else:
            entries.append(names if len(names) > 1 else names[0])
    return P(*entries)


def shard_slices(shape: tuple, spec: P, mesh) -> tuple[slice, ...]:
    """This rank's block of a tensor of `shape` under `spec` (fitted to the
    shape first): a slice a dim. A dim over several axes is cut in their
    order, the last axis fastest."""
    spec = fit_spec(spec, shape, mesh)
    out = []
    for dim, names in zip(shape, dim_axes(spec, len(shape), mesh)):
        idx, total = 0, 1
        for n in names:
            idx = idx * mesh.shape[n] + mesh.index(n)
            total *= mesh.shape[n]
        size = dim // total
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def shard_tensor(full: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of `full` under `spec`, in memory of its own."""
    return full[shard_slices(tuple(full.shape), spec, mesh)].clone()


def gather_tensor(shard: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The full tensor from every rank's block under `spec` (the spec the
    blocks were cut with, fitted to the full shape: `param_pspecs` gives
    it). Every rank of the mesh calls it; each gets the full tensor, in
    memory of its own."""
    x = shard.detach()
    axes = dim_axes(spec, shard.dim(), mesh)
    if not any(axes):
        return x.clone()
    for d, names in enumerate(axes):
        for n in reversed(names):   # the fastest axis first
            group = mesh.group(n)
            parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, x.contiguous(), group=group)
            x = torch.cat(parts, dim=d)
    return x


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """`tree` (a `ParamTree`, an `AdamWState`, a dict of batch arrays) with
    each tensor cut to this rank's block under its spec in `specs` (a tree
    of `tree`'s structure, as `param_pspecs` gives)."""
    sp = flat_dict(specs)
    leaves = []
    for path, leaf in flatten_with_path(tree):
        leaves.append(shard_tensor(leaf.detach(), sp[path_key(path)], mesh)
                      if isinstance(leaf, torch.Tensor) else leaf)
    return unflatten(tree, leaves)


def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """The full tensors of a tree of this rank's blocks (`shard_tree`'s
    inverse; a collective)."""
    sp = flat_dict(specs)
    leaves = []
    for path, leaf in flatten_with_path(tree):
        leaves.append(gather_tensor(leaf, sp[path_key(path)], mesh) if isinstance(leaf, torch.Tensor) else leaf)
    return unflatten(tree, leaves)


def shard_caches(caches: Any, mesh, *, batch_divisible: bool) -> Any:
    """This rank's blocks of full decode caches by `cache_pspecs`: K, V and
    codes cut over the sequence on `model` where it divides, an SSM cache's
    conv window over its channels and its state over its heads, each over
    the batch on the data axes where `batch_divisible` (and it divides);
    `index` whole."""
    return shard_tree(caches, cache_pspecs(caches, mesh, batch_divisible=batch_divisible), mesh)


def gather_caches(blocks: Any, mesh, *, s_max: int, batch_divisible: bool, cfg=None) -> Any:
    """The full caches of `s_max` positions from every rank's blocks
    (`shard_caches`' inverse; a collective; whisper's cross K and V keep
    their frames). The specs are those of the full
    shapes: a block's length does not say whether the sequence was cut, nor
    an SSM cache's block whether its channels (`conv`) or heads (`state`)
    were: those take the config `cfg`."""
    dp = 1
    for a in DP_AXES:
        dp *= _axis_size(mesh, a)

    def full(path, t):
        name = _names(path)[-1] if path else ""
        shape = list(t.shape)
        if name in ("conv", "state"):               # (L, B, K-1, ch), (L, B, H, P, N)
            if cfg is None:
                raise ValueError("gathering an SSM cache needs the config's widths (cfg=)")
            di = cfg.ssm_expand * cfg.d_model
            if name == "conv":
                shape[3] = di + 2 * cfg.ssm_groups * cfg.ssm_state
            else:
                shape[2] = di // cfg.ssm_head_dim
        elif name in ("k", "v", "codes"):
            shape[2] = s_max
        elif t.dim() != 5:                          # unnamed (L, B, M, Hkv, hd): cross K/V
            return t
        shape[1] *= dp if batch_divisible else 1
        return torch.empty(shape, dtype=t.dtype, device="meta")

    specs = cache_pspecs(map_with_path(full, blocks), mesh, batch_divisible=batch_divisible)
    return gather_tree(blocks, specs, mesh)
