"""Trees of tensors: the port's counterpart of `jax.tree_util` for training.

The training state is a tree: the `ParamTree` of parameters, the optimizer's
`AdamWState` (a NamedTuple of a step tensor and dicts keyed by parameter
path), tuples of both. `flatten_with_path` lists its tensors with a path of
keys (dict keys, NamedTuple field names, list and tuple indices, the
parameter names of an `nn.Module`), and `unflatten` builds a tree of a
template's structure from new leaves. Leaves are tensors; any other value (None, a number) is a leaf
too and is passed through as it is.
"""
from __future__ import annotations

from typing import Any

from torch import nn


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> list[tuple[str, Any]] | None:
    """(key, child) pairs of a node, or None for a leaf."""
    if isinstance(node, nn.Module):
        # The ParamTree's own parameters, then its sub-trees, in registration order.
        return ([(k, v) for k, v in node._parameters.items() if v is not None]
                + list(node._modules.items()))
    if isinstance(node, dict):
        return list(node.items())
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten_with_path(tree) -> list[tuple[tuple[str, ...], Any]]:
    """Every leaf of `tree` with its path, depth first in the tree's order."""
    out = []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            out.append((path, node))
            return
        for k, v in kids:
            walk(v, path + (k,))

    walk(tree, ())
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def path_key(path: tuple[str, ...]) -> str:
    """A path as one string, its keys joined by '/' (the checkpoint's keys)."""
    return "/".join(path)


def flat_dict(tree) -> dict[str, Any]:
    """{path key: leaf} of `tree`: the optimizer's view of a parameter tree."""
    return {path_key(p): leaf for p, leaf in flatten_with_path(tree)}


def map_with_path(fn, tree):
    """A tree of `tree`'s structure with `fn(path, leaf)` in each leaf: an
    `nn.Module` (a `ParamTree`) comes back as nested dicts, its
    `nn.ModuleList`s as lists, so the result may hold leaves that are not
    tensors (partition specs)."""

    def walk(node, path):
        if isinstance(node, nn.ModuleList):
            return [walk(m, path + (str(i),)) for i, m in enumerate(node)]
        if isinstance(node, nn.Module) or isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in _children(node)}
        if _is_namedtuple(node):
            return type(node)(*(walk(v, path + (k,)) for k, v in _children(node)))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (k,)) for k, v in _children(node))
        return fn(path, node)

    return walk(tree, ())


def unflatten(template, new_leaves: list):
    """A tree of `template`'s structure with `new_leaves` in its leaves'
    order. An `nn.Module` (a `ParamTree`) comes back as a new `ParamTree`
    whose parameters take `template`'s `requires_grad`."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, nn.Module):
            from .models.layers import ParamTree

            return ParamTree(_module_dict(node, build), requires_grad=_requires_grad(node))
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _requires_grad(module: nn.Module) -> bool:
    return any(p.requires_grad for p in module.parameters())


def _module_dict(module: nn.Module, build) -> dict:
    """A module's parameters and sub-modules as the nested dict `ParamTree`
    takes (an `nn.ModuleList` as a list), its leaves through `build`."""
    out = {k: build(v) for k, v in module._parameters.items() if v is not None}
    for k, sub in module._modules.items():
        if isinstance(sub, nn.ModuleList):
            out[k] = [_module_dict(m, build) for m in sub]
        else:
            out[k] = _module_dict(sub, build)
    return out
