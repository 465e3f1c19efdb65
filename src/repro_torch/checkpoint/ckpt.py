"""Checkpointing with async save and restore onto any device.

The port of the reference package's `checkpoint/ckpt.py`, with its on-disk
layout: <dir>/step_<k>/ arrays.npz + manifest.json, written to a `.tmp`
directory and atomically renamed (a torn write can never look like a valid
checkpoint -- the property fault-tolerant restart depends on), bf16 stored
bit-exact as a uint16 view, the last `keep_last` steps kept. The keys are
the port's own tree paths (`tree.flatten_with_path`, joined by '/': a
`(params, opt_state)` tuple gives "0/layers/3/attn/wq" and
"1/master/layers/3/attn/wq"). Saves run on a background thread so the
train loop never blocks on serialization; the tensors are copied to host
memory before the thread starts, since the loop updates them in place.

Restore loads the arrays on the host and places each on a device: the
template leaf's, `device`, or what `placement_fn(key, array)` returns --
the counterpart of the reference's `sharding_fn`. A `placement_fn` may
instead return a part of the array (a numpy array: this rank's block, cut
by `distributed.partitioning.shard_slices`), which is restored in its
place: a checkpoint of gathered tensors restores onto any mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable

import numpy as np
import torch

from ..tree import flatten_with_path, path_key, unflatten


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host numpy array of its own (bf16 as a uint16 view) and
    its dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _flatten(tree) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    flat, dtypes = {}, {}
    for path, leaf in flatten_with_path(tree):
        key = path_key(path)
        flat[key], dtypes[key] = _host_array(leaf)
    return flat, dtypes


def _write(directory: str, step: int, flat: dict, dtypes: dict, extra: dict | None,
           keep_last: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "n_arrays": len(flat),
        "bytes": int(sum(a.nbytes for a in flat.values())),
        "dtypes": dtypes,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep_last)
    return final


def save_checkpoint(directory: str, step: int, tree: Any, *, extra: dict | None = None,
                    keep_last: int = 3) -> str:
    """Blocking save: atomic write of the tree + manifest."""
    flat, dtypes = _flatten(tree)
    return _write(directory, step, flat, dtypes, extra, keep_last)


def _gc(directory: str, keep_last: int):
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, d))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(directory, d, "manifest.json"))
    ]
    return max(steps) if steps else None


def load_checkpoint(directory: str, template: Any, *, step: int | None = None,
                    device: str | torch.device | None = None,
                    placement_fn: Callable[[str, np.ndarray], Any] | None = None) -> tuple[Any, int]:
    """Restore a tree of `template`'s structure (a `ParamTree` comes back as
    a new `ParamTree`), each leaf cast to the template leaf's dtype.

    Each array goes to `placement_fn(key, host_array)` when that returns a
    device, else to `device`, else to the template leaf's device. Where
    `placement_fn` returns a numpy array (a block of the host array: bf16
    arrays come as their uint16 view, which cuts alike), that block is the
    leaf, on `device` or the template leaf's device."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    data = np.load(os.path.join(path, "arrays.npz"))
    with open(os.path.join(path, "manifest.json")) as f:
        dtypes = json.load(f).get("dtypes", {})
    leaves = []
    for p, leaf in flatten_with_path(template):
        key = path_key(p)
        arr = data[key]
        dev = placement_fn(key, arr) if placement_fn is not None else None
        if isinstance(dev, (np.ndarray, np.generic)):   # a block (a 0-d one comes as a scalar)
            arr, dev = np.array(dev), None
        if dtypes.get(key) == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if dev is None:
            dev = device if device is not None else getattr(leaf, "device", "cpu")
        dtype = leaf.dtype if isinstance(leaf, torch.Tensor) else t.dtype
        leaves.append(t.to(device=dev, dtype=dtype))
    return unflatten(template, leaves), step


class CheckpointManager:
    """Async checkpoint writer with at-most-one in-flight save."""

    def __init__(self, directory: str, *, every: int = 50, keep_last: int = 3):
        self.directory = directory
        self.every = every
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None

    def maybe_save(self, step: int, tree: Any, *, extra: dict | None = None,
                   force: bool = False) -> bool:
        if not force and (step == 0 or step % self.every):
            return False
        self.wait()
        # Snapshot to host *before* handing to the thread: the train loop
        # updates the device tensors in place on the next step.
        flat, dtypes = _flatten(tree)

        def work():
            _write(self.directory, step, flat, dtypes, extra, self.keep_last)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
