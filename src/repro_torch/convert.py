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
"""
from __future__ import annotations

import numpy as np
import torch

from .core.bang import BangIndex

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
