"""Vamana graph container (DiskANN [26]; paper §2.2).

BANG searches a pre-built Vamana graph. This slice of the port carries the
graph as the search reads it: a fixed-degree (n, R) int32 adjacency, -1
padded, and the medoid entry point. Building the graph comes with a later
slice; an index built by the reference package converts with
`repro_torch.convert.index_from_reference`.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class VamanaGraph:
    """Fixed-degree adjacency: (n, R) int32, -1 padded, in host memory
    (pinned for an index on a CUDA device). medoid = search entry."""

    adjacency: torch.Tensor
    medoid: int
