"""BANG approximate nearest-neighbour search on PyTorch and CUDA (H100).

The port of the JAX package `repro`, slice by slice. It imports neither JAX
nor `repro`. Entry points run on the CUDA device unless the caller passes
`device="cpu"`, where every kernel runs its plain PyTorch version.
"""
from .core import (  # noqa: F401
    KERNEL_MODES,
    BangIndex,
    SearchConfig,
    SearchStats,
    brute_force_knn,
    recall_at_k,
)
