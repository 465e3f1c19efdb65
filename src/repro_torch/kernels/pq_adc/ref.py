"""Plain PyTorch version of the ADC kernel (csrc/pq_adc.cu)."""
from __future__ import annotations

import torch

from repro_torch.core.pq import adc_distance


def adc_ref(table: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """table (B, m, 256) f32, codes (B, R, m) int, valid (B, R) bool -> (B, R).

    dist[b, r] = sum_j table[b, j, codes[b, r, j]], in MC-subspace chunks;
    +inf where invalid.
    """
    d = adc_distance(table.to(torch.float32), codes)
    return torch.where(valid, d, torch.full_like(d, float("inf")))
