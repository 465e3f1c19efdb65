"""ADC of R candidates per query: the CUDA kernel on the card, its plain
version on the CPU."""
from __future__ import annotations

import torch

from repro_torch.kernels import common

from .ref import adc_ref

VARIANTS = ("onehot", "gather")
THREADS = 128


def adc(
    table: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor, *, variant: str = "onehot"
) -> torch.Tensor:
    """PQ asymmetric distances. table (B, m, 256) f32, codes (B, R, m) integer
    in [0, 256), valid (B, R) bool -> (B, R) f32, +inf where invalid.

    Both reference variant names are accepted: on the GPU the one-hot
    product and the gather are the same shared-memory lookup.
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}, expected one of {VARIANTS}")
    if not common.on_cuda(table, codes, valid):
        return adc_ref(table, codes, valid)
    B, m, _ = table.shape
    R = codes.shape[1]
    codes = codes.to(torch.int32).contiguous()
    common.check(table, "table", torch.float32, (B, m, 256))
    common.check(codes, "codes", torch.int32, (B, R, m))
    common.check(valid, "valid", torch.bool, (B, R))
    out = torch.empty((B, R), dtype=torch.float32, device=table.device)
    if B and R:
        fn = common.kernel_fn("repro_pq_adc", [common.PTR] * 4 + [common.INT] * 4 + [common.PTR])
        with torch.cuda.device(table.device):
            rc = fn(table.data_ptr(), codes.data_ptr(), valid.data_ptr(), out.data_ptr(),
                    B, R, m, THREADS, common.stream_of(table))
        common.check_launch(rc, f"pq_adc (m={m})")
        adc.launches += 1
    return out


adc.launches = 0

__all__ = ["adc", "adc_ref"]
