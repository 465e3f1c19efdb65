"""ADC of R candidates per query: the CUDA kernel on the card, its plain
version on the CPU."""
from __future__ import annotations

import torch

from repro_torch.kernels import common

from .ref import adc_ref

VARIANTS = ("onehot", "gather")
# From this many candidates per query on, the kernel copies each query's
# table into shared memory; below it, it looks the entries up in global
# memory. Measured on the H100 (chip_smoke.py phase 3 sweeps both regimes).
SHARED_TABLE_MIN_R = 40
THREADS_GLOBAL = 128    # one warp per candidate
THREADS_SHARED = 256    # one block per query, one thread per candidate


def adc(
    table: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor, *, variant: str = "onehot"
) -> torch.Tensor:
    """PQ asymmetric distances. table (B, m, 256) f32, codes (B, R, m) integer
    in [0, 256), valid (B, R) bool -> (B, R) f32, +inf where invalid.

    Both reference variant names are accepted: on the GPU the one-hot
    product and the gather are the same lookup.
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}, expected one of {VARIANTS}")
    return _adc_regime(table, codes, valid, shared_table=codes.shape[1] >= SHARED_TABLE_MIN_R)


def _adc_regime(
    table: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor, *, shared_table: bool
) -> torch.Tensor:
    """`adc` with the kernel's regime given (the tests and chip_smoke.py
    time and check both): the table in shared memory or looked up in global
    memory. The kernel reads uint8 codes (the index's type); codes of another
    integer type are converted, which leaves codes in [0, 256) as they are.
    CPU tensors take the plain version."""
    if not common.on_cuda(table, codes, valid):
        return adc_ref(table, codes, valid)
    B, m, _ = table.shape
    R = codes.shape[1]
    codes = codes.to(torch.uint8).contiguous()
    common.check(table, "table", torch.float32, (B, m, 256))
    common.check(codes, "codes", torch.uint8, (B, R, m))
    common.check(valid, "valid", torch.bool, (B, R))
    out = torch.empty((B, R), dtype=torch.float32, device=table.device)
    if B and R:
        fn = common.kernel_fn("repro_pq_adc", [common.PTR] * 4 + [common.INT] * 5 + [common.PTR])
        with torch.cuda.device(table.device):
            rc = fn(table.data_ptr(), codes.data_ptr(), valid.data_ptr(), out.data_ptr(),
                    B, R, m, int(shared_table),
                    THREADS_SHARED if shared_table else THREADS_GLOBAL, common.stream_of(table))
        common.check_launch(rc, f"pq_adc (m={m}, {'shared' if shared_table else 'global'} table)")
        adc.launches += 1
    return out


adc.launches = 0

__all__ = ["adc", "adc_ref"]
