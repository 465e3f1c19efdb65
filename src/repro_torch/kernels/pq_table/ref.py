"""Plain PyTorch version of the PQ distance-table kernel (csrc/pq_table.cu).

table[b, j, c] = (qn + cn) - 2 * qc with, over i = 0..dsub-1,
qn = sum q_i * q_i, cn = sum c_i * c_i and qc = sum q_i * c_i, each a
sequential float32 sum of rounded products: the kernel's order, so the two
are bit-equal. The formula cancels where q lies near a centroid; against
the reference's direct sum of squared differences it agrees within the
reference's own bound for its kernel (rtol 2e-4, atol 2e-4).
"""
from __future__ import annotations

import torch


def dist_table_ref(q_sub: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """q_sub (B, m, dsub), codebooks (m, 256, dsub) -> table (B, m, 256) f32."""
    q = q_sub.to(torch.float32)
    c = codebooks.to(torch.float32)
    B, m, dsub = q.shape
    qn = torch.zeros((B, m), dtype=torch.float32, device=q.device)
    cn = torch.zeros(c.shape[:2], dtype=torch.float32, device=q.device)
    qc = torch.zeros((B, m, c.shape[1]), dtype=torch.float32, device=q.device)
    for i in range(dsub):
        a, x = q[..., i], c[..., i]
        qn = qn + a * a
        cn = cn + x * x
        qc = qc + a[:, :, None] * x[None, :, :]
    return (qn[:, :, None] + cn[None, :, :]) - 2.0 * qc
