"""Plain PyTorch versions of the bitonic sort and merge kernels
(csrc/bitonic.cu).

Both run the compare-exchange network of the reference's Pallas kernels
(`src/repro/kernels/bitonic/bitonic.py`, `_compare_exchange` and
`bitonic_stages`) stage by stage: the partner of index a is a ^ j, the pair
sorts ascending iff bit k of a is 0, and equal (dist, id) keys swap in
descending pairs. Real keys are unique, so on them the result is the
lexicographic (dist, id) order of a stable sort. The network matters on the
(+inf, INVALID) pads of the merge, whose visited flags differ (1 from the
worklist, 0 from the candidates): which of them lands in the kept t slots
depends on the network's order, and this version reproduces it to the bit.
Unlike the fused hop, the staged merge does not force INVALID slots visited.
"""
from __future__ import annotations

import torch

from repro_torch.core.worklist import INVALID_ID
from repro_torch.kernels.common import next_pow2


def _compare_exchange(d, i, v, j: int, k: int):
    """One stage over (B, n): elements a (leading half of each 2j block) and
    a + j; ascending iff bit k of a is 0, constant within a 2j block."""
    B, n = d.shape
    g = n // (2 * j)
    d3, i3, v3 = (x.reshape(B, g, 2, j) for x in (d, i, v))
    a_d, b_d = d3[:, :, 0], d3[:, :, 1]
    a_i, b_i = i3[:, :, 0], i3[:, :, 1]
    asc = ((torch.arange(g, device=d.device) * (2 * j)) & k) == 0      # (g,)
    a_gt_b = (a_d > b_d) | ((a_d == b_d) & (a_i > b_i))
    swap = torch.where(asc[None, :, None], a_gt_b, ~a_gt_b)
    out = []
    for x3 in (d3, i3, v3):
        a, b = x3[:, :, 0], x3[:, :, 1]
        out.append(torch.stack([torch.where(swap, b, a), torch.where(swap, a, b)], 2).reshape(B, n))
    return out


def bitonic_stages(d, i, v, n: int, full_sort: bool):
    """The whole network (every k = 2..n) or, for a bitonic input, its final
    merge phase only (k = n). n is a power of two."""
    k = 2 if full_sort else n
    while k <= n:
        j = k // 2
        while j >= 1:
            d, i, v = _compare_exchange(d, i, v, j, k)
            j //= 2
        k *= 2
    return d, i, v


def sort_kv_ref(dists: torch.Tensor, ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n) ascending by (dist, id); n is padded to a power of two with
    (+inf, INVALID) and cut back."""
    B, n0 = dists.shape
    n = next_pow2(n0)
    d = torch.full((B, n), float("inf"), dtype=torch.float32, device=dists.device)
    i = torch.full((B, n), INVALID_ID, dtype=torch.int32, device=dists.device)
    d[:, :n0], i[:, :n0] = dists, ids
    d, i, _ = bitonic_stages(d, i, torch.zeros_like(i), n, full_sort=True)
    return d[:, :n0], i[:, :n0]


def merge_ref(
    d1: torch.Tensor, i1: torch.Tensor, v1: torch.Tensor,
    d2: torch.Tensor, i2: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge sorted (d1, i1, v1) (B, t) with sorted (d2, i2) (B, R), which
    enter unvisited; keep the best t.

    As `merge_pallas`: list 2 is padded with (+inf, INVALID, unvisited) up to
    a power-of-two total *before* it is reversed, list 1 ++ reversed list 2
    is bitonic, and only the final merge phase runs.
    """
    B, t = d1.shape
    R = d2.shape[1]
    p = next_pow2(t + R)
    d = torch.full((B, p), float("inf"), dtype=torch.float32, device=d1.device)
    i = torch.full((B, p), INVALID_ID, dtype=torch.int32, device=d1.device)
    v = torch.zeros((B, p), dtype=torch.int32, device=d1.device)
    d[:, :t], i[:, :t], v[:, :t] = d1, i1, v1.to(torch.int32)
    # Positions t .. p-1 hold list 2 padded to p - t, reversed: list 2's
    # entry s lands at p - 1 - s.
    d[:, p - R :] = d2.flip(-1)
    i[:, p - R :] = i2.flip(-1)
    d, i, v = bitonic_stages(d, i, v, p, full_sort=False)
    return d[:, :t], i[:, :t], v[:, :t].bool()
