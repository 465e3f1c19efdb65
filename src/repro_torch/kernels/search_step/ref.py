"""Plain PyTorch versions of the fused search-step kernel (csrc/search_step.cu)
and of the owner-shard ADC kernel (csrc/local_adc.cu).

Same contract as `ops.fused_step`: one whole Algorithm-2 iteration body
(ADC -> sort -> select -> merge -> mark-visited) with the gather, the
chunked ADC sum and stable sorts. Real candidate keys (dist, id) are unique,
so the kernel's bitonic network must match this version exactly on ids and
visited flags, and on distances too, since both sum in the same order.

Padding semantics: masked candidate lanes carry (+inf, INVALID, unvisited);
after the merge every INVALID slot in the kept prefix is forced visited --
INVALID is never expandable, and this closes the gap between the stable sort
here (which keeps the worklist's visited pads) and the bitonic network (which
may shuffle tied pads).
"""
from __future__ import annotations

import torch

from repro_torch.core.pq import adc_sum
from repro_torch.core.worklist import INVALID_ID, lex_order


def _first_unvisited(ids: torch.Tensor, visited: torch.Tensor):
    unvis = ~visited
    found = unvis.any(dim=-1)
    pos = torch.argmax(unvis.to(torch.uint8), dim=-1)
    u = torch.gather(ids, -1, pos[:, None])[:, 0]
    return torch.where(found, u, torch.full_like(u, INVALID_ID)), found


def traverse_ref(
    cand_dists: torch.Tensor,   # (B, R) f32, +inf on masked lanes
    cand_ids: torch.Tensor,     # (B, R) i32, INVALID on masked lanes
    wld: torch.Tensor,          # (B, t) f32
    wli: torch.Tensor,          # (B, t) i32
    wlv: torch.Tensor,          # (B, t) bool
    active: torch.Tensor,       # (B,) bool
    *,
    eager: bool = True,
):
    """Sort + select + merge + mark-visited; returns (d, i, v, u_next, active)."""
    t = wld.shape[1]
    order = lex_order(cand_dists, cand_ids)
    sd = torch.gather(cand_dists, -1, order)
    si = torch.gather(cand_ids, -1, order)

    def merge():
        d = torch.cat([wld, sd], dim=-1)
        i = torch.cat([wli, si], dim=-1)
        v = torch.cat([wlv, torch.zeros_like(si, dtype=torch.bool)], dim=-1)
        o = lex_order(d, i)[:, :t]
        md, mi, mv = torch.gather(d, -1, o), torch.gather(i, -1, o), torch.gather(v, -1, o)
        return md, mi, mv | (mi == INVALID_ID)

    inf = torch.full_like(wld, float("inf"))
    if eager:
        wl_u, wl_found = _first_unvisited(wli, wlv)
        wl_d = torch.where(wlv, inf, wld).min(dim=-1).values
        wl_d = torch.where(wl_found, wl_d, inf[:, 0])
        cand_d, cand_i = sd[:, 0], si[:, 0]
        u_next = torch.where(cand_d < wl_d, cand_i, wl_u)
        found = wl_found | (cand_i != INVALID_ID)
        d, i, v = merge()
    else:
        d, i, v = merge()
        u_next, found = _first_unvisited(i, v)

    active = active & found
    u_next = torch.where(active, u_next, torch.full_like(u_next, INVALID_ID))
    v = v | (i == u_next[:, None])
    return d, i, v, u_next, active


def step_ref(
    table: torch.Tensor,    # (B, m, 256) f32
    codes: torch.Tensor,    # (n, m) uint8
    nbrs: torch.Tensor,     # (B, R) i32
    fresh: torch.Tensor,    # (B, R) bool
    wld: torch.Tensor,
    wli: torch.Tensor,
    wlv: torch.Tensor,
    active: torch.Tensor,
    *,
    eager: bool = True,
):
    """Full-step plain version: gather + chunked ADC, then traverse_ref."""
    safe = torch.where(fresh, nbrs, torch.zeros_like(nbrs)).long()
    gathered = codes[safe].long()                                # (B, R, m)
    vals = torch.gather(
        table[:, None, :, :].expand(-1, gathered.shape[1], -1, -1), 3, gathered[..., None]
    )[..., 0]
    adc = adc_sum(vals)
    cd = torch.where(fresh, adc, torch.full_like(adc, float("inf")))
    ci = torch.where(fresh, nbrs, torch.full_like(nbrs, INVALID_ID))
    return traverse_ref(cd, ci, wld, wli, wlv, active, eager=eager)


def local_adc_ref(
    table: torch.Tensor,        # (B, m, 256) f32
    codes_local: torch.Tensor,  # (n_loc, m) uint8, one shard's rows
    rel: torch.Tensor,          # (B, R) i32 shard-relative ids in [0, n_loc)
    own: torch.Tensor,          # (B, R) bool: the lane's id lies in this shard
) -> torch.Tensor:
    """Owner-shard gather + ADC: (B, R) f32, the chunked ADC sum of each
    owned lane's code row and 0.0 elsewhere, so that a sum over the shards
    rebuilds the full row (x + 0.0 = x)."""
    safe = torch.where(own, rel, torch.zeros_like(rel)).long()
    gathered = codes_local[safe].long()                          # (B, R, m)
    vals = torch.gather(
        table[:, None, :, :].expand(-1, gathered.shape[1], -1, -1), 3, gathered[..., None]
    )[..., 0]
    adc = adc_sum(vals)
    return torch.where(own, adc, torch.zeros_like(adc))
