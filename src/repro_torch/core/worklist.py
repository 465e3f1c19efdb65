"""Sorted fixed-size worklist 𝓛 and its update ops (paper §4.7, §4.8).

The worklist holds the t best candidates seen so far, sorted ascending by
(distance, id). Entries carry a `visited` flag; padding slots are
(+inf, INVALID_ID, visited=True), so they never win selection and never block
convergence. Plain PyTorch; the fused search kernel
(`repro_torch.kernels.search_step`) does the same work in one launch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

INVALID_ID = 2**31 - 1  # sorts last on the id tie-break, never a real node


class Worklist(NamedTuple):
    dists: torch.Tensor    # (B, t) float32, ascending
    ids: torch.Tensor      # (B, t) int32
    visited: torch.Tensor  # (B, t) bool

    @property
    def t(self) -> int:
        return self.dists.shape[-1]


def worklist_init(batch: int, t: int, device: torch.device | str) -> Worklist:
    return Worklist(
        dists=torch.full((batch, t), float("inf"), dtype=torch.float32, device=device),
        ids=torch.full((batch, t), INVALID_ID, dtype=torch.int32, device=device),
        visited=torch.ones((batch, t), dtype=torch.bool, device=device),
    )


def lex_order(dists: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Permutation sorting each row ascending by (dist, id).

    torch has no multi-key sort: a stable sort by id, then a stable sort by
    dist, gives the lexicographic order of `lax.sort(num_keys=2)`.
    """
    by_id = torch.sort(ids, dim=-1, stable=True).indices
    d = torch.gather(dists, -1, by_id)
    by_d = torch.sort(d, dim=-1, stable=True).indices
    return torch.gather(by_id, -1, by_d)


def sort_candidates(dists: torch.Tensor, ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort (B, R) candidate lists ascending by (dist, id)."""
    order = lex_order(dists, ids)
    return torch.gather(dists, -1, order), torch.gather(ids, -1, order)


def merge_worklist(wl: Worklist, cand_dists: torch.Tensor, cand_ids: torch.Tensor) -> Worklist:
    """Merge sorted candidates into the sorted worklist, keep the t nearest.

    cand_* are (B, R), padded with (+inf, INVALID_ID). New entries enter
    unvisited; worklist entries keep their flags. A pure sorted merge with no
    dedup, as in the reference.
    """
    t = wl.t
    d = torch.cat([wl.dists, cand_dists], dim=-1)
    i = torch.cat([wl.ids, cand_ids], dim=-1)
    v = torch.cat([wl.visited, torch.zeros_like(cand_ids, dtype=torch.bool)], dim=-1)
    order = lex_order(d, i)[:, :t]
    return Worklist(
        torch.gather(d, -1, order), torch.gather(i, -1, order), torch.gather(v, -1, order)
    )


def merge_path_reference(
    d1: torch.Tensor, i1: torch.Tensor, d2: torch.Tensor, i2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge-path merge of two lists sorted by (dist, id) (paper §4.8, Green
    et al. [21]): the host oracle of the bitonic merge.

    Each element's output slot is its own position plus its rank in the
    other list: list-1 elements count the list-2 keys strictly below them,
    list-2 elements the list-1 keys at or below them, so the slots are a
    permutation. Batched over the leading axis: (B, n1) and (B, n2) in,
    merged (B, n1 + n2) dists and ids out.
    """

    def rank(dq, iq, dref, iref, strict: bool) -> torch.Tensor:
        # Elements of ref that precede each (dq, iq): (B, nq).
        dr, ir = dref[:, None, :], iref[:, None, :]
        dq, iq = dq[:, :, None], iq[:, :, None]
        lt = (dr < dq) | ((dr == dq) & (ir < iq))
        if not strict:
            lt = lt | ((dr == dq) & (ir == iq))
        return lt.sum(-1)

    B, n1 = d1.shape
    n2 = d2.shape[1]
    pos1 = torch.arange(n1, device=d1.device) + rank(d1, i1, d2, i2, strict=True)
    pos2 = torch.arange(n2, device=d1.device) + rank(d2, i2, d1, i1, strict=False)
    out_d = torch.zeros((B, n1 + n2), dtype=d1.dtype, device=d1.device)
    out_i = torch.zeros((B, n1 + n2), dtype=i1.dtype, device=d1.device)
    out_d.scatter_(1, pos1, d1).scatter_(1, pos2, d2)
    out_i.scatter_(1, pos1, i1).scatter_(1, pos2, i2)
    return out_d, out_i


def first_unvisited(wl: Worklist) -> tuple[torch.Tensor, torch.Tensor]:
    """First unvisited entry per query (Algorithm 2 line 15).

    Returns (ids (B,), found (B,)); INVALID_ID where nothing is unvisited.
    """
    unvis = ~wl.visited
    found = unvis.any(dim=-1)
    pos = torch.argmax(unvis.to(torch.uint8), dim=-1)   # first maximum
    ids = torch.gather(wl.ids, -1, pos[:, None])[:, 0]
    return torch.where(found, ids, torch.full_like(ids, INVALID_ID)), found


def mark_visited(wl: Worklist, ids: torch.Tensor) -> Worklist:
    """Set the visited flag of the slot holding each id (B,)."""
    return wl._replace(visited=wl.visited | (wl.ids == ids[:, None]))
