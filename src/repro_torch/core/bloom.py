"""Bloom filter for visited-vertex tracking (paper §4.4).

One filter per query, "an array of z bools", probed by two FNV-1a hashes of
the node id. False positives are tolerable (a node is skipped that needn't
be); false negatives never happen.

FNV-1a runs over the 4 little-endian bytes of the id in uint32 arithmetic.
torch's uint32 coverage is thin, so the arithmetic is int64 masked to 32 bits
after every product, which gives the same bits as the reference's uint32 ops.
"""
from __future__ import annotations

import torch

FNV_OFFSET_BASIS = 2166136261
FNV_PRIME = 16777619
# Second hash: FNV-1a with a different offset basis.
FNV_OFFSET_BASIS_2 = 0x9747B28C
MASK32 = 0xFFFFFFFF


def _fnv1a_u32(x: torch.Tensor, basis: int) -> torch.Tensor:
    """FNV-1a over the 4 LE bytes of each int32 element; int64 in [0, 2**32)."""
    x = x.to(torch.int64) & MASK32          # the uint32 bit pattern
    h = torch.full_like(x, basis)
    for shift in (0, 8, 16, 24):
        byte = (x >> shift) & 0xFF
        h = ((h ^ byte) * FNV_PRIME) & MASK32
    return h


def bloom_hashes(ids: torch.Tensor, z: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Two probe positions in [0, z) for each id (int64, ready to index)."""
    return _fnv1a_u32(ids, FNV_OFFSET_BASIS) % z, _fnv1a_u32(ids, FNV_OFFSET_BASIS_2) % z


def bloom_init(batch: int, z: int, device: torch.device | str) -> torch.Tensor:
    """(batch, z) uint8 filter, all clear."""
    return torch.zeros((batch, z), dtype=torch.uint8, device=device)


def _insert(filt: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    # Invalid lanes write 0 through a max, so a lane with valid 0 and a lane
    # with valid 1 that hit the same slot leave it set whatever their order:
    # a plain store (`index_put_`) could clear a bit another lane set.
    filt.scatter_reduce_(1, p1, v, "amax")
    filt.scatter_reduce_(1, p2, v, "amax")
    return filt


def _probe(filt: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    return (torch.gather(filt, 1, p1) > 0) & (torch.gather(filt, 1, p2) > 0)


def bloom_set(filt: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Insert ids (B, R) into the per-query filters (B, z), in place; lanes
    where `valid` is False insert nothing."""
    p1, p2 = bloom_hashes(ids, filt.shape[-1])
    v = torch.ones_like(ids, dtype=torch.uint8) if valid is None else valid.to(torch.uint8)
    return _insert(filt, p1, p2, v)


def bloom_query(filt: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Membership test. (B, z), (B, R) -> (B, R) bool (True = maybe seen)."""
    return _probe(filt, *bloom_hashes(ids, filt.shape[-1]))


def bloom_query_and_set(
    filt: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 2 lines 7-10: test every id first, then insert the fresh
    ones, so two copies of an id in one row are both fresh. The probe
    positions are hashed once for both.

    Returns (fresh_mask, filter); the filter is updated in place.
    """
    p1, p2 = bloom_hashes(ids, filt.shape[-1])
    fresh = ~_probe(filt, p1, p2)
    if valid is not None:
        fresh = fresh & valid
    return fresh, _insert(filt, p1, p2, fresh.to(torch.uint8))
