"""Device-resident hot-adjacency cache: PilotANN's staging idea for BANG.

The host-resident graph variants pay the host link for *every* hop, but graph
traversals are skewed: high-in-degree hub nodes (and the medoid, which every
query expands first) are fetched far more often than the tail. PilotANN
(arXiv:2503.21206) stages exactly that hot subgraph in GPU memory.
`HotAdjacencyCache` does the same for the `base`/`sharded-base` neighbour
fetch:

  * **Ranking.** Rows are ranked by in-degree over the full adjacency (how
    often a node appears as someone's neighbour -- a static proxy for fetch
    frequency that needs no warm-up traffic), medoid always included; the
    top `n_rows` rows are pinned on the device. numpy, the reference's
    ranking exactly (stable argsort on ties, the medoid prepended as int32).
  * **Probe.** A dense `slot_of: (n,) int32` map (-1 = not cached) resolves
    frontier ids to cache slots on the device. The map costs n*4 bytes -- R
    (the adjacency fan-out) times smaller than the graph it shields. A host
    copy of the same map answers `covers`, which the host side of the
    exchange masks its requests with, so no hit mask crosses the link.
  * **Bit-exact masked merge.** Cache-hit lanes take their row from the
    device copy; only miss lanes reach the host service (their lanes are
    masked out of the request's ownership mask, so host memory is never
    touched for a hit). The merged result equals the uncached gather
    bit-for-bit because the cached rows ARE the adjacency rows.

Hit counting reaches the service through each request's `cache_hit`
operand (`NeighborService._account`), which feeds the measured hit rate into
`exchange_bytes_per_hop` as `host_bytes_saved_per_hop`.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.worklist import INVALID_ID
from ...kernels.common import resolve_device

__all__ = ["HotAdjacencyCache"]


def _host_array(adjacency) -> np.ndarray:
    if isinstance(adjacency, torch.Tensor):
        adjacency = adjacency.detach().cpu().numpy()
    return np.asarray(adjacency, np.int32)


class HotAdjacencyCache:
    """Top-in-degree adjacency rows pinned in device memory.

    The rows and the id -> slot map are uploaded once to `device` (CUDA
    unless the caller asks for the CPU)."""

    def __init__(
        self,
        adjacency,
        n_rows: int,
        *,
        medoid: int | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        adjacency = _host_array(adjacency)
        n, R = adjacency.shape
        if n_rows < 1:
            raise ValueError(f"n_rows must be >= 1, got {n_rows}")
        n_rows = min(n_rows, n)
        # Frequency ranking: in-degree over the adjacency (pad entries of -1
        # never vote). Stable argsort keeps the ranking deterministic on ties.
        flat = adjacency[adjacency >= 0]
        indeg = np.bincount(np.minimum(flat, n - 1), minlength=n)
        order = np.argsort(-indeg, kind="stable")
        hot = order[:n_rows].astype(np.int32)
        if medoid is not None and medoid not in hot:
            # The medoid is every query's first expansion: always cache it
            # (an int32 array, so hot_ids stays int32).
            hot = np.concatenate(
                [np.array([medoid], np.int32), hot[: n_rows - 1]]
            )
        slot_of = np.full(n, -1, np.int32)
        slot_of[hot] = np.arange(len(hot), dtype=np.int32)
        self.device = resolve_device(device)
        self.n = n
        self.R = R
        self.n_rows = int(len(hot))
        self.hot_ids = hot
        self._slot_host = slot_of
        self._slot_of = torch.from_numpy(slot_of).to(self.device)
        self._rows = torch.from_numpy(np.ascontiguousarray(adjacency[hot])).to(self.device)
        # Observability: re-uploads after a mutation, surfaced through
        # HostIORuntime.set_telemetry as bang_hostio_hot_cache_refreshes.
        self.refreshes = 0
        self._tel = None

    def set_telemetry(self, telemetry) -> None:
        """Attach a telemetry bundle (refresh-count gauge mirroring)."""
        self._tel = telemetry
        self._publish_refreshes()

    def _publish_refreshes(self) -> None:
        tel = self._tel
        if tel is not None:
            tel.registry.gauge(
                "bang_hostio_hot_cache_refreshes",
                "pinned-row re-uploads after consolidations",
            ).set(self.refreshes)

    # ------------------------------------------------------------- inspection
    def device_bytes(self) -> int:
        """Bytes this cache pins on the device (rows + id->slot map)."""
        return int(self._rows.numel() * self._rows.element_size()
                   + self._slot_of.numel() * self._slot_of.element_size())

    def covers(self, ids) -> np.ndarray:
        """Host-side membership mask: which of `ids` are pinned on the device.

        numpy in, numpy out, no device traffic. The exchange masks each host
        request with it; and when a host partition is down, lanes this mask
        covers are still served bit-exactly from the device copy, so
        `covers(partition_ids).mean()` bounds the recall a dead partition
        can cost.
        """
        ids = np.asarray(ids)
        valid = (ids >= 0) & (ids < self.n)
        return valid & (self._slot_host[np.clip(ids, 0, self.n - 1)] >= 0)

    # ------------------------------------------------------------- mutation
    def refresh(self, adjacency) -> None:
        """Re-upload the pinned rows from a mutated adjacency (same hot set).

        A consolidation rewrites adjacency rows in place, and a stale pinned
        row would be served bit-for-bit to every future hit. Keeping the
        *same* hot ids means `slot_of` is unchanged and only the
        (n_rows, R) row block is uploaded again.
        """
        adjacency = _host_array(adjacency)
        if adjacency.shape[0] < self.n or adjacency.shape[1] != self.R:
            raise ValueError(
                f"refresh adjacency must cover ({self.n}, {self.R}), got "
                f"{adjacency.shape}"
            )
        self._rows = torch.from_numpy(
            np.ascontiguousarray(adjacency[self.hot_ids])
        ).to(self.device)
        self.refreshes += 1
        self._publish_refreshes()

    # ------------------------------------------------------------------ probe
    def probe(self, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(rows (B, R), hit (B,)) for a frontier id vector on the device.

        Hit lanes carry their adjacency row from the device copy; non-hit
        lanes carry -1. Sentinel/negative/out-of-range ids never hit.
        """
        valid = (u >= 0) & (u != INVALID_ID) & (u < self.n)
        slot = self._slot_of[torch.clamp(u, 0, self.n - 1).long()]
        hit = valid & (slot >= 0)
        rows = self._rows[torch.clamp(slot, 0, self.n_rows - 1).long()]
        return torch.where(hit[:, None], rows, torch.full_like(rows, -1)), hit
