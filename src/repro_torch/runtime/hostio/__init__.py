"""Host-I/O subsystem: the paper's CPU half as a service beside the search.

BANG's central claim (§4) is that the CPU-side graph fetch and the GPU-side
distance phases run concurrently. Without this package the `base` and
`sharded-base` variants gather adjacency inline on the search thread, every
hop, one thread, nothing overlapped (`core.search.HostNeighborFn`). This
package serves the host side behind one `NeighborService` interface:

    service.py    multi-worker host neighbour service: one thread pool per
                  graph partition, request queue, batched chunked gathers
                  written straight into pinned staging buffers,
                  queue-depth / latency / hit-rate counters.
    cache.py      device-resident hot-adjacency cache: top-in-degree rows
                  pinned in device memory, served without crossing the host
                  link, merged bit-exactly with the host rows.
    prefetch.py   the host exchange, optionally prefetched: hop k+1's
                  expected frontier (§4.6 eager candidate) is copied to the
                  host behind a CUDA event and gathered by a worker while
                  the search thread goes on with hop k; a sequence ticket
                  carries the order, and `overlap_fraction` measures how
                  much gather time was hidden.

`HostIOConfig` is the serving-surface knob set (`workers`, `hot_cache_rows`,
`prefetch`, `resilience`); `HostIORuntime` bundles the live pieces (service,
optional cache, exchange builders) for an executor. Enabled on
`SearchExecutor(variant="base", hostio=...)` and
`ShardedSearchExecutor(variant="sharded-base", hostio=...)`; every
configuration returns ids and distances bit-exact vs the synchronous paths
in every kernel mode (`tests/test_torch_hostio.py`).
"""
from __future__ import annotations

import dataclasses

import torch

from ...kernels.common import resolve_device
from ..resilience import ResilienceConfig
from .cache import HotAdjacencyCache, _host_array
from .prefetch import HostExchange, Ticket, make_base_exchange, make_shard_exchange
from .service import NeighborService

__all__ = [
    "HostExchange",
    "HostIOConfig",
    "HostIORuntime",
    "HotAdjacencyCache",
    "NeighborService",
    "ResilienceConfig",
    "Ticket",
    "make_base_exchange",
    "make_shard_exchange",
]


@dataclasses.dataclass(frozen=True)
class HostIOConfig:
    """Host-I/O serving knobs (part of the executor's pipeline-cache key).

    workers         host gather threads per graph partition (>= 1)
    hot_cache_rows  top-in-degree adjacency rows pinned on the device
                    (0 = off)
    prefetch        double-buffer the frontier exchange (issue hop k+1's
                    gather while the search thread finishes hop k)
    resilience      fault-handling policy (deadlines, retry/backoff,
                    hedging, failover, degraded mode); None = fail-fast.
                    Frozen, so it rides the cache key harmlessly: every
                    resilience decision is host-side state inside the
                    service, and the device work is the same for any value.
    """

    workers: int = 1
    hot_cache_rows: int = 0
    prefetch: bool = False
    resilience: ResilienceConfig | None = None

    def __post_init__(self) -> None:
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if self.hot_cache_rows < 0:
            raise ValueError(
                f"hot_cache_rows must be >= 0, got {self.hot_cache_rows}"
            )
        if self.resilience is not None and not isinstance(
            self.resilience, ResilienceConfig
        ):
            raise TypeError(
                "resilience must be a ResilienceConfig or None, "
                f"got {type(self.resilience).__name__}"
            )


class HostIORuntime:
    """Live host-I/O state for one executor: service + cache + exchanges.

    `partitions` are the host-RAM graph partitions the service gathers from
    (the whole graph for "base", this rank's block for "sharded-base");
    `adjacency` is the full (padded) adjacency the hot cache ranks and
    copies rows out of, and the medoid's row is pinned from it for
    degraded-mode substitution. The cache and the exchanges serve searches
    on `device` (CUDA unless the caller asks for the CPU).
    """

    def __init__(
        self,
        config: HostIOConfig,
        partitions,
        adjacency,
        *,
        medoid: int | None = None,
        name: str = "hostio",
        device: str | torch.device = "cuda",
    ) -> None:
        self.config = config
        self.device = resolve_device(device)
        adjacency = _host_array(adjacency)
        self.service = NeighborService(
            partitions, workers=config.workers, name=name,
            resilience=config.resilience, medoid=medoid,
            medoid_row=None if medoid is None else adjacency[medoid],
        )
        self.cache = (
            HotAdjacencyCache(adjacency, config.hot_cache_rows, medoid=medoid,
                              device=self.device)
            if config.hot_cache_rows > 0
            else None
        )

    def base_exchange(self):
        """(neighbor_fn, prefetch_fn) for the single-device base variant."""
        return make_base_exchange(
            self.service, cache=self.cache, prefetch=self.config.prefetch,
            device=self.device,
        )

    def shard_exchange(self, group):
        """(neighbor_fn, prefetch_fn) for sharded-base over the model
        process `group`."""
        return make_shard_exchange(
            self.service, group, cache=self.cache,
            prefetch=self.config.prefetch, device=self.device,
        )

    # Lifecycle + stats passthrough (ServePipeline drives these).
    def start(self) -> "HostIORuntime":
        self.service.start()
        return self

    def stop(self) -> None:
        self.service.stop()

    def set_telemetry(self, telemetry) -> None:
        """Attach a `repro_torch.runtime.telemetry.Telemetry` bundle.

        Forwards to the service (counter mirroring, gather spans, fault
        postmortems) and, when a hot cache is present, publishes its
        static footprint as gauges -- a router scraping `to_prom()` sees
        the device-memory cost of each replica's cache next to its
        measured hit rate.
        """
        self.service.set_telemetry(telemetry)
        if self.cache is not None:
            self.cache.set_telemetry(telemetry)
        if telemetry is not None and self.cache is not None:
            reg = telemetry.registry
            reg.gauge(
                "bang_hostio_hot_cache_rows",
                "adjacency rows pinned in device memory",
            ).set(self.cache.n_rows)
            reg.gauge(
                "bang_hostio_hot_cache_device_bytes",
                "device bytes held by the hot-adjacency cache",
            ).set(self.cache.device_bytes())

    def stats(self) -> dict:
        s = self.service.stats()
        s["hot_cache_rows"] = 0 if self.cache is None else self.cache.n_rows
        s["hot_cache_device_bytes"] = (
            0 if self.cache is None else self.cache.device_bytes()
        )
        s["prefetch"] = self.config.prefetch
        return s
