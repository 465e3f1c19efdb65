"""Opt-in per-hop profiling of the search loop's host seams.

The hop kernels are opaque from the host; what *is* observable without
touching them are the host seams the traversal crosses every hop -- the
host-I/O neighbour service's request/issue/collect gathers. `HopProfiler`
hangs off exactly those seams (the service calls `on_hop`) and records,
per hop:

  * wall time of the host gather visible to the device (the gather's
    blocking portion),
  * frontier occupancy -- how many of the exchange's padded lanes carried
    a live frontier node (`own` or cache-hit) vs padding,
  * hot-cache hit lanes,

and, from kernel metadata the executor stamps at dispatch time
(`set_kernel_info`), the modelled code-row bytes one hop reads
(`repro_torch.kernels.search_step.ops.hbm_codes_stream_bytes_per_hop`), so
the summary reports measured per-hop wall next to the modelled traffic.

`annotate(name)` brackets a region with `torch.profiler.record_function`,
so a `torch.profiler` trace of the card carries the same names as the
Chrome trace of `tracing.py` around the kernels it launches. With no
profiler running the range costs next to nothing and records nothing.

None of this perturbs the search: the profiler attaches as executor
*state* (`set_telemetry`), never enters the pipeline-cache key, and the
same kernels run on the same inputs with or without it.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["HopProfiler"]


class HopProfiler:
    """Per-hop host-seam recorder; see module docstring."""

    def __init__(self, max_hops: int = 100_000) -> None:
        self._lock = threading.Lock()
        self._max = max_hops
        self._wall_s: list[float] = []
        self._lanes: list[int] = []
        self._own: list[int] = []
        self._cache_hits: list[int] = []
        self.dropped_hops = 0
        self._kernel_info: dict | None = None

    # --------------------------------------------------------------- feeding
    def on_hop(self, shard: int, *, lanes: int, own_lanes: int,
               cache_hit_lanes: int, wall_s: float) -> None:
        """One host-gather seam crossing (called per shard per hop)."""
        with self._lock:
            if len(self._wall_s) >= self._max:
                self.dropped_hops += 1
                return
            self._wall_s.append(float(wall_s))
            self._lanes.append(int(lanes))
            self._own.append(int(own_lanes))
            self._cache_hits.append(int(cache_hit_lanes))

    def set_kernel_info(self, *, kernel_mode: str, batch: int, n: int,
                        m: int, R: int, tile_rows: int = 0) -> None:
        """Stamp dispatch-time kernel metadata for codes-stream accounting:
        the mode, the batch bucket, the codes block (n, m) one hop kernel
        sees and the graph degree R (the code rows a query reads a hop)."""
        with self._lock:
            self._kernel_info = {
                "kernel_mode": kernel_mode, "batch": int(batch),
                "n": int(n), "m": int(m), "R": int(R),
                "tile_rows": int(tile_rows),
            }

    # ----------------------------------------------------------- annotations
    @contextlib.contextmanager
    def annotate(self, name: str):
        """Bracket a region with a `torch.profiler.record_function` range."""
        with torch.profiler.record_function(name):
            yield

    # -------------------------------------------------------------- summary
    @property
    def hops(self) -> int:
        with self._lock:
            return len(self._wall_s)

    def summary(self) -> dict:
        """Aggregate per-hop record -> JSON-serialisable profile summary."""
        with self._lock:
            wall = sorted(self._wall_s)
            lanes = self._lanes[:]
            own = self._own[:]
            hits = self._cache_hits[:]
            info = None if self._kernel_info is None else dict(
                self._kernel_info)
            dropped = self.dropped_hops
        n = len(wall)
        total_lanes = sum(lanes)
        occupied = sum(o + h for o, h in zip(own, hits))
        out = {
            "hops": n,
            "dropped_hops": dropped,
            "hop_wall_s_total": sum(wall),
            "hop_wall_s_p50": _pct(wall, 50.0),
            "hop_wall_s_p95": _pct(wall, 95.0),
            "hop_wall_s_max": wall[-1] if wall else 0.0,
            "frontier_occupancy": occupied / total_lanes if total_lanes else 0.0,
            "own_lanes_total": sum(own),
            "cache_hit_lanes_total": sum(hits),
            "kernel_info": info,
            "codes_stream_bytes_per_hop": None,
            "codes_stream_bytes_total": None,
        }
        if info is not None:
            # Lazy import: the kernel wrappers stay out of a profiler that
            # never saw a dispatch.
            from repro_torch.kernels.search_step.ops import (
                hbm_codes_stream_bytes_per_hop,
            )

            per_hop = hbm_codes_stream_bytes_per_hop(
                info["kernel_mode"], info["batch"], info["n"], info["m"],
                tile_rows=info["tile_rows"], R=info["R"],
            )
            out["codes_stream_bytes_per_hop"] = per_hop
            out["codes_stream_bytes_total"] = per_hop * n
        return out


def _pct(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile on an already-sorted list (0.0 if empty)."""
    if not sorted_vals:
        return 0.0
    idx = min(int(round(q / 100.0 * (len(sorted_vals) - 1))),
              len(sorted_vals) - 1)
    return sorted_vals[idx]
