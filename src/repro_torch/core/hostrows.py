"""Rows of a host-resident table, gathered on the host and sent to the device.

BANG Base keeps the graph and the full vectors in host RAM: per hop only the
frontier's adjacency rows cross PCIe, and per batch only the expanded
candidates' vectors (paper §3, §4.9). `HostRows` holds such a table in
pinned memory when its consumer is a CUDA device. A gather selects the rows
on the host into a pinned staging buffer and copies it to the device with
one non-blocking copy on the current stream. The buffer is written again
only after the copy that reads it has completed (an event recorded behind
the copy). On the CPU the rows are simply selected.
"""
from __future__ import annotations

import time

import torch

from .worklist import INVALID_ID


class HostRows:
    """A (n, width) host table whose rows are sent to `device` on demand.

    `seconds` and `bytes_sent` add up the host time spent gathering and
    the bytes copied to the device, for the caller's accounting.
    """

    def __init__(self, table: torch.Tensor, device: torch.device | str) -> None:
        self.device = torch.device(device)
        table = table.detach().to("cpu").contiguous()
        if self.device.type == "cuda" and not table.is_pinned():
            table = table.pin_memory()
        self.table = table
        self._buf: torch.Tensor | None = None
        self._copied: torch.cuda.Event | None = None
        self.seconds = 0.0
        self.bytes_sent = 0

    @property
    def width(self) -> int:
        return int(self.table.shape[1])

    def gather(self, ids: torch.Tensor, fill: int | float | None = None) -> torch.Tensor:
        """Rows `ids` (a CPU integer tensor of N ids) as an (N, width) tensor
        on the device. Lanes holding INVALID read row 0, or hold `fill`
        where it is given."""
        pad = ids == INVALID_ID
        safe = torch.where(pad, torch.zeros_like(ids), ids).long()

        def rows(out: torch.Tensor) -> None:
            torch.index_select(self.table, 0, safe, out=out)
            if fill is not None:
                out[pad] = fill

        return self.send(safe.shape[0], rows)

    def send(self, n: int, rows) -> torch.Tensor:
        """An (n, width) tensor on the device whose rows `rows(out)` writes
        on the host into `out`, a host tensor of that shape (the pinned
        staging buffer on a CUDA device)."""
        t0 = time.perf_counter()
        if self.device.type != "cuda":
            out = torch.empty((n, self.width), dtype=self.table.dtype)
            rows(out)
        else:
            if self._copied is not None:
                self._copied.synchronize()
            if self._buf is None or self._buf.shape[0] != n:
                self._buf = torch.empty((n, self.width), dtype=self.table.dtype, pin_memory=True)
            rows(self._buf)
            out = self._buf.to(self.device, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record(torch.cuda.current_stream(self.device))
        self.seconds += time.perf_counter() - t0
        self.bytes_sent += out.numel() * out.element_size()
        return out
