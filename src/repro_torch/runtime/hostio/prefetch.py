"""The host exchange of BANG Base over the neighbour service, with an
optional prefetched (double-buffered) frontier (§4.6).

The paper's eager candidate selection exists so the CPU-side fetch of hop
k+1 can start while the GPU is still sorting and merging hop k. The search
loop (`core.search.bang_search`) is a host loop, and this module gives it a
neighbour source, `HostExchange.fetch(u, active[, ticket])`, and, with
prefetch, the issue half, `HostExchange.issue(u_pred, active)`:

    issue   (inside hop k)    a non-blocking device-to-host copy of the
                              expected frontier and its activity flags into
                              a pinned buffer on the current stream, an
                              event recorded behind it, and the gather
                              enqueued on the service's worker pool
                              (`NeighborService.issue_lazy`): the worker
                              waits on that event, not the search thread,
                              and writes the rows straight into a pinned
                              staging buffer. Returns a `Ticket`.
    collect (top of hop k+1)  the search thread waits on the ticket's event
                              -- the hop's one device-to-host sync; the
                              copy carries the stop test too -- redeems the
                              ticket (`NeighborService.collect`, blocking
                              only for whatever gather time was not hidden)
                              and sends the rows up with one non-blocking
                              host-to-device copy.

Without prefetch, `fetch(u, active)` copies the frontier down (one blocking
copy: the stop test and the ids), runs the service's synchronous `request`
and sends the rows up the same way.

Prediction is best-effort: the eager steps issue the frontier selected
*before* the convergence masking (`ReferenceStep.step_with_prefetch`), so
`collect` validates the issued lanes and re-gathers any that changed --
results are bit-exact vs the synchronous path regardless of prediction
quality, and the service's `overlap_fraction` reports how much gather time
the prefetch hid.

**Buffers.** Each exchange keeps a small ring of pinned staging slots (a
(2, B) frontier buffer and a (B, R) rows buffer each). A slot is reused only
once the event behind its frontier copy and the event behind its rows copy
have passed and the worker writing it has settled; a ticket of hop k+1 may
be issued while hop k's rows copy still reads its slot, and then the ring
grows by a slot rather than waits. On the H100 one slot served every hop of
the harness cell: the search thread waits for each hop's frontier, so the
copies of the hop before have passed by the next issue. A slot whose buffer was
abandoned to a stalled worker (a hedged gather) is never reused. Worker
threads launch no CUDA work: the search thread issues every copy, on its
own current stream. On the CPU the frontier is on the host already and the
service's arrays are used as they are.

**Hot cache.** With a `HotAdjacencyCache`, lanes it covers are masked out
of the request's ownership at issue and at collect (the host side reads the
cache's host copy of its slot map, so no hit mask crosses the link), and
their rows are merged on the device with `torch.where`.

**Sharded.** `make_shard_exchange` serves one rank's block of the graph
(rows `[rank * n_loc, (rank + 1) * n_loc)` of the model group): each rank
redeems its own ticket against its own service, and an all-reduce over the
model group of the +1-shifted contributions rebuilds the full rows, as
`core.distributed.HostShardNeighborFn` does.

Degraded serving (`repro_torch.runtime.resilience`) changes nothing here:
deadlines, retries, hedging, failover reads and degraded-row substitution
all happen inside the service's calls. A lane whose partition is down and
not failed over arrives as the medoid's +1-shifted row ("medoid" mode) or
a zero contribution ("mask" mode), which the `- 1` shift below turns into
an all -1 row, dropped by the `(nbrs >= 0)` validity mask of
`bang_search`. Cache-hit lanes are immune to host faults.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from ...core.distributed import all_reduce_sum
from ...core.search import HostNeighborFn
from ...core.worklist import INVALID_ID
from ...kernels.common import resolve_device
from .cache import HotAdjacencyCache
from .service import NeighborService

__all__ = ["HostExchange", "Ticket", "make_base_exchange", "make_shard_exchange"]

_RING_SLOTS = 4     # staging slots kept for reuse


class _Slot:
    """One exchange's pinned staging: the frontier copied down, the rows
    sent up, and what guards them."""

    def __init__(self, B: int, R: int) -> None:
        self.B = B
        self.frontier = torch.empty((2, B), dtype=torch.int32, pin_memory=True)
        self.rows = torch.empty((B, R), dtype=torch.int32, pin_memory=True)
        self.rows_np = self.rows.numpy()
        self.down: torch.cuda.Event | None = None   # behind the frontier copy
        self.up: torch.cuda.Event | None = None     # behind the rows copy
        self.settled: threading.Event | None = None  # its ticket's writer is done
        self.abandoned = False                      # a stalled writer may still write

    def free(self) -> bool:
        return (not self.abandoned
                and (self.settled is None or self.settled.is_set())
                and (self.down is None or self.down.query())
                and (self.up is None or self.up.query()))


class Ticket:
    """A prefetch ticket: the service's sequence number, the predicted
    frontier and its activity flags as a (2, B) int32 host tensor, the CUDA
    event behind their copy (None on the CPU) and the staging slot the
    gather writes (None on the CPU)."""

    __slots__ = ("seq", "frontier", "event", "slot")

    def __init__(self, seq: int, frontier: torch.Tensor, event, slot) -> None:
        self.seq = seq
        self.frontier = frontier
        self.event = event
        self.slot = slot

    def host(self) -> np.ndarray:
        """The (2, B) frontier on the host, once its copy has landed."""
        if self.event is not None:
            self.event.synchronize()
        return self.frontier.numpy()


class HostExchange:
    """One graph partition's host exchange over `service` (its partition 0),
    for searches on `device`.

    Counters, for the caller's accounting: `hops` (fetches that returned
    rows), `frontier_bytes` and `rows_bytes` (copied down and up), and the
    search thread's host seconds split into `wait_s` (the frontier's copy
    down, which waits for the device), `gather_s` (the masks and the
    service call: the gather, or what of it was not hidden) and `send_s`
    (issuing the rows' copy up and merging them).
    """

    INACTIVE = HostNeighborFn.INACTIVE

    def __init__(
        self,
        service: NeighborService,
        *,
        device: str | torch.device = "cuda",
        cache: HotAdjacencyCache | None = None,
        row0: int = 0,
        group=None,
    ) -> None:
        self.service = service
        self.device = resolve_device(device)
        self.cache = cache
        self.row0 = row0
        self.group = group
        self._ring: collections.deque[_Slot] = collections.deque()
        self.hops = 0
        self.frontier_bytes = 0
        self.rows_bytes = 0
        self.wait_s = self.gather_s = self.send_s = 0.0

    # ------------------------------------------------------------ host side
    def _request(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rel, own, hit) of a host frontier for this partition: ownership
        as `core.distributed._owned_at`, minus the lanes the cache covers."""
        ids = ids.astype(np.int64)
        rel = ids - self.row0
        own = (rel >= 0) & (rel < self.service.n_loc) & (ids != INVALID_ID) & (ids >= 0)
        rel = np.clip(rel, 0, self.service.n_loc - 1).astype(np.int32)
        hit = self.cache.covers(ids) if self.cache is not None else np.zeros(ids.shape, bool)
        return rel, own & ~hit, hit

    def _slot(self, B: int) -> _Slot:
        for s in self._ring:
            if s.B == B and s.free():
                self._ring.remove(s)
                self._ring.append(s)
                return s
        s = _Slot(B, self.service.R)
        self._ring.append(s)
        while len(self._ring) > _RING_SLOTS:
            self._ring.popleft()       # busy slots stay alive with their users
        return s

    # ----------------------------------------------------------- device side
    def _send(self, res: np.ndarray, slot: _Slot | None) -> torch.Tensor:
        """The +1-shifted contributions on the device."""
        if self.device.type != "cuda":
            contrib = torch.from_numpy(res)
        elif res is slot.rows_np:
            contrib = slot.rows.to(self.device, non_blocking=True)
            slot.up = torch.cuda.Event()
            slot.up.record(torch.cuda.current_stream(self.device))
        else:
            # A hedged gather left the slot's buffer to a stalled worker.
            slot.abandoned = True
            contrib = torch.from_numpy(res).to(self.device)
        self.rows_bytes += contrib.numel() * contrib.element_size()
        return contrib

    def _rows(self, u: torch.Tensor, contrib: torch.Tensor) -> torch.Tensor:
        if self.group is not None:
            contrib = all_reduce_sum(contrib, self.group)
        rows = contrib - 1
        if self.cache is not None:
            dev_rows, hit = self.cache.probe(u)
            rows = torch.where(hit[:, None], dev_rows, rows)
        return rows

    # -------------------------------------------------------------- protocol
    def fetch(self, u: torch.Tensor, active: torch.Tensor, tok: Ticket | None = None):
        """Adjacency rows (B, R) of the frontier on the device, -1 rows for
        inactive lanes, or None once no lane is active. With a ticket the
        stop test and the ids come from its frontier copy (the copy of
        `active` behind it and `u` agree with it); without one, from a copy
        of `u` with the inactive lanes marked."""
        t0 = time.perf_counter()
        if tok is None:
            lanes = torch.where(active, u, torch.full_like(u, self.INACTIVE)).cpu().numpy()
            self.frontier_bytes += lanes.nbytes
            live = lanes != self.INACTIVE
        else:
            fr = tok.host()
            lanes, live = fr[0], fr[1] != 0
        t1 = time.perf_counter()
        self.wait_s += t1 - t0
        if not live.any():
            return None
        rel, own, hit = self._request(np.where(live, lanes, INVALID_ID))
        if tok is None:
            slot = self._slot(len(lanes)) if self.device.type == "cuda" else None
            res = self.service.request(0, rel, own, hit, out=None if slot is None else slot.rows_np)
        else:
            slot = tok.slot
            res = self.service.collect(0, rel, own, hit, tok.seq,
                                       out=None if slot is None else slot.rows_np)
        t2 = time.perf_counter()
        rows = self._rows(u, self._send(res, slot))
        self.send_s += time.perf_counter() - t2
        self.gather_s += t2 - t1
        self.hops += 1
        return rows

    def issue(self, u_pred: torch.Tensor, active: torch.Tensor) -> Ticket:
        """Start the gather of the expected frontier `u_pred` (its lanes as
        issued, inactive ones included: the service re-gathers at collect
        whatever differs) and return its ticket. `active` is the activity the
        next hop will see; it rides the same copy as the stop test."""
        packed = torch.stack([u_pred.to(torch.int32), active.to(torch.int32)])
        if self.device.type != "cuda":
            rel, own, _ = self._request(packed[0].numpy())
            seq = self.service.issue(0, rel, own)
            return Ticket(int(seq[0]), packed, None, None)
        slot = self._slot(packed.shape[1])
        slot.frontier.copy_(packed, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        slot.down = ev
        slot.settled = threading.Event()
        self.frontier_bytes += slot.frontier.numel() * slot.frontier.element_size()
        frontier = slot.frontier.numpy()

        def resolve():
            ev.synchronize()            # releases the GIL while it waits
            rel, own, _ = self._request(frontier[0])
            return rel, own

        seq = self.service.issue_lazy(0, resolve, out=slot.rows_np, settled=slot.settled)
        return Ticket(int(seq[0]), slot.frontier, ev, slot)

    def split(self) -> dict:
        """The counters above as one dict (seconds summed over hops)."""
        return dict(hops=self.hops, wait_s=self.wait_s, gather_s=self.gather_s,
                    send_s=self.send_s, frontier_bytes=self.frontier_bytes,
                    rows_bytes=self.rows_bytes)


def make_base_exchange(
    service: NeighborService,
    *,
    cache: HotAdjacencyCache | None = None,
    prefetch: bool = False,
    device: str | torch.device = "cuda",
):
    """(neighbor_fn, prefetch_fn) for the single-device "base" variant.

    The whole graph is one host partition. `neighbor_fn` is the
    `HostExchange` (its `fetch` serves `bang_search`); `prefetch_fn` is its
    `issue`, or None when prefetch is off. Results are bit-exact vs
    `core.search.host_neighbor_fn` for any worker count or cache size.
    """
    ex = HostExchange(service, device=device, cache=cache)
    return ex, (ex.issue if prefetch else None)


def make_shard_exchange(
    service: NeighborService,
    group,
    *,
    cache: HotAdjacencyCache | None = None,
    prefetch: bool = False,
    device: str | torch.device = "cuda",
):
    """(neighbor_fn, prefetch_fn) for "sharded-base": `service` holds this
    rank's block of the graph (its rank in the model `group` times the
    block's rows is its first row), and the contributions are all-reduced
    over `group`. Cache-hit lanes are masked out of every rank's ownership
    (they contribute 0) and served from the replicated device cache."""
    import torch.distributed as dist

    ex = HostExchange(service, device=device, cache=cache,
                      row0=dist.get_rank(group) * service.n_loc, group=group)
    return ex, (ex.issue if prefetch else None)
