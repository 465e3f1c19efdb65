"""Streaming mutability: inserts and deletes under serving load.

BANG (§6) serves a frozen index; a production corpus changes while traffic
flows. `MutableBangIndex` closes that gap with the FreshDiskANN split of
mutation handling into three mechanisms, none of which builds a pipeline
mid-epoch:

  * **Tombstones (deletes).** An (n,) bool bitmap is handed to every
    dispatch as an argument of the pipeline (never state it closes over),
    and `bang_search` masks deleted ids out of each hop's validity before
    the bloom filter and the StepFn: a deleted id scores +inf in every lane,
    so it never enters 𝓛, the re-rank history or the top-k, in all three
    kernel modes and all five variants. The executor writes the bitmap in
    place into one device buffer. Setting a bit is O(1) host work.
  * **Delta set (inserts).** Fresh points gather in a small host-side
    `DeltaGraph` (an incremental robust_prune adjacency that consolidation
    uses for linkage). Searches scan the *alive* delta points exactly on
    the host -- the delta is small between consolidations -- and fuse the
    scan into the main results with `core.worklist.merge_worklist`, the
    sorted merge the traversal itself uses. Fusion happens in exact-distance
    space, so the PQ variants must re-rank (`rerank=True`) while delta
    points are live. The scan and the fusion are the reference's numpy code
    over the same float32 arrays, so they give the same bits.
  * **Consolidation (background).** `consolidate()` folds both logs into a
    new base index: the in-neighbours of deleted nodes are re-linked through
    the deleted nodes' own neighbourhoods with `robust_prune` (DiskANN's
    α rule), deleted slots are retired (all -1 rows; ids are never reused),
    and alive delta points are inserted with the build's GreedySearch +
    robust_prune + reverse-edge rule, all on the host. The corpus is then
    re-encoded with the unchanged codebooks on the index's device, and the
    new `BangIndex` (pinned host tables on a CUDA index) swaps in under the
    lock as a new **generation**: executors are rebuilt from it on their
    next dispatch and the old ones are dropped. Mutations that land while a
    consolidation computes are reconciled at the swap -- ids are stable
    (delta ids are `base_n + ordinal`, and a post-snapshot insert keeps its
    global id across the rebase), so nothing is lost or renumbered.

Cache-invalidation contract (what serving layers must do, and do):

  * Every mutation bumps `epoch`; `ServePipeline` drops its result cache
    whenever the executor's `mutation_epoch` moved (and refuses to cache
    results that raced a mutation mid-drain).
  * Consolidation bumps `generation`; `MutableSearchExecutor` resolves its
    inner executor per generation, so a stale executor never serves.
  * The host-I/O `HotAdjacencyCache` of a retiring executor is
    `refresh()`ed with the consolidated rows when the shapes allow, so
    in-flight traffic on the old generation never reads a device row that
    contradicts the host tables.

`MutableSearchExecutor` speaks the `SearchExecutor` dispatch/finish
contract, so `ServePipeline` serves a mutating index unchanged.
`consolidate_async()` runs the fold on a thread that queues its device work
on the same CUDA stream as the search thread; its Python holds the
interpreter lock that the search loop needs between hops.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import pq as pqlib
from repro_torch.core.bang import BangIndex
from repro_torch.core.search import SearchConfig
from repro_torch.core.vamana import greedy_search, robust_prune
from repro_torch.core.worklist import Worklist, merge_worklist

__all__ = ["DeltaGraph", "MutableBangIndex", "MutableSearchExecutor"]


def _sq_dists(data: np.ndarray, ids: np.ndarray, x: np.ndarray) -> np.ndarray:
    diff = data[ids] - x[None, :]
    return np.einsum("nd,nd->n", diff, diff).astype(np.float32)


class DeltaGraph:
    """Host-side log of freshly inserted points and their pruned adjacency.

    Ordinals are append-only and never reused; `alive` goes False on delete.
    The adjacency (robust_prune over the alive delta points, reverse edges
    patched) is *not* searched -- searches scan the alive points exactly --
    but consolidation seeds each folded point's candidates with it, keeping
    the locality the α rule built up.
    """

    def __init__(self, d: int, *, R: int = 16, alpha: float = 1.2) -> None:
        self.d = d
        self.R = R
        self.alpha = alpha
        self.vectors = np.zeros((0, d), np.float32)
        self.alive = np.zeros(0, np.bool_)
        self.adjacency: list[np.ndarray] = []   # out-edges by ordinal

    def __len__(self) -> int:
        return int(self.alive.shape[0])

    @property
    def n_alive(self) -> int:
        return int(self.alive.sum())

    def add(self, vec: np.ndarray) -> int:
        vec = np.asarray(vec, np.float32).reshape(self.d)
        o = len(self)
        self.vectors = np.concatenate([self.vectors, vec[None]], 0)
        self.alive = np.concatenate([self.alive, [True]])
        cand = np.nonzero(self.alive[:o])[0].astype(np.int32)
        if cand.size:
            cd = _sq_dists(self.vectors, cand, vec)
            row = robust_prune(self.vectors, o, cand, cd, self.alpha, self.R)
        else:
            row = np.zeros(0, np.int32)
        self.adjacency.append(row)
        # Reverse edges b -> o, pruning full rows as build_vamana does.
        for b in row:
            b = int(b)
            brow = self.adjacency[b]
            if o in brow:
                continue
            if brow.size < self.R:
                self.adjacency[b] = np.concatenate([brow, [np.int32(o)]]).astype(np.int32)
            else:
                cand = np.concatenate([brow, [o]]).astype(np.int32)
                cd = _sq_dists(self.vectors, cand, self.vectors[b])
                self.adjacency[b] = robust_prune(self.vectors, b, cand, cd, self.alpha, self.R)
        return o

    def mark_dead(self, ordinal: int) -> None:
        self.alive[ordinal] = False


@dataclasses.dataclass
class _MutableHandle:
    """An in-flight batch and the mutation snapshot it was dispatched under."""

    inner_ex: Any
    inner: Any              # the inner executor's SearchHandle
    queries: np.ndarray     # (B, d): the delta scan scores these
    delta_ids: np.ndarray   # (m,) int32 global ids of the alive delta points
    delta_vecs: np.ndarray  # (m, d)

    # The SearchHandle fields ServePipeline reads off in-flight handles.
    @property
    def compile_s(self) -> float:
        return self.inner.compile_s

    @property
    def batch(self) -> int:
        return self.inner.batch

    @property
    def bucket(self) -> int:
        return self.inner.bucket


def _fuse_delta(
    ids: np.ndarray, dists: np.ndarray, queries: np.ndarray,
    delta_ids: np.ndarray, delta_vecs: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Merge the exact delta scan into the main top-k.

    Both inputs are ascending (dist, id) lists in exact squared-L2 space;
    `merge_worklist` -- the traversal's own sorted merge, on the CPU -- keeps
    the k best. Delta ids are >= base_n, so they never collide with a main id.
    """
    diff = queries[:, None, :].astype(np.float32) - delta_vecs[None, :, :]
    d2 = np.einsum("bmd,bmd->bm", diff, diff).astype(np.float32)
    order = np.argsort(d2, axis=1, kind="stable")
    cand_d = np.take_along_axis(d2, order, 1)
    cand_i = delta_ids[order].astype(np.int32)
    wl = Worklist(
        dists=torch.from_numpy(np.ascontiguousarray(dists, np.float32)),
        ids=torch.from_numpy(np.ascontiguousarray(ids, np.int32)),
        visited=torch.ones(np.shape(ids), dtype=torch.bool),
    )
    merged = merge_worklist(wl, torch.from_numpy(cand_d), torch.from_numpy(cand_i))
    return merged.ids.numpy(), merged.dists.numpy()


class MutableSearchExecutor:
    """`SearchExecutor`-contract facade over a `MutableBangIndex`.

    Each dispatch snapshots the tombstones and the alive delta under the
    index lock and launches the generation-current inner executor with the
    delete bitmap; each finish fuses the exact delta scan into the main
    results and returns (ids, dists) on the index's device, as
    `SearchExecutor.finish` does. `mutation_epoch` and `mutation_stats` feed `ServePipeline`'s result
    cache scoping and `ServeStats.mutation`.
    """

    def __init__(self, owner: "MutableBangIndex", variant: str = "inmem",
                 *, mesh=None, hostio=None) -> None:
        if variant in ("sharded", "sharded-base") and mesh is None:
            from repro_torch.distributed import default_mesh

            mesh = default_mesh(owner.index.device)
        self._owner = owner
        self.variant = variant
        self._mesh = mesh
        self._hostio = hostio
        # Made now, so that ServePipeline can own the host-I/O lifecycle.
        self._owner._inner_executor(variant, mesh, hostio)

    # -------------------------------------------------------------- plumbing
    def _inner(self):
        return self._owner._inner_executor(self.variant, self._mesh, self._hostio)

    @property
    def mutation_epoch(self) -> int:
        return self._owner.epoch

    def mutation_stats(self) -> dict:
        return self._owner.mutation_stats()

    def set_telemetry(self, telemetry) -> "MutableSearchExecutor":
        """Forward the bundle to the owning index (and so to every inner
        executor, across generation swaps)."""
        self._owner.set_telemetry(telemetry)
        return self

    @property
    def hostio_runtime(self):
        return self._inner().hostio_runtime

    @property
    def query_dim(self) -> int | None:
        return self._inner().query_dim

    @property
    def trace_counts(self) -> dict:
        return self._inner().trace_counts

    def exchange_bytes_per_hop(self, batch: int) -> dict:
        stats = self._owner.mutation_stats()
        d = dict(self._inner().exchange_bytes_per_hop(batch))
        d["tombstone_fraction"] = stats["tombstone_fraction"]
        d["delta_points"] = stats["delta_points"]
        return d

    # --------------------------------------------------------------- serving
    def dispatch(
        self,
        queries: np.ndarray | torch.Tensor,
        k: int = 10,
        *,
        t: int = 64,
        cfg: SearchConfig | None = None,
        rerank: bool = True,
        kernel_mode: str | None = None,
    ) -> _MutableHandle:
        owner = self._owner
        with owner._lock:
            inner_ex = self._inner()
            tomb = owner._tombstones.copy()
            delta_ids, delta_vecs = owner._alive_delta()
        if delta_ids.size and not rerank and self.variant != "exact":
            raise ValueError(
                "rerank=False is unsupported while delta points are live: "
                "delta/main result fusion needs exact-distance top-k "
                "(PQ-space worklist distances cannot be merged with the "
                "exact delta scan)"
            )
        if isinstance(queries, torch.Tensor):
            queries = queries.detach().cpu().numpy()
        q = np.asarray(queries, np.float32)
        h = inner_ex.dispatch(q, k, t=t, cfg=cfg, rerank=rerank, kernel_mode=kernel_mode,
                              tombstones=tomb)
        return _MutableHandle(inner_ex=inner_ex, inner=h, queries=q, delta_ids=delta_ids,
                              delta_vecs=delta_vecs)

    def finish(self, handle: _MutableHandle, *, return_stats: bool = False):
        out = handle.inner_ex.finish(handle.inner, return_stats=return_stats)
        ids, dists = out[0], out[1]
        if handle.delta_ids.size:
            fids, fdists = _fuse_delta(ids.cpu().numpy(), dists.cpu().numpy(), handle.queries,
                                       handle.delta_ids, handle.delta_vecs)
            ids = torch.from_numpy(fids).to(ids.device)
            dists = torch.from_numpy(fdists).to(dists.device)
        if return_stats:
            return ids, dists, out[2]
        return ids, dists

    def search(
        self,
        queries: np.ndarray | torch.Tensor,
        k: int = 10,
        *,
        t: int = 64,
        cfg: SearchConfig | None = None,
        rerank: bool = True,
        return_stats: bool = False,
        kernel_mode: str | None = None,
    ):
        handle = self.dispatch(queries, k, t=t, cfg=cfg, rerank=rerank, kernel_mode=kernel_mode)
        return self.finish(handle, return_stats=return_stats)


class MutableBangIndex:
    """Insert/delete layer over a built `BangIndex` (see module docstring)."""

    def __init__(
        self,
        index: BangIndex,
        *,
        alpha: float = 1.2,
        delta_R: int = 16,
        consolidate_L: int = 32,
    ) -> None:
        self._lock = threading.RLock()
        self._index = index
        self._codec = index.codec
        self._alpha = alpha
        self._consolidate_L = consolidate_L
        self._tombstones = np.zeros(index.n, np.bool_)
        self._delta = DeltaGraph(index.data_host.shape[1], R=delta_R, alpha=alpha)
        self.epoch = 0
        self.generation = 0
        self._consolidations = 0
        # (variant, mesh, hostio) -> (generation, inner executor)
        self._inner: dict[Any, tuple[int, Any]] = {}
        self._retired_runtimes: list[Any] = []
        self._executors: dict[Any, MutableSearchExecutor] = {}
        self.consolidate_error: BaseException | None = None
        # Seconds of the last consolidation's stages (`consolidate`).
        self.last_consolidation: dict[str, float] = {}
        # Telemetry bundle; re-applied to every rebuilt inner executor so a
        # generation swap never drops observability.
        self._tel = None

    # -------------------------------------------------------------- telemetry
    def set_telemetry(self, telemetry) -> None:
        """Attach a `repro_torch.runtime.telemetry.Telemetry` bundle.

        Mutation counters go to the registry (`bang_mutation_*_total`, the
        epoch and generation gauges), consolidations emit `consolidate`
        spans and `generation_swap` events, and every inner executor --
        current and future generations -- forwards the same bundle (host
        I/O included).
        """
        with self._lock:
            self._tel = telemetry
            if telemetry is not None:
                self._mutation_gauges_locked()
            for _gen, ex in self._inner.values():
                ex.set_telemetry(telemetry)

    def _mutation_gauges_locked(self) -> None:
        """Refresh the epoch and generation gauges; the caller holds the lock."""
        tel = self._tel
        if tel is None:
            return
        reg = tel.registry
        reg.gauge("bang_mutation_epoch",
                  "mutation epoch (bumps on insert/delete/consolidate)").set(self.epoch)
        reg.gauge("bang_mutation_generation",
                  "consolidation generation of the serving snapshot").set(self.generation)

    # ------------------------------------------------------------ inspection
    @property
    def index(self) -> BangIndex:
        """The current immutable base snapshot (swaps at consolidation)."""
        return self._index

    @property
    def n(self) -> int:
        """Size of the live id space (base rows + every delta ordinal)."""
        with self._lock:
            return self._index.n + len(self._delta)

    def mutation_stats(self) -> dict:
        with self._lock:
            base_n = self._index.n
            tomb = int(self._tombstones.sum())
            return {
                "epoch": self.epoch,
                "generation": self.generation,
                "consolidations": self._consolidations,
                "base_n": base_n,
                "tombstones": tomb,
                "tombstone_fraction": tomb / max(base_n, 1),
                "delta_points": self._delta.n_alive,
                "delta_total": len(self._delta),
            }

    def live_points(self) -> tuple[np.ndarray, np.ndarray]:
        """Consistent snapshot of the live corpus: (ids (L,), vectors (L, d)).

        Non-deleted base points followed by alive delta points, under their
        global ids: brute force over this pair is the ground truth for a
        search of the mutated corpus.
        """
        with self._lock:
            base = self._index.data_host.numpy()
            live = np.nonzero(~self._tombstones)[0]
            delta_ids, delta_vecs = self._alive_delta()
        ids = np.concatenate([live, delta_ids.astype(np.int64)])
        vecs = np.concatenate([base[live], delta_vecs], 0)
        return ids.astype(np.int64), vecs

    # ------------------------------------------------------------- mutations
    def insert(self, vectors: np.ndarray) -> np.ndarray:
        """Insert (B, d) or (d,) vectors; returns their global ids.

        Ids are `base_n + ordinal` and stay stable across consolidations
        (the fold appends every ordinal -- dead ones as retired rows -- so
        the arithmetic never shifts).
        """
        v = np.asarray(vectors, np.float32)
        if v.ndim == 1:
            v = v[None]
        with self._lock:
            base_n = self._index.n
            ids = np.empty(v.shape[0], np.int32)
            for i, row in enumerate(v):
                ids[i] = base_n + self._delta.add(row)
            self.epoch += 1
            if self._tel is not None:
                self._tel.registry.counter("bang_mutation_inserts_total",
                                           "vectors inserted").inc(v.shape[0])
                self._mutation_gauges_locked()
            return ids

    def delete(self, ids) -> None:
        """Tombstone base ids, kill delta ids. Idempotent per id.

        The medoid is every query's entry point and must stay searchable;
        deleting it is refused (retire it by consolidating a replacement
        corpus instead).
        """
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        with self._lock:
            base_n = self._index.n
            medoid = int(self._index.graph.medoid)
            hi = base_n + len(self._delta)
            for i in ids:
                i = int(i)
                if i == medoid:
                    raise ValueError(f"cannot delete the medoid (id {medoid}): it is the "
                                     "search entry point")
                if 0 <= i < base_n:
                    self._tombstones[i] = True
                elif base_n <= i < hi:
                    self._delta.mark_dead(i - base_n)
                else:
                    raise ValueError(f"unknown id {i} (id space is [0, {hi}))")
            self.epoch += 1
            if self._tel is not None:
                self._tel.registry.counter("bang_mutation_deletes_total",
                                           "ids tombstoned/killed").inc(ids.size)
                self._mutation_gauges_locked()

    # ------------------------------------------------------------- executors
    def executor(self, variant: str = "inmem", *, mesh=None, hostio=None) -> MutableSearchExecutor:
        """The mutation-aware executor facade for `variant` (cached)."""
        key = (variant, mesh, hostio)
        ex = self._executors.get(key)
        if ex is None:
            ex = MutableSearchExecutor(self, variant, mesh=mesh, hostio=hostio)
            self._executors[key] = ex
        return ex

    def search(self, queries, k: int = 10, *, variant: str = "inmem", mesh=None, hostio=None, **kw):
        return self.executor(variant, mesh=mesh, hostio=hostio).search(queries, k, **kw)

    def _alive_delta(self) -> tuple[np.ndarray, np.ndarray]:
        base_n = self._index.n
        ords = np.nonzero(self._delta.alive)[0]
        return (base_n + ords).astype(np.int32), self._delta.vectors[ords]

    def _inner_executor(self, variant: str, mesh, hostio):
        """Generation-current inner executor, (re)built on demand.

        A consolidation bumps `generation`; the first dispatch after the
        swap finds its cached entry stale, builds a new executor over the
        new snapshot (new pipeline cache: the old pipelines are dropped),
        and parks the old host-I/O runtime for `close()` (its threads may
        still serve an in-flight batch, so it is never stopped here).
        """
        with self._lock:
            key = (variant, mesh, hostio)
            entry = self._inner.get(key)
            if entry is not None and entry[0] == self.generation:
                return entry[1]
            if entry is not None and entry[1].hostio_runtime is not None:
                self._retired_runtimes.append(entry[1].hostio_runtime)
            if variant in ("sharded", "sharded-base"):
                from repro_torch.runtime.sharded import ShardedSearchExecutor

                ex = ShardedSearchExecutor.from_index(self._index, mesh, variant=variant,
                                                      hostio=hostio, with_tombstones=True)
            else:
                from repro_torch.runtime.executor import SearchExecutor

                ex = SearchExecutor.from_index(self._index, variant=variant, hostio=hostio,
                                               with_tombstones=True)
            if self._tel is not None:
                ex.set_telemetry(self._tel)
            self._inner[key] = (self.generation, ex)
            return ex

    def close(self) -> None:
        """Stop every host-I/O runtime this index ever made (idempotent)."""
        with self._lock:
            runtimes = list(self._retired_runtimes)
            self._retired_runtimes.clear()
            for _gen, ex in self._inner.values():
                if ex.hostio_runtime is not None:
                    runtimes.append(ex.hostio_runtime)
        for rt in runtimes:
            rt.stop()

    def __enter__(self) -> "MutableBangIndex":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------- consolidation
    def consolidate(self) -> dict:
        """Fold tombstones and delta into a new base index (new generation).

        Safe to run beside traffic: the rebuild works on a *snapshot*
        outside the lock, and mutations that land meanwhile are reconciled
        at the swap (post-snapshot deletes tombstoned again, post-snapshot
        inserts rebased into the new delta with their global ids unchanged).
        Returns the post-swap `mutation_stats()`. `last_consolidation` then
        holds the seconds of its stages: the host re-link of deleted nodes'
        in-neighbours, the host inserts of the delta points, the re-encode
        and the new index's tables on the device, and the swap.
        """
        tel = self._tel
        span = None
        t_start = time.perf_counter()
        with self._lock:
            if tel is not None:
                span = tel.span("consolidate", track="mutation", from_generation=self.generation)
            snap_index = self._index
            snap_tomb = self._tombstones.copy()
            snap_vecs = self._delta.vectors.copy()
            snap_alive = self._delta.alive.copy()
            snap_adj = [row.copy() for row in self._delta.adjacency]
            snap_len = len(self._delta)
            delta_R = self._delta.R

        # ---- the host rebuild, outside the lock ---------------------------
        t0 = time.perf_counter()
        data = np.asarray(snap_index.data_host.numpy(), np.float32)
        adjacency = np.array(snap_index.graph.adjacency.numpy(), np.int32, copy=True)
        medoid = int(snap_index.graph.medoid)
        base_n, R = adjacency.shape
        alpha = self._alpha

        deleted = np.nonzero(snap_tomb)[0]
        if deleted.size:
            is_del = np.zeros(base_n, np.bool_)
            is_del[deleted] = True
            # Re-link every live in-neighbour b of a deleted node d through
            # d's own live neighbourhood: robust_prune over
            # (nbrs(b) \ del) U (nbrs(d) \ del \ {b}) -- FreshDiskANN's
            # delete rule, keeping b's reachability without d.
            touched = ((adjacency >= 0) & is_del[np.clip(adjacency, 0, base_n - 1)]).any(1) & ~snap_tomb
            for b in np.nonzero(touched)[0]:
                b = int(b)
                row = adjacency[b]
                row = row[row >= 0]
                cand: list[int] = [int(x) for x in row if not is_del[x]]
                for dnode in row:
                    if is_del[dnode]:
                        for x in adjacency[dnode]:
                            if x >= 0 and not is_del[x] and int(x) != b:
                                cand.append(int(x))
                adjacency[b, :] = -1
                if not cand:
                    continue
                cand_ids = np.unique(np.asarray(cand, np.int32))
                cd = _sq_dists(data, cand_ids, data[b])
                newrow = robust_prune(data, b, cand_ids, cd, alpha, R)
                adjacency[b, : newrow.size] = newrow
            # Retire the deleted slots: ids are never reused, rows go dark.
            adjacency[deleted, :] = -1
        t_relink = time.perf_counter()

        new_n = base_n + snap_len
        # Dead-at-snapshot mask over the new id space: retired base slots
        # and delta ordinals deleted before they were ever folded in.
        dead_mask = np.zeros(new_n, np.bool_)
        dead_mask[deleted] = True
        dead_mask[base_n + np.nonzero(~snap_alive)[0]] = True
        if snap_len:
            data = np.concatenate([data, snap_vecs], 0)
            adjacency = np.concatenate([adjacency, np.full((snap_len, R), -1, np.int32)], 0)
            for o in np.nonzero(snap_alive)[0]:
                o = int(o)
                g = base_n + o
                vis_ids, _ = greedy_search(data, adjacency, medoid, data[g], self._consolidate_L)
                # Seed with the delta graph's own α-pruned out-edges so that
                # the delta's locality survives the fold.
                extra = np.asarray([base_n + int(x) for x in snap_adj[o] if snap_alive[x]], np.int32)
                cand_ids = np.concatenate([vis_ids.astype(np.int32), extra])
                # Candidates must be live nodes other than g.
                cand_ids = cand_ids[(cand_ids != g) & ~dead_mask[cand_ids]]
                if cand_ids.size == 0:
                    cand_ids = np.asarray([medoid], np.int32)
                cd = _sq_dists(data, cand_ids, data[g])
                newrow = robust_prune(data, g, cand_ids, cd, alpha, R)
                adjacency[g, : newrow.size] = newrow
                # Reverse edges b -> g, pruning full rows (the build rule).
                for b in newrow:
                    b = int(b)
                    brow = adjacency[b]
                    if g in brow:
                        continue
                    empty = np.nonzero(brow < 0)[0]
                    if empty.size:
                        adjacency[b, empty[0]] = g
                    else:
                        cand2 = np.concatenate([brow, [g]]).astype(np.int32)
                        cd2 = _sq_dists(data, cand2, data[b])
                        brow2 = robust_prune(data, b, cand2, cd2, alpha, R)
                        adjacency[b, :] = -1
                        adjacency[b, : brow2.size] = brow2
        t_insert = time.perf_counter()

        # PQ codes: the codebooks are NOT retrained (the codec is fixed at
        # build); the whole corpus is re-encoded on the index's device, so
        # the delta rows get codes.
        dev = snap_index.device
        codes = pqlib.pq_encode(self._codec, torch.from_numpy(data).to(dev))
        new_index = BangIndex.from_arrays(self._codec.codebooks, codes, adjacency, medoid, data,
                                          device=dev,
                                          keep_device_data=snap_index.data_dev is not None)
        if dev.type == "cuda":
            # Wait for the re-encode here, so that its time is its own and
            # not the swap's or the next search's.
            torch.cuda.current_stream(dev).synchronize()
        new_tomb = dead_mask.copy()
        t_encode = time.perf_counter()

        # ---- the swap and the reconciliation, under the lock --------------
        with self._lock:
            # Base deletes that landed after the snapshot: ids are stable,
            # so the live bitmap ORs straight in (retired slots stay set).
            new_tomb[:base_n] |= self._tombstones
            # Folded delta points deleted after the snapshot.
            for o in range(snap_len):
                if not self._delta.alive[o]:
                    new_tomb[base_n + o] = True
            # Post-snapshot inserts rebase into a fresh delta; ordinal o
            # becomes o - snap_len and base_n grows by snap_len, so the
            # global id base_n + ordinal is unchanged.
            new_delta = DeltaGraph(data.shape[1], R=delta_R, alpha=alpha)
            for o in range(snap_len, len(self._delta)):
                no = new_delta.add(self._delta.vectors[o])
                if not self._delta.alive[o]:
                    new_delta.mark_dead(no)
            # Refresh retiring hot-adjacency caches where the consolidated
            # rows still cover the pinned set (a delete-only fold keeps the
            # shape), so in-flight old-generation traffic reads rows that
            # agree with the host tables.
            for _gen, ex in self._inner.values():
                rt = ex.hostio_runtime
                cache = None if rt is None else rt.cache
                if cache is not None and adjacency.shape[0] >= cache.n and adjacency.shape[1] == cache.R:
                    cache.refresh(adjacency)
            self._index = new_index
            self._delta = new_delta
            self._tombstones = new_tomb
            self.generation += 1
            self.epoch += 1
            self._consolidations += 1
            if tel is not None:
                tel.registry.counter("bang_mutation_consolidations_total",
                                     "background consolidations completed").inc()
                self._mutation_gauges_locked()
                tel.event("generation_swap", track="mutation", generation=self.generation,
                          folded=snap_len, retired=int(new_tomb.sum()))
                if span is not None:
                    span.end(to_generation=self.generation)
            t_end = time.perf_counter()
            self.last_consolidation = dict(
                relink_s=t_relink - t0, insert_s=t_insert - t_relink, encode_s=t_encode - t_insert,
                swap_s=t_end - t_encode, total_s=t_end - t_start,
            )
            return self.mutation_stats()

    def consolidate_async(self) -> threading.Thread:
        """Run `consolidate()` on a background thread (join to wait).

        Traffic keeps flowing meanwhile: searches serve the old generation
        (tombstones and the delta scan keep them correct) until the swap,
        after which the next dispatch picks up the new generation. The
        thread queues its device work on the current CUDA stream of the
        index's device, the one the search thread uses. A failure is kept in
        `consolidate_error` and raised again on the next call.
        """
        if self.consolidate_error is not None:
            err, self.consolidate_error = self.consolidate_error, None
            raise err
        dev = self._index.device

        def run() -> None:
            try:
                if dev.type == "cuda":
                    with torch.cuda.device(dev):
                        self.consolidate()
                else:
                    self.consolidate()
            except BaseException as e:  # surfaced on the next call
                self.consolidate_error = e

        th = threading.Thread(target=run, name="bang-consolidate", daemon=True)
        th.start()
        return th
