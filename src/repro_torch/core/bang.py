"""BangIndex: the paper's three-stage pipeline behind one public API.

    Stage 1  Distance-table construction   (§4.2, plain torch.matmul)
    Stage 2  ANN search                    (§4.1-4.8, repro_torch.core.search)
    Stage 3  Re-ranking                    (§4.9, repro_torch.core.rerank)

Three variants (paper §5): "base" (BANG proper: graph and full vectors in
host RAM, only the PQ codes and codebooks on the device), "inmem" (graph,
codes and vectors on the device) and "exact" (graph and vectors on the
device, exact distances, no re-rank); and two over a mesh of ranks,
"sharded" and "sharded-base" (`repro_torch.runtime.sharded`). Three kernel
modes: "fused" (the hop in one kernel), "staged" (one kernel per stage) and
"reference" (the plain PyTorch versions); all return identical ids. With no
`kernel_mode` a search on a CUDA index runs "fused", one on a CPU index
"reference".

An index serves one device, CUDA unless the caller asks for the CPU. It is
built with `BangIndex.build` (PQ codebooks trained and the codes encoded on
the device, the Vamana graph built on the host) or assembled from arrays
with `BangIndex.from_arrays`. The adjacency and the full vectors are kept in
host memory (pinned for a CUDA index) as BANG Base reads them; the vectors
also on the device unless `keep_device_data=False`, and the adjacency goes
to the device the first time an "inmem" or "exact" executor needs it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from . import pq as pqlib
from .search import SearchConfig
from .vamana import VamanaGraph, build_vamana
from ..kernels.common import resolve_device


def _tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A contiguous tensor of `dtype` on `device` from an array or tensor."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))          # a writable host copy
    return x.to(device, dtype).contiguous()


@dataclasses.dataclass
class SearchStats:
    n_iters: int
    mean_hops: float
    p95_hops: float
    wall_s: float        # dispatch -> results ready
    qps: float           # batch / wall_s (excludes pipeline set-up)
    compile_s: float = 0.0  # pipeline set-up paid by this call (0 on cache hit)
    batch: int = 0       # true batch size
    bucket: int = 0      # padded shape bucket the pipeline was built for


@dataclasses.dataclass
class BangIndex:
    """An immutable ANNS index over a dataset (codec + codes + graph + data)."""

    codec: pqlib.PQCodec         # codebooks on `device`
    codes: torch.Tensor          # (n, m) uint8 on `device`
    graph: VamanaGraph           # (n, R) int32 host adjacency + medoid
    data_host: torch.Tensor      # (n, d) float32 in host memory (base re-rank source)
    device: torch.device
    data_dev: torch.Tensor | None = None   # (n, d) float32 on `device` (inmem, exact)
    _adjacency_dev: torch.Tensor | None = dataclasses.field(default=None, repr=False, compare=False)
    _executors: dict[str, Any] = dataclasses.field(
        default_factory=dict, repr=False, compare=False,
    )

    @classmethod
    def build(
        cls,
        data: np.ndarray | torch.Tensor,
        *,
        m: int = 16,
        R: int = 32,
        L_build: int = 64,
        alpha: float = 1.2,
        kmeans_iters: int = 12,
        seed: int = 0,
        keep_device_data: bool = True,
        graph: VamanaGraph | None = None,
        device: str | torch.device = "cuda",
    ) -> "BangIndex":
        """Build an index over (n, d) vectors: PQ codebooks trained and the
        codes encoded on `device` (plain torch), the Vamana graph built on
        the host (`build_vamana(data, R, L_build, alpha, seed=seed)`) unless
        `graph` is given. The rest is `from_arrays`: its checks, and the
        host tables pinned for a CUDA index. Raises when `device` is CUDA
        and no card exists."""
        dev = resolve_device(device)
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        data = np.asarray(data, np.float32)
        x = torch.from_numpy(data).to(dev)
        codec = pqlib.train_pq(x, m, iters=kmeans_iters)
        codes = pqlib.pq_encode(codec, x)
        del x
        if graph is None:
            graph = build_vamana(data, R=R, L=L_build, alpha=alpha, seed=seed)
        return cls.from_arrays(codec.codebooks, codes, graph.adjacency, graph.medoid, data,
                               device=dev, keep_device_data=keep_device_data)

    @classmethod
    def from_arrays(
        cls,
        codebooks: np.ndarray | torch.Tensor,
        codes: np.ndarray | torch.Tensor,
        adjacency: np.ndarray | torch.Tensor,
        medoid: int,
        data: np.ndarray | torch.Tensor,
        *,
        device: str | torch.device = "cuda",
        keep_device_data: bool = True,
    ) -> "BangIndex":
        """Index from trained codebooks (m, 256, dsub), codes (n, m) uint8,
        adjacency (n, R) int32 (-1 padded), the medoid id and the full
        vectors (n, d). Raises when `device` is CUDA and no card exists.
        With `keep_device_data=False` the vectors stay in host memory only,
        as BANG Base needs; the "exact" variant then cannot be served."""
        dev = resolve_device(device)
        codebooks = _tensor(codebooks, torch.float32, dev)
        codes = _tensor(codes, torch.uint8, dev)
        adj = _tensor(adjacency, torch.int32, "cpu")
        data_host = _tensor(data, torch.float32, "cpu")
        n = codes.shape[0]
        if codebooks.ndim != 3 or codebooks.shape[1] != pqlib.N_CLUSTERS:
            raise ValueError(f"codebooks must be (m, 256, dsub), got {tuple(codebooks.shape)}")
        if codes.shape != (n, codebooks.shape[0]):
            raise ValueError(f"codes must be (n, m={codebooks.shape[0]}), got {tuple(codes.shape)}")
        if adj.ndim != 2 or adj.shape[0] != n or data_host.shape[0] != n:
            raise ValueError("codes, adjacency and data must have one row per point")
        if not 0 <= int(medoid) < n:
            raise ValueError(f"medoid {medoid} out of range [0, {n})")
        if int(adj.max()) >= n or int(adj.min()) < -1:
            raise ValueError("adjacency ids must lie in [-1, n)")
        data_dev = data_host.to(dev) if keep_device_data else None
        if dev.type == "cuda":
            adj, data_host = adj.pin_memory(), data_host.pin_memory()
        return cls(codec=pqlib.PQCodec(codebooks), codes=codes,
                   graph=VamanaGraph(adjacency=adj, medoid=int(medoid)),
                   data_host=data_host, device=dev, data_dev=data_dev)

    def adjacency_dev(self) -> torch.Tensor:
        """The adjacency on the device, uploaded once and shared by the
        "inmem" and "exact" executors ("base" never uploads it)."""
        if self._adjacency_dev is None:
            self._adjacency_dev = self.graph.adjacency.to(self.device)
        return self._adjacency_dev

    @property
    def n(self) -> int:
        return self.codes.shape[0]

    def executor(self, variant: str = "inmem", *, mesh=None, hostio=None):
        """The cached executor serving this index for `variant`.

        `variant="sharded"` or `"sharded-base"` returns a
        `ShardedSearchExecutor` over `mesh` (a `repro_torch.distributed`
        mesh; by default (1, every rank of the default process group), or a
        one-rank group when there is none).

        `hostio=HostIOConfig(...)` (`repro_torch.runtime.hostio`; the
        host-graph variants "base" and "sharded-base" only) serves the graph
        through the host-I/O subsystem -- multi-worker neighbour service,
        device-resident hot-adjacency cache, prefetched frontier exchange --
        instead of the inline gather. Executors are cached per
        (variant, mesh, hostio), so the two sharded variants never share
        state and differently-configured services never share worker pools.
        """
        if variant in ("sharded", "sharded-base"):
            if mesh is None:
                from repro_torch.distributed import default_mesh

                mesh = default_mesh(self.device)
        elif mesh is not None:
            raise ValueError(f"mesh= only applies to the sharded variants, got {variant!r}")
        if hostio is not None and variant not in ("base", "sharded-base"):
            raise ValueError(
                "hostio= only applies to the host-resident-graph variants "
                f"('base', 'sharded-base'), got {variant!r}"
            )
        key = (variant, mesh, hostio)
        ex = self._executors.get(key)
        if ex is None:
            if mesh is not None:
                from repro_torch.runtime.sharded import ShardedSearchExecutor

                ex = ShardedSearchExecutor.from_index(self, mesh, variant=variant, hostio=hostio)
            else:
                from repro_torch.runtime.executor import SearchExecutor

                ex = SearchExecutor.from_index(self, variant=variant, hostio=hostio)
            self._executors[key] = ex
        return ex

    def search(
        self,
        queries: np.ndarray | torch.Tensor,
        k: int = 10,
        *,
        t: int = 64,
        variant: str = "inmem",
        mesh=None,
        rerank: bool = True,
        cfg: SearchConfig | None = None,
        return_stats: bool = False,
        kernel_mode: str | None = None,
        hostio=None,
    ):
        """Batched k-NN search. Returns (ids (B, k), dists (B, k)) on the
        index's device, plus `SearchStats` with `return_stats=True`.
        `hostio=HostIOConfig(...)` serves the host-graph variants through
        the host-I/O subsystem, bit-exact vs the inline gather."""
        return self.executor(variant, mesh=mesh, hostio=hostio).search(
            queries, k, t=t, cfg=cfg, rerank=rerank,
            return_stats=return_stats, kernel_mode=kernel_mode,
        )


def brute_force_knn(
    data: np.ndarray | torch.Tensor,
    queries: np.ndarray | torch.Tensor,
    k: int,
    *,
    device: str | torch.device = "cuda",
    chunk: int = 256,
) -> np.ndarray:
    """Ground truth for recall: exact k nearest ids (B, k) by squared L2.

    Chunked over queries: one `torch.matmul` per chunk, then a stable sort,
    so ties resolve to the lowest id as the reference's `lax.top_k` does.
    """
    dev = resolve_device(device)
    x = _tensor(data, torch.float32, dev)
    q = _tensor(queries, torch.float32, dev)
    xn = (x * x).sum(-1)[None, :]
    out = []
    for s in range(0, q.shape[0], chunk):
        qc = q[s : s + chunk]
        d2 = (qc * qc).sum(-1)[:, None] + xn - 2.0 * torch.matmul(qc, x.T)
        out.append(torch.sort(d2, dim=-1, stable=True).indices[:, :k].cpu())
    return torch.cat(out).numpy()


def recall_at_k(found_ids: np.ndarray, true_ids: np.ndarray) -> float:
    """k-recall@k (paper §6.3): |found ∩ true| / k averaged over queries."""
    k = true_ids.shape[1]
    hits = 0
    for f, t in zip(np.asarray(found_ids), true_ids):
        hits += len(set(f.tolist()) & set(t.tolist()))
    return hits / (true_ids.shape[0] * k)
