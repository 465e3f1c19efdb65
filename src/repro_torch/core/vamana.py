"""Vamana graph construction (DiskANN [26]; paper §2.2).

BANG searches a pre-built Vamana graph; the paper reuses DiskANN's index.
This module builds one: iterative insertion with GreedySearch to collect a
visited set and RobustPrune (the α rule) to select out-neighbours, plus
reverse-edge patching. `BangIndex.build` calls it; an index built by the
reference package can also be carried across with
`repro_torch.convert.index_from_reference`.

Construction is host numpy, as in the reference: offline and sequential by
nature. It makes every decision of the reference's `build_vamana` in the
same order and returns the same adjacency and medoid bit for bit: the same
`np.random.default_rng(seed)` draws, every distance the same
`np.einsum("nd,nd->n", diff, diff)` over `data[ids] - x`, the same
`robust_prune` and reverse-edge rule. Only the greedy search's bookkeeping
differs: its worklist stays sorted by the key the reference's `argmin` and
stable `argsort` decide by, so each expansion takes the first unvisited
entry instead of scanning the worklist in Python (`_greedy_search_build`).

The graph the search reads is a fixed-degree (n, R) int32 adjacency, -1
padded, in host memory (pinned for an index on a CUDA device), and the
medoid entry point.
"""
from __future__ import annotations

import bisect
import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class VamanaGraph:
    """Fixed-degree adjacency: (n, R) int32 torch tensor, -1 padded, in host
    memory (pinned for an index on a CUDA device). medoid = search entry."""

    adjacency: torch.Tensor
    medoid: int

    @property
    def n(self) -> int:
        return self.adjacency.shape[0]

    @property
    def R(self) -> int:
        return self.adjacency.shape[1]

    def degree_stats(self) -> tuple[float, int]:
        """(mean, max) out-degree."""
        deg = (self.adjacency >= 0).sum(1)
        return float(deg.double().mean()), int(deg.max())


def _host(a) -> np.ndarray:
    """A numpy view of a host array or CPU tensor."""
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _dists_to(data: np.ndarray, ids: np.ndarray, x: np.ndarray) -> np.ndarray:
    diff = data[ids] - x[None, :]
    return np.einsum("nd,nd->n", diff, diff)


def find_medoid(data: np.ndarray) -> int:
    """The point nearest the centroid (squared L2; first on ties)."""
    centroid = data.mean(axis=0)
    return int(np.argmin(np.einsum("nd,nd->n", data - centroid, data - centroid)))


def _greedy_search_build(
    data: np.ndarray,
    adjacency: np.ndarray,
    start: int,
    query: np.ndarray,
    L: int,
) -> tuple[np.ndarray, np.ndarray]:
    """GreedySearch(s, q, L) during build: (visited_ids, visited_dists) in
    the order of expansion.

    Best-first beam (Algorithm 1 of the paper): expand the closest unvisited
    worklist entry until every entry is visited. A neighbour joins the
    worklist when it is neither in it nor visited (duplicates within one
    adjacency row join together); past L entries the worklist keeps its L
    nearest, and an entry dropped unvisited may join again later.

    The reference keeps its worklist in concatenation order and takes the
    first minimum (`argmin`) and the L smallest (stable `argsort`): both
    order entries by (distance, order of joining). This worklist is a list
    of (distance, join number, id) kept sorted by that key, so the entry to
    expand is the first unvisited one from a cursor, and a fresh neighbour
    that sorts past a full worklist's last entry is never inserted (the
    reference drops it in the same step).
    """
    wl_d0 = float(_dists_to(data, np.array([start], np.int32), query)[0])
    wl = [(wl_d0, 0, int(start))]
    joined = 1                        # join numbers handed out so far
    count = {int(start): 1}           # copies of each id held in the worklist
    visited: set[int] = set()
    order: list[int] = []
    vis_d: list[float] = []
    cur = 0                           # every entry before it is visited
    while True:
        while cur < len(wl) and wl[cur][2] in visited:
            cur += 1
        if cur == len(wl):
            break
        du, _, u = wl[cur]
        visited.add(u)
        order.append(u)
        vis_d.append(du)
        fresh = [b for b in adjacency[u].tolist() if b >= 0 and b not in count and b not in visited]
        if not fresh:
            continue
        fd = _dists_to(data, np.array(fresh, np.int32), query).tolist()
        new = sorted(zip(fd, range(joined, joined + len(fresh)), fresh))
        joined += len(fresh)
        if len(wl) >= L:
            last = wl[L - 1]
            new = [e for e in new if e < last]
        for e in new:
            pos = bisect.bisect_left(wl, e)
            wl.insert(pos, e)
            count[e[2]] = count.get(e[2], 0) + 1
            cur = min(cur, pos)
        for _, _, i in wl[L:]:
            if count[i] == 1:
                del count[i]
            else:
                count[i] -= 1
        del wl[L:]
    return np.array(order, np.int32), np.array(vis_d, np.float32)


def greedy_search(
    data: np.ndarray,
    adjacency: np.ndarray | torch.Tensor,
    start: int,
    query: np.ndarray,
    L: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Public GreedySearch(s, q, L): (visited_ids, visited_dists).

    The build-time beam search, for a consolidation pass that links freshly
    inserted points the way `build_vamana` links each point. Data and query
    must be finite.
    """
    return _greedy_search_build(_host(data), _host(adjacency), start, query, L)


def robust_prune(
    data: np.ndarray,
    p: int,
    cand_ids: np.ndarray,
    cand_dists: np.ndarray,
    alpha: float,
    R: int,
) -> np.ndarray:
    """RobustPrune(p, V, α, R) (DiskANN Algorithm 2).

    Greedily keep the closest candidate p*, then discard every remaining
    candidate x with α·d(p*, x) <= d(p, x) -- the α rule that creates the
    long-range edges BANG's search relies on (paper §2.2, §4.4).
    """
    mask = cand_ids != p
    cand_ids, cand_dists = cand_ids[mask], cand_dists[mask]
    cand_ids, uniq = np.unique(cand_ids, return_index=True)
    cand_dists = cand_dists[uniq]
    order = np.argsort(cand_dists, kind="stable")
    cand_ids, cand_dists = cand_ids[order], cand_dists[order]

    result = np.empty(R, np.int32)
    count = 0
    while cand_ids.size and count < R:
        p_star = int(cand_ids[0])
        result[count] = p_star
        count += 1
        if cand_ids.size == 1:
            break
        rest_ids, rest_d = cand_ids[1:], cand_dists[1:]
        diff = data[rest_ids] - data[p_star][None, :]
        d_star = np.einsum("nd,nd->n", diff, diff)
        # Distances are squared L2 throughout; the α rule in squared space
        # uses α² to stay equivalent to DiskANN's metric-space formulation.
        keep = (alpha * alpha) * d_star > rest_d
        cand_ids, cand_dists = rest_ids[keep], rest_d[keep]
    return result[:count]


def build_vamana(
    data: np.ndarray,
    R: int = 32,
    L: int = 64,
    alpha: float = 1.2,
    *,
    seed: int = 0,
    two_pass: bool = True,
) -> VamanaGraph:
    """Construct a Vamana graph over (n, d) float data, on the host.

    Follows DiskANN: random-regular init, then one pass with α=1 and one
    with the target α (two_pass), inserting points in random order; each
    insertion runs GreedySearch from the medoid, RobustPrunes the visited
    set and the current out-list into the point's out-list, and patches
    reverse edges (pruning overfull nodes). The data must be finite: the
    worklist orders distances as Python floats, where NaN has no order.
    """
    data = np.asarray(data, np.float32)
    if not np.isfinite(data).all():
        raise ValueError("build_vamana needs finite data")
    n = data.shape[0]
    rng = np.random.default_rng(seed)
    R = min(R, n - 1)

    # Random R-regular initial out-edges (no self-loops).
    adjacency = np.full((n, R), -1, np.int32)
    init = rng.integers(0, n - 1, size=(n, R))
    init = init + (init >= np.arange(n)[:, None])  # skip self
    adjacency[:, :] = init.astype(np.int32)

    med = find_medoid(data)

    passes = [1.0, alpha] if two_pass else [alpha]
    for a in passes:
        for p in rng.permutation(n).tolist():
            vis_ids, vis_d = _greedy_search_build(data, adjacency, med, data[p], L)
            own = adjacency[p]
            own = own[own >= 0]
            if own.size:
                own_d = _dists_to(data, own, data[p])
                vis_ids = np.concatenate([vis_ids, own])
                vis_d = np.concatenate([vis_d, own_d])
            pruned = robust_prune(data, p, vis_ids, vis_d, a, R)
            adjacency[p, :] = -1
            adjacency[p, : pruned.size] = pruned
            # Reverse edges: b -> p for every new neighbour b; a full row
            # is pruned over its entries and p.
            for b in pruned.tolist():
                row = adjacency[b]
                if (row == p).any():
                    continue
                free = np.flatnonzero(row < 0)
                if free.size:
                    adjacency[b, free[0]] = p
                else:
                    cand = np.concatenate([row, [p]]).astype(np.int32)
                    cd = _dists_to(data, cand, data[b])
                    newrow = robust_prune(data, b, cand, cd, a, R)
                    adjacency[b, :] = -1
                    adjacency[b, : newrow.size] = newrow

    return VamanaGraph(adjacency=torch.from_numpy(adjacency), medoid=med)


def build_fully_connected(n: int) -> VamanaGraph:
    """Degenerate complete graph -- search on it must be exhaustive-exact.

    Row i lists i+1, ..., n-1, 0, ..., i-1 (no self-loop). Exact-distance
    BANG on it with t >= n has recall 1 by construction.
    """
    adj = (np.arange(n)[:, None] + 1 + np.arange(n - 1)[None, :]) % n
    return VamanaGraph(adjacency=torch.from_numpy(adj.astype(np.int32)), medoid=0)
