#!/usr/bin/env python3
"""Where host threads cost the port time: the host-I/O workers and the
serve pipeline's dispatch thread against the search thread's hop loop.

    python3 scripts/probe_host_threads.py [--n 1000000] [--batches 4] [--device cuda]

Builds `chip_smoke.py`'s harness index on the card (its corpus, PQ and
harness graph at n points, d = 128, m = 32, R = 64), then times batches of
1,024 (host clock around each synchronised batch, a warm-up batch first)
through: plain base; host-I/O base with four workers and prefetch (and with
one worker and prefetch); inmem one batch at a time, on the main thread and
on one other thread (the main thread waiting); and `ServePipeline` over
inmem, with and without ground truth and a result cache (the caller's
bookkeeping). Each threaded configuration runs at the interpreter's default
switch interval (5 ms) and at 0.05 ms (`sys.setswitchinterval`, restored
after): a GIL handed between threads waits up to the interval, so a time
that falls with it is time spent waiting for the interpreter lock. Prints
one line per run and a JSON summary. `--device cpu` rehearses the script
at a small --n (the plain versions; no device time).

`--timeline` instead times the pieces of each hop of one batch, host clock
at each edge, for host-I/O base with one worker, synchronous and
prefetched: on the search thread the fetch, the step between the fetch and
the issue (bloom filter and K1 launches), the issue, and the rest of the hop
(history launches); on the worker the wait to be woken, the request's
resolution (the wait on the frontier's copy and the masks) and the gather.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeline", action="store_true")
    args = ap.parse_args()
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("probe_host_threads: no CUDA device is available", file=sys.stderr)
        return 1
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch import BangIndex, SearchConfig
    from repro_torch.core import pq
    from repro_torch.data import gaussian_mixture
    from repro_torch.runtime import HostIOConfig, ServePipeline

    card = smoke.card_line() if dev.type == "cuda" else "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    B, nb = smoke.BATCH, args.batches
    both = gaussian_mixture(args.n + B * (nb + 1), smoke.D, seed=smoke.SEED, intrinsic_dim=smoke.INTRINSIC_DIM)
    data, queries = both[: args.n], both[args.n:]
    x = torch.from_numpy(data).to(dev)
    codec = pq.train_pq(x, smoke.M)
    codes = pq.pq_encode(codec, x)
    adj, medoid = smoke.harness_graph(x, smoke.R, smoke.SEED)
    index = BangIndex.from_arrays(codec.codebooks, codes, adj, medoid, x, device=dev)
    del adj
    gt = np.zeros((len(queries), smoke.K), np.int64)     # recall is not read here
    cfg = SearchConfig()
    print(f"[probe] harness index n={args.n} on {card}; {nb} batches of {B}", flush=True)
    out = {}

    def batches(variant, hio=None):
        index.search(queries[:B], smoke.K, cfg=cfg, variant=variant, kernel_mode="fused", hostio=hio)
        sync()
        t0 = time.perf_counter()
        for b in range(nb):
            index.search(queries[b * B:(b + 1) * B], smoke.K, cfg=cfg, variant=variant,
                         kernel_mode="fused", hostio=hio)
        sync()
        return nb * B / (time.perf_counter() - t0)

    def pipeline(variant, hio=None, bookkeeping=True):
        ex = index.executor(variant, hostio=hio)
        with ServePipeline(ex, k=smoke.K, cfg=cfg, max_batch=B, kernel_mode="fused",
                           result_cache_size=nb * B if bookkeeping else 0) as pipe:
            pipe.submit(queries[:B])
            pipe.drain()                      # warm-up
            pipe.submit(queries[B:B + nb * B], gt_ids=gt[:nb * B] if bookkeeping else None)
            _, _, st = pipe.drain()
        return st.qps, st.p50_ms

    def at_interval(interval, fn, *a, **kw):
        old = sys.getswitchinterval()
        sys.setswitchinterval(interval)
        try:
            return fn(*a, **kw)
        finally:
            sys.setswitchinterval(old)

    def on_a_thread(fn, *a):
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(1) as pool:
            return pool.submit(fn, *a).result()

    if args.timeline:
        out = {name: timeline(index, queries[:B], cfg, smoke.K, HostIOConfig(workers=1, prefetch=p), sync)
               for name, p in (("base-hostio-w1", False), ("base-hostio-w1-p", True))}
        print(json.dumps({"card": card, "n": args.n, "timeline": out}))
        return 0

    runs = [("base", lambda: batches("base")),
            ("inmem", lambda: batches("inmem")),
            ("inmem-on-a-thread", lambda: on_a_thread(batches, "inmem")),
            ("base-on-a-thread", lambda: on_a_thread(batches, "base"))]
    for interval in (5e-3, 5e-5):
        tag = f"@{interval * 1e3:g}ms"
        runs += [
            (f"base-hostio-w4-p{tag}", lambda i=interval: at_interval(
                i, batches, "base", HostIOConfig(workers=4, prefetch=True))),
            (f"base-hostio-w1-p{tag}", lambda i=interval: at_interval(
                i, batches, "base", HostIOConfig(workers=1, prefetch=True))),
            (f"base-hostio-w1{tag}", lambda i=interval: at_interval(
                i, batches, "base", HostIOConfig(workers=1))),
            (f"serve-inmem{tag}", lambda i=interval: at_interval(i, pipeline, "inmem")),
            (f"serve-inmem-no-bookkeeping{tag}", lambda i=interval: at_interval(
                i, pipeline, "inmem", bookkeeping=False)),
        ]
    for name, fn in runs:
        res = fn()
        qps, p50 = res if isinstance(res, tuple) else (res, None)
        out[name] = {"qps": qps, "p50_ms": p50}
        print(f"[probe] {name}: QPS {qps:.1f}" + ("" if p50 is None else f", p50 {p50:.1f} ms"),
              flush=True)
    for ex in list(index._executors.values()):
        if getattr(ex, "hostio_runtime", None) is not None:
            ex.hostio_runtime.stop()
    print(json.dumps({"card": card, "n": args.n, "batches": nb, "runs": out}))
    return 0


def timeline(index, q, cfg, k, hio, sync) -> dict:
    """Mean ms a hop of each piece of one batch (see the module docstring)."""
    import time as _t

    from repro_torch.runtime.hostio import prefetch as pf, service as sv

    ex = index.executor("base", hostio=hio)
    index.search(q, k, cfg=cfg, variant="base", kernel_mode="fused", hostio=hio)   # warm-up
    sync()
    marks: list[tuple[str, float]] = []
    real_fetch, real_issue = pf.HostExchange.fetch, ex._prefetch_fn
    real_issue_lazy, real_gather = sv.NeighborService.issue_lazy, sv.NeighborService._gather

    def fetch(self, *a, **kw):
        marks.append(("fetch0", _t.perf_counter()))
        try:
            return real_fetch(self, *a, **kw)
        finally:
            marks.append(("fetch1", _t.perf_counter()))

    def issue(*a, **kw):
        marks.append(("issue0", _t.perf_counter()))
        try:
            return real_issue(*a, **kw)
        finally:
            marks.append(("issue1", _t.perf_counter()))

    def issue_lazy(self, shard, resolve, **kw):
        def timed():
            marks.append(("resolve0", _t.perf_counter()))
            try:
                return resolve()
            finally:
                marks.append(("resolve1", _t.perf_counter()))
        return real_issue_lazy(self, shard, timed, **kw)

    def gather(self, *a, **kw):
        marks.append(("gather0", _t.perf_counter()))
        try:
            return real_gather(self, *a, **kw)
        finally:
            marks.append(("gather1", _t.perf_counter()))

    pf.HostExchange.fetch = fetch
    if real_issue is not None:
        ex._prefetch_fn = issue       # the executor holds the exchange's bound issue
    sv.NeighborService.issue_lazy, sv.NeighborService._gather = issue_lazy, gather
    try:
        t0 = _t.perf_counter()
        index.search(q, k, cfg=cfg, variant="base", kernel_mode="fused", hostio=hio)
        sync()
        wall = _t.perf_counter() - t0
    finally:
        pf.HostExchange.fetch, ex._prefetch_fn = real_fetch, real_issue
        sv.NeighborService.issue_lazy, sv.NeighborService._gather = real_issue_lazy, real_gather
    ex.hostio_runtime.stop()
    by = {}
    for name, t in marks:
        by.setdefault(name, []).append(t)
    f0, f1 = np.array(by["fetch0"]), np.array(by["fetch1"])
    hops = len(f0) - 1                       # the last fetch finds no active lane
    res = {"hops": hops, "batch_wall_ms": wall * 1e3,
           "hop_ms": float(np.mean(np.diff(f0))) * 1e3,
           "fetch_ms": float(np.mean(f1 - f0)) * 1e3}
    if "issue0" in by:
        i0, i1 = np.array(by["issue0"]), np.array(by["issue1"])     # warm-start first
        res["fetch_to_issue_ms"] = float(np.mean(i0[1:hops + 1] - f1[:hops])) * 1e3
        res["issue_ms"] = float(np.mean(i1 - i0)) * 1e3
        res["issue_to_next_fetch_ms"] = float(np.mean(f0[1:hops + 1] - i1[1:hops + 1])) * 1e3
        g0, g1 = np.array(by["gather0"]), np.array(by["gather1"])
        if "resolve0" in by:                 # a CUDA index: the lazy issue
            r0, r1 = np.array(by["resolve0"]), np.array(by["resolve1"])
            n = min(len(i1), len(r0), len(g1))
            res["worker_wake_ms"] = float(np.mean(r0[:n] - i1[:n])) * 1e3
            res["worker_resolve_ms"] = float(np.mean(r1[:n] - r0[:n])) * 1e3
        n = min(len(g1), hops)
        res["worker_gather_ms"] = float(np.mean(g1[:n] - g0[:n])) * 1e3
        res["gather_done_before_collect_share"] = float(np.mean(g1[:n] < f0[1:n + 1]))
    else:
        res["between_fetches_ms"] = float(np.mean(f0[1:hops + 1] - f1[:hops])) * 1e3
    print(f"[timeline] {hio}: " + ", ".join(f"{k_} {v:.4f}" for k_, v in res.items()), flush=True)
    return res


if __name__ == "__main__":
    sys.exit(main())
