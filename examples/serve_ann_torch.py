"""Streaming ANN serving on the PyTorch/CUDA port (`repro_torch`).

Builds an index with `BangIndex.build` (PQ on the device, the Vamana graph
on the host), then serves batches of queries through `ServePipeline`: the
queue drains in micro-batches of at most `--max-batch` rows, each dispatched
on the pipeline's own thread while the previous one is finished, and the
server reports QPS, latency percentiles and recall@k against brute force.

`--variant base` keeps the graph and the full vectors in pinned host memory
(BANG Base); `--host-workers N` serves its adjacency through the host-I/O
subsystem (`repro_torch.runtime.hostio`: N gather threads), `--hot-cache-rows
H` pins the H highest-in-degree adjacency rows on the device, and
`--prefetch` starts hop k+1's gather while hop k finishes. The sharded
variants run on a one-rank mesh. `--result-cache N` turns on the pipeline's
query-result LRU; `--max-queue` and `--deadline-ms` its admission control.

`--autotune` sweeps the fused path's configurations (eager and lazy §4.6
selection) on real searches before serving and saves the winners to
`--autotune-cache` (JSON keyed by device kind, bucket, R, m); a winners file
that already exists is applied even without the sweep, and a missing or
corrupt one falls back to the default configuration with a warning.

`--mutate` wraps the index in a `MutableBangIndex`
(`repro_torch.runtime.mutation`) and puts a few deletes and inserts before
every serving batch, with a background consolidation halfway through; recall
is scored against the live corpus.

    PYTHONPATH=src python examples/serve_ann_torch.py --variant base \\
        --host-workers 4 --hot-cache-rows 512 --prefetch
    PYTHONPATH=src python examples/serve_ann_torch.py --device cpu --n 1500 --dim 32
    PYTHONPATH=src python examples/serve_ann_torch.py --mutate --result-cache 256
"""
import argparse
import os

MUTABILITY = """\
streaming mutability (--mutate): the cache-invalidation contract

    cache                    scope     invalidated by
    -----------------------  --------  --------------------------------
    ServePipeline result     epoch     every insert()/delete()/
    LRU (--result-cache)               consolidate() bumps the epoch;
                                       the next drain drops the LRU, so
                                       a hit can never return a deleted
                                       id or miss a fresh insert
    search pipelines         gen       consolidation bumps the
    (per-bucket cache)                 generation; executors are rebuilt
                                       from the new snapshot and the old
                                       pipelines are dropped
    host-I/O hot-adjacency   gen       retiring caches are refresh()ed
    cache (--hot-cache-rows)           with the consolidated rows

Consolidation guarantees: deleted ids never come back (slots are retired,
ids never reused); inserted ids are stable across the fold (delta ids are
base_n + ordinal); searches racing the background fold stay correct -- the
delete bitmap and the exact delta scan cover the gap until the generation
swap.
"""


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], epilog=MUTABILITY,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=6000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--m", type=int, default=16, help="PQ subspaces")
    ap.add_argument("--R", type=int, default=32, help="graph degree")
    ap.add_argument("--L-build", type=int, default=64)
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--t", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=128,
                    help="micro-batch size the pipeline drains into")
    ap.add_argument("--variant", default="inmem",
                    choices=["base", "inmem", "exact", "sharded", "sharded-base"])
    ap.add_argument("--kernel-mode", default=None, choices=["reference", "staged", "fused"],
                    help="default: fused on a CUDA device, reference on the CPU")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--host-workers", type=int, default=0,
                    help="serve the host graph through the host-I/O subsystem with N "
                         "gather threads (base/sharded-base only; 0 = inline gathers)")
    ap.add_argument("--hot-cache-rows", type=int, default=0,
                    help="pin the H highest-in-degree adjacency rows on the device "
                         "(requires --host-workers >= 1)")
    ap.add_argument("--prefetch", action="store_true",
                    help="prefetch the frontier exchange (requires --host-workers >= 1)")
    ap.add_argument("--result-cache", type=int, default=0,
                    help="ServePipeline query-result LRU size (0 = off)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="shed submissions past this backlog (0 = unbounded)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request deadline; expired rows are dropped at dispatch (0 = none)")
    ap.add_argument("--autotune", action="store_true",
                    help="sweep the fused path's configurations on real searches before "
                         "serving and save the winners to --autotune-cache")
    ap.add_argument("--autotune-cache", default="bang_autotune.json",
                    help="JSON winners file keyed by (device kind, bucket, R, m); applied when "
                         "it exists (default: %(default)s)")
    ap.add_argument("--mutate", action="store_true",
                    help="serve through a MutableBangIndex with deletes and inserts before "
                         "every batch and a background consolidation halfway through")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.mutate and args.autotune:
        ap.error("--autotune does not combine with --mutate (tune first, then serve mutably)")
    if (args.hot_cache_rows or args.prefetch) and not args.host_workers:
        ap.error("--hot-cache-rows and --prefetch need --host-workers >= 1")

    import torch.distributed as dist

    import numpy as np

    from repro_torch import BangIndex, SearchConfig, brute_force_knn
    from repro_torch.data import gaussian_mixture, uniform_queries
    from repro_torch.kernels.autotune import AutotuneCache, autotune_executor, device_kind
    from repro_torch.runtime import HostIOConfig, MutableBangIndex, ServePipeline

    hostio = None
    if args.host_workers:
        if args.variant not in ("base", "sharded-base"):
            ap.error("--host-workers applies to the host-graph variants base and sharded-base")
        hostio = HostIOConfig(workers=args.host_workers, hot_cache_rows=args.hot_cache_rows,
                              prefetch=args.prefetch)
    data = gaussian_mixture(args.n, args.dim, seed=args.seed)
    index = BangIndex.build(data, m=args.m, R=args.R, L_build=args.L_build, seed=args.seed,
                            device=args.device)
    print(f"[serve] index: n={args.n} d={args.dim} m={args.m} R={args.R} on {index.device}")
    made_group = args.variant.startswith("sharded") and not dist.is_initialized()
    autotune = None
    if args.autotune or os.path.exists(args.autotune_cache):
        autotune = (AutotuneCache.load(args.autotune_cache) if os.path.exists(args.autotune_cache)
                    else AutotuneCache())
    mut = None
    if args.mutate:
        mut = MutableBangIndex(index)
        executor = mut.executor(args.variant, hostio=hostio)
    else:
        executor = index.executor(args.variant, hostio=hostio, autotune=autotune)
    cfg = SearchConfig(t=max(args.t, args.k))
    if args.autotune:
        tune_q = uniform_queries(data, min(args.batch_size, args.max_batch), seed=99)
        print(f"[serve] autotuning the fused path on {device_kind(index.device)} "
              f"(bucket for batch {len(tune_q)}) ...")
        autotune_executor(executor, tune_q, k=args.k, t=args.t, cfg=cfg, cache=autotune)
        autotune.save(args.autotune_cache)
        for key, w in autotune.winners.items():
            print(f"[serve]   winner {key}: eager={w['eager']} codes_tile_rows="
                  f"{w['codes_tile_rows']} ({w['per_hop_us']:.0f} us/hop)")
        print(f"[serve] winners saved to {args.autotune_cache}")
    if hostio is not None:
        print(f"[serve] host-I/O: {hostio.workers} worker(s), hot cache {hostio.hot_cache_rows} "
              f"rows, prefetch {'on' if hostio.prefetch else 'off'}")

    def on_batch(rep) -> None:
        recall = "" if rep.recall is None else f", recall@{args.k}={rep.recall:.3f}"
        print(f"[serve] batch {rep.index}: {rep.size} queries in {rep.wall_s * 1e3:.1f} ms"
              f"{recall}")

    try:
        with ServePipeline(executor, k=args.k, cfg=cfg, max_batch=args.max_batch,
                           kernel_mode=args.kernel_mode, result_cache_size=args.result_cache,
                           max_queue=args.max_queue, deadline_s=args.deadline_ms / 1e3) as pipe:
            if mut is None:
                for b in range(args.batches):
                    queries = uniform_queries(data, args.batch_size, seed=100 + b)
                    gt = brute_force_knn(data, queries, args.k, device=args.device)
                    pipe.submit(queries, gt_ids=gt)
                _, _, stats = pipe.drain(on_batch=on_batch)
                total_queries = stats.queries
            else:
                # Each batch follows a few deletes and inserts (recall scored
                # against the live corpus); a background consolidation starts
                # halfway through.
                rng = np.random.default_rng(args.seed)
                medoid = index.graph.medoid
                consolidation = None
                total_queries = 0
                for b in range(args.batches):
                    live_ids, _ = mut.live_points()
                    mut.delete([int(v) for v in rng.choice(live_ids, 4, replace=False)
                                if int(v) != medoid])
                    fresh = data[rng.integers(len(data), size=4)]
                    mut.insert(fresh + (rng.integers(-2, 3, fresh.shape) / 100).astype(np.float32))
                    if b == args.batches // 2:
                        consolidation = mut.consolidate_async()
                        print("[serve] background consolidation started")
                    queries = uniform_queries(data, args.batch_size, seed=100 + b)
                    live_ids, live_vecs = mut.live_points()
                    gt = live_ids[brute_force_knn(live_vecs, queries, args.k, device=args.device)]
                    pipe.submit(queries, gt_ids=gt)
                    _, _, stats = pipe.drain(on_batch=on_batch)
                    total_queries += stats.queries
                if consolidation is not None:
                    consolidation.join()
                    if mut.consolidate_error is not None:
                        raise mut.consolidate_error
                mutation = mut.mutation_stats()
    finally:
        if mut is not None:
            mut.close()
        if made_group and dist.is_initialized():
            dist.destroy_process_group()
    recall = "n/a" if stats.mean_recall is None else f"{stats.mean_recall:.3f}"
    print(f"[serve] TOTAL {total_queries} queries, last drain {stats.batches} batches | {stats.qps:.0f} QPS "
          f"(set-up {stats.compile_s:.2f} s excluded)")
    print(f"[serve] latency p50={stats.p50_ms:.1f}ms p95={stats.p95_ms:.1f}ms | mean "
          f"recall@{args.k}={recall} (variant={args.variant})")
    if args.max_queue or args.deadline_ms:
        print(f"[serve] admission control: {stats.shed_queries} shed, {stats.expired_queries} expired")
    if stats.hostio is not None:
        h = stats.hostio
        x = executor.exchange_bytes_per_hop(args.max_batch)
        print(f"[serve] host-I/O: {h['requests']} requests, mean {h['mean_latency_ms']:.3f} ms | "
              f"hot-cache hit rate {h['cache_hit_rate']:.1%} (~{x['host_bytes_saved_per_hop']} "
              f"B/hop saved of {x['host_rows_in_bytes']}) | prefetch overlap "
              f"{h['overlap_fraction']:.1%} ({h['prefetch_hits']} hits, {h['prefetch_misses']} misses)")
    if mut is not None:
        ms = mutation
        print(f"[serve] mutation: epoch {ms['epoch']}, generation {ms['generation']} "
              f"({ms['consolidations']} consolidation(s)), {ms['tombstones']} tombstones "
              f"({ms['tombstone_fraction']:.2%}), {ms['delta_points']} live delta points, "
              f"base_n={ms['base_n']}")
    return {"stats": stats, "variant": args.variant, "autotune": autotune}


if __name__ == "__main__":
    main()
