"""ANN serving entrypoint (the paper's production workload).

The port of the reference package's `launch/serve.py`. The single-device
mode builds an index (PQ on the device, the Vamana graph on the host) and
answers batched queries with the three-stage pipeline, printing each
batch's QPS (host clock, the batch's results on the host) and recall@10
against brute force:

    PYTHONPATH=src python -m repro_torch.launch.serve --n 4000 --batch-size 128
    PYTHONPATH=src python -m repro_torch.launch.serve --n 400 --device cpu

`--dryrun-sharded` runs the pod-scale sharded search shape-only instead
(`launch.dryrun.sharded_search_dryrun`): the reference's shapes (n =
2,000,000, d = 96, B = 10,240) on a fake 2 x 16 x 16 process group, the
codes, the graph and the vectors over `model`, the queries over (`pod`,
`data`). It prints the bytes a rank holds and the collectives of one hop,
estimates from shapes, not measurements.

    PYTHONPATH=src python -m repro_torch.launch.serve --dryrun-sharded
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def serve(n: int = 4000, dim: int = 64, batch_size: int = 128, batches: int = 3, t: int = 64,
          device: str = "cuda") -> list[dict]:
    """Build the index over `gaussian_mixture(n, dim, n_clusters=48)` and
    search `batches` batches of held-near queries: one dict a batch
    (`batch`, `qps`, `recall_at_10`, `wall_s`)."""
    import numpy as np

    from repro_torch import BangIndex, SearchConfig, brute_force_knn, recall_at_k
    from repro_torch.data import gaussian_mixture, uniform_queries

    data = gaussian_mixture(n, dim, n_clusters=48, seed=0)
    index = BangIndex.build(data, m=16, R=24, L_build=48, device=device)
    cfg = SearchConfig(t=t, bloom_z=16384)
    out = []
    for b in range(batches):
        q = uniform_queries(data, batch_size, seed=b)
        t0 = time.perf_counter()
        ids, _ = index.search(q, 10, cfg=cfg)
        ids = ids.cpu().numpy()          # waits for the device
        dt = time.perf_counter() - t0
        gt = brute_force_knn(data, q, 10, device=device)
        out.append({"batch": b, "qps": batch_size / dt, "recall_at_10": recall_at_k(np.asarray(ids), gt),
                    "wall_s": dt})
    return out


def main(argv: list[str] | None = None) -> list[dict] | dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-sharded", action="store_true")
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--t", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.dryrun_sharded:
        from repro_torch.launch.dryrun import sharded_search_dryrun

        rec = sharded_search_dryrun()
        print(json.dumps(rec, indent=1))
        if rec["status"] != "ok":
            sys.exit(1)
        return rec

    rows = serve(args.n, args.dim, args.batch_size, args.batches, args.t, args.device)
    for r in rows:
        print(f"batch {r['batch']}: {r['qps']:.0f} QPS recall@10={r['recall_at_10']:.3f}", flush=True)
    return rows


if __name__ == "__main__":
    main()
