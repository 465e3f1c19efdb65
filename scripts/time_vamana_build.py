#!/usr/bin/env python3
"""Time one Vamana graph build on this host.

    python3 scripts/time_vamana_build.py --case cell --n 10000          # the port's build
    python3 scripts/time_vamana_build.py --case fixture --impl reference

`--impl port` (the default) builds with `repro_torch.core.vamana`,
`--impl reference` with the JAX package's `repro.core.vamana` (which
imports JAX); each run imports only the package it times. Cases:

  fixture   the tests' shared index: gaussian_mixture(1200, 32, 24
            clusters, seed 3), R=16, L=24, alpha 1.2, seed 0;
  d128      tests/test_torch_vamana.py's d=128 set: gaussian_mixture(300,
            128, 8 clusters, seed 7), R=32, L=64, seed 1, both passes;
  d128-one  the same with one pass;
  cell      chip_smoke.py's Vamana cell: gaussian_mixture(n, 128, seed 0,
            intrinsic_dim 16), R=64, L=128, seed 0.

Prints the build's seconds, the ms a point and pass, the degree stats and a
SHA-256 of the adjacency (equal across the two implementations).
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

CASES = {
    "fixture": (dict(n=1200, d=32, n_clusters=24, seed=3), dict(R=16, L=24, seed=0)),
    "d128": (dict(n=300, d=128, n_clusters=8, seed=7), dict(R=32, L=64, seed=1)),
    "d128-one": (dict(n=300, d=128, n_clusters=8, seed=7), dict(R=32, L=64, seed=1, two_pass=False)),
    "cell": (dict(n=10_000, d=128, seed=0, intrinsic_dim=16), dict(R=64, L=128, seed=0)),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", choices=sorted(CASES), default="cell")
    ap.add_argument("--impl", choices=("port", "reference"), default="port")
    ap.add_argument("--n", type=int, default=None, help="points (cell case only)")
    args = ap.parse_args()
    data_kw, build_kw = (dict(kw) for kw in CASES[args.case])
    if args.n is not None:
        if args.case != "cell":
            ap.error("--n applies to the cell case only")
        data_kw["n"] = args.n
    if args.impl == "port":
        from repro_torch.core.vamana import build_vamana
        from repro_torch.data import gaussian_mixture
    else:
        from repro.core.vamana import build_vamana
        from repro.data import gaussian_mixture
    import numpy as np

    n, d = data_kw.pop("n"), data_kw.pop("d")
    x = gaussian_mixture(n, d, **data_kw)
    t0 = time.perf_counter()
    g = build_vamana(x, alpha=1.2, **build_kw)
    dt = time.perf_counter() - t0
    adj = np.asarray(g.adjacency)
    passes = 2 if build_kw.get("two_pass", True) else 1
    mean_deg, max_deg = g.degree_stats()
    print(f"{args.impl} {args.case} n={n} d={d} {build_kw}: build {dt:.2f} s, "
          f"{dt / (passes * n) * 1e3:.3f} ms a point and pass; degree mean {mean_deg:.4f} max {max_deg}; "
          f"medoid {g.medoid}; adjacency sha256 {hashlib.sha256(adj.tobytes()).hexdigest()[:16]}; "
          f"{os.cpu_count()} cpus")
    return 0


if __name__ == "__main__":
    sys.exit(main())
