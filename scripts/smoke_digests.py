#!/usr/bin/env python3
"""Run a `chip_smoke.py` and print a digest of every search path's results.

    python3 scripts/smoke_digests.py [path/to/chip_smoke.py]

Loads the given script (this checkout's by default; another checkout's
`chip_smoke.py` runs against that checkout's `src/`), wraps its `run_path`
so that each path's ids and distances, batch by batch, are hashed
(SHA-256 of the bytes, in batch order) together with its `n_iters` and
recall@10, and then runs its `main()` unchanged. After the script's own
output it prints one line `DIGESTS {...}`. Two checkouts' lines are equal
where their paths returned the same ids and distances bit for bit, so a
change can be held to its parent's results in one call on the card.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from pathlib import Path


def main() -> int:
    script = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1] / "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", script.resolve())
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    digests = {}
    run_path = smoke.run_path

    def hashed(name, *args, **kwargs):
        res = run_path(name, *args, **kwargs)
        h_ids, h_d = hashlib.sha256(), hashlib.sha256()
        for ids, dists in zip(res["ids"], res["dists"]):
            h_ids.update(ids.cpu().numpy().tobytes())
            h_d.update(dists.cpu().numpy().tobytes())
        digests[name] = dict(ids=h_ids.hexdigest(), dists=h_d.hexdigest(), n_iters=res["n_iters"],
                             recall_at_10=res["recall_at_10"])
        return res

    smoke.run_path = hashed
    rc = smoke.main()
    print("DIGESTS " + json.dumps(digests, sort_keys=True), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
