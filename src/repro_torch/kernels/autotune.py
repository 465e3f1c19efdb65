"""Autotuner for the fused hop: tuning winners as a persisted artifact.

The fused search path has two configuration knobs that ride the pipeline
key: the §4.6 selection flavour (`SearchConfig.eager`) and the codes tile
(`SearchConfig.codes_tile_rows`). The right settings depend on the device,
the batch bucket, the adjacency fan-out R and the PQ subspace count m. This
module makes the tuning a persisted artifact instead of a per-process guess:

  * `autotune_executor(ex, queries)` sweeps the candidate (eager, tile)
    configurations of `queries`' batch bucket by timing real executor
    searches in `kernel_mode="fused"`, and records the bucket's winner.
  * `AutotuneCache` persists winners as JSON keyed by
    `(device kind, bucket, R, m)`. `load()` of a missing, corrupt or
    wrong-version file falls back to an empty cache (defaults) with a
    warning: a bad tuning file can never take serving down.
  * Executors built with `autotune=cache` apply the winner for their
    `(device kind, bucket, R, m)` *before* the pipeline key is formed
    (`SearchExecutor._pipeline`), so the tuned fields ride the key: a
    reloaded file reproduces the same pipeline keys, and differently-tuned
    configurations never share a pipeline.

The device kind is `torch.cuda.get_device_name` for a card and "cpu"
otherwise, so tunings never migrate across cards. On the card the hop kernel
reads code rows from global memory at any n: there is no on-chip placement
to decide, `codes_tile_rows` changes no bit (`kernels/search_step/ops.py`),
and `default_tile_candidates` sweeps 0 alone. The kernels' block shapes
(`TRAVERSE_WARPS`, `SORT_ROWS`, `SHARED_TABLE_MIN_R`) are chosen by regime
in their wrappers and are not tuned here. The reference's latency-hiding
XLA flags (`setup_xla_flags`, `LATENCY_HIDING_XLA_FLAGS`) configure XLA's
scheduler and have no counterpart in the port.

Schema (version 1)::

    {"version": 1,
     "winners": {"<device kind>|bucket=<B>|R=<R>|m=<m>":
                 {"eager": bool, "codes_tile_rows": int,
                  "per_hop_us": float}}}
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from pathlib import Path
from typing import Any

import torch

from .common import resolve_device

__all__ = [
    "SCHEMA_VERSION",
    "AutotuneCache",
    "autotune_key",
    "autotune_executor",
    "device_kind",
    "default_tile_candidates",
]

SCHEMA_VERSION = 1

# Winner entries carry exactly these fields with these types (bool is
# checked before int: isinstance(True, int) holds).
_WINNER_FIELDS = (
    ("eager", bool),
    ("codes_tile_rows", int),
    ("per_hop_us", (int, float)),
)


def device_kind(device: str | torch.device = "cuda") -> str:
    """The device kind the winners are keyed by: the card's name for a CUDA
    device, "cpu" otherwise. Raises when `device` is CUDA and no card
    exists."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def autotune_key(dev_kind: str, bucket: int, R: int, m: int) -> str:
    """The JSON winner key: `(device kind, bucket, R, m)` flattened."""
    return f"{dev_kind}|bucket={int(bucket)}|R={int(R)}|m={int(m)}"


def _validate_winner(key: str, entry: Any) -> dict:
    if not isinstance(entry, dict):
        raise ValueError(f"winner {key!r} must be an object, got {entry!r}")
    out = {}
    for field, typ in _WINNER_FIELDS:
        if field not in entry:
            raise ValueError(f"winner {key!r} missing field {field!r}")
        v = entry[field]
        if typ is int and isinstance(v, bool):
            raise ValueError(f"winner {key!r} field {field!r} must be int")
        if not isinstance(v, typ):
            raise ValueError(
                f"winner {key!r} field {field!r} has type {type(v).__name__}, expected {typ}"
            )
        out[field] = v
    if out["codes_tile_rows"] < 0:
        raise ValueError(f"winner {key!r}: codes_tile_rows must be >= 0")
    return out


class AutotuneCache:
    """Persisted tuning winners, keyed (device kind, bucket, R, m).

    Hashed by identity (no __eq__): `BangIndex.executor` caches executors per
    configuration object, and two caches with equal contents still denote
    two tuning artifacts.
    """

    def __init__(self, winners: dict[str, dict] | None = None) -> None:
        self.winners: dict[str, dict] = {}
        # Every candidate's per-hop times of the last `autotune_executor`
        # sweep recorded here (not persisted).
        self.last_sweep: list[dict] = []
        for k, v in (winners or {}).items():
            self.winners[str(k)] = _validate_winner(str(k), v)

    # ------------------------------------------------------------ persistence
    @classmethod
    def load(cls, path: str | os.PathLike, *, strict: bool = False) -> "AutotuneCache":
        """Load winners from JSON; fall back to defaults on any defect.

        A missing, unreadable, wrong-version or schema-violating file gives
        an *empty* cache (executors then serve with default configurations)
        and a warning -- unless `strict=True`, which raises instead.
        """
        try:
            raw = json.loads(Path(path).read_text())
            if not isinstance(raw, dict):
                raise ValueError("top level must be an object")
            if raw.get("version") != SCHEMA_VERSION:
                raise ValueError(
                    f"unsupported version {raw.get('version')!r}, expected {SCHEMA_VERSION}"
                )
            winners = raw.get("winners")
            if not isinstance(winners, dict):
                raise ValueError("'winners' must be an object")
            return cls(winners)
        except (OSError, ValueError, TypeError, KeyError) as e:
            if strict:
                raise
            warnings.warn(f"autotune cache {path}: {e}; falling back to default kernel configs",
                          stacklevel=2)
            return cls()

    def save(self, path: str | os.PathLike) -> None:
        Path(path).write_text(json.dumps(
            {"version": SCHEMA_VERSION, "winners": self.winners}, indent=2, sort_keys=True,
        ))

    # ----------------------------------------------------------------- access
    def put(self, dev_kind: str, bucket: int, R: int, m: int, *,
            eager: bool, codes_tile_rows: int, per_hop_us: float) -> None:
        key = autotune_key(dev_kind, bucket, R, m)
        self.winners[key] = _validate_winner(key, {
            "eager": bool(eager),
            "codes_tile_rows": int(codes_tile_rows),
            "per_hop_us": float(per_hop_us),
        })

    def lookup(self, dev_kind: str, bucket: int, R: int, m: int) -> dict | None:
        return self.winners.get(autotune_key(dev_kind, bucket, R, m))

    def apply(self, cfg, dev_kind: str, bucket: int, R: int, m: int):
        """The winning SearchConfig for this shape, or `cfg` untouched.

        Executors call this *before* forming the pipeline key, so the tuned
        fields key the pipeline: reloading a saved file reproduces the same
        keys.
        """
        w = self.lookup(dev_kind, bucket, R, m)
        if w is None:
            return cfg
        return dataclasses.replace(cfg, eager=bool(w["eager"]),
                                   codes_tile_rows=int(w["codes_tile_rows"]))

    def __len__(self) -> int:
        return len(self.winners)


# --------------------------------------------------------------------- sweep
def default_tile_candidates(n: int, m: int) -> tuple[int, ...]:
    """Candidate `codes_tile_rows` values for an (n, m) codes block: 0 alone,
    at any n. The card's hop kernel gathers code rows from global memory, so
    there is no placement or tile axis to sweep (module docstring)."""
    return (0,)


def autotune_executor(
    ex,
    queries,
    *,
    k: int = 10,
    t: int = 32,
    cfg=None,
    tile_candidates: tuple[int, ...] | None = None,
    eager_options: tuple[bool, ...] = (True, False),
    repeats: int = 2,
    cache: AutotuneCache | None = None,
) -> AutotuneCache:
    """Sweep fused configurations on real searches; record the winner.

    Times `ex.search(..., kernel_mode="fused")` for every (eager,
    codes_tile_rows) candidate on `queries`' batch bucket (one warm-up call
    per candidate pays its set-up, then `repeats` timed calls; the best
    per-hop wall time wins) and stores the winner under (device kind,
    bucket, R, m) in `cache` (a fresh one when not given). Returns the
    cache: `save()` it and hand the reloaded file to executors with
    `autotune=`. Each candidate's per-hop times are kept in
    `cache.last_sweep`.
    """
    import numpy as np

    from repro_torch.core.search import SearchConfig

    cache = cache if cache is not None else AutotuneCache()
    queries = np.asarray(queries, np.float32)
    cfg = cfg or SearchConfig(t=max(t, k))
    bucket = ex._bucket_for(queries.shape[0])
    R, m, block_rows = ex.autotune_shape()
    if tile_candidates is None:
        tile_candidates = default_tile_candidates(block_rows, m)
    dk = device_kind(ex.device)
    best = None
    sweep = []
    # The sweep must measure each *explicit* candidate: suspend the
    # executor's own winner (it would clamp every candidate to itself).
    saved_autotune = ex._autotune
    ex._autotune = None
    try:
        for eager in eager_options:
            for tile in tile_candidates:
                c = dataclasses.replace(cfg, kernel_mode="fused", eager=eager, codes_tile_rows=tile)
                ex.search(queries, k, t=t, cfg=c)      # warm-up (builds the pipeline)
                per_hop = []
                for _ in range(max(repeats, 1)):
                    _, _, stats = ex.search(queries, k, t=t, cfg=c, return_stats=True)
                    per_hop.append(stats.wall_s / max(stats.n_iters, 1) * 1e6)
                score = min(per_hop)
                sweep.append({"eager": eager, "codes_tile_rows": tile, "per_hop_us": per_hop})
                if best is None or score < best[0]:
                    best = (score, eager, tile)
    finally:
        ex._autotune = saved_autotune
    score, eager, tile = best
    cache.put(dk, bucket, R, m, eager=eager, codes_tile_rows=tile, per_hop_us=score)
    cache.last_sweep = sweep
    return cache
