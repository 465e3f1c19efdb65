#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of BANG on one NVIDIA GPU (H100), end to end.

    python3 chip_smoke.py

Phases, each timed; any failure exits non-zero:

  1. the card: name and power limit (nvidia-smi), TF32 off;
  2. the build: every kernel under src/repro_torch/csrc, compiled with nvcc
     (one process per source, all at once);
  3. kernel vs plain: each CUDA kernel and its plain PyTorch version on the
     same tensors on the card, at the main path's shapes (B=1024, R=64,
     t=64, m=32, n=10**6, d=128, C=104), held bit-equal, with times, bounds
     and a library yardstick where one PyTorch call computes the function:
     K1 fused hop (also timed over the count of fresh lanes a query, with a
     warm table, and with one block per SM), K2 ADC (R=1, the seed, and R=64, the
     staged distances, and both of its regimes, global lookups and a shared
     table, over R: the crossover),
     K3 re-rank distances, K4 bitonic sort (also over rows a block and
     over n, across its two regimes), K5 bitonic merge (also over rows a
     block and over t, across its two regimes), K6 fused traverse (also
     over queries a block and over t, across its two regimes), K7
     owner-shard ADC (4 shards of n/4 rows, one shard of all n, the medoid
     seed at R=1, and over the count of owned lanes a query), K8 PQ
     distance table (also over queries a tile and its two grids, and its
     general regime); and the launch floor, the device time of a one-element
     zero_(), beside every kernel's bound;
  4. the main paths on a synthetic corpus with the shape of SIFT1M (n =
     10**6, d = 128, the ANN_SIFT1M set of the BIGANN/texmex corpus;
     clusters of intrinsic dimension 16, queries held out from the same
     draw), one graph and one index for all of them, batches of 1,024:
     "inmem" (fused), "base" (fused; adjacency and vectors in pinned host
     memory, only codes and codebooks on the card), "exact" (fused
     traverse, no re-rank), the staged kernel mode on one batch, and the
     mesh paths "sharded" and "sharded-base" (fused) on the default (1, 1)
     mesh, a one-rank NCCL group. Each path runs with every launch count set
     to 0 just before it and read just after; each reports recall@10, QPS,
     n_iters, hops, batch walls and the device's idle share. Checks: base
     ids equal inmem ids, staged ids equal fused ids, exact fused ids equal
     exact reference-mode ids, fused ids equal reference-mode ids, sharded
     ids and distances equal inmem's and sharded-base's equal base's on
     every batch (K7 and K6 launched on every hop, two all-reduces a hop),
     and `index.search(q)` with no kernel_mode launches K1. One more inmem
     batch, outside the timed runs, counts the fresh lanes per query of
     every K1 launch (K1's time grows with it). K8, which no
     search path runs, is driven through its own entry point
     (`kernels.pq_table.ops.build_dist_table`) on every batch;
  4b. host I/O and serving, on phase 4's index and queries: base (fused)
     through the host-I/O subsystem in three configurations (one worker,
     the service's synchronous path; four workers with the prefetched
     exchange; and that with 65,536 hot adjacency rows pinned on the card),
     and sharded-base with the last on the one-rank NCCL mesh, ten batches
     each: ids and distances equal to the plain path's on every batch, K1
     (or K7 and K6) on every hop, no prefetch miss, hedge or degraded lane;
     QPS, idle share, overlap fraction, hot-cache hit rate, host-link bytes,
     the service's mean latency, and each hop's host time split into the
     wait for the device, the host gather and the copy up (also for phase
     4's inline base hop). Then `ServePipeline` over inmem and over
     host-I/O base: every query with its ground truth in micro-batches of
     1,024 (QPS, p50/p95 latency, recall equal to the plain path's, ids
     equal), and the first 1,024 again, served bit-identically from the
     result cache;
  5. the Vamana cell: `BangIndex.build` over VAMANA_N points of the same
     draw's shape (d = 128, m = 32, R = 64, L_build = 128, alpha = 1.2):
     PQ trained and encoded on the card, the Vamana graph built on the
     host, each timed; then 1,000 held-out queries through inmem, base and
     exact (fused, t = 64), each with its launch counts set to 0 just
     before it: recall@10 against brute force, mean hops, n_iters, QPS and
     the idle share. Checks: fused ids equal kernel_mode="reference" ids on
     every variant, base ids and distances equal inmem's; and one batch of
     host-I/O base (four workers, 1,500 hot rows, prefetch), ids and
     distances equal base's, with the hot cache's hit rate on this graph;
  6. a small corpus searched on the card and on the CPU, ids equal.

Kernel times are taken cold: the timed calls cycle through copies of the
inputs that together exceed twice the H100's 50 MB L2. Bounds count the bytes the function needs for this run's
data (the 32-byte sectors of the tables that the codes look up, not whole
tables).

Phase 4's graph is a harness graph built here on the card (per point the
R/2 exact nearest neighbours and R/2 seeded random ids): the Vamana build is
a sequential host loop that cannot build n = 10**6 within the run, so the
real graph is phase 5's, at the largest n whose build keeps the script
within about five minutes. The last two lines of output are the card's name
and power limit, then {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

N, D, M, R, T, K = 1_000_000, 128, 32, 64, 64, 10
N_QUERIES, BATCH, SEED = 10_000, 1024, 0
PATH_BATCHES = {"inmem": 10, "base": 10, "exact": 10,   # batches each variant's path runs
                "sharded": 10, "sharded-base": 10}
S_K7 = 4                       # shards of the owner-shard ADC's kernel check
ADC_SWEEP_R = (1, 2, 4, 8, 16, 24, 32, 40, 48, 64)   # K2's two regimes timed at these R: the crossover
LANE_SWEEP = (0, 1, 4, 8, 16, 32, 48, 64)   # K1 and K7 timed at these scored lanes a query
WARPS_SWEEP = (1, 2, 4, 8)     # K6's queries and K4's rows a block, timed at the main shape
TRAVERSE_SWEEP_T = (16, 64, 152, 448, 500)   # K6 and K5 timed at these t (R = 64): P = 128 .. 1024
TABLE_SWEEP_QUERIES = (8, 16, 32, 64, 128)   # K8 timed at these queries a tile
SORT_SWEEP_N = (64, 512, 513, 1000)          # K4 timed at these n: both sides of its regimes
INTRINSIC_DIM = 16             # per-cluster subspace of the synthetic corpus
# The Vamana cell (phase 5): the largest n whose host build keeps the whole
# script within about five minutes (3.6 ms a point and pass at n = 10**4,
# R = 64, L = 128 on the H100 machine's host).
VAMANA_N, VAMANA_QUERIES = 15_000, 1_000
VAMANA_R, VAMANA_L, VAMANA_ALPHA = 64, 128, 1.2
COPIES = 4                     # input copies cycled by timed calls, at least
L2_BYTES = 50 * 2**20          # H100 L2; the copies together exceed twice this
SECTOR = 32                    # bytes: the unit in which the card reads memory
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


_FLUSH: list = []   # the buffer flush_l2 reads, made at its first call


def flush_l2() -> None:
    """Read a buffer of twice the L2, so that no tensor an earlier call
    touched is left in L2 (and no dirty line is left to write back)."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.zeros(2 * L2_BYTES // 4, device="cuda"))
    _FLUSH[0].sum()


def time_ms(fn, arg_sets: list[tuple], reps: int = 20) -> float:
    """Device ms of one call of `fn`: CUDA events around `reps` calls, after
    an L2 flush and a warm-up. Call i takes the arguments
    `arg_sets[i % len(arg_sets)]`, so copies of the inputs that together
    exceed L2 make every call read them from memory; the flush keeps the
    copies an earlier `time_ms` read from being found in L2 (one argument
    set: the warm-up brings it in, so the calls are timed warm). A spin
    kernel holds the device while the host queues the calls, so the events
    time the device's work and not the host's Python between launches."""
    import torch

    args = itertools.cycle(arg_sets)
    flush_l2()
    fn(*next(args))
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)     # about 0.1 s of spinning at the H100's clocks
    a.record()
    for _ in range(reps):
        fn(*next(args))
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def copies(*xs) -> list[tuple]:
    """Argument sets: the tensors themselves, then clones; at least `COPIES`,
    and enough that together they exceed twice the L2, so every timed call
    reads inputs that the calls before it have not brought into L2."""
    size = sum(x.numel() * x.element_size() for x in xs)
    n = max(COPIES, -(-2 * L2_BYTES // size))
    return [xs] + [tuple(x.clone() for x in xs) for _ in range(n - 1)]


def table_sectors(codes, mask) -> int:
    """32-byte sectors of the (B, m, 256) f32 tables that ADC of `codes`
    (B, R, m) reads where `mask` (B, R) holds: the least table traffic."""
    import torch

    B, _, m = codes.shape
    rows = torch.arange(B * m, device=codes.device).reshape(B, 1, m) * (256 * 4 // SECTOR)
    keys = (rows + codes.long() * 4 // SECTOR)[mask]
    hit = torch.zeros(B * m * 256 * 4 // SECTOR, dtype=torch.bool, device=codes.device)
    hit[keys.flatten()] = True
    return int(hit.sum())


def exactly(g, B: int, R: int, f: int, dev):
    """(B, R) bool flags with exactly f set lanes in every row, at random."""
    import torch

    keys = torch.rand((B, R), generator=g, device=dev)
    return keys.argsort(dim=-1).argsort(dim=-1) < f


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def exchanges(n: int, full_sort: bool) -> int:
    """Compare-exchanges of a bitonic network over n (a power of two): the
    whole sort, or its final merge phase only."""
    lg = n.bit_length() - 1
    return n // 2 * (lg * (lg + 1) // 2 if full_sort else lg)


def sorted_by_key(d, i):
    """Rows of (dist, id) in the worklist's order, ascending by (dist, id):
    float32 draws scaled to 5000 tie often enough that sorting by the
    distance alone would leave tied pairs out of order."""
    import torch

    from repro_torch.core.worklist import lex_order

    o = lex_order(d, i)
    return torch.gather(d, -1, o), torch.gather(i, -1, o)


def exact(a, b) -> None:
    import torch

    if not torch.equal(a, b):
        raise AssertionError(f"kernel and plain version differ: {a.flatten()[:8]} vs {b.flatten()[:8]}")


# --------------------------------------------------------------- phase 3
def check_kernels(dev) -> list[dict]:
    import torch

    from repro_torch.core.distributed import _owned_at
    from repro_torch.core.worklist import INVALID_ID, Worklist
    from repro_torch.kernels import common
    from repro_torch.kernels.bitonic import ops as bitonic_ops
    from repro_torch.kernels.pq_adc import ops as adc_ops
    from repro_torch.kernels.pq_table import ops as table_ops
    from repro_torch.kernels.rerank_l2 import ops as rr_ops
    from repro_torch.kernels.search_step import ops as step_ops

    g = torch.Generator(device=dev).manual_seed(SEED)
    # The sweeps' own draws, so that every other kernel sees the inputs of
    # earlier versions of this script.
    g_sweep = torch.Generator(device=dev).manual_seed(SEED + 1)
    g_merge = torch.Generator(device=dev).manual_seed(SEED + 2)   # K5's sweep over t
    B, C = BATCH, int(1.5 * T) + 8
    rows = []
    # The launch floor: the device time of the smallest launch, a one-element
    # zero_(), timed as every kernel is. A bound below it cannot be reached.
    floor_ms = time_ms(lambda z: z.zero_(), [(torch.zeros(1, device=dev),)])
    log(f"[kernels] launch floor (one-element zero_(), the same timing): {floor_ms:.4f} ms")

    # K1: one fused hop at the main path's state sizes.
    codes = torch.randint(0, 256, (N, M), generator=g, device=dev, dtype=torch.uint8)
    nbrs = torch.randint(0, N, (B, R), generator=g, device=dev, dtype=torch.int32)
    fresh = torch.rand((B, R), generator=g, device=dev) > 0.3
    wd, wi = sorted_by_key(torch.rand((B, T), generator=g, device=dev) * 5000,
                           torch.randperm(B * T, generator=g, device=dev).to(torch.int32).reshape(B, T) + N)
    wv = torch.rand((B, T), generator=g, device=dev) > 0.5
    active = torch.rand((B,), generator=g, device=dev) > 0.2
    wl = Worklist(wd, wi, wv)

    def step(tb, cd, fr, eager=True):
        return step_ops.fused_step(tb, cd, wl, nbrs, fr, active, eager=eager)

    def check_step(tb, fr, eager=True):
        kern = step(tb, codes, fr, eager)
        plain = step_ops.step_ref(tb, codes, nbrs, fr, wd, wi, wv, active, eager=eager)
        for a, b in zip((kern[0].dists, kern[0].ids, kern[0].visited, kern[1], kern[2]), plain):
            exact(a, b)
        return float((kern[0].dists - plain[0]).nan_to_num().abs().max())

    err = 0.0
    for integer in (True, False):
        if integer:
            table = torch.randint(0, 1000, (B, M, 256), generator=g, device=dev).float()
        else:
            table = torch.rand((B, M, 256), generator=g, device=dev) ** 2 * 4
        for eager in (True, False):
            err = max(err, check_step(table, fresh, eager))
    torch.cuda.synchronize()
    sets = copies(table, codes)
    ms = time_ms(lambda tb, cd: step(tb, cd, fresh), sets)
    plain_ms = time_ms(lambda tb, cd: step_ops.step_ref(tb, cd, nbrs, fresh, wd, wi, wv, active),
                       sets, reps=5)
    # The same table and inputs every call, as the path re-reads one table
    # for every hop of a batch.
    warm_ms = time_ms(lambda tb, cd: step(tb, cd, fresh), sets[:1])
    # One block per SM: the latency of one block's hop, whatever the batch.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else 8
    one = [x[:sms] for x in (nbrs, fresh, wd, wi, wv, active)]
    one_wave_ms = time_ms(lambda tb, cd: step_ops.fused_step(tb[:sms], cd, Worklist(*one[2:5]), one[0],
                                                             one[1], one[5]), sets)
    rp = common.next_pow2(R)
    p = common.next_pow2(T + rp)
    cmp_sort, cmp_merge = exchanges(rp, True), exchanges(p, False)

    def step_bound(fr):
        # Inputs: the table sectors the fresh codes look up, the fresh code
        # rows, neighbours, fresh flags, worklists and active flags; outputs:
        # worklists, u_next and active.
        nf = int(fr.sum())
        nbytes = (table_sectors(codes[nbrs.long()], fr) * SECTOR + nf * M + B * R * 5 + B * T * 9 + B
                  + B * T * 9 + B * 5)
        return bound_ms(nbytes, nf * M + B * 2 * (cmp_sort + cmp_merge))

    n_fresh = int(fresh.sum())
    sectors = table_sectors(codes[nbrs.long()], fresh)
    b_ms, b_by = step_bound(fresh)
    # Over the count of fresh lanes a query, every query with the same count:
    # the lookups' cost beyond the hop's tail (F = 0).
    sweep = []
    for f in LANE_SWEEP:
        fr = exactly(g, B, R, f, dev)
        check_step(table, fr)
        sweep.append(dict(F=f, ms=time_ms(lambda tb, cd, fr=fr: step(tb, cd, fr), sets),
                          bound_ms=step_bound(fr)[0]))
        log(f"[kernels] search_step at F={f} fresh lanes a query: {sweep[-1]['ms']:.4f} ms, bound "
            f"{sweep[-1]['bound_ms']:.4f} ms")
    rows.append(dict(name="search_step", route="cuda", source="src/repro_torch/csrc/search_step.cu",
                     replaces="src/repro/kernels/search_step/search_step.py:311",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None, library_call=None, ms_warm_table=warm_ms,
                     ms_one_block_per_sm=one_wave_ms, by_fresh_lanes=sweep))
    log(f"[kernels] search_step (fused hop, eager+lazy, integer and float tables, F = "
        f"{', '.join(map(str, LANE_SWEEP))} fresh lanes a query): bit-equal to plain (tolerance 0); "
        f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {n_fresh} fresh lanes, "
        f"{sectors} table sectors = {100 * sectors * SECTOR / (table.numel() * 4):.1f}% of the "
        f"tables); warm table {warm_ms:.4f} ms; B={sms} (one block per SM) {one_wave_ms:.4f} ms")

    # K2: the medoid seed, R = 1 candidate per query.
    table = torch.rand((B, M, 256), generator=g, device=dev) ** 2 * 4
    seed_codes = codes[torch.randint(0, N, (B, 1), generator=g, device=dev)]   # uint8, as the path gives
    valid = torch.ones((B, 1), dtype=torch.bool, device=dev)
    out = adc_ops.adc(table, seed_codes, valid)
    ref = adc_ops.adc_ref(table, seed_codes, valid)
    exact(out, ref)
    sets = copies(table)
    ms = time_ms(lambda tb: adc_ops.adc(tb, seed_codes, valid), sets)
    plain_ms = time_ms(lambda tb: adc_ops.adc_ref(tb, seed_codes, valid), sets)
    # Yardstick: one embedding_bag "sum" over the flattened table (indices
    # prepared outside the timed call; no +inf masking).
    offs = (torch.arange(B, device=dev)[:, None, None] * M * 256
            + torch.arange(M, device=dev)[None, None, :] * 256 + seed_codes).reshape(-1, M)
    bag = torch.nn.functional.embedding_bag
    lib = bag(offs, table.reshape(-1, 1), mode="sum").reshape(B, 1)
    if not torch.allclose(lib, ref, rtol=1e-5, atol=1e-5):
        raise AssertionError("embedding_bag yardstick disagrees with the ADC")
    lib_ms = time_ms(lambda tb: bag(offs, tb.reshape(-1, 1), mode="sum"), sets)
    # Inputs: the m looked-up table sectors per query, the codes and valid
    # flags; output: one distance per query.
    sectors = table_sectors(seed_codes, valid)
    b_ms, b_by = bound_ms(sectors * SECTOR + seed_codes.numel() + B + B * 4, B * M)
    rows.append(dict(name="pq_adc", route="cuda", source="src/repro_torch/csrc/pq_adc.cu",
                     replaces="src/repro/kernels/pq_adc/pq_adc.py:98",
                     max_abs_err=float((out - ref).abs().max()), ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                     library_call="torch.nn.functional.embedding_bag(mode='sum')"))
    log(f"[kernels] pq_adc (B={B}, R=1, m={M}): bit-equal to plain; {ms:.4f} ms vs plain "
        f"{plain_ms:.4f} ms, embedding_bag {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; under "
        f"one launch's own device time)")

    # K2 at R = 64: the staged mode's distances of the gathered (B, R, m)
    # codes, fresh lanes only.
    cand_codes = codes[nbrs.long()]
    out = adc_ops.adc(table, cand_codes, fresh)
    ref = adc_ops.adc_ref(table, cand_codes, fresh)
    exact(out, ref)
    sets = copies(table, cand_codes)
    ms = time_ms(lambda tb, cc: adc_ops.adc(tb, cc, fresh), sets)
    plain_ms = time_ms(lambda tb, cc: adc_ops.adc_ref(tb, cc, fresh), sets, reps=5)
    offs = (torch.arange(B, device=dev)[:, None, None] * M * 256
            + torch.arange(M, device=dev)[None, None, :] * 256 + cand_codes.long()).reshape(-1, M)
    lib = bag(offs, table.reshape(-1, 1), mode="sum").reshape(B, R)
    if not torch.allclose(lib[fresh], ref[fresh], rtol=1e-5, atol=1e-5):
        raise AssertionError("embedding_bag yardstick disagrees with the ADC at R=64")
    lib_ms = time_ms(lambda tb, cc: bag(offs, tb.reshape(-1, 1), mode="sum"), sets)
    sectors = table_sectors(cand_codes, fresh)
    b_ms, b_by = bound_ms(sectors * SECTOR + cand_codes.numel() + B * R + B * R * 4, n_fresh * M)
    rows[-1]["at_r64"] = dict(max_abs_err=float((out - ref).nan_to_num().abs().max()), ms=ms,
                              plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    log(f"[kernels] pq_adc (B={B}, R={R}, m={M}, staged distances): bit-equal to plain; {ms:.4f} ms "
        f"vs plain {plain_ms:.4f} ms, embedding_bag {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
        f"{sectors} table sectors)")

    # K2's two regimes over R on the fresh lanes' codes: where the shared
    # table starts to pay (the wrapper switches at SHARED_TABLE_MIN_R).
    sweep = []
    for r in ADC_SWEEP_R:
        cc, ok = cand_codes[:, :r].contiguous(), fresh[:, :r].contiguous()
        ref = adc_ops.adc_ref(table, cc, ok)
        entry = dict(R=r, shared_table=r >= adc_ops.SHARED_TABLE_MIN_R)
        for key, shared in (("global_ms", False), ("shared_ms", True)):
            exact(adc_ops._adc_regime(table, cc, ok, shared_table=shared), ref)
            entry[key] = time_ms(lambda tb, c, ok=ok, shared=shared: adc_ops._adc_regime(
                tb, c, ok, shared_table=shared), copies(table, cc))
        entry["ms"] = entry["shared_ms" if entry["shared_table"] else "global_ms"]
        entry["bound_ms"] = bound_ms(table_sectors(cc, ok) * SECTOR + cc.numel() + B * r * 5,
                                     int(ok.sum()) * M)[0]
        sweep.append(entry)
        log(f"[kernels] pq_adc regimes at R={r}: global lookups {entry['global_ms']:.4f} ms, shared "
            f"table {entry['shared_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms; the wrapper takes "
            f"the {'shared table' if entry['shared_table'] else 'global lookups'}")
    cross = adc_ops.SHARED_TABLE_MIN_R
    rows[-1].update(
        crossover_r_measured=next((e["R"] for e in sweep if e["shared_ms"] < e["global_ms"]), None),
        regimes=sweep,
        below_crossover=max((e for e in sweep if e["R"] < cross), key=lambda e: e["R"], default=None),
        above_crossover=min((e for e in sweep if e["R"] >= cross), key=lambda e: e["R"], default=None))
    log(f"[kernels] pq_adc crossover: the wrapper's R={cross}; this run's first R with the shared "
        f"table faster: {rows[-1]['crossover_r_measured']}")

    # K3: exact re-rank distances of C = iters() candidates per query.
    q = torch.randn((B, D), generator=g, device=dev)
    v = torch.randn((B, C, D), generator=g, device=dev) + q[:, None, :]
    out = rr_ops.exact_sq_dists(q, v)
    ref = rr_ops.exact_sq_dists_ref(q, v)
    exact(out, ref)
    sets = copies(v)
    ms = time_ms(lambda vv: rr_ops.exact_sq_dists(q, vv), sets)
    plain_ms = time_ms(lambda vv: rr_ops.exact_sq_dists_ref(q, vv), sets, reps=5)
    # Yardstick: one baddbmm computing ||q||^2+||v||^2-2<v,q> from the norms
    # (norms prepared outside the timed call).
    norms = ((q * q).sum(-1)[:, None] + (v * v).sum(-1))[:, :, None]
    lib = torch.baddbmm(norms, v, q[:, :, None], alpha=-2.0)[..., 0]
    if not torch.allclose(lib, ref, rtol=1e-4, atol=1e-3):
        raise AssertionError("baddbmm yardstick disagrees with the re-rank distances")
    lib_ms = time_ms(lambda vv: torch.baddbmm(norms, vv, q[:, :, None], alpha=-2.0), sets)
    b_ms, b_by = bound_ms(v.numel() * 4 + q.numel() * 4 + B * C * 4, B * C * D * 6)
    rows.append(dict(name="rerank_l2", route="cuda", source="src/repro_torch/csrc/rerank_l2.cu",
                     replaces="src/repro/kernels/rerank_l2/rerank_l2.py:54",
                     max_abs_err=float((out - ref).abs().max()), ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                     library_call="torch.baddbmm (norms precomputed)"))
    log(f"[kernels] rerank_l2 (B={B}, C={C}, d={D}): bit-equal to plain; {ms:.4f} ms vs plain "
        f"{plain_ms:.4f} ms, baddbmm {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

    # Candidate tiles as the staged and exact paths give them: distances of
    # the fresh lanes (distinct values), (+inf, INVALID) elsewhere.
    cand_d = torch.where(fresh, torch.rand((B, R), generator=g, device=dev) * 5000,
                         torch.full((B, R), float("inf"), device=dev))
    cand_i = torch.where(fresh, nbrs, torch.full_like(nbrs, INVALID_ID))

    # K4: the staged mode's candidate sort, (B, R) by (dist, id).
    out = bitonic_ops.sort_kv(cand_d, cand_i)
    ref = bitonic_ops.sort_kv_ref(cand_d, cand_i)
    for a, b in zip(out, ref):
        exact(a, b)
    sets = copies(cand_d, cand_i)
    ms = time_ms(bitonic_ops.sort_kv, sets)
    plain_ms = time_ms(bitonic_ops.sort_kv_ref, sets, reps=5)
    # Yardstick: one stable torch.sort of the distances (the ids' gather by
    # its indices left out); the fresh distances are distinct and the pads
    # identical, so it gives the same order.
    lib = torch.sort(cand_d, dim=-1, stable=True)
    if not (torch.equal(lib.values, ref[0]) and torch.equal(torch.gather(cand_i, -1, lib.indices), ref[1])):
        raise AssertionError("torch.sort yardstick disagrees with the bitonic sort")
    lib_ms = time_ms(lambda d, i: torch.sort(d, dim=-1, stable=True), sets)
    b_ms, b_by = bound_ms(2 * B * R * 8, B * 2 * exchanges(rp, True))
    # Rows a block of the warp regime, and the block regime, at the main shape.
    by_rows = []
    for w in (0,) + WARPS_SWEEP:
        for a, b in zip(bitonic_ops._sort(cand_d, cand_i, rows=w), ref):
            exact(a, b)
        by_rows.append(dict(rows=w, ms=time_ms(lambda d, i, w=w: bitonic_ops._sort(d, i, rows=w), sets)))
    log(f"[kernels] bitonic_sort at n={R}, rows a block (0: the block regime, one row a block): "
        + ", ".join(f"{e['rows']}: {e['ms']:.4f} ms" for e in by_rows)
        + f"; the wrapper takes {bitonic_ops.sort_rows(rp)}")
    # Over n, across the warp regime's limit (p = 512).
    by_n = []
    for n in SORT_SWEEP_N:
        d = torch.rand((B, n), generator=g_sweep, device=dev) * 5000
        i = torch.randperm(B * n, generator=g_sweep, device=dev).to(torch.int32).reshape(B, n)
        for a, b in zip(bitonic_ops.sort_kv(d, i), bitonic_ops.sort_kv_ref(d, i)):
            exact(a, b)
        pn = common.next_pow2(n)
        by_n.append(dict(n=n, ms=time_ms(bitonic_ops.sort_kv, copies(d, i)),
                         bound_ms=bound_ms(2 * B * n * 8, B * 2 * exchanges(pn, True))[0]))
        log(f"[kernels] bitonic_sort at n={n} (rows a block {bitonic_ops.sort_rows(pn)}): bit-equal to "
            f"plain; {by_n[-1]['ms']:.4f} ms, bound {by_n[-1]['bound_ms']:.4f} ms")
    rows.append(dict(name="bitonic_sort", route="cuda", source="src/repro_torch/csrc/bitonic.cu",
                     replaces="src/repro/kernels/bitonic/bitonic.py:147",
                     max_abs_err=float((out[0] - ref[0]).nan_to_num().abs().max()), ms=ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                     library_call="torch.sort(stable=True) of the distances",
                     by_rows_a_block=by_rows, by_n=by_n))
    log(f"[kernels] bitonic_sort (B={B}, n={R}): bit-equal to plain; {ms:.4f} ms vs plain "
        f"{plain_ms:.4f} ms, torch.sort {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), launch floor "
        f"{floor_ms:.4f} ms")

    # K5: the staged mode's merge of the sorted candidates into the worklist.
    sd, si = out
    out = bitonic_ops.merge_worklist(wl, sd, si)
    ref = bitonic_ops.merge_ref(wd, wi, wv, sd, si)
    for a, b in zip(out, ref):
        exact(a, b)
    sets = copies(wd, wi, wv, sd, si)
    ms = time_ms(lambda a, b, c, d, i: bitonic_ops.merge_worklist(Worklist(a, b, c), d, i), sets)
    plain_ms = time_ms(bitonic_ops.merge_ref, sets, reps=5)
    b_ms, b_by = bound_ms(B * T * 9 + B * R * 8 + B * T * 9, B * 2 * exchanges(p, False))
    # Rows a block of the warp regime, and the block regime, at the main shape.
    # Warm: the same inputs every call, as on the staged path, where K4 has
    # just written the candidates and the previous merge the worklist.
    by_rows = []
    for w in (0,) + WARPS_SWEEP:
        for a, b in zip(bitonic_ops._merge(wl, sd, si, rows=w), ref):
            exact(a, b)

        def merge_w(a, b, c, d, i, w=w):
            return bitonic_ops._merge(Worklist(a, b, c), d, i, rows=w)

        by_rows.append(dict(rows=w, ms=time_ms(merge_w, sets), warm_ms=time_ms(merge_w, sets[:1])))
    log(f"[kernels] bitonic_merge at t={T}, rows a block (0: the block regime, one row a block), "
        "cold / warm: " + ", ".join(f"{e['rows']}: {e['ms']:.4f} / {e['warm_ms']:.4f} ms" for e in by_rows)
        + f"; the wrapper takes {bitonic_ops.merge_rows(p)}")
    # Over t at R = 64 (p = 128 .. 1024), across the warp regime's limit;
    # worklists sorted by (dist, id), as the merge assumes.
    by_t = []
    for t in TRAVERSE_SWEEP_T:
        wlt = Worklist(*sorted_by_key(
            torch.rand((B, t), generator=g_merge, device=dev) * 5000,
            torch.randperm(B * t, generator=g_merge, device=dev).to(torch.int32).reshape(B, t) + N),
            torch.rand((B, t), generator=g_merge, device=dev) > 0.5)
        for a, b in zip(bitonic_ops.merge_worklist(wlt, sd, si), bitonic_ops.merge_ref(*wlt, sd, si)):
            exact(a, b)
        pt = common.next_pow2(t + R)
        by_t.append(dict(t=t, p=pt, ms=time_ms(
            lambda a, b, c, d, i: bitonic_ops.merge_worklist(Worklist(a, b, c), d, i),
            copies(*wlt, sd, si)),
            bound_ms=bound_ms(B * t * 18 + B * R * 8, B * 2 * exchanges(pt, False))[0]))
        log(f"[kernels] bitonic_merge at t={t} (p={pt}, rows a block {bitonic_ops.merge_rows(pt)}): "
            f"bit-equal to plain; {by_t[-1]['ms']:.4f} ms, bound {by_t[-1]['bound_ms']:.4f} ms")
    rows.append(dict(name="bitonic_merge", route="cuda", source="src/repro_torch/csrc/bitonic.cu",
                     replaces="src/repro/kernels/bitonic/bitonic.py:192",
                     max_abs_err=float((out[0] - ref[0]).nan_to_num().abs().max()), ms=ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     library_call=None, by_rows_a_block=by_rows, by_t=by_t))
    log(f"[kernels] bitonic_merge (B={B}, t={T}, R={R}): bit-equal to plain (visited flags "
        f"included); {ms:.4f} ms vs plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), launch "
        f"floor {floor_ms:.4f} ms; no single PyTorch call merges with a payload (a sort of the "
        f"concatenation is not one call)")

    # K6: the exact variant's hop on precomputed distances.
    for eager in (True, False):
        kern = step_ops.fused_traverse(wl, cand_d, cand_i, active, eager=eager)
        plain = step_ops.traverse_ref(cand_d, cand_i, wd, wi, wv, active, eager=eager)
        for a, b in zip((kern[0].dists, kern[0].ids, kern[0].visited, kern[1], kern[2]), plain):
            exact(a, b)
    sets = copies(cand_d, cand_i, wd, wi, wv)
    ms = time_ms(lambda d, i, a, b, c: step_ops.fused_traverse(Worklist(a, b, c), d, i, active), sets)
    plain_ms = time_ms(lambda d, i, a, b, c: step_ops.traverse_ref(d, i, a, b, c, active), sets, reps=5)
    b_ms, b_by = bound_ms(B * R * 8 + B * T * 9 + B + B * T * 9 + B * 5,
                          B * 2 * (cmp_sort + cmp_merge))

    def check_traverse(wlt, warps=None):
        for eager in (True, False):
            kern = (step_ops.fused_traverse(wlt, cand_d, cand_i, active, eager=eager) if warps is None
                    else step_ops._traverse(wlt, cand_d, cand_i, active, eager=eager, warps=warps))
            plain = step_ops.traverse_ref(cand_d, cand_i, *wlt, active, eager=eager)
            for a, b in zip((kern[0].dists, kern[0].ids, kern[0].visited, kern[1], kern[2]), plain):
                exact(a, b)

    # Queries a block of the warp regime, and the block regime, at the main shape.
    by_warps = []
    for w in (0,) + WARPS_SWEEP:
        check_traverse(wl, w)
        by_warps.append(dict(warps=w, ms=time_ms(
            lambda d, i, a, b, c, w=w: step_ops._traverse(Worklist(a, b, c), d, i, active, eager=True,
                                                          warps=w), sets)))
    log(f"[kernels] fused_traverse at t={T}, queries a block (0: the block regime, one query a block): "
        + ", ".join(f"{e['warps']}: {e['ms']:.4f} ms" for e in by_warps)
        + f"; the wrapper takes {step_ops.traverse_warps(p)}")
    # Over t at R = 64 (P = 128 .. 1024), across the warp regime's limit.
    by_t = []
    for t in TRAVERSE_SWEEP_T:
        wlt = Worklist(*sorted_by_key(
            torch.rand((B, t), generator=g_sweep, device=dev) * 5000,
            torch.randperm(B * t, generator=g_sweep, device=dev).to(torch.int32).reshape(B, t) + N),
            torch.rand((B, t), generator=g_sweep, device=dev) > 0.5)
        check_traverse(wlt)
        pt = step_ops.merge_slots(R, t)
        by_t.append(dict(t=t, P=pt, ms=time_ms(
            lambda d, i, a, b, c: step_ops.fused_traverse(Worklist(a, b, c), d, i, active),
            copies(cand_d, cand_i, *wlt)),
            bound_ms=bound_ms(B * R * 8 + B * t * 18 + B * 6,
                              B * 2 * (cmp_sort + exchanges(pt, False)))[0]))
        log(f"[kernels] fused_traverse at t={t} (P={pt}, queries a block {step_ops.traverse_warps(pt)}): "
            f"bit-equal to plain, eager and lazy; {by_t[-1]['ms']:.4f} ms, bound "
            f"{by_t[-1]['bound_ms']:.4f} ms")
    rows.append(dict(name="fused_traverse", route="cuda", source="src/repro_torch/csrc/search_step.cu",
                     replaces="src/repro/kernels/search_step/search_step.py:458",
                     max_abs_err=float((kern[0].dists - plain[0]).nan_to_num().abs().max()), ms=ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     library_call=None, by_warps_a_block=by_warps, by_t=by_t))
    log(f"[kernels] fused_traverse (B={B}, R={R}, t={T}, eager+lazy): bit-equal to plain; "
        f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), launch floor "
        f"{floor_ms:.4f} ms; no single PyTorch call does sort, select and merge")

    # K7: the owner-shard ADC, on S_K7 contiguous shards of the n code rows
    # (each shard's contribution, exact zeros where it does not own the lane,
    # and the sum over the shards equal to K2 on the same candidates), and
    # on one shard owning every row (the main path's (1, 1) mesh).
    n_loc = N // S_K7
    contribs = []
    for s in range(S_K7):
        rel, own = _owned_at(s, n_loc, nbrs)
        mine = own & fresh
        codes_s = codes[s * n_loc : (s + 1) * n_loc]
        out = step_ops.local_adc(table, codes_s, rel, mine)
        exact(out, step_ops.local_adc_ref(table, codes_s, rel, mine))
        exact(step_ops.local_adc(table, codes_s, rel, mine, tile_rows=4096), out)
        if not bool((out[~mine] == 0.0).all()):
            raise AssertionError("local_adc wrote a non-zero where the shard owns no lane")
        contribs.append(out)
    total = contribs[0]
    for c in contribs[1:]:
        total = total + c
    k2 = adc_ops.adc(table, cand_codes, fresh)
    exact(total[fresh], k2[fresh])
    if not bool((total[~fresh] == 0.0).all()):
        raise AssertionError("local_adc: the shards' sum is not zero on lanes that are not fresh")
    rel0, own0 = _owned_at(0, n_loc, nbrs)
    mine0 = own0 & fresh
    sets = copies(table)
    shard_ms = time_ms(lambda tb: step_ops.local_adc(tb, codes[:n_loc], rel0, mine0), sets)
    shard_b_ms, _ = bound_ms(table_sectors(cand_codes, mine0) * SECTOR + int(mine0.sum()) * M
                             + B * R * 5 + B * R * 4, int(mine0.sum()) * M)
    out = step_ops.local_adc(table, codes, nbrs, fresh)
    ref = step_ops.local_adc_ref(table, codes, nbrs, fresh)
    exact(out, ref)
    ms = time_ms(lambda tb: step_ops.local_adc(tb, codes, nbrs, fresh), sets)
    plain_ms = time_ms(lambda tb: step_ops.local_adc_ref(tb, codes, nbrs, fresh), sets, reps=5)
    # Inputs: the table sectors the owned lanes' codes look up, their code
    # rows, ids and flags; output: one distance per lane.
    sectors = table_sectors(cand_codes, fresh)
    b_ms, b_by = bound_ms(sectors * SECTOR + n_fresh * M + B * R * 5 + B * R * 4, n_fresh * M)
    # The medoid seed: R = 1, the one lane owned (the (1, 1) mesh).
    seed = torch.randint(0, N, (B, 1), generator=g, device=dev, dtype=torch.int32)
    seed_own = torch.ones((B, 1), dtype=torch.bool, device=dev)
    exact(step_ops.local_adc(table, codes, seed, seed_own), step_ops.local_adc_ref(table, codes, seed, seed_own))
    r1_ms = time_ms(lambda tb: step_ops.local_adc(tb, codes, seed, seed_own), sets)
    r1_b_ms, _ = bound_ms(table_sectors(codes[seed.long()], seed_own) * SECTOR + B * M + B * 5 + B * 4,
                          B * M)
    # Over the count of owned lanes a query (one shard owning every row,
    # every query with the same count).
    sweep = []
    for f in LANE_SWEEP:
        mine = exactly(g, B, R, f, dev)
        exact(step_ops.local_adc(table, codes, nbrs, mine), step_ops.local_adc_ref(table, codes, nbrs, mine))
        sweep.append(dict(F=f, ms=time_ms(lambda tb, mine=mine: step_ops.local_adc(tb, codes, nbrs, mine),
                                          sets),
                          bound_ms=bound_ms(table_sectors(cand_codes, mine) * SECTOR + f * B * M
                                            + B * R * 9, f * B * M)[0]))
        log(f"[kernels] local_adc at F={f} owned lanes a query: {sweep[-1]['ms']:.4f} ms, bound "
            f"{sweep[-1]['bound_ms']:.4f} ms")
    rows.append(dict(name="local_adc", route="cuda", source="src/repro_torch/csrc/local_adc.cu",
                     replaces="src/repro/kernels/search_step/search_step.py:492",
                     max_abs_err=float((out - ref).abs().max()), ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=None, library_call=None,
                     shards=dict(S=S_K7, n_loc=n_loc, ms=shard_ms, bound_ms=shard_b_ms,
                                 owned_lanes=int(mine0.sum())),
                     at_r1=dict(ms=r1_ms, bound_ms=r1_b_ms), by_owned_lanes=sweep))
    log(f"[kernels] local_adc (B={B}, R={R}, m={M}): {S_K7} shards of n_loc={n_loc} each bit-equal "
        f"to plain, exact zeros where not owned, their sum bit-equal to pq_adc at R={R}, tile_rows "
        f"0 and 4096 bit-identical, F = {', '.join(map(str, LANE_SWEEP))} owned lanes a query "
        f"bit-equal; one shard of the {S_K7}: "
        f"{shard_ms:.4f} ms, bound {shard_b_ms:.4f} ms ({int(mine0.sum())} owned lanes); one shard "
        f"owning all n rows (the main path): {ms:.4f} ms vs plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}); the medoid seed (R=1): {r1_ms:.4f} ms, bound {r1_b_ms:.4f} ms; "
        f"no single PyTorch call gathers the code rows, looks the table up and masks")

    # K8: the PQ distance table through its own kernel (off the search path).
    dsub = D // M
    q_sub = torch.randn((B, M, dsub), generator=g, device=dev)
    cb = torch.randn((M, 256, dsub), generator=g, device=dev)
    out = table_ops.dist_table(q_sub, cb)
    ref = table_ops.dist_table_ref(q_sub, cb)
    exact(out, ref)
    sets = copies(q_sub)
    ms = time_ms(lambda qs: table_ops.dist_table(qs, cb), sets)
    plain_ms = time_ms(lambda qs: table_ops.dist_table_ref(qs, cb), sets, reps=5)
    # Yardstick: one baddbmm over (m, B, dsub) x (m, dsub, 256), the norms
    # (m, B, 256) prepared outside the timed call; its output is (m, B, 256).
    norms = ((q_sub * q_sub).sum(-1).T[:, :, None] + (cb * cb).sum(-1)[:, None, :]).contiguous()
    cb_t = cb.transpose(1, 2)
    lib = torch.baddbmm(norms, q_sub.transpose(0, 1), cb_t, alpha=-2.0)
    if not torch.allclose(lib.transpose(0, 1), ref, rtol=2e-4, atol=2e-4):
        raise AssertionError("baddbmm yardstick disagrees with the distance table")
    lib_ms = time_ms(lambda qs: torch.baddbmm(norms, qs.transpose(0, 1), cb_t, alpha=-2.0), sets)
    # Inputs read once, the table written once; the norms and the dot
    # products (a multiply and an add per dimension), then two adds and a
    # scaling per entry.
    b_ms, b_by = bound_ms(q_sub.numel() * 4 + cb.numel() * 4 + out.numel() * 4,
                          2 * dsub * (B * M + M * 256 + B * M * 256) + 3 * B * M * 256)
    # Queries a tile of the tile regime, and the general regime (0), at the
    # main shape.
    by_tile = []
    for qt in (0,) + TABLE_SWEEP_QUERIES:
        exact(table_ops._dist_table(q_sub, cb, queries=qt), ref)
        by_tile.append(dict(queries=qt, ms=time_ms(
            lambda qs, qt=qt: table_ops._dist_table(qs, cb, queries=qt), sets)))
    log(f"[kernels] dist_table at dsub={dsub}, queries a tile (0: the general regime, one block "
        "per (query, subspace)): "
        + ", ".join(f"{e['queries']}: {e['ms']:.4f} ms" for e in by_tile)
        + f"; the wrapper takes {table_ops.table_queries(dsub)}")
    rows.append(dict(name="dist_table", route="cuda", source="src/repro_torch/csrc/pq_table.cu",
                     replaces="src/repro/kernels/pq_table/pq_table.py:56",
                     max_abs_err=float((out - ref).abs().max()), ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                     library_call="torch.baddbmm over (m, B, dsub) x (m, dsub, 256), norms precomputed",
                     by_tile=by_tile))
    log(f"[kernels] dist_table (B={B}, m={M}, dsub={dsub}): bit-equal to plain; {ms:.4f} ms vs "
        f"plain {plain_ms:.4f} ms, baddbmm {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), launch "
        f"floor {floor_ms:.4f} ms")
    for row in rows:
        row["launch_floor_ms"] = floor_ms
    log("[kernels] ms / bound ms / launch floor ms: " + "; ".join(
        f"{r['name']} {r['ms']:.4f} / {r['bound_ms']:.5f} / {floor_ms:.4f}" for r in rows))
    return rows


# --------------------------------------------------------------- phase 4
def harness_graph(x, r: int, seed: int, chunk: int = 1024):
    """Per point: the r/2 exact nearest neighbours (self excluded) and r/2
    seeded random ids. A stand-in for the Vamana graph; medoid = the point
    nearest the mean."""
    import torch

    n = x.shape[0]
    xn = (x * x).sum(-1)
    adj = torch.empty((n, r), dtype=torch.int32, device=x.device)
    for s in range(0, n, chunk):
        xc = x[s : s + chunk]
        d2 = xn[s : s + chunk, None] + xn[None, :] - 2.0 * torch.matmul(xc, x.T)
        rows = torch.arange(xc.shape[0], device=x.device)
        d2[rows, rows + s] = float("inf")
        adj[s : s + chunk, : r // 2] = torch.topk(d2, r // 2, dim=-1, largest=False).indices.to(torch.int32)
    g = torch.Generator(device=x.device).manual_seed(seed)
    adj[:, r // 2 :] = torch.randint(0, n, (n, r - r // 2), generator=g, device=x.device, dtype=torch.int32)
    medoid = int(torch.argmin(((x - x.mean(0)) ** 2).sum(-1)))
    return adj, medoid


def kernel_counters() -> dict:
    """The launch-counted kernel wrappers, by kernel name."""
    from repro_torch.kernels.bitonic import ops as bitonic_ops
    from repro_torch.kernels.pq_adc import ops as adc_ops
    from repro_torch.kernels.pq_table import ops as table_ops
    from repro_torch.kernels.rerank_l2 import ops as rr_ops
    from repro_torch.kernels.search_step import ops as step_ops

    return {"search_step": (step_ops, "fused_step"), "pq_adc": (adc_ops, "adc"),
            "rerank_l2": (rr_ops, "exact_sq_dists"), "bitonic_sort": (bitonic_ops, "sort_kv"),
            "bitonic_merge": (bitonic_ops, "merge_worklist"),
            "fused_traverse": (step_ops, "fused_traverse"), "local_adc": (step_ops, "local_adc"),
            "dist_table": (table_ops, "dist_table")}


def reset_launches() -> None:
    for mod, attr in kernel_counters().values():
        getattr(mod, attr).launches = 0


def read_launches() -> dict:
    return {name: getattr(mod, attr).launches for name, (mod, attr) in kernel_counters().items()}


# The kernels each path must launch.
PATH_KERNELS = {
    "inmem": ("search_step", "pq_adc", "rerank_l2"),
    "base": ("search_step", "pq_adc", "rerank_l2"),
    "exact": ("fused_traverse",),
    "staged": ("pq_adc", "bitonic_sort", "bitonic_merge", "rerank_l2"),
    "sharded": ("local_adc", "fused_traverse", "rerank_l2"),
    "sharded-base": ("local_adc", "fused_traverse", "rerank_l2"),
    "pq_table": ("dist_table",),
    "vamana-inmem": ("search_step", "pq_adc", "rerank_l2"),
    "vamana-base": ("search_step", "pq_adc", "rerank_l2"),
    "vamana-exact": ("fused_traverse",),
    "base-hostio-w1": ("search_step", "pq_adc", "rerank_l2"),
    "base-hostio-w4-p": ("search_step", "pq_adc", "rerank_l2"),
    "base-hostio-w4-c64k-p": ("search_step", "pq_adc", "rerank_l2"),
    "sharded-base-hostio": ("local_adc", "fused_traverse", "rerank_l2"),
    "serve-inmem": ("search_step", "pq_adc", "rerank_l2"),
    "serve-base-hostio": ("search_step", "pq_adc", "rerank_l2"),
    "vamana-base-hostio": ("search_step", "pq_adc", "rerank_l2"),
}


def run_path(name: str, index, queries, gt, cfg, variant: str, kernel_mode: str, n_batches: int,
             card: str, hostio=None) -> dict:
    """Drive one path through `BangIndex.search` (with `hostio`, through the
    host-I/O subsystem), with every launch count set to 0 just before and
    read just after. Returns its measurements, the ids and distances of
    every batch, and the launches."""
    import torch

    from repro_torch import recall_at_k

    reset_launches()
    ids_all, dists_all, walls, iters, hops = [], [], [], [], []
    t_all = time.perf_counter()
    for b in range(n_batches):
        ids, dists, st = index.search(queries[b * BATCH : (b + 1) * BATCH], K, cfg=cfg, variant=variant,
                                      kernel_mode=kernel_mode, return_stats=True, hostio=hostio)
        ids_all.append(ids)
        dists_all.append(dists)
        walls.append(st.wall_s)
        iters.append(st.n_iters)
        hops.append(st.mean_hops)
    total_s = time.perf_counter() - t_all
    launches = read_launches()
    for kname in PATH_KERNELS[name]:
        if launches[kname] <= 0:
            raise AssertionError(f"the {name} path launched no {kname} kernel")
    ids = torch.cat(ids_all).cpu().numpy()
    nq = min(n_batches * BATCH, len(queries))
    if ids.shape != (nq, K) or (ids < 0).any() or (ids >= index.n).any():
        raise AssertionError(f"{name}: bad ids, shape {ids.shape}")
    rec = recall_at_k(ids, gt[:nq])
    res = dict(recall_at_10=rec, qps=nq / total_s, n_batches=n_batches,
               mean_n_iters=float(np.mean(iters)), n_iters=iters, mean_hops=float(np.mean(hops)),
               batch_wall_ms=[w * 1e3 for w in walls], launches=launches,
               launches_per_batch={k: v / n_batches for k, v in launches.items()},
               ids=ids_all, dists=dists_all, total_s=total_s)
    log(f"[{name}] {variant} {kernel_mode}{'' if hostio is None else f', {hostio}'}, SearchConfig(t={cfg.t}, "
        f"bloom_z={cfg.bloom_z}, eager={cfg.eager}), k={K}, {nq} queries / {n_batches} batches on {card}: recall@10 "
        f"{rec:.5f}, QPS {res['qps']:.1f}, n_iters {iters} (cap {cfg.iters() - 1}), mean hops per "
        f"query {res['mean_hops']:.2f}, batch wall ms {[round(w * 1e3, 2) for w in walls]}")
    log(f"[{name}] launches in the path's run: {launches}")
    return res


def check_same(name: str, a, b) -> None:
    import torch

    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: results differ")


def main_path(dev, card: str) -> dict:
    import torch

    from repro_torch import BangIndex, SearchConfig, brute_force_knn
    from repro_torch.core import pq
    from repro_torch.data import gaussian_mixture

    t0 = time.perf_counter()
    # Base and query points from one draw, as SIFT1M's query set is disjoint
    # from its base set but drawn from the same distribution.
    both = gaussian_mixture(N + N_QUERIES, D, seed=SEED, intrinsic_dim=INTRINSIC_DIM)
    data, queries = both[:N], both[N:]
    x = torch.from_numpy(data).to(dev)
    log(f"[main] corpus n={N} d={D} (SIFT1M shape, gaussian_mixture seed {SEED}, intrinsic_dim "
        f"{INTRINSIC_DIM}), {N_QUERIES} held-out queries: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    codec = pq.train_pq(x, M)
    codes = pq.pq_encode(codec, x)
    torch.cuda.synchronize()
    log(f"[main] train_pq m={M} + pq_encode: {time.perf_counter() - t0:.1f} s "
        f"(n*m = {N * M / 2**20:.1f} MiB of codes)")

    t0 = time.perf_counter()
    adj, medoid = harness_graph(x, R, SEED)
    torch.cuda.synchronize()
    log(f"[main] harness graph (not Vamana: {R // 2} exact NN + {R - R // 2} random ids per point, "
        f"medoid {medoid}): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    gt100 = brute_force_knn(x, queries, 100, device=dev)
    gt = gt100[:, :K]
    # How far the 10th and the 100th true neighbours stand apart: near 1, the
    # neighbours are almost equidistant and PQ distances cannot rank them.
    qx = torch.from_numpy(queries).to(dev)
    d2 = [((x[torch.from_numpy(gt100[:, j]).to(dev)] - qx) ** 2).sum(-1) for j in (K - 1, 99)]
    contrast = float((d2[1] / d2[0]).mean())
    log(f"[main] brute-force ground truth: {time.perf_counter() - t0:.1f} s; mean "
        f"d^2(100th NN) / d^2(10th NN) = {contrast:.4f}")

    # One index for every variant: codes and codebooks on the card; the
    # adjacency and the vectors in pinned host memory, the vectors also on
    # the card (inmem, exact), the adjacency uploaded for inmem and exact.
    t0 = time.perf_counter()
    index = BangIndex.from_arrays(codec.codebooks, codes, adj, medoid, x, device=dev)
    del adj
    log(f"[main] index: adjacency and vectors pinned in host memory "
        f"({(index.graph.adjacency.numel() * 4 + index.data_host.numel() * 4) / 2**20:.0f} MiB): "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = SearchConfig()
    q0 = queries[:BATCH]
    for variant in ("inmem", "base", "exact"):
        # Warm-up batch (first-use allocations), not counted.
        index.search(q0, K, cfg=cfg, variant=variant, kernel_mode="fused")
    torch.cuda.synchronize()
    fresh = fresh_lanes(index, q0, cfg)

    paths = {}
    for variant in ("inmem", "base", "exact"):
        if variant == "base":
            # The base executor's host sources count the bytes they send and
            # the host seconds their gathers take.
            nbr, vec = index.executor("base").neighbors, index.executor("base").host_data
            before = (nbr.frontier_bytes, nbr.rows.bytes_sent, nbr.rows.seconds, vec.bytes_sent,
                      vec.seconds, nbr.wait_s, nbr.rows.gather_s, nbr.rows.send_s)
        res = run_path(variant, index, queries, gt, cfg, variant, "fused", PATH_BATCHES[variant], card)
        if variant == "base":
            down, up, adj_s, vec_bytes, vec_s, wait_s, gather_s, send_s = (
                a - b for a, b in zip((nbr.frontier_bytes, nbr.rows.bytes_sent, nbr.rows.seconds,
                                       vec.bytes_sent, vec.seconds, nbr.wait_s, nbr.rows.gather_s,
                                       nbr.rows.send_s), before))
            nb = res["n_batches"]
            res["hop_split_ms"] = hop_split(wait_s, gather_s, send_s, sum(res["n_iters"]))
            res["link_bytes_per_hop"] = (down + up) / sum(res["n_iters"])
            res["rerank_bytes_per_batch"] = vec_bytes / nb
            res["host_gather_ms_per_batch"] = {"adjacency": adj_s * 1e3 / nb, "vectors": vec_s * 1e3 / nb}
            res["host_gather_share"] = (adj_s + vec_s) / res["total_s"]
            log(f"[base] host link per hop: {res['link_bytes_per_hop']:.0f} bytes ((B + B*R)*4 = "
                f"{(BATCH + BATCH * R) * 4}); re-rank vectors per batch "
                f"{res['rerank_bytes_per_batch'] / 2**20:.1f} MiB; host gathers per batch: adjacency "
                f"rows {adj_s * 1e3 / nb:.2f} ms, re-rank vectors {vec_s * 1e3 / nb:.2f} ms, "
                f"{100 * res['host_gather_share']:.1f}% of the batch wall; the inline hop's host ms "
                f"(host clocks): {fmt_split(res['hop_split_ms'])}")
        set_profile(res, profile_batch(index, q0, cfg, variant, "fused",
                                       float(np.mean(res["batch_wall_ms"]))))
        paths[variant] = res

    # Checks on the paths' results.
    inmem, base, exact_p = paths["inmem"], paths["base"], paths["exact"]
    nb = min(inmem["n_batches"], base["n_batches"])
    check_same("base vs inmem ids", base["ids"][:nb], inmem["ids"][:nb])
    check_same("base vs inmem distances", base["dists"][:nb], inmem["dists"][:nb])
    log(f"[check] base ids and distances equal inmem's on {nb} batches")
    ref_ids, _ = index.search(q0, K, cfg=cfg, kernel_mode="reference")
    check_same("inmem fused vs reference ids", [ref_ids], inmem["ids"][:1])
    first_ids, first_d = inmem["ids"][0], inmem["dists"][0]
    qd = torch.from_numpy(q0).to(dev).double()
    true_d = ((x[first_ids.long()].double() - qd[:, None, :]) ** 2).sum(-1)
    if not (torch.isfinite(first_d).all() and torch.allclose(first_d.double(), true_d, rtol=1e-5, atol=2e-3)):
        raise AssertionError("re-ranked distances are not the exact squared L2 of the ids")
    ex_ref = index.search(q0, K, cfg=cfg, variant="exact", kernel_mode="reference")
    check_same("exact fused vs reference", ex_ref, (exact_p["ids"][0], exact_p["dists"][0]))
    true_d = ((x[exact_p["ids"][0].long()].double() - qd[:, None, :]) ** 2).sum(-1)
    if not torch.allclose(exact_p["dists"][0].double(), true_d, rtol=1e-5, atol=2e-3):
        raise AssertionError("exact-variant distances are not the squared L2 of the ids")
    log("[check] inmem fused ids equal kernel_mode='reference'; re-ranked distances are the exact "
        "L2 of the ids; exact fused ids and distances equal its reference mode's")

    # The staged kernel mode on one batch: ADC, bitonic sort and bitonic
    # merge, one launch each per hop.
    paths["staged"] = run_path("staged", index, queries, gt, cfg, "inmem", "staged", 1, card)
    set_profile(paths["staged"], profile_batch(index, q0, cfg, "inmem", "staged",
                                               paths["staged"]["batch_wall_ms"][0]))
    check_same("staged vs fused ids", paths["staged"]["ids"], inmem["ids"][:1])
    log("[check] staged ids equal fused ids on the first batch")

    paths.update(sharded_paths(dev, index, queries, gt, cfg, card, inmem, base))

    # With no kernel_mode, the index on the card runs the fused kernels.
    reset_launches()
    ids, _ = index.search(q0, K, cfg=cfg)
    k1 = read_launches()["search_step"]
    if (k1 > 0) != (dev.type == "cuda") or not torch.equal(ids, first_ids):
        raise AssertionError(f"index.search(q) with no kernel_mode: {k1} search_step launches")
    log(f"[check] index.search(q) with no kernel_mode launched search_step {k1} times and "
        f"returned the fused path's ids")

    # What the host-I/O phase reuses: the index, the queries, and each
    # twin path's ids and distances.
    ctx = dict(index=index, queries=queries, gt=gt, cfg=cfg,
               twins={p: (paths[p]["ids"], paths[p]["dists"], paths[p]["recall_at_10"])
                      for p in ("inmem", "base", "sharded-base")})
    for res in paths.values():
        del res["ids"], res["dists"]
    return dict(paths=paths, nn_contrast=contrast, pq_table=table_path(index, queries),
                fresh_lanes=fresh, ctx=ctx)


def fresh_lanes(index, q0, cfg) -> dict:
    """The fresh lanes per query of every K1 launch of one inmem batch, run
    outside the timed batches: the count F that K1's time grows with.
    Returns the number of blocks at each F = 0..R and its quantiles."""
    import torch

    from repro_torch.kernels.search_step import ops as step_ops

    real, counts = step_ops.fused_step, []

    def counting(table, codes, wl, nbrs, fresh, active, **kw):
        counts.append(fresh.sum(-1))
        return real(table, codes, wl, nbrs, fresh, active, **kw)

    # The kernel's wrapper counts its launches on whatever the module's
    # `fused_step` is; these launches stay out of every path's counts.
    counting.launches = 0
    step_ops.fused_step = counting
    try:
        index.search(q0, K, cfg=cfg, variant="inmem", kernel_mode="fused")
    finally:
        step_ops.fused_step = real
    f = torch.cat(counts).cpu()
    hist = torch.bincount(f, minlength=R + 1).tolist()
    q = torch.quantile(f.double(), torch.tensor([0.1, 0.5, 0.9], dtype=torch.float64)).tolist()
    res = dict(launches=len(counts), blocks=int(f.numel()), mean=float(f.double().mean()),
               p10=q[0], p50=q[1], p90=q[2], blocks_at_f=hist)
    log(f"[fresh] inmem, one batch of {q0.shape[0]} outside the timed runs: {len(counts)} K1 launches, "
        f"fresh lanes per query mean {res['mean']:.2f}, p10/p50/p90 {q[0]:.0f}/{q[1]:.0f}/{q[2]:.0f}; "
        f"blocks at F=0..{R}: {hist}")
    return res


def set_profile(res: dict, prof: dict | None) -> None:
    res["device_busy_ms_per_batch"] = None if prof is None else prof["busy_ms"]
    res["collective_ms_per_batch"] = None if prof is None else prof["nccl_ms"]
    res["collective_events_per_batch"] = None if prof is None else prof["nccl_events"]


def sharded_paths(dev, index, queries, gt, cfg, card: str, inmem: dict, base: dict) -> dict:
    """The mesh paths on the default (1, 1) mesh (a one-rank process group:
    NCCL on the card), ids and distances held equal to inmem's ("sharded")
    and base's ("sharded-base") on every batch; K7 and K6 launched on every
    hop, two all-reduces a hop (neighbour rows, distances) and two a batch
    (the medoid's distance, the re-rank)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed as tdist
    from repro_torch.distributed import default_mesh

    made = not dist.is_initialized()
    t0 = time.perf_counter()
    mesh = default_mesh(dev)
    log(f"[sharded] mesh {mesh.shape} on {mesh.device} ({dist.get_backend()}, one rank): "
        f"{time.perf_counter() - t0:.1f} s")
    model = mesh.group("model")
    x = torch.rand((BATCH, R), device=dev)
    allreduce_ms = time_ms(lambda v: dist.all_reduce(v, group=model), copies(x))
    log(f"[sharded] one all-reduce of a ({BATCH}, {R}) f32 tile on the one-rank group: "
        f"{allreduce_ms:.4f} ms (CUDA events)")
    paths = {}
    try:
        for variant, twin in (("sharded", inmem), ("sharded-base", base)):
            index.search(queries[:BATCH], K, cfg=cfg, variant=variant, kernel_mode="fused")
            torch.cuda.synchronize()
            ex = index.executor(variant)
            nbr = ex.neighbors
            before = (nbr.frontier_bytes, nbr.rows.bytes_sent, nbr.rows.seconds) if nbr else None
            tdist.all_reduce_sum.calls, tdist.all_reduce_sum.seconds = 0, 0.0
            res = run_path(variant, index, queries, gt, cfg, variant, "fused", PATH_BATCHES[variant], card)
            calls, ar_s = tdist.all_reduce_sum.calls, tdist.all_reduce_sum.seconds
            hops, nb = sum(res["n_iters"]), res["n_batches"]
            nb_twin = min(nb, twin["n_batches"])
            for b in range(nb_twin):
                check_same(f"{variant} batch {b} ids", [res["ids"][b]], [twin["ids"][b]])
                if dev.type == "cuda":
                    check_same(f"{variant} batch {b} distances", [res["dists"][b]], [twin["dists"][b]])
                elif not torch.allclose(res["dists"][b], twin["dists"][b], rtol=1e-6, atol=1e-4):
                    # On the CPU (the rehearsal) the sharded re-rank sums in
                    # XLA:CPU's order, the single-device one in K3's; the
                    # formula cancels at the corpus's squared norms (about
                    # 50), a few ulp of which are ~2e-5 (ROADMAP C4).
                    raise AssertionError(f"{variant} batch {b} distances differ")
            lk = res["launches"]
            if lk["local_adc"] != hops + nb or lk["fused_traverse"] != hops or lk["search_step"]:
                raise AssertionError(f"{variant}: launches {lk} for {hops} hops in {nb} batches")
            if calls != 2 * hops + 2 * nb:
                raise AssertionError(f"{variant}: {calls} all-reduces for {hops} hops in {nb} batches")
            res["all_reduces_per_hop"] = (calls - 2 * nb) / hops
            res["all_reduces"] = calls
            res["allreduce_ms"] = allreduce_ms
            res["allreduce_host_ms_per_batch"] = ar_s * 1e3 / nb
            res["exchange_bytes_per_hop"] = ex.exchange_bytes_per_hop(BATCH)
            res["k7_k6_launches_per_batch"] = [lk["local_adc"] / nb, lk["fused_traverse"] / nb]
            if nbr is not None:
                down, up, secs = (a - b for a, b in zip(
                    (nbr.frontier_bytes, nbr.rows.bytes_sent, nbr.rows.seconds), before))
                res["link_bytes_per_hop"] = (down + up) / hops
                res["host_gather_ms_per_batch"] = {"adjacency": secs * 1e3 / nb}
                res["host_gather_share"] = secs / res["total_s"]
            log(f"[{variant}] ids and distances equal {'inmem' if twin is inmem else 'base'}'s on "
                f"{nb_twin} batches ({'bit for bit' if dev.type == 'cuda' else 'distances within 1e-4'}); local_adc {lk['local_adc'] / nb:.1f} and fused_traverse "
                f"{lk['fused_traverse'] / nb:.1f} launches per batch; {calls} all-reduces = "
                f"{res['all_reduces_per_hop']:.2f} per hop + 2 per batch, issued in "
                f"{res['allreduce_host_ms_per_batch']:.2f} ms of host time per batch; exchange_bytes_per_hop "
                f"{res['exchange_bytes_per_hop']}"
                + (f"; host link {res['link_bytes_per_hop']:.0f} bytes per hop, adjacency gathers "
                   f"{secs * 1e3 / nb:.2f} ms per batch" if nbr is not None else ""))
            set_profile(res, profile_batch(index, queries[:BATCH], cfg, variant, "fused",
                                           float(np.mean(res["batch_wall_ms"]))))
            paths[variant] = res
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
    return paths


def table_path(index, queries) -> dict:
    """K8 through its own entry point, `kernels.pq_table.ops.build_dist_table`,
    on every batch of the queries, held against the search's plain table
    within the reference's bound for its kernel."""
    import torch

    from repro_torch.core import pq
    from repro_torch.kernels.pq_table import ops as table_ops

    reset_launches()
    n_batches, err, walls = PATH_BATCHES["inmem"], 0.0, []
    for b in range(n_batches):
        q = torch.from_numpy(queries[b * BATCH : (b + 1) * BATCH]).to(index.device)
        t0 = time.perf_counter()
        table = table_ops.build_dist_table(index.codec, q)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        plain = pq.build_dist_table(index.codec, q)
        if not torch.allclose(table, plain, rtol=2e-4, atol=2e-4):
            raise AssertionError("build_dist_table through the kernel disagrees with the plain table")
        err = max(err, float((table - plain).abs().max()))
    launches = read_launches()
    if launches["dist_table"] != n_batches:
        raise AssertionError(f"pq_table entry point: {launches['dist_table']} launches in {n_batches} batches")
    log(f"[pq_table] build_dist_table through the kernel on {n_batches} batches of {BATCH}: within "
        f"rtol/atol 2e-4 of the plain table (max |diff| {err:.3g}); host wall per call "
        f"{[round(w, 3) for w in walls]} ms")
    return dict(launches=launches, n_batches=n_batches, max_abs_diff=err, wall_ms=walls)


# ------------------------------------------------------------ phase 4b
# The host-I/O configurations of the base paths: the service's synchronous
# path, the prefetched exchange, and the prefetched exchange with 65,536 hot
# rows pinned on the card (65,536 x 64 x 4 bytes + the n x 4 slot map: about
# 21 MB).
HOSTIO_CONFIGS = (("base-hostio-w1", dict(workers=1)),
                  ("base-hostio-w4-p", dict(workers=4, prefetch=True)),
                  ("base-hostio-w4-c64k-p", dict(workers=4, hot_cache_rows=65_536, prefetch=True)))
HOSTIO_FULL = dict(workers=4, hot_cache_rows=65_536, prefetch=True)
VAMANA_HOSTIO = dict(workers=4, hot_cache_rows=1_500, prefetch=True)


def hop_split(wait_s: float, gather_s: float, send_s: float, hops: int) -> dict:
    """A hop's host ms in three parts: the wait for the device (the frontier's
    copy down), the host gather (for the service: what of it the search
    thread waited for), the copy up (issuing it and merging the rows)."""
    return {"wait_ms": wait_s * 1e3 / hops, "gather_ms": gather_s * 1e3 / hops,
            "send_ms": send_s * 1e3 / hops, "total_ms": (wait_s + gather_s + send_s) * 1e3 / hops}


def fmt_split(sp: dict) -> str:
    return (f"wait for the device {sp['wait_ms']:.4f} + host gather {sp['gather_ms']:.4f} + copy up "
            f"{sp['send_ms']:.4f} = {sp['total_ms']:.4f} ms a hop")


def healthy(name: str, stats: dict) -> None:
    """A healthy run takes no miss, no hedge and no degraded lane."""
    bad = {k: stats[k] for k in ("prefetch_misses", "hedged_gathers", "degraded_lanes") if stats[k]}
    if bad:
        raise AssertionError(f"{name}: a healthy run counted {bad}")


def hostio_run(name: str, ctx: dict, variant: str, hio, card: str, n_batches: int) -> dict:
    """One host-I/O path: a warm-up batch, then `run_path` with the service's
    counters and the exchange's split reset just before; ids and distances
    held equal to the twin path's on every batch."""
    import torch

    index, queries, gt, cfg = ctx["index"], ctx["queries"], ctx["gt"], ctx["cfg"]
    index.search(queries[:BATCH], K, cfg=cfg, variant=variant, kernel_mode="fused", hostio=hio)
    torch.cuda.synchronize()
    ex = index.executor(variant, hostio=hio)
    svc, nbr = ex.hostio_service, ex.neighbors
    svc.reset_stats()
    before = nbr.split()
    res = run_path(name, index, queries, gt, cfg, variant, "fused", n_batches, card, hostio=hio)
    split = {k: v - before[k] for k, v in nbr.split().items()}
    twin_ids, twin_dists, _ = ctx["twins"][variant]
    for b in range(n_batches):
        check_same(f"{name} batch {b} ids", [res["ids"][b]], [twin_ids[b]])
        check_same(f"{name} batch {b} distances", [res["dists"][b]], [twin_dists[b]])
    stats = ex.hostio_runtime.stats()
    healthy(name, stats)
    hops = sum(res["n_iters"])
    if split["hops"] != hops:
        raise AssertionError(f"{name}: {split['hops']} exchanges for {hops} hops")
    res["hop_split_ms"] = hop_split(split["wait_s"], split["gather_s"], split["send_s"], hops)
    res["link_bytes_per_hop"] = (split["frontier_bytes"] + split["rows_bytes"]) / hops
    res["exchange_bytes_per_hop"] = ex.exchange_bytes_per_hop(BATCH)
    res["hostio"] = {k: stats[k] for k in (
        "requests", "rows_gathered", "host_miss_lanes", "cache_hit_lanes", "prefetch_issued",
        "prefetch_hits", "prefetch_misses", "prefetch_lane_mismatches", "hedged_gathers",
        "degraded_lanes", "max_queue_depth", "mean_latency_ms", "cache_hit_rate",
        "overlap_fraction", "hot_cache_rows", "hot_cache_device_bytes")}
    for k in ("overlap_fraction", "cache_hit_rate", "mean_latency_ms"):
        res[k] = stats[k]
    res["host_link_bytes"] = res["exchange_bytes_per_hop"]["host_link_bytes"]
    # The pinned staging ring on the card: its slots, each pinned.
    res["staging_slots"] = len(nbr._ring)
    if nbr.device.type == "cuda" and not all(s.rows.is_pinned() and s.frontier.is_pinned() for s in nbr._ring):
        raise AssertionError(f"{name}: a staging slot is not pinned")
    log(f"[{name}] ids and distances equal {variant}'s on {n_batches} batches; no miss, hedge or "
        f"degraded lane; overlap_fraction {stats['overlap_fraction']:.4f}, cache_hit_rate "
        f"{stats['cache_hit_rate']:.4f}, host_link_bytes per hop {res['host_link_bytes']} (copied "
        f"{res['link_bytes_per_hop']:.0f}), service mean latency {stats['mean_latency_ms']:.4f} ms, "
        f"max queue depth {stats['max_queue_depth']}, {res['staging_slots']} staging slots; "
        f"{fmt_split(res['hop_split_ms'])}")
    return res


def hostio_phase(dev, card: str, ctx: dict) -> dict:
    """Phase 4b: phase 4's index and queries through the host-I/O subsystem.

    base (fused) in the three HOSTIO_CONFIGS, sharded-base with HOSTIO_FULL
    on the one-rank NCCL mesh, ten batches each, ids and distances equal to
    the plain path's on every batch, K1 (or K7 and K6) on every hop; then
    `ServePipeline` over inmem and over host-I/O base: every query with
    ground truth in batches of up to 1,024, ids equal to the plain path's,
    and a repeat of the first 1,024 served from the result cache,
    bit-identical. Returns each path's measurements."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import default_mesh
    from repro_torch.runtime.hostio import HostIOConfig

    index, queries, cfg = ctx["index"], ctx["queries"], ctx["cfg"]
    paths = {}
    for name, kw in HOSTIO_CONFIGS:
        hio = HostIOConfig(**kw)
        res = hostio_run(name, ctx, "base", hio, card, PATH_BATCHES["base"])
        lk, nb = res["launches"], res["n_batches"]
        if (lk["search_step"], lk["pq_adc"], lk["rerank_l2"]) != (sum(res["n_iters"]), nb, nb):
            raise AssertionError(f"{name}: launches {lk} for {sum(res['n_iters'])} hops in {nb} batches")
        set_profile(res, profile_batch(index, queries[:BATCH], cfg, "base", "fused",
                                       float(np.mean(res["batch_wall_ms"])), hostio=hio))
        index.executor("base", hostio=hio).hostio_runtime.stop()
        paths[name] = res

    made = not dist.is_initialized()
    mesh = default_mesh(dev)
    hio = HostIOConfig(**HOSTIO_FULL)
    try:
        res = hostio_run("sharded-base-hostio", ctx, "sharded-base", hio, card, PATH_BATCHES["sharded-base"])
        lk, nb, hops = res["launches"], res["n_batches"], sum(res["n_iters"])
        if lk["local_adc"] != hops + nb or lk["fused_traverse"] != hops or lk["search_step"]:
            raise AssertionError(f"sharded-base-hostio: launches {lk} for {hops} hops in {nb} batches")
        set_profile(res, profile_batch(index, queries[:BATCH], cfg, "sharded-base", "fused",
                                       float(np.mean(res["batch_wall_ms"])), hostio=hio))
        index.executor("sharded-base", mesh=mesh, hostio=hio).hostio_runtime.stop()
        paths["sharded-base-hostio"] = res
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()

    for name, variant, hio in (("serve-inmem", "inmem", None),
                               ("serve-base-hostio", "base", HostIOConfig(**HOSTIO_FULL))):
        paths[name] = serve_path(name, ctx, variant, hio, card)
    return paths


def serve_path(name: str, ctx: dict, variant: str, hio, card: str) -> dict:
    """`ServePipeline` over one executor: every query with its ground truth,
    micro-batches of BATCH, then the first BATCH queries again, served from
    the result cache."""
    import torch

    from repro_torch import recall_at_k
    from repro_torch.runtime import ServePipeline

    index, queries, gt, cfg = ctx["index"], ctx["queries"], ctx["gt"], ctx["cfg"]
    twin_ids, twin_dists, twin_recall = ctx["twins"]["inmem"]
    ex = index.executor(variant, hostio=hio)
    n = min(len(queries), PATH_BATCHES["inmem"] * BATCH)
    # The same batches one at a time on this thread, just before: the
    # pipeline's yardstick in the same phase (the host's speed drifts
    # between phases).
    ex.search(queries[:BATCH], K, cfg=cfg, kernel_mode="fused")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, n, BATCH):
        ex.search(queries[s : min(s + BATCH, n)], K, cfg=cfg, kernel_mode="fused")
    torch.cuda.synchronize()
    seq_qps = n / (time.perf_counter() - t0)
    with ServePipeline(ex, k=K, cfg=cfg, max_batch=BATCH, kernel_mode="fused",
                       result_cache_size=n) as pipe:
        reset_launches()
        pipe.submit(queries[:n], gt_ids=gt[:n])
        ids, dists, st = pipe.drain()
        launches = read_launches()
        torch.cuda.synchronize()
        plain = torch.cat(twin_ids).cpu().numpy()[:n]
        if not np.array_equal(ids, plain) or not np.array_equal(dists, torch.cat(twin_dists).cpu().numpy()[:n]):
            raise AssertionError(f"{name}: drain() results differ from the plain inmem path's")
        rec = recall_at_k(ids, gt[:n])
        # The pipeline's recall is a row-weighted mean of batch recalls: the
        # same count of hits, summed in another order.
        if rec != twin_recall or abs(st.mean_recall - twin_recall) > 1e-12:
            raise AssertionError(f"{name}: recall {st.mean_recall} against the plain path's {twin_recall}")
        for kname in PATH_KERNELS[name]:
            if launches[kname] <= 0:
                raise AssertionError(f"the {name} path launched no {kname} kernel")
        pipe.submit(queries[:BATCH])
        ids2, dists2, st2 = pipe.drain()
        if not (np.array_equal(ids2, ids[:BATCH]) and np.array_equal(dists2, dists[:BATCH])
                and st2.result_cache_hits == BATCH and st2.result_cache_hit_rate == 1.0 and st2.batches == 0):
            raise AssertionError(f"{name}: the repeat of {BATCH} queries was not served bit-identically "
                                 f"from the result cache ({st2.result_cache_hits} hits)")
        hostio = st.hostio
    if hostio is not None:
        healthy(name, hostio)
    res = dict(qps=st.qps, one_at_a_time_qps=seq_qps, p50_ms=st.p50_ms, p95_ms=st.p95_ms,
               mean_recall=st.mean_recall,
               recall_at_10=rec, n_batches=st.batches, wall_s=st.wall_s, launches=launches,
               launches_per_batch={k: v / st.batches for k, v in launches.items()},
               cache_repeat_hit_rate=st2.result_cache_hit_rate, cache_repeat_p50_ms=st2.p50_ms)
    if hostio is not None:
        for k in ("overlap_fraction", "cache_hit_rate", "mean_latency_ms"):
            res[k] = hostio[k]
    log(f"[{name}] ServePipeline(max_batch={BATCH}, kernel_mode='fused') over {variant}"
        f"{'' if hio is None else f' {hio}'} on {card}: {n} queries in {st.batches} batches, QPS "
        f"{st.qps:.1f} (one batch at a time just before: {seq_qps:.1f}), p50 {st.p50_ms:.2f} ms, p95 {st.p95_ms:.2f} ms (enqueue -> ready, all queued at "
        f"once), mean_recall {st.mean_recall:.5f} (plain {twin_recall:.5f}), ids and distances equal "
        f"the plain path's; repeat of {BATCH}: {st2.result_cache_hits} result-cache hits, bit-identical"
        + ("" if hostio is None else f"; overlap_fraction {hostio['overlap_fraction']:.4f}, "
           f"cache_hit_rate {hostio['cache_hit_rate']:.4f}"))
    log(f"[{name}] launches in the pipeline's run: {launches}")
    return res


# --------------------------------------------------------------- phase 5
def vamana_cell(dev, card: str) -> dict:
    """The Vamana cell: `BangIndex.build` (PQ on `dev`, the graph on the
    host) over VAMANA_N points of the phase-4 draw's shape, then
    VAMANA_QUERIES held-out queries through `index.search` on inmem, base
    and exact (fused, t = 64), each run with every launch count set to 0
    just before it. Checks: fused ids equal kernel_mode="reference" ids on
    every variant, base ids and distances equal inmem's. Returns the build
    and each path's measurements, keyed as the paths are named."""
    import torch

    from repro_torch import BangIndex, SearchConfig, brute_force_knn
    from repro_torch.core import bang as bang_mod
    from repro_torch.core import pq
    from repro_torch.data import gaussian_mixture

    both = gaussian_mixture(VAMANA_N + VAMANA_QUERIES, D, seed=SEED, intrinsic_dim=INTRINSIC_DIM)
    data, queries = both[:VAMANA_N], both[VAMANA_N:]
    # Time the graph inside `BangIndex.build`: the PQ work queued on the
    # card before it is waited for first, so the split is PQ / graph / rest.
    real_build, marks = bang_mod.build_vamana, {}

    def timed_build(*args, **kwargs):
        torch.cuda.synchronize()
        marks["graph_start"] = time.perf_counter()
        g = real_build(*args, **kwargs)
        marks["graph_end"] = time.perf_counter()
        return g

    bang_mod.build_vamana = timed_build
    try:
        t0 = time.perf_counter()
        index = BangIndex.build(data, m=M, R=VAMANA_R, L_build=VAMANA_L, alpha=VAMANA_ALPHA, seed=SEED,
                                device=dev)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        bang_mod.build_vamana = real_build
    build = dict(pq_s=marks["graph_start"] - t0, graph_s=marks["graph_end"] - marks["graph_start"],
                 index_s=t_end - marks["graph_end"], total_s=t_end - t0)
    mean_deg, max_deg = index.graph.degree_stats()
    build.update(mean_degree=mean_deg, max_degree=max_deg, medoid=index.graph.medoid,
                 pq_error=pq.quantization_error(index.codec, index.data_dev))
    log(f"[vamana] BangIndex.build n={VAMANA_N} d={D} m={M} R={VAMANA_R} L_build={VAMANA_L} "
        f"alpha={VAMANA_ALPHA} (gaussian_mixture seed {SEED}, intrinsic_dim {INTRINSIC_DIM}): "
        f"{build['total_s']:.3f} s = PQ on the card {build['pq_s']:.3f} s + graph on the host "
        f"{build['graph_s']:.3f} s ({build['graph_s'] / (2 * VAMANA_N) * 1e3:.3f} ms a point and pass) "
        f"+ index {build['index_s']:.3f} s; degree mean {mean_deg:.4f}, max {max_deg}, medoid "
        f"{index.graph.medoid}; PQ error (mean squared reconstruction) {build['pq_error']:.6g}")

    gt = brute_force_knn(data, queries, K, device=dev)
    cfg = SearchConfig()
    paths = {}
    for variant in ("inmem", "base", "exact"):
        name = f"vamana-{variant}"
        # Warm-up batch (first-use allocations), not counted.
        index.search(queries[:BATCH], K, cfg=cfg, variant=variant, kernel_mode="fused")
        torch.cuda.synchronize()
        res = run_path(name, index, queries, gt, cfg, variant, "fused", 1, card)
        ref_ids, _, ref_st = index.search(queries, K, cfg=cfg, variant=variant, kernel_mode="reference",
                                          return_stats=True)
        check_same(f"{name} fused vs reference ids", [ref_ids], res["ids"])
        # The plain mode's hops equal the kernels' (bit-exact search).
        res["p95_hops"] = ref_st.p95_hops
        set_profile(res, profile_batch(index, queries, cfg, variant, "fused", res["batch_wall_ms"][0]))
        busy = res["device_busy_ms_per_batch"]
        idle = "not measured" if busy is None else f"{100 * (1 - busy / res['batch_wall_ms'][0]):.1f}%"
        log(f"[{name}] fused ids equal kernel_mode='reference' ids; p95 hops per query "
            f"{res['p95_hops']:.2f} (cap {cfg.iters() - 1}); idle share {idle}")
        paths[name] = res
    check_same("vamana base vs inmem ids", paths["vamana-base"]["ids"], paths["vamana-inmem"]["ids"])
    check_same("vamana base vs inmem distances", paths["vamana-base"]["dists"],
               paths["vamana-inmem"]["dists"])
    log("[check] vamana: base ids and distances equal inmem's")
    # One batch of host-I/O base: the hot cache's hit rate on a real graph's
    # hub skew.
    from repro_torch.runtime.hostio import HostIOConfig

    hio = HostIOConfig(**VAMANA_HOSTIO)
    res = run_path("vamana-base-hostio", index, queries, gt, cfg, "base", "fused", 1, card, hostio=hio)
    check_same("vamana host-I/O base vs base ids", res["ids"], paths["vamana-base"]["ids"])
    check_same("vamana host-I/O base vs base distances", res["dists"], paths["vamana-base"]["dists"])
    rt = index.executor("base", hostio=hio).hostio_runtime
    stats = rt.stats()
    rt.stop()
    healthy("vamana-base-hostio", stats)
    for k in ("overlap_fraction", "cache_hit_rate", "mean_latency_ms"):
        res[k] = stats[k]
    log(f"[vamana-base-hostio] {hio}: ids and distances equal base's; hot-cache hit rate "
        f"{stats['cache_hit_rate']:.4f} ({stats['cache_hit_lanes']} of "
        f"{stats['cache_hit_lanes'] + stats['host_miss_lanes']} lanes), overlap_fraction "
        f"{stats['overlap_fraction']:.4f}")
    paths["vamana-base-hostio"] = res
    for res in paths.values():
        del res["ids"], res["dists"]
    return dict(build=build, paths=paths)


def profile_batch(index, queries, cfg, variant: str, kernel_mode: str,
                  batch_wall_ms: float, hostio=None) -> dict | None:
    """Device time by kernel over one batch (torch.profiler). Returns the
    device's busy ms and the collectives' (NCCL) device ms and event count,
    or None where the profiler saw no device time.

    Only device-side events are summed (an aten op's own entry repeats its
    kernels' time). The profiler slows the host many times over, so the busy
    time is set against `batch_wall_ms`, the mean wall of unprofiled batches.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        index.search(queries, K, cfg=cfg, variant=variant, kernel_mode=kernel_mode, hostio=hostio)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    def self_us(e) -> float:   # the name differs across torch versions
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and self_us(e) > 0), key=lambda e: -self_us(e))
    if not events:
        log(f"[profile] {variant}: the profiler recorded no device time: not measured")
        return None
    busy_ms = sum(self_us(e) for e in events) / 1e3
    nccl = [e for e in events if "nccl" in e.key.lower()]
    log(f"[profile] {variant}, one batch of {queries.shape[0]}: device busy {busy_ms:.2f} ms in "
        f"{sum(e.count for e in events)} device events = {100 * busy_ms / batch_wall_ms:.1f}% of "
        f"the unprofiled mean batch wall {batch_wall_ms:.2f} ms (profiled wall {wall_ms:.0f} ms)")
    for e in events[:12]:
        log(f"[profile]   {self_us(e) / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")
    for e in nccl:
        log(f"[profile]   collective {self_us(e) / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")
    for e in events:
        # The port's own kernels (csrc/*.cu); PyTorch's lie in at::.
        if "(anonymous namespace)::" in e.key and "at::" not in e.key:
            log(f"[profile]   port kernel {self_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
                f"{self_us(e) / e.count / 1e3:.4f} ms a launch  {e.key[:80]}")
    return dict(busy_ms=busy_ms, nccl_ms=sum(self_us(e) for e in nccl) / 1e3,
                nccl_events=sum(e.count for e in nccl))


def small_vs_cpu(dev) -> float:
    """A small corpus searched on the card (kernels) and on the CPU (plain
    versions): the ids and distances must agree. Returns the recall@10."""
    import torch

    from repro_torch import BangIndex, SearchConfig, brute_force_knn, recall_at_k
    from repro_torch.core import pq
    from repro_torch.data import gaussian_mixture, uniform_queries

    data = gaussian_mixture(4000, D, n_clusters=16, seed=SEED + 2)
    queries = uniform_queries(data, 40, seed=SEED + 3)
    x = torch.from_numpy(data)
    codec = pq.train_pq(x, M, iters=4)
    codes = pq.pq_encode(codec, x)
    adj, medoid = harness_graph(x, 32, SEED)
    cfg = SearchConfig(t=32, bloom_z=4096)
    out = {}
    for d in (dev, "cpu"):
        idx = BangIndex.from_arrays(codec.codebooks, codes, adj, medoid, x, device=d)
        ids, dists = idx.search(queries, K, cfg=cfg, kernel_mode="fused")
        out[str(d)] = (ids.cpu(), dists.cpu())
    (gi, gd), (ci, cd) = out[str(dev)], out["cpu"]
    if not torch.equal(gi, ci):
        raise AssertionError("card and CPU searches returned different ids")
    if not torch.allclose(gd, cd, rtol=1e-6, atol=1e-5):
        raise AssertionError("card and CPU re-ranked distances differ")
    rec = recall_at_k(gi.numpy(), brute_force_knn(x, queries, K, device=dev))
    log(f"[small] n=4000 corpus, 40 queries: card (kernels) and CPU (plain) ids equal, "
        f"max |dist diff| {float((gd - cd).abs().max()):.3g}, recall@10 {rec:.4f}")
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import common

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    lib = common.build_library(verbose=True)
    log(f"[build] {lib.relative_to(ROOT)} built in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rows = check_kernels(dev)
    log(f"[kernels] phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    res = main_path(dev, card)
    paths = res["paths"]
    log(f"[main] phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    paths.update(hostio_phase(dev, card, res.pop("ctx")))
    log(f"[hostio] phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    vamana = vamana_cell(dev, card)
    paths.update(vamana["paths"])
    log(f"[vamana] phase: {time.perf_counter() - t0:.1f} s")
    rows[0]["fresh_lanes_inmem"] = res["fresh_lanes"]
    for row in rows:
        # A kernel's launches are those of the path that runs it; the counts
        # of every path stand beside them.
        if row["name"] == "dist_table":
            row["launches"] = res["pq_table"]["launches"]["dist_table"]
            row["launches_per_batch"] = row["launches"] / res["pq_table"]["n_batches"]
            row["launches_by_path"] = {"pq_table": row["launches"]}
            continue
        primary = next(p for p in ("inmem", "exact", "staged", "sharded") if row["name"] in PATH_KERNELS[p])
        row["launches"] = paths[primary]["launches"][row["name"]]
        row["launches_per_batch"] = paths[primary]["launches_per_batch"][row["name"]]
        row["launches_by_path"] = {p: r["launches"][row["name"]] for p, r in paths.items()}

    t0 = time.perf_counter()
    small = small_vs_cpu(dev)
    log(f"[small] phase: {time.perf_counter() - t0:.1f} s")

    keys = ("recall_at_10", "qps", "n_batches", "mean_n_iters", "mean_hops", "batch_wall_ms",
            "device_busy_ms_per_batch", "link_bytes_per_hop", "rerank_bytes_per_batch",
            "host_gather_ms_per_batch", "host_gather_share", "collective_ms_per_batch",
            "collective_events_per_batch", "all_reduces_per_hop", "allreduce_ms",
            "allreduce_host_ms_per_batch",
            "exchange_bytes_per_hop", "k7_k6_launches_per_batch", "p95_hops", "hop_split_ms",
            "overlap_fraction", "cache_hit_rate", "mean_latency_ms", "host_link_bytes", "hostio",
            "p50_ms", "p95_ms", "mean_recall", "one_at_a_time_qps")
    summary = {p: {k: r[k] for k in keys if k in r} for p, r in paths.items()}
    for r in summary.values():
        busy = r.get("device_busy_ms_per_batch")
        r["idle_share"] = None if busy is None else 1.0 - busy / float(np.mean(r["batch_wall_ms"]))
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows, "main_path": summary, "nn_contrast": res["nn_contrast"],
                      "vamana_build": vamana["build"], "small_recall_at_10": small, "card": card}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
