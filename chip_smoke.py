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
  4c. the autotuner on phase 4's inmem executor at bucket 1,024:
     `autotune_executor` over eager True and False (two timed calls each;
     the card's only tile candidate is 0), each candidate's per-hop us and
     the winner; the winners file saved and loaded strictly, and an executor
     built with `autotune=` from it: its pipeline key equals the tuned one
     and its ids and distances equal a search with the winner's config;
  5. the Vamana cell: `BangIndex.build` over VAMANA_N points of the same
     draw's shape (d = 128, m = 32, R = 64, L_build = 128, alpha = 1.2):
     PQ trained and encoded on the card, the Vamana graph built on the
     host, each timed; then 1,000 held-out queries through inmem, base and
     exact (fused, t = 64), each with its launch counts set to 0 just
     before it: recall@10 against brute force, mean hops, n_iters, QPS and
     the idle share. Checks: fused ids equal kernel_mode="reference" ids on
     every variant, base ids and distances equal inmem's; and one batch of
     host-I/O base (four workers, 600 hot rows, prefetch), ids and
     distances equal base's, with the hot cache's hit rate on this graph;
  5b. streaming mutability on the Vamana cell's index (`MutableBangIndex`):
     MUT_INSERTS further points of the draw inserted and MUT_DELETES random
     non-medoid base ids deleted (1% of n each); the 1,000 queries through
     inmem, base, exact (fused, each also in reference mode) and sharded
     (the one-rank NCCL mesh), the staged mode on inmem, then the inserted
     vectors as queries, each with its launch counts set to 0 just before
     it. Checks: no deleted id in any result, each inserted vector's own id
     at rank 0, fused ids equal reference-mode ids, staged ids equal fused,
     sharded ids equal inmem's, `trace_counts` unchanged across three more
     deletes; recall@10 against brute force over `live_points()`. Then
     `consolidate()`, timed as host re-link / host inserts / re-encode on the
     card / swap, its codes against a CPU `pq_encode` of the same rows (the
     count of rows that differ, and for each differing code the float64 gap
     between the two centroids' squared distances in float32 ulps), and the
     same checks again; a second round
     of mutations folded by `consolidate_async()` while inmem batches are
     served (QPS before and during the fold); and `ServePipeline` over the
     mutable inmem executor with its result cache on: a repeat after a
     delete misses the cache and does not return the deleted id;
  6. a small corpus searched on the card and on the CPU, ids equal;
  7. the LM's serve path (`lm_phase`), after the earlier phases' memory is
     freed: 7a glm4-9b at full width and depth in bf16 (9.4 B parameters
     drawn on the card from a seeded generator), 4 requests of 2,048 random
     tokens prefilled, then 32 greedy exact-KV decode steps (prefill ms,
     decode ms a step, tokens/s, peak memory, parameter and KV bytes); 7b
     one request of 32,768 tokens, codebooks fitted per layer on its keys,
     16 steps exact and 16 BANG-KV (m = 16, top-L 64, window 256) from one
     state, the logit correlation and argmax agreement of every step and
     the share of exact attention's mass BANG-KV keeps at layer 0; 7e
     mamba2-2.7b at full width and depth in bf16 (64 Mamba2 layers), 4 x
     2,048 tokens and 32 greedy steps, then one request of 32,768 tokens
     and 16 steps (the SSM cache the same bytes a request at both lengths);
     7f zamba2-2.7b (54 Mamba2 layers, the shared attention block after
     every 6), 4 x 2,048 tokens, 32 greedy exact-KV steps, then 16 exact and
     16 BANG-KV steps from that state (codebooks fitted on each of the 9
     shared-block caches), logit correlation and argmax agreement a step;
     7g whisper-medium (24 encoder and 24 decoder layers), 4 requests of
     1,500 frame embeddings and 64-token prompts, the encoder timed alone,
     32 greedy exact-KV steps (each: prefill ms and tokens/s, decode ms a
     step, the idle share of one profiled step, peak memory, cache bytes);
     7c prefill-decode consistency at full width in float32, 4 layers of
     glm4-9b, phi3.5-moe and mamba2, 12 of zamba2 (two groups), 4 + 4 of
     whisper (rtol = atol = 2e-2), exact and, where the family has
     attention, BANG-KV with a covering top-L, and phi3.5-moe's dropped
     fraction at its published capacity; 7d the reduced glm4-9b, mamba2,
     zamba2 and whisper on the card against the CPU (rtol 1e-4, atol 1e-5)
     and BANG-KV's top-L overlap. No port kernel lies on this path: the
     launch counts stay 0. Its numbers go into the summary line under
     "lm".
  8. training (`train_phase`), through `runtime.train_loop` on the card:
     8a granite-3-2b at full width and depth in bf16 with remat (2.53 B
     parameters drawn on the card, the reference's float32 AdamW state),
     8 steps of 2 x 4,096 tokens of the synthetic stream (warmup 2, peak
     lr 3e-4): the step ms (median after the first), tokens/s, the
     model-FLOPs share (6 N tokens over the step and 989.4 TFLOP/s), the
     optimizer step alone (CUDA events), device busy, events and idle share
     of one profiled step, peak memory, each step's loss and grad norm
     (finite); 8b phi3.5-moe (2 layers), mamba2 (4), zamba2 (12), whisper
     (4 + 4, 448 decoder tokens after 1,500 frames) at full width and
     internvl2-1b at full depth, bf16, 3 steps each (step ms, peak memory,
     finite values); 8c the reduced granite, phi3.5-moe, mamba2, zamba2 and
     whisper at float32 on the card against the CPU from one set of
     parameters: `LM.loss`, its metrics and the grad norm (rtol 1e-4, atol
     1e-5), 3 `train_loop` steps' losses and grad norms, the master
     parameters after them; 8d a failure injected at step 7 of reduced
     granite with checkpoints every 3 steps, resumed, bit-equal to an
     uninterrupted run. No port kernel lies on this path: the launch
     counts stay 0. Its numbers go into the summary line under "train".
  9. the mesh training step (`mesh_phase`) on the (1, 1) mesh, a one-rank
     NCCL group: 9a granite-3-2b at full width and depth (8a's shape, bf16,
     remat, 2 x 4,096 tokens, parameters drawn from 8a's seed), 3 steps of
     `launch.specs.step_and_specs`'s train step (every weight gathered at
     its use, the vocabulary-parallel cross-entropy, the row-parallel
     all-reduces, the sharded global norm, all over one rank), then 3
     plain steps (`LM.loss`, backward, `adamw_update` at lr 1e-4) from the
     same parameters (drawn again from the seed): each step's loss and the
     bf16 parameters after step 3, from host copies, bit-equal or within
     the stated bound; both median step times, the mesh step's collectives
     a step (host count), its NCCL kernels and device copies and their
     share of device time (one step profiled on the device alone), and
     peak memory of each; 9b `compressed_psum` over the
     one-rank data group on granite's gradients of the profiled step,
     bit-equal to `ef_int8_compress` (n = 1). No port kernel lies on this
     path: the launch counts stay 0. Its numbers go into the summary line
     under "mesh".
  10. prefill and decode on the (1, 1) mesh (`mesh_serve_phase`), after
     phase 9: glm4-9b at full width and depth in bf16 with
     `opt_hier_topk`, its parameters drawn again from 7a's seed; 10a 7a's
     requests prefilled and decoded 32 greedy exact-KV steps by the plain
     `LM` and by `launch.specs.step_and_specs`'s prefill and decode steps;
     10b 16 greedy BANG-KV steps of each from 7b's state (host copies kept
     by phase 7), the mesh's top-L the hierarchical one. Logits, tokens,
     caches and every layer's top-L ids bit-equal; step times against the
     plain steps, the collectives a step (host count) and the host us of
     one collective, one profiled mesh step each, peak memory. No port
     kernel lies on this path: the launch counts stay 0. Its numbers go
     into the summary line under "mesh_serve".
  11. the moe family on the (1, 1) mesh (`mesh_moe_phase`), after phase 10,
     parameters drawn on the card from a seed, depth cut (listed as cuts):
     11a phi3.5-moe (hf:microsoft/Phi-3.5-MoE-instruct) at full width, 2
     of 32 layers, bf16 with remat, 3 steps of `step_and_specs`'s train
     step on 2 x 4,096 tokens, then 3 plain steps from the same draw:
     losses within rtol 1e-5, the bf16 parameters within ROADMAP C15's
     bound (the dispatch's backward sums with atomics, C17), step times,
     collectives a step, peak memory; 11b phi3.5-moe, 8 of 32 layers, 7a's
     4 x 2,048 tokens prefilled and 32 greedy exact-KV steps; 11c
     llama4-scout (hf:meta-llama/Llama-4-Scout-17B-16E), 4 of 48 layers,
     its shared expert on the card, 7a's requests and 16 steps; each plain
     then through the mesh prefill and decode steps, logits, tokens, caches
     and every layer's dropped fraction bit-equal, decode ms a step against
     the plain path, collectives a step, one profiled mesh step (11b), peak
     memory. No port kernel lies on this path: the launch counts stay 0.
     Its numbers go into the summary line under "mesh_moe".
  12. the ssm and hybrid families on the (1, 1) mesh (`mesh_ssm_phase`),
     after phase 11, every width of the Mamba2 block (in_proj's columns,
     the conv channels, the heads, di) on the one `model` rank, parameters
     drawn on the card from a seed: 12a mamba2-2.7b
     (arXiv:2405.21060) cut to 4 of 64 layers and zamba2-2.7b
     (hf:Zyphra/Zamba2-2.7B) to 12 of 54 (8b's cuts), bf16 with remat, 3
     steps of `step_and_specs`'s train step on 2 x 4,096 tokens, then 3
     plain steps from the same draw: losses within rtol 1e-5, the bf16
     parameters within ROADMAP C15's bound; 12b mamba2-2.7b at full depth
     serving 7e's 4 x 2,048 tokens and 32 greedy steps, one mesh step
     profiled; 12c zamba2-2.7b at full depth serving 7f's requests, 32
     greedy exact-KV steps, then 16 greedy BANG-KV steps with the
     hierarchical top-L, the codebooks fitted once on the plain path's
     keys; each plain then through the mesh prefill and decode steps,
     logits, tokens, every cache tensor and the top-L ids bit-equal;
     decode and prefill ms against the plain path, collectives a step,
     peak memory. No port kernel lies on this path: the launch counts stay
     0. Its numbers go into the summary line under "mesh_ssm".
  13. the encdec family on the (1, 1) mesh (`mesh_encdec_phase`), after
     phase 12: whisper-medium (arXiv:2212.04356) at full width and depth,
     24 encoder and 24 decoder layers, bf16, its parameters drawn on the
     card from a seed, the encoder's, the self-attention's and the
     cross-attention's heads and the FFNs on the one `model` rank, the
     cross K and V whole there: 13a 3 steps of `step_and_specs`'s train
     step on 2 x 448 tokens after 1,500 frames (8b's shape without its
     depth cut), with remat, then 3 plain steps from the same draw, losses
     within rtol 1e-5 and the bf16 parameters within ROADMAP C15's bound;
     13b 7g's requests (4 x 1,500 frames, 64-token prompts) prefilled and
     decoded 32 greedy exact-KV steps, one mesh step profiled; 13c 4
     requests of 448-token prompts, 4 exact-KV steps, then 16 greedy
     BANG-KV steps with the hierarchical top-L (its 64 keys reach past the
     256-token window), the codebooks fitted once on the plain path's
     keys; each plain then through the mesh prefill and decode steps,
     logits, tokens, the self caches, the cross K and V and the top-L ids
     bit-equal; prefill and decode ms against the plain path, collectives
     a step, peak memory. No port kernel lies on this path: the launch
     counts stay 0. Its numbers go into the summary line under
     "mesh_encdec".
  14. the launch slice (`launch_phase`), after phase 13: 14a the ANN serve
     CLI (`repro_torch.launch.serve.main`, its defaults: n = 4,000, d =
     64, 3 batches of 128, t = 64) on the card, each batch's QPS and
     recall@10, the recall no lower than the reference package's CLI
     gives on the CPU for the same arguments; it runs the ANN main path,
     so K1-K3 launch there and their counts are printed beside it; 14b
     granite-3-2b cut to 4 layers at 9a's shape on the (1, 1, 1) ("pod",
     "data", "model") mesh, a one-rank NCCL group: 2 training steps, a
     prefill and 4 greedy exact-KV steps, each bit-equal to the plain path
     on the same parameters, launch counts 0; 14c, after them,
     `launch.dryrun` in processes of its own (host work only, one a cell,
     side by side), the step of one cell a family (decode_32k) shape-only at full width and
     depth on a fake 2 x 16 x 16 process group and the sharded search at
     the reference's `--dryrun-sharded` shapes: each cell's wall, peak
     bytes a rank and dominant roofline term, estimates from shapes. Its
     numbers go into the summary line under "launch".

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
# The Vamana cell (phase 5): its host build (3.6-5.7 ms a point and pass
# at R = 64, L = 128 on the H100 machines' hosts) cut from 15,000 points to
# 6,000 so that the whole script, phase 14 in it, stays within its earlier
# time on a slow host.
VAMANA_N, VAMANA_QUERIES = 6_000, 1_000
VAMANA_R, VAMANA_L, VAMANA_ALPHA = 64, 128, 1.2
# Phase 5b: mutations of the Vamana cell's index, 1% of its n each: inserts
# of further points of the same draw (two rounds: before the fold, and
# before the background fold), deletes of random non-medoid base ids.
MUT_INSERTS, MUT_DELETES = 60, 60
MUT_BATCHES = 3                # timed batches of each phase-5b path
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
    "autotune-inmem": ("search_step", "pq_adc", "rerank_l2"),
}
# Phase 5b's paths: each variant before ("mutable-") and after
# ("consolidated-") the fold, the inserted vectors as queries, the staged mode
# on one batch, batches served during the background fold, and the pipeline.
for _stage in ("mutable", "consolidated"):
    PATH_KERNELS.update({
        f"{_stage}-inmem": PATH_KERNELS["inmem"], f"{_stage}-base": PATH_KERNELS["base"],
        f"{_stage}-exact": PATH_KERNELS["exact"], f"{_stage}-sharded": PATH_KERNELS["sharded"],
        f"{_stage}-inserts": PATH_KERNELS["inmem"], f"{_stage}-staged": PATH_KERNELS["staged"],
    })
PATH_KERNELS.update({"mutable-during-fold": PATH_KERNELS["inmem"],
                     "serve-mutable-inmem": PATH_KERNELS["inmem"]})


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
VAMANA_HOSTIO = dict(workers=4, hot_cache_rows=600, prefetch=True)


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
    every variant, base ids and distances equal inmem's. Returns the build,
    each path's measurements, keyed as the paths are named, and what phase
    5b reuses: the index, the queries, the points it inserts and the
    configuration."""
    import torch

    from repro_torch import BangIndex, SearchConfig, brute_force_knn
    from repro_torch.core import bang as bang_mod
    from repro_torch.core import pq
    from repro_torch.data import gaussian_mixture

    # The base points, the held-out queries and phase 5b's inserts, from one draw.
    both = gaussian_mixture(VAMANA_N + VAMANA_QUERIES + 2 * MUT_INSERTS, D, seed=SEED,
                            intrinsic_dim=INTRINSIC_DIM)
    data = both[:VAMANA_N]
    queries = both[VAMANA_N : VAMANA_N + VAMANA_QUERIES]
    fresh = both[VAMANA_N + VAMANA_QUERIES :]
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
    return dict(build=build, paths=paths, ctx=dict(index=index, queries=queries, fresh=fresh, cfg=cfg))


# ------------------------------------------------------------ phase 4c
def autotune_phase(dev, card: str, ctx: dict) -> dict:
    """Phase 4c: `autotune_executor` on phase 4's inmem executor at bucket
    BATCH, eager True and False (the card's tile candidates are 0 alone),
    two timed calls each; the winners file saved and loaded strictly; an
    executor built with `autotune=` from the loaded file, whose pipeline key
    must equal the tuned one and whose ids must equal a search with the
    winner's configuration. Its search is the "autotune-inmem" path."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.kernels import autotune as at
    from repro_torch.runtime import SearchExecutor

    index, queries, cfg = ctx["index"], ctx["queries"], ctx["cfg"]
    q = queries[:BATCH]
    ex = index.executor("inmem")
    t0 = time.perf_counter()
    cache = at.autotune_executor(ex, q, k=K, t=cfg.t, cfg=cfg, eager_options=(True, False), repeats=2)
    sweep_s = time.perf_counter() - t0
    bucket = ex._bucket_for(BATCH)
    r, m, n_rows = ex.autotune_shape()
    kind = at.device_kind(dev)
    winner = cache.lookup(kind, bucket, r, m)
    if winner is None or len(cache) != 1:
        raise AssertionError(f"autotune: no single winner for ({kind}, {bucket}, {r}, {m}): {cache.winners}")
    for cand in cache.last_sweep:
        log(f"[autotune] eager={cand['eager']} codes_tile_rows={cand['codes_tile_rows']}: per-hop us "
            f"{[round(u, 3) for u in cand['per_hop_us']]} (best {min(cand['per_hop_us']):.3f})")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "winners.json"
        cache.save(path)
        loaded = at.AutotuneCache.load(path, strict=True)
    if loaded.winners != cache.winners:
        raise AssertionError("autotune: the reloaded winners differ from the saved ones")
    tuned_cfg = dataclasses.replace(cfg, kernel_mode="fused", eager=winner["eager"],
                                    codes_tile_rows=winner["codes_tile_rows"])
    tuned = SearchExecutor.from_index(index, "inmem", autotune=loaded)
    tuned.search(q, K, cfg=cfg, kernel_mode="fused")       # builds the pipeline
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ids, dists, st = tuned.search(q, K, cfg=cfg, kernel_mode="fused", return_stats=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    for kname in PATH_KERNELS["autotune-inmem"]:
        if launches[kname] <= 0:
            raise AssertionError(f"the autotune-inmem path launched no {kname} kernel")
    keys = set(tuned._cache)
    want = (bucket, D, K, True, tuned_cfg, None, False)
    if keys != {want} or want not in ex._cache:
        raise AssertionError(f"autotune: pipeline keys {keys}, tuned key {want}")
    ids_w, dists_w = ex.search(q, K, cfg=tuned_cfg)
    check_same("autotune tuned vs winner's config ids", [ids], [ids_w])
    check_same("autotune tuned vs winner's config distances", [dists], [dists_w])
    log(f"[autotune] sweep of {len(cache.last_sweep)} candidates over bucket {bucket} (R={r}, m={m}, "
        f"{n_rows} code rows) on {kind}: {sweep_s:.2f} s; winner eager={winner['eager']} "
        f"codes_tile_rows={winner['codes_tile_rows']} at {winner['per_hop_us']:.3f} us a hop; the "
        f"reloaded file's executor built the tuned key and returned the winner's ids and distances")
    return {"autotune-inmem": dict(
        qps=BATCH / wall, n_batches=1, n_iters=[st.n_iters], mean_hops=st.mean_hops,
        batch_wall_ms=[st.wall_s * 1e3], launches=launches,
        launches_per_batch=dict(launches), winner=winner, sweep=cache.last_sweep, sweep_s=sweep_s,
        device_kind=kind)}


# ------------------------------------------------------------ phase 5b
def mutable_run(name: str, ex, queries, cfg, kernel_mode: str = "fused") -> dict:
    """MUT_BATCHES batches of the same queries through a mutable executor
    (a warm-up batch first), with every launch count set to 0 just before
    them and read just after; the host seconds of the delta fusion
    (`runtime.mutation._fuse_delta`) are summed apart. Returns the last
    batch's ids and distances, each batch's wall and the launches."""
    import torch

    from repro_torch.runtime import mutation as mutation_mod

    ex.search(queries, K, cfg=cfg, kernel_mode=kernel_mode)
    torch.cuda.synchronize()
    real_fuse, fuse_s = mutation_mod._fuse_delta, []

    def timed_fuse(*args):
        t0 = time.perf_counter()
        out = real_fuse(*args)
        fuse_s.append(time.perf_counter() - t0)
        return out

    mutation_mod._fuse_delta = timed_fuse
    try:
        reset_launches()
        walls, iters, hops = [], [], []
        for _ in range(MUT_BATCHES):
            t0 = time.perf_counter()
            ids, dists, st = ex.search(queries, K, cfg=cfg, kernel_mode=kernel_mode, return_stats=True)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            iters.append(st.n_iters)
            hops.append(st.mean_hops)
        launches = read_launches()
    finally:
        mutation_mod._fuse_delta = real_fuse
    for kname in PATH_KERNELS[name]:
        if launches[kname] <= 0:
            raise AssertionError(f"the {name} path launched no {kname} kernel")
    return dict(ids=ids.cpu().numpy(), dists=dists.cpu().numpy(),
                qps=MUT_BATCHES * len(queries) / sum(walls), n_batches=MUT_BATCHES, n_iters=iters,
                mean_hops=float(np.mean(hops)), batch_wall_ms=[w * 1e3 for w in walls],
                fuse_ms_per_batch=sum(fuse_s) * 1e3 / MUT_BATCHES, launches=launches,
                launches_per_batch={k: v / MUT_BATCHES for k, v in launches.items()})


def no_deleted(name: str, ids: np.ndarray, deleted: set) -> None:
    hit = deleted & set(ids.ravel().tolist())
    if hit:
        raise AssertionError(f"{name}: deleted ids {sorted(hit)[:5]} returned")


def mutable_paths(stage: str, mut, queries, inserted, new_ids, deleted: set, cfg, dev,
                  yardstick) -> dict:
    """The checks phase 5b makes before and after the fold: the queries
    through inmem, base and exact (fused, each also in reference mode) and
    sharded (the default one-rank mesh); the staged mode on inmem; then the
    inserted vectors as queries. No deleted id in any result, fused ids
    equal reference-mode ids, sharded ids equal inmem's. Recall@10 is taken
    against brute force over `live_points()`.

    The inserted vectors' own ids: while they are delta points the exact
    scan must put each at rank 0. Once the fold has made them graph nodes,
    each must be linked (in- and out-edges), and the share found at rank 0
    is reported beside `yardstick`'s, base ids of the same index searched
    as their own queries: graph search finds neither share by construction."""
    import torch

    from repro_torch import brute_force_knn, recall_at_k

    live_ids, live_vecs = mut.live_points()
    gt = live_ids[brute_force_knn(live_vecs, queries, K, device=dev)]
    out = {}
    for variant in ("inmem", "base", "exact", "sharded"):
        name = f"{stage}-{variant}"
        ex = mut.executor(variant)
        res = mutable_run(name, ex, queries, cfg)
        no_deleted(name, res["ids"], deleted)
        res["recall_at_10"] = recall_at_k(res["ids"], gt)
        if variant != "sharded":
            ref_ids = ex.search(queries, K, cfg=cfg, kernel_mode="reference")[0].cpu().numpy()
            if not np.array_equal(ref_ids, res["ids"]):
                raise AssertionError(f"{name}: fused ids differ from kernel_mode='reference' ids")
        out[name] = res
    if not np.array_equal(out[f"{stage}-sharded"]["ids"], out[f"{stage}-inmem"]["ids"]):
        raise AssertionError(f"{stage}: sharded ids differ from inmem's")
    name = f"{stage}-staged"
    out[name] = res = mutable_run(name, mut.executor("inmem"), queries, cfg, "staged")
    if not np.array_equal(res["ids"], out[f"{stage}-inmem"]["ids"]):
        raise AssertionError(f"{name}: staged ids differ from fused ids")
    res["recall_at_10"] = out[f"{stage}-inmem"]["recall_at_10"]
    name = f"{stage}-inserts"
    out[name] = res = mutable_run(name, mut.executor("inmem"), inserted, cfg)
    no_deleted(name, res["ids"], deleted)
    found = res["ids"][:, 0] == new_ids
    in_delta = int(new_ids.min()) >= mut.index.n
    base_vecs = mut.index.data_host[torch.from_numpy(yardstick).long()].numpy()
    base_found = mut.executor("inmem").search(base_vecs, K, cfg=cfg)[0].cpu().numpy()[:, 0] == yardstick
    res.update(recall_at_10=float(found.mean()), base_own_id_at_rank0=float(base_found.mean()),
               in_top10=float((res["ids"] == new_ids[:, None]).any(1).mean()))
    if in_delta and not found.all():
        raise AssertionError(f"{name}: {int((~found).sum())} of {len(new_ids)} delta points not at rank 0")
    if not in_delta:
        adj = mut.index.graph.adjacency.numpy()
        in_deg = np.bincount(adj[adj >= 0], minlength=adj.shape[0])[new_ids]
        out_deg = (adj[new_ids] >= 0).sum(1)
        if (in_deg == 0).any() or (out_deg == 0).any():
            raise AssertionError(f"{name}: {int((in_deg == 0).sum())} folded points without in-edges, "
                                 f"{int((out_deg == 0).sum())} without out-edges")
        res.update(in_degree_mean=float(in_deg.mean()), out_degree_mean=float(out_deg.mean()),
                   missed_in_degree=in_deg[~found].tolist(), missed_out_degree=out_deg[~found].tolist())
    log(f"[{name}] own id at rank 0: {int(found.sum())} of {len(new_ids)} inserted vectors "
        f"({'the exact delta scan' if in_delta else 'graph nodes since the fold'}), in the top 10: "
        f"{res['in_top10']:.4f}; {int(base_found.sum())} of {len(yardstick)} base points of the index "
        f"searched as their own queries"
        + ("" if in_delta else f"; folded points' in-degree mean {res['in_degree_mean']:.2f} (min "
           f"{int(in_deg.min())}), out-degree mean {res['out_degree_mean']:.2f}; the missed ones' in-degrees "
           f"{res['missed_in_degree']}, out-degrees {res['missed_out_degree']}"))
    for name, r in out.items():
        log(f"[{name}] {len(queries) if not name.endswith('inserts') else len(inserted)} queries: "
            f"recall@10 {r['recall_at_10']:.5f}"
            f"{' (own id at rank 0)' if name.endswith('inserts') else ''}, QPS {r['qps']:.1f} over "
            f"{r['n_batches']} batches (walls ms {[round(w, 2) for w in r['batch_wall_ms']]}; delta fusion on "
            f"the host {r['fuse_ms_per_batch']:.2f} ms a batch), n_iters {r['n_iters']}, mean hops "
            f"{r['mean_hops']:.2f}; launches {r['launches']}")
    log(f"[{stage}] no deleted id returned; fused ids equal reference-mode ids (inmem, base, exact), "
        f"staged ids equal fused, sharded ids equal inmem's")
    for r in out.values():
        del r["ids"], r["dists"]
    return out


def code_gaps(codebooks, data, card_codes, cpu_codes) -> list[dict]:
    """For each (row, subspace) whose card-encoded code differs from the
    CPU's: both centroids' squared distances to the row's subvector in
    float64, their gap, and the float32 ulp at the distance and at
    |x|^2 + |c|^2, the size of the terms whose difference `pq_encode`
    takes (ROADMAP C10). A gap of a few ulps of the terms is a near tie."""
    m = codebooks.shape[0]
    x = data.double().reshape(data.shape[0], m, -1)
    cb = codebooks.double()
    out = []
    for row, sub in (card_codes != cpu_codes).nonzero().tolist():
        xs = x[row, sub]
        a, b = int(card_codes[row, sub]), int(cpu_codes[row, sub])
        da, db = float(((xs - cb[sub, a]) ** 2).sum()), float(((xs - cb[sub, b]) ** 2).sum())
        terms = float((xs * xs).sum() + (cb[sub, a] * cb[sub, a]).sum())
        gap = abs(da - db)
        ulp_d, ulp_t = float(np.spacing(np.float32(max(da, db)))), float(np.spacing(np.float32(terms)))
        out.append({"row": row, "subspace": sub, "card_code": a, "cpu_code": b, "card_d2": da,
                    "cpu_d2": db, "gap": gap, "ulp_at_d2": ulp_d, "ulp_at_terms": ulp_t,
                    "gap_in_ulps_of_terms": gap / ulp_t})
        log(f"[mutation] C10 row {row} subspace {sub}: card code {a} d2 {da:.9g}, CPU code {b} d2 "
            f"{db:.9g} (float64); gap {gap:.3g} = {gap / ulp_d:.2f} float32 ulps at d2, "
            f"{gap / ulp_t:.2f} ulps at |x|^2+|c|^2 = {terms:.6g}")
    return out


def mutation_phase(dev, card: str, vctx: dict) -> dict:
    """Phase 5b: streaming mutability on the Vamana cell's index.

    MUT_INSERTS further points of the draw inserted and MUT_DELETES random
    non-medoid base ids deleted through `MutableBangIndex`; `mutable_paths`'
    checks; three more deletes with `trace_counts` unchanged; `consolidate()`
    timed in its stages, the re-encoded codes against a CPU `pq_encode` of
    the same rows, and `mutable_paths` again; a second round of mutations
    folded by `consolidate_async()` while inmem batches are served (QPS
    before and during the fold); then `ServePipeline` over the mutable inmem
    executor with its result cache on, where a repeat after a delete must
    miss the cache and not return the deleted id."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import pq
    from repro_torch.runtime import MutableBangIndex, ServePipeline

    index, queries, fresh, cfg = vctx["index"], vctx["queries"], vctx["fresh"], vctx["cfg"]
    medoid = index.graph.medoid
    rng = np.random.default_rng(SEED + 5)
    paths, info = {}, {}
    made = not dist.is_initialized()
    # The fold inserts with the build's beam width.
    mut = MutableBangIndex(index, alpha=VAMANA_ALPHA, consolidate_L=VAMANA_L)
    try:
        t0 = time.perf_counter()
        new_ids = mut.insert(fresh[:MUT_INSERTS])
        insert_s = time.perf_counter() - t0
        victims = [int(i) for i in rng.choice(index.n, MUT_DELETES + 1, replace=False) if i != medoid]
        victims = victims[:MUT_DELETES]
        t0 = time.perf_counter()
        mut.delete(victims)
        delete_s = time.perf_counter() - t0
        deleted = set(victims)
        log(f"[mutation] {MUT_INSERTS} inserts ({insert_s * 1e3:.1f} ms on the host) and {MUT_DELETES} "
            f"deletes ({delete_s * 1e3:.3f} ms) on the n={index.n} Vamana index: {mut.mutation_stats()}")
        # Live base ids searched as their own queries: the yardstick for
        # the inserted vectors once they are graph nodes.
        yardstick = np.array([int(i) for i in rng.choice(index.n, 2 * MUT_INSERTS, replace=False)
                              if int(i) != medoid and int(i) not in deleted][:MUT_INSERTS])
        paths.update(mutable_paths("mutable", mut, queries, fresh[:MUT_INSERTS], new_ids, deleted, cfg, dev,
                                   yardstick))

        # Deletes build no pipeline: the bitmap is an argument.
        ex = mut.executor("inmem")
        traces = dict(ex.trace_counts)
        for v in [int(i) for i in rng.choice(index.n, 8, replace=False)
                  if i != medoid and int(i) not in deleted][:3]:
            mut.delete([v])
            deleted.add(v)
            no_deleted("delete without a rebuild", ex.search(queries, K, cfg=cfg)[0].cpu().numpy(), deleted)
        if dict(ex.trace_counts) != traces:
            raise AssertionError(f"deletes built pipelines: {traces} -> {dict(ex.trace_counts)}")
        log(f"[mutation] three more deletes: trace_counts unchanged ({sum(traces.values())} builds)")

        stats = mut.consolidate()
        fold = dict(mut.last_consolidation)
        new = mut.index
        cpu_codes = pq.pq_encode(pq.PQCodec(new.codec.codebooks.cpu()), new.data_host)
        differ = int((cpu_codes != new.codes.cpu()).any(1).sum())
        gaps = code_gaps(new.codec.codebooks.cpu(), new.data_host, new.codes.cpu(), cpu_codes)
        info.update(consolidate_s=fold, consolidated_stats=stats, codes_rows=int(new.n),
                    codes_rows_differing_from_cpu=differ, code_gaps=gaps)
        log(f"[mutation] consolidate(): {fold['total_s']:.3f} s = host re-link {fold['relink_s']:.3f} s + "
            f"host inserts {fold['insert_s']:.3f} s + re-encode and tables on the card "
            f"{fold['encode_s']:.3f} s + swap {fold['swap_s'] * 1e3:.3f} ms; {stats}; re-encoded codes: "
            f"{differ} of {new.n} rows differ from a CPU pq_encode of the same rows")
        yardstick = np.array([int(i) for i in yardstick if int(i) not in deleted])
        paths.update(mutable_paths("consolidated", mut, queries, fresh[:MUT_INSERTS], new_ids, deleted,
                                   cfg, dev, yardstick))

        # A second round, folded in the background while batches are served.
        new_ids2 = mut.insert(fresh[MUT_INSERTS:])
        victims2 = [int(i) for i in rng.choice(index.n, MUT_DELETES + 8, replace=False)
                    if i != medoid and int(i) not in deleted][:MUT_DELETES]
        mut.delete(victims2)
        deleted.update(victims2)
        ex = mut.executor("inmem")
        ex.search(queries, K, cfg=cfg, kernel_mode="fused")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            no_deleted("before the fold", ex.search(queries, K, cfg=cfg, kernel_mode="fused")[0].cpu().numpy(),
                       deleted)
        qps_before = 5 * len(queries) / (time.perf_counter() - t0)
        reset_launches()
        th = mut.consolidate_async()
        t0 = time.perf_counter()
        served = 0
        while True:
            alive = th.is_alive()
            ids = ex.search(queries, K, cfg=cfg, kernel_mode="fused")[0].cpu().numpy()
            no_deleted("during the fold", ids, deleted)
            served += 1
            if not alive:
                break
        during_s = time.perf_counter() - t0
        th.join()
        launches = read_launches()
        if mut.consolidate_error is not None or mut.generation != 2:
            raise AssertionError(f"consolidate_async failed: {mut.consolidate_error!r}")
        for kname in PATH_KERNELS["mutable-during-fold"]:
            if launches[kname] <= 0:
                raise AssertionError(f"the mutable-during-fold path launched no {kname} kernel")
        ids = ex.search(fresh[MUT_INSERTS:], K, cfg=cfg)[0].cpu().numpy()
        no_deleted("after the background fold", ids, deleted)
        adj = mut.index.graph.adjacency.numpy()
        if not ((adj[new_ids2] >= 0).any(1).all() and np.isin(new_ids2, adj[adj >= 0]).all()):
            raise AssertionError("the background fold left inserted points without in- or out-edges")
        async_fold = dict(mut.last_consolidation)
        info["second_round_own_id_at_rank0"] = float((ids[:, 0] == new_ids2).mean())
        paths["mutable-during-fold"] = dict(qps=served * len(queries) / during_s, n_batches=served,
                                            launches=launches, launches_per_batch={
                                                k: v / served for k, v in launches.items()},
                                            batch_wall_ms=[during_s * 1e3 / served])
        info.update(qps_before_fold=qps_before, qps_during_fold=served * len(queries) / during_s,
                    batches_during_fold=served, async_fold_s=async_fold)
        log(f"[mutation] consolidate_async() of {MUT_INSERTS} inserts and {MUT_DELETES} deletes "
            f"({async_fold['total_s']:.3f} s: re-link {async_fold['relink_s']:.3f}, inserts "
            f"{async_fold['insert_s']:.3f}, re-encode {async_fold['encode_s']:.3f}) beside inmem batches "
            f"of {len(queries)}: QPS {qps_before:.1f} before the fold, "
            f"{info['qps_during_fold']:.1f} during it ({served} batches in {during_s:.3f} s; the fold's "
            f"Python holds the interpreter lock the hop loop needs); no deleted id returned; the second "
            f"round's inserts at rank 0 after the fold: {info['second_round_own_id_at_rank0']:.4f}")

        name = "serve-mutable-inmem"
        with ServePipeline(mut.executor("inmem"), k=K, cfg=cfg, max_batch=BATCH, kernel_mode="fused",
                           result_cache_size=len(queries)) as pipe:
            reset_launches()
            pipe.submit(queries)
            ids0, _, st0 = pipe.drain()
            launches = read_launches()
            for kname in PATH_KERNELS[name]:
                if launches[kname] <= 0:
                    raise AssertionError(f"the {name} path launched no {kname} kernel")
            no_deleted(name, ids0, deleted)
            pipe.submit(queries)
            ids1, _, st1 = pipe.drain()
            if st1.result_cache_hits != len(queries) or not np.array_equal(ids1, ids0):
                raise AssertionError(f"{name}: the repeat was not served from the result cache")
            victim = next(int(i) for i in ids0[:, 0] if int(i) != medoid)
            mut.delete([victim])
            deleted.add(victim)
            pipe.submit(queries)
            ids2, _, st2 = pipe.drain()
            if st2.result_cache_hits != 0:
                raise AssertionError(f"{name}: {st2.result_cache_hits} cache hits after a delete")
            no_deleted(name, ids2, deleted)
        paths[name] = dict(qps=st0.qps, p50_ms=st0.p50_ms, p95_ms=st0.p95_ms, n_batches=st0.batches,
                           launches=launches,
                           launches_per_batch={k: v / st0.batches for k, v in launches.items()},
                           batch_wall_ms=[st0.wall_s * 1e3 / st0.batches])
        log(f"[{name}] ServePipeline(max_batch={BATCH}, result cache on) over the mutable inmem executor: "
            f"QPS {st0.qps:.1f}, p50 {st0.p50_ms:.2f} ms; the repeat hit the cache {st1.result_cache_hits} "
            f"times; after deleting id {victim} the repeat hit it {st2.result_cache_hits} times and did "
            f"not return the id")
        info["final_stats"] = mut.mutation_stats()
    finally:
        mut.close()
        if made and dist.is_initialized():
            dist.destroy_process_group()
    return dict(paths=paths, info=info)


def profile_batch(index, queries, cfg, variant: str, kernel_mode: str,
                  batch_wall_ms: float, hostio=None) -> dict | None:
    """Device time by kernel over one batch (torch.profiler). Returns the
    device's busy ms and the collectives' (NCCL) device ms and event count,
    or None where the profiler saw no device time.

    Only device-side events are summed (an aten op's own entry repeats its
    kernels' time). The profiler slows the host many times over, so the busy
    time is set against `batch_wall_ms`, the mean wall of unprofiled batches.
    """
    return device_profile(
        f"{variant}, one batch of {queries.shape[0]}",
        lambda: index.search(queries, K, cfg=cfg, variant=variant, kernel_mode=kernel_mode,
                             hostio=hostio),
        batch_wall_ms)


def port_kernel_names() -> set:
    """The `__global__` functions of the port's CUDA sources."""
    import re

    names = set()
    for src in (ROOT / "src" / "repro_torch" / "csrc").glob("*.cu*"):
        names.update(re.findall(r"__global__\s+(?:__launch_bounds__\([^)]*\)\s+)?void\s+"
                                 r"(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                                src.read_text()))
    return names


def device_profile(label: str, fn, wall_ms_unprofiled: float, cpu_ops: bool = True) -> dict | None:
    """Device time by kernel over one call of `fn` (torch.profiler), set
    against `wall_ms_unprofiled`, the mean wall of unprofiled calls.
    Returns the busy ms, the device event count and the collectives' (NCCL)
    ms and events, or None where the profiler saw no device time. With
    `cpu_ops=False` only device activity is recorded (a training step's
    host ops take the profiler tens of seconds to process)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    activities = [ProfilerActivity.CPU] if cpu_ops else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    def self_us(e) -> float:   # the name differs across torch versions
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and self_us(e) > 0), key=lambda e: -self_us(e))
    if not events:
        log(f"[profile] {label}: the profiler recorded no device time: not measured")
        return None
    busy_ms = sum(self_us(e) for e in events) / 1e3
    n_events = sum(e.count for e in events)
    nccl = [e for e in events if "nccl" in e.key.lower()]
    log(f"[profile] {label}: device busy {busy_ms:.2f} ms in "
        f"{n_events} device events = {100 * busy_ms / wall_ms_unprofiled:.1f}% of "
        f"the unprofiled mean wall {wall_ms_unprofiled:.2f} ms (profiled wall {wall_ms:.0f} ms)")
    for e in events[:12]:
        log(f"[profile]   {self_us(e) / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")
    for e in nccl:
        log(f"[profile]   collective {self_us(e) / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")
    port = port_kernel_names()
    for e in events:
        # The port's own kernels (csrc/*.cu), by name: PyTorch's lie in
        # anonymous namespaces too (`indexing_backward_kernel`).
        if any(f"::{name}" in e.key for name in port):
            log(f"[profile]   port kernel {self_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
                f"{self_us(e) / e.count / 1e3:.4f} ms a launch  {e.key[:80]}")
    copies = [e for e in events if "memcpy dtod" in e.key.lower()]
    return dict(busy_ms=busy_ms, device_events=n_events, nccl_ms=sum(self_us(e) for e in nccl) / 1e3,
                nccl_events=sum(e.count for e in nccl),
                copy_ms=sum(self_us(e) for e in copies) / 1e3, copy_events=sum(e.count for e in copies))


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


# ------------------------------------------------------------- phase 7
LM_ARCH, LM_MOE_ARCH = "glm4-9b", "phi3.5-moe-42b-a6.6b"
SSM_ARCH, HYBRID_ARCH, ENCDEC_ARCH = "mamba2-2.7b", "zamba2-2.7b", "whisper-medium"   # 7e, 7f, 7g
ENCDEC_PROMPT = 64     # 7g: decoder prompt tokens a request (after 1,500 frames)
HYBRID_CUT_LAYERS = 12  # 7c's zamba2 cut: two groups of hybrid_attn_every = 6
LM_REQUESTS, LM_PROMPT, LM_DECODE = 4, 2048, 32   # 7a: requests, tokens each, greedy steps
LM_LONG, LM_LONG_DECODE = 32_768, 16                # 7b: S_long (see lm_phase), steps each way
LM_FIT_ITERS = 12                                   # 7b: k-means iterations a layer, as the example
LM_CUT_LAYERS = 4      # 7c's depth cut: f32 weights of all 40 layers and 7a's would not share the card
LM_CHECK_TOKENS = 16   # 7c: prompt length of the prefill-decode check (2 requests)
LM_CPU_STEPS = 4       # 7d: decode steps each way, card against CPU


def lm_config(name: str, **overrides):
    """An architecture at its published widths, with `overrides` (7c's depth
    cut and dtype)."""
    import dataclasses

    import repro_torch.configs as configs

    return dataclasses.replace(configs.get(name), **overrides)


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def device_mem(dev) -> dict | None:
    """Device memory in use, reserved and at its peak; None off the card."""
    import torch

    if torch.device(dev).type != "cuda":
        return None
    return {"allocated_bytes": torch.cuda.memory_allocated(),
            "reserved_bytes": torch.cuda.memory_reserved(),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def free_device(dev) -> dict | None:
    import gc

    import torch

    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return device_mem(dev)


def finite(name: str, x, shape: tuple) -> None:
    import torch

    if tuple(x.shape) != shape or not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{name}: shape {tuple(x.shape)} (expected {shape}) or non-finite values")


def greedy_run(step, caches, tok, steps: int, dev, *, forced=None, peaks: list | None = None):
    """`steps` decode steps of `step(caches, tokens) -> (logits, caches)`
    from `tok` (B, 1): greedy, or fed `forced` (steps, B, 1). Returns logits
    (steps, B, V), the tokens fed, the host ms of each step (ending in a
    synchronise) and the caches. On the card, each step's peak device
    memory is appended to `peaks` (the peak is reset after each)."""
    import torch

    logits, fed, ms = [], [], []
    for s in range(steps):
        if forced is not None:
            tok = forced[s]
        t0 = time.perf_counter()
        out, caches = step(caches, tok)
        nxt = out[:, 0].argmax(dim=-1, keepdim=True).to(torch.int32)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        if peaks is not None and torch.device(dev).type == "cuda":
            peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
        logits.append(out[:, 0])
        fed.append(tok)
        tok = nxt
    return torch.stack(logits), torch.stack(fed), ms, caches


def decode_run(lm, caches, tok, steps: int, dev, *, bangkv: bool = False, forced=None):
    """`steps` decode steps of `lm` from `tok` (B, 1): greedy, or fed
    `forced` (steps, B, 1) (`greedy_run`)."""
    return greedy_run(lambda c, t: lm.decode_step(c, t, bangkv=bangkv), caches, tok, steps, dev,
                      forced=forced)


def profile_step(dev, label: str, lm, caches, tok, stats: dict, *, bangkv: bool = False) -> None:
    """One more decode step under the profiler (on the card): its device
    busy ms and events, and the idle share against the median step, into
    `stats`. The caches must hold one more slot."""
    import torch

    prof = None
    if torch.device(dev).type == "cuda":
        prof = device_profile(label, lambda: lm.decode_step(caches, tok, bangkv=bangkv),
                              stats["ms_per_step"])
    stats["device_busy_ms_per_step"] = None if prof is None else prof["busy_ms"]
    stats["device_events_per_step"] = None if prof is None else prof["device_events"]
    stats["idle_share"] = None if prof is None else 1.0 - prof["busy_ms"] / stats["ms_per_step"]


def step_stats(ms: list, batch: int) -> dict:
    """Median ms a step after the first, and tokens a second from it."""
    med = float(np.median(ms[1:] if len(ms) > 1 else ms))
    return {"step_ms": ms, "ms_per_step": med, "tokens_per_s": batch / (med / 1e3)}


def kept_attention_mass(lm, tok, bang) -> float:
    """Layer 0 of the step after the prompt: the share of exact attention's
    softmax mass over the prompt's keys that lies on the keys BANG-KV keeps
    (its top-L and the window), the mean over requests and heads. A
    uniform distribution gives (L + W) / S."""
    import torch

    from repro_torch.models import retrieval_attention as bkv
    from repro_torch.models.layers import apply_rope, embed, norm

    cfg, p = lm.cfg, lm.params
    lp, layer = p["layers"][0], type(bang)(*(t[0] for t in bang))
    B, n, W = tok.shape[0], int(layer.index), cfg.bangkv_window
    x = norm(embed(tok.long(), p["embed"]), lp["attn_norm"], cfg.norm_kind, cfg.norm_eps)
    q = (x @ lp["attn"]["wq"]).reshape(B, 1, cfg.n_heads, cfg.head_dim)
    q = apply_rope(q, layer.index.reshape(1, 1).expand(B, 1), cfg.rope_theta)
    _, top = bkv.bangkv_decode_attention(p["bangkv_codebooks"][0], q, layer, top_l=cfg.bangkv_topl,
                                         window=W, return_top_idx=True)
    G = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, cfg.n_kv_heads, G, cfg.head_dim).float()
    scores = (qg @ layer.k[:, :n].float().permute(0, 2, 3, 1)) * cfg.head_dim ** -0.5
    probs = torch.softmax(scores.reshape(B, cfg.n_heads, n), dim=-1)
    # Retrieved slots past the retrieval region (history < L) are invalid;
    # they never share a position with a valid one.
    kept = torch.zeros_like(probs, dtype=torch.bool).scatter_(-1, top.clamp(max=n - 1), top < n - W)
    kept[..., n - W:] = True
    return float((probs * kept).sum(-1).mean())


def lm_serve(dev, card: str) -> dict:
    """7a and 7b: glm4-9b at full width and depth in bf16, its parameters
    drawn on the card. 7a: LM_REQUESTS prompts of LM_PROMPT random tokens,
    prefilled together, then LM_DECODE greedy exact-KV steps. 7b: one
    prompt of LM_LONG tokens, codebooks fitted per layer on its keys, then
    LM_LONG_DECODE steps from one state twice: exact, and BANG-KV fed the
    exact path's tokens, so every step compares the two attentions on the
    same input."""
    import torch

    from repro_torch.models import LM
    from repro_torch.models.attention import KVCache
    from repro_torch.models.retrieval_attention import fit_bangkv_caches

    cfg = lm_config(LM_ARCH)
    g = torch.Generator(dev).manual_seed(SEED)
    t0 = time.perf_counter()
    lm = LM(cfg, device=dev, generator=g)
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"({cfg.n_kv_heads} KV), d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}: "
        f"{n_params:,} parameters, {param_bytes / 1e9:.2f} GB, drawn on {dev} in {init_s:.2f} s")

    # 7a: the batch of requests.
    B, S, V = LM_REQUESTS, LM_PROMPT, cfg.vocab_size
    tokens = torch.randint(0, V, (B, S), generator=g, device=dev)
    free_device(dev)
    t0 = time.perf_counter()
    logits, caches = lm.prefill({"tokens": tokens}, s_max=S + LM_DECODE + 1)
    sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    finite("7a prefill logits", logits, (B, 1, V))
    tok = logits[:, 0].argmax(dim=-1, keepdim=True).to(torch.int32)
    dl, _, ms, caches = decode_run(lm, caches, tok, LM_DECODE, dev)
    tok = dl[-1].argmax(dim=-1, keepdim=True).to(torch.int32)
    finite("7a decode logits", dl, (LM_DECODE, B, V))
    if not bool((caches.index == S + LM_DECODE).all()):
        raise AssertionError(f"7a cache fill {caches.index.tolist()} != {S + LM_DECODE}")
    serve = {"requests": B, "prompt_tokens": S, "decode_steps": LM_DECODE, "prefill_ms": prefill_ms,
             "prefill_tokens_per_s": B * S / (prefill_ms / 1e3), **step_stats(ms, B),
             "kv_cache_bytes": caches.k.nbytes + caches.v.nbytes, "memory": device_mem(dev)}
    profile_step(dev, "7a exact-KV decode step", lm, caches, tok, serve)
    log(f"[lm] 7a: {B} x {S} tokens prefilled in {prefill_ms:.1f} ms "
        f"({serve['prefill_tokens_per_s']:.0f} tokens/s); exact-KV decode "
        f"{serve['ms_per_step']:.2f} ms a step (median of steps 2-{LM_DECODE}; first "
        f"{ms[0]:.2f}), {serve['tokens_per_s']:.1f} tokens/s; KV cache "
        f"{serve['kv_cache_bytes'] / 1e6:.1f} MB; peak device memory "
        f"{(serve['memory'] or {}).get('peak_bytes', 0) / 1e9:.2f} GB [{card}]")
    del logits, caches, dl

    # 7b: one long request, exact against BANG-KV.
    S = LM_LONG
    tokens = torch.randint(0, V, (1, S), generator=g, device=dev)
    free_device(dev)
    t0 = time.perf_counter()
    logits, exact = lm.prefill({"tokens": tokens}, s_max=S + LM_LONG_DECODE + 1)
    sync(dev)
    long_prefill_ms = (time.perf_counter() - t0) * 1e3
    finite("7b prefill logits", logits, (1, 1, V))
    t0 = time.perf_counter()
    own = KVCache(exact.k.clone(), exact.v.clone(), exact.index.clone())
    codebooks, bang = fit_bangkv_caches(own, S, cfg.bangkv_m, iters=LM_FIT_ITERS)
    lm.set_codebooks(codebooks)
    sync(dev)
    fit_s = time.perf_counter() - t0
    tok = logits[:, 0].argmax(dim=-1, keepdim=True).to(torch.int32)
    mass = kept_attention_mass(lm, tok, bang)
    le, fed, ms_e, exact = decode_run(lm, exact, tok, LM_LONG_DECODE, dev)
    # Phase 10 decodes on a mesh from this state: host copies, made between
    # the timed runs.
    ctx = {"bang": type(bang)(*(t.cpu() for t in bang)), "codebooks": codebooks.cpu(),
           "token": tok.cpu()}
    lb, _, ms_b, bang = decode_run(lm, bang, tok, LM_LONG_DECODE, dev, bangkv=True, forced=fed)
    finite("7b exact logits", le, (LM_LONG_DECODE, 1, V))
    finite("7b BANG-KV logits", lb, (LM_LONG_DECODE, 1, V))
    for name, c in (("exact", exact), ("BANG-KV", bang)):
        if not bool((c.index == S + LM_LONG_DECODE).all()):
            raise AssertionError(f"7b {name} cache fill {c.index.tolist()}")
    ex_stats, bang_stats = step_stats(ms_e, 1), step_stats(ms_b, 1)
    tok = le[-1].argmax(dim=-1, keepdim=True).to(torch.int32)
    profile_step(dev, "7b exact-KV decode step", lm, exact, tok, ex_stats)
    profile_step(dev, "7b BANG-KV decode step", lm, bang, tok, bang_stats, bangkv=True)
    corr = [float(torch.corrcoef(torch.stack([a.double().flatten(), b.double().flatten()]))[0, 1])
            for a, b in zip(le, lb)]
    agree = [bool(a) for a in (le.argmax(-1) == lb.argmax(-1)).flatten().tolist()]
    long = {"s_long": S, "decode_steps": LM_LONG_DECODE, "prefill_ms": long_prefill_ms,
            "fit_encode_s": fit_s, "fit_iters": LM_FIT_ITERS,
            "exact_decode": ex_stats, "bangkv_decode": bang_stats,
            "logit_corr": corr, "argmax_agree": agree, "kept_attention_mass_layer0": mass,
            "scan_bytes_per_key": {"bangkv_codes": cfg.bangkv_m, "exact_k": 2 * cfg.head_dim},
            "bangkv": {"m": cfg.bangkv_m, "top_l": cfg.bangkv_topl, "window": cfg.bangkv_window},
            "kv_cache_bytes": exact.k.nbytes + exact.v.nbytes, "memory": device_mem(dev)}
    log(f"[lm] 7b: {S} tokens prefilled in {long_prefill_ms:.1f} ms; codebooks fitted "
        f"({LM_FIT_ITERS} iterations) and keys encoded, all {cfg.n_layers} layers, in {fit_s:.2f} s; "
        f"at layer 0 BANG-KV's keys hold {mass:.4f} of exact attention's mass (uniform: "
        f"{(cfg.bangkv_topl + cfg.bangkv_window) / S:.4f})")
    for s in range(LM_LONG_DECODE):
        log(f"[lm] 7b step {s:2d}: exact {ms_e[s]:8.2f} ms  BANG-KV {ms_b[s]:8.2f} ms  "
            f"logit corr {corr[s]:.4f}  argmax {'agrees' if agree[s] else 'differs'}")
    log(f"[lm] 7b: decode ms a step (median of steps 2-{LM_LONG_DECODE}): exact "
        f"{long['exact_decode']['ms_per_step']:.2f}, BANG-KV {long['bangkv_decode']['ms_per_step']:.2f} "
        f"(m = {cfg.bangkv_m}, top-L {cfg.bangkv_topl}, window {cfg.bangkv_window}); argmax agreement "
        f"{sum(agree)}/{len(agree)}; the scan reads {cfg.bangkv_m} B a key against "
        f"{2 * cfg.head_dim} B of full-precision K [{card}]")
    return {"arch": cfg.name, "params": n_params, "param_bytes": param_bytes, "init_s": init_s,
            "serve": serve, "long": long, "ctx": ctx}


def cache_bytes(caches) -> int:
    if hasattr(caches, "nbytes"):
        return caches.nbytes
    return sum(cache_bytes(c) for c in caches)


def encoded(lm, caches):
    """BANG-KV caches over a copy of `caches`: every slot's key encoded with
    its stack's codebooks (slots past the fill are never scanned)."""
    import torch

    from repro_torch.models import retrieval_attention as bkv
    from repro_torch.models.transformer import attention_caches, clone_caches, with_attention_caches

    cfg = lm.cfg
    state = clone_caches(caches)
    kv = attention_caches(cfg, state)
    cb = lm.params["bangkv_codebooks"]
    codes = torch.stack([bkv.encode_keys(cb[i], kv.k[i]) for i in range(kv.k.shape[0])])
    return with_attention_caches(cfg, state, bkv.BangKVCache(codes, kv.k, kv.v, kv.index))


def model_on_card(dev, name: str, seed: int):
    """An architecture at full width and depth, its parameters drawn on
    `dev` from a seeded generator."""
    import torch

    from repro_torch.models import LM

    cfg = lm_config(name)
    g = torch.Generator(dev).manual_seed(seed)
    t0 = time.perf_counter()
    lm = LM(cfg, device=dev, generator=g)
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    log(f"[lm] {cfg.name} ({cfg.family}): {cfg.n_layers} layers"
        + (f" + {cfg.n_encoder_layers} encoder layers" if cfg.n_encoder_layers else "")
        + f", d_model {cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}: {n_params:,} parameters, "
        f"{param_bytes / 1e9:.2f} GB, drawn on {dev} in {init_s:.2f} s")
    return lm, g, {"arch": cfg.name, "params": n_params, "param_bytes": param_bytes, "init_s": init_s}


def serve_batch(dev, label: str, lm, batch: dict, steps: int, s_max: int | None = None):
    """Prefill `batch`, then `steps` greedy exact-KV steps. Returns the
    measures (prefill ms and tokens/s, step stats, cache bytes, memory),
    the caches after the steps, the next tokens and the step logits."""
    import torch

    from repro_torch.models.transformer import attention_caches

    B, S = batch["tokens"].shape
    V = lm.cfg.vocab_size
    free_device(dev)
    t0 = time.perf_counter()
    logits, caches = lm.prefill(batch, s_max=s_max)
    sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    finite(f"{label} prefill logits", logits, (B, 1, V))
    tok = logits[:, 0].argmax(dim=-1, keepdim=True).to(torch.int32)
    dl, fed, ms, caches = decode_run(lm, caches, tok, steps, dev)
    finite(f"{label} decode logits", dl, (steps, B, V))
    kv = attention_caches(lm.cfg, caches)
    if kv is not None and not bool((kv.index == S + steps).all()):
        raise AssertionError(f"{label} cache fill {kv.index.tolist()} != {S + steps}")
    stats = {"requests": B, "prompt_tokens": S, "decode_steps": steps, "prefill_ms": prefill_ms,
             "prefill_tokens_per_s": B * S / (prefill_ms / 1e3), **step_stats(ms, B),
             "cache_bytes": cache_bytes(caches), "cache_bytes_per_request": cache_bytes(caches) / B,
             "memory": device_mem(dev)}
    return stats, caches, dl[-1].argmax(dim=-1, keepdim=True).to(torch.int32), fed


def log_serve(label: str, st: dict, card: str, extra: str = "") -> None:
    log(f"[lm] {label}: {st['requests']} x {st['prompt_tokens']} tokens prefilled in "
        f"{st['prefill_ms']:.1f} ms ({st['prefill_tokens_per_s']:.0f} tokens/s){extra}; exact decode "
        f"{st['ms_per_step']:.2f} ms a step (median of steps 2-{st['decode_steps']}; first "
        f"{st['step_ms'][0]:.2f}), {st['tokens_per_s']:.1f} tokens/s; idle "
        + ("not measured" if st.get("idle_share") is None else f"{100 * st['idle_share']:.1f}%")
        + f"; cache {st['cache_bytes'] / 1e6:.1f} MB ({st['cache_bytes_per_request'] / 1e6:.1f} MB a "
        f"request); peak device memory {(st['memory'] or {}).get('peak_bytes', 0) / 1e9:.2f} GB [{card}]")


def ssm_serve(dev, card: str) -> dict:
    """7e: mamba2-2.7b at full width and depth in bf16. LM_REQUESTS prompts
    of LM_PROMPT random tokens, then LM_DECODE greedy steps; one prompt of
    LM_LONG tokens, then LM_LONG_DECODE steps. The SSM's decode state is
    (conv window, state) a layer whatever the context: the same bytes a
    request at both lengths."""
    import torch

    lm, g, out = model_on_card(dev, SSM_ARCH, SEED + 3)
    V = lm.cfg.vocab_size
    for key, B, S, steps in (("serve", LM_REQUESTS, LM_PROMPT, LM_DECODE),
                             ("long", 1, LM_LONG, LM_LONG_DECODE)):
        tokens = torch.randint(0, V, (B, S), generator=g, device=dev)
        st, caches, tok, _ = serve_batch(dev, f"7e {key}", lm, {"tokens": tokens}, steps)
        profile_step(dev, f"7e {key} decode step", lm, caches, tok, st)
        if key == "serve" and torch.device(dev).type == "cuda":
            # Where the SSD prefill's device time goes (the scan, the conv, the
            # products), and its idle share.
            prof = device_profile(f"7e prefill {B} x {S}", lambda: lm.prefill({"tokens": tokens}),
                                  st["prefill_ms"])
            st["prefill_device_busy_ms"] = None if prof is None else prof["busy_ms"]
            st["prefill_device_events"] = None if prof is None else prof["device_events"]
        log_serve(f"7e {lm.cfg.name} {key}", st, card)
        out[key] = st
        del caches
    per = {k: out[k]["cache_bytes_per_request"] for k in ("serve", "long")}
    if per["serve"] != per["long"]:
        raise AssertionError(f"7e: the SSM cache grew with the context: {per}")
    out["cache_bytes_per_request"] = per["serve"]
    return out


def hybrid_serve(dev, card: str) -> dict:
    """7f: zamba2-2.7b at full width and depth in bf16 (the shared attention
    block after every `hybrid_attn_every` SSM layers). LM_REQUESTS prompts
    of LM_PROMPT random tokens, LM_DECODE greedy exact-KV steps; then from
    that state LM_LONG_DECODE steps twice: exact, and BANG-KV with
    codebooks fitted on each shared-block cache, fed the exact path's
    tokens."""
    import torch

    from repro_torch.models.attention import KVCache
    from repro_torch.models.retrieval_attention import fit_bangkv_caches
    from repro_torch.models.transformer import clone_caches

    lm, g, out = model_on_card(dev, HYBRID_ARCH, SEED + 4)
    cfg = lm.cfg
    B, S, V = LM_REQUESTS, LM_PROMPT, cfg.vocab_size
    tokens = torch.randint(0, V, (B, S), generator=g, device=dev)
    s_max = S + LM_DECODE + LM_LONG_DECODE + 1
    st, exact, tok, _ = serve_batch(dev, "7f", lm, {"tokens": tokens}, LM_DECODE, s_max=s_max)
    fill = S + LM_DECODE
    t0 = time.perf_counter()
    kv = exact[1]
    own = KVCache(kv.k.clone(), kv.v.clone(), kv.index.clone())
    codebooks, bang_kv = fit_bangkv_caches(own, fill, cfg.bangkv_m, iters=LM_FIT_ITERS)
    lm.set_codebooks(codebooks)
    bang = (clone_caches(exact[0]), bang_kv)
    sync(dev)
    fit_s = time.perf_counter() - t0
    le, fed, ms_e, exact = decode_run(lm, exact, tok, LM_LONG_DECODE, dev)
    lb, _, ms_b, bang = decode_run(lm, bang, tok, LM_LONG_DECODE, dev, bangkv=True, forced=fed)
    finite("7f exact logits", le, (LM_LONG_DECODE, B, V))
    finite("7f BANG-KV logits", lb, (LM_LONG_DECODE, B, V))
    for name, c in (("exact", exact), ("BANG-KV", bang)):
        if not bool((c[1].index == fill + LM_LONG_DECODE).all()):
            raise AssertionError(f"7f {name} cache fill {c[1].index.tolist()}")
    ex_stats, bang_stats = step_stats(ms_e, B), step_stats(ms_b, B)
    tok = le[-1].argmax(dim=-1, keepdim=True).to(torch.int32)
    profile_step(dev, "7f exact-KV decode step", lm, exact, tok, ex_stats)
    profile_step(dev, "7f BANG-KV decode step", lm, bang, tok, bang_stats, bangkv=True)
    st["idle_share"] = ex_stats["idle_share"]
    corr = [float(torch.corrcoef(torch.stack([a.double().flatten(), b.double().flatten()]))[0, 1])
            for a, b in zip(le, lb)]
    agree = (le.argmax(-1) == lb.argmax(-1)).float().mean(-1).tolist()   # share of requests a step
    n_groups = cfg.n_layers // cfg.hybrid_attn_every
    log_serve(f"7f {cfg.name}", st, card, f"; {n_groups} shared-block calls a token")
    for s in range(LM_LONG_DECODE):
        log(f"[lm] 7f step {s:2d}: exact {ms_e[s]:8.2f} ms  BANG-KV {ms_b[s]:8.2f} ms  "
            f"logit corr {corr[s]:.4f}  argmax agreement {agree[s]:.2f} of {B} requests")
    log(f"[lm] 7f: codebooks fitted ({LM_FIT_ITERS} iterations) and keys encoded on the {n_groups} "
        f"shared-block caches of {fill} keys in {fit_s:.2f} s; decode ms a step (median of steps "
        f"2-{LM_LONG_DECODE}): exact {ex_stats['ms_per_step']:.2f}, BANG-KV "
        f"{bang_stats['ms_per_step']:.2f}; idle exact "
        + ("not measured" if ex_stats["idle_share"] is None else
           f"{100 * ex_stats['idle_share']:.1f}%, BANG-KV {100 * bang_stats['idle_share']:.1f}%")
        + f" [{card}]")
    out.update(serve=st, n_groups=n_groups, fit_encode_s=fit_s, fit_iters=LM_FIT_ITERS,
               exact_decode=ex_stats, bangkv_decode=bang_stats, logit_corr=corr, argmax_agree=agree,
               bangkv={"m": cfg.bangkv_m, "top_l": cfg.bangkv_topl, "window": cfg.bangkv_window})
    return out


def encdec_serve(dev, card: str) -> dict:
    """7g: whisper-medium at full width and depth in bf16. LM_REQUESTS
    requests of `frontend_len` seeded frame embeddings (the stub front end)
    and ENCDEC_PROMPT-token prompts: the encoder timed alone, then the
    prefill (encoder, cross K and V, decoder), then LM_DECODE greedy
    exact-KV steps."""
    import torch

    lm, g, out = model_on_card(dev, ENCDEC_ARCH, SEED + 5)
    cfg = lm.cfg
    B, S = LM_REQUESTS, ENCDEC_PROMPT
    frames = torch.randn((B, cfg.frontend_len, cfg.d_model), generator=g, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
    lm.encode(frames)   # the first call's set-up is not the encoder's time
    sync(dev)
    t0 = time.perf_counter()
    ck, cv = lm.encode(frames)
    sync(dev)
    encoder_ms = (time.perf_counter() - t0) * 1e3
    finite("7g cross K", ck, (cfg.n_layers, B, cfg.frontend_len, cfg.n_kv_heads, cfg.head_dim))
    del ck, cv
    st, caches, tok, _ = serve_batch(dev, "7g", lm, {"tokens": tokens, "frontend": frames},
                                     LM_DECODE, s_max=S + LM_DECODE + 1)
    profile_step(dev, "7g exact-KV decode step", lm, caches, tok, st)
    st["encoder_ms"] = encoder_ms
    log_serve(f"7g {cfg.name}", st, card,
              f" (the encoder over {B} x {cfg.frontend_len} frames alone {encoder_ms:.1f} ms)")
    out["serve"] = st
    return out


def lm_consistency(dev, name: str, **overrides) -> dict:
    """7c: decode(prefill(x[:S-1])) against prefill(x[:S])'s last logits at
    the architecture's full width, LM_CUT_LAYERS layers (or `overrides`),
    float32, with the reference test's tolerance (rtol = atol = 2e-2); and,
    where the family has attention, the same with BANG-KV, its top-L
    covering the whole history outside a 4-key window, so that stages 1-3
    must give exact attention whatever the codes."""
    import dataclasses

    import torch

    from repro_torch.models import LM
    from repro_torch.models.transformer import (attention_caches, clone_caches, decoder_stack,
                                                embed_inputs)

    cfg = lm_config(name, **{"n_layers": LM_CUT_LAYERS, "dtype": "float32", **overrides})
    g = torch.Generator(dev).manual_seed(SEED + 1)
    lm = LM(cfg, device=dev, generator=g)
    S = LM_CHECK_TOKENS
    tokens = torch.randint(0, cfg.vocab_size, (2, S), generator=g, device=dev)
    batch = {}
    if cfg.arch_kind == "encdec":
        batch["frontend"] = torch.randn((2, cfg.frontend_len, cfg.d_model), generator=g, device=dev)
    full, _ = lm.prefill({**batch, "tokens": tokens})
    _, caches = lm.prefill({**batch, "tokens": tokens[:, :-1]}, s_max=S)
    checks = [("decode", lm.decode_step(clone_caches(caches), tokens[:, -1:])[0])]
    if attention_caches(cfg, caches) is not None:
        cover = LM(dataclasses.replace(cfg, bangkv_topl=S, bangkv_window=4), lm.params)
        checks.append(("BANG-KV decode (covering top-L)",
                       cover.decode_step(encoded(lm, caches), tokens[:, -1:], bangkv=True)[0]))
    diffs = []
    for what, got in checks:
        diffs.append(float((got - full).abs().max()))
        if not torch.allclose(got, full, rtol=2e-2, atol=2e-2):
            raise AssertionError(f"7c {cfg.name}: {what} and prefill logits differ by {diffs[-1]}")
    diff, diff_b = diffs[0], (diffs[1] if len(diffs) > 1 else None)
    out = {"arch": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
           "encoder_layers": cfg.n_encoder_layers, "d_model": cfg.d_model, "dtype": cfg.dtype,
           "max_abs_diff": diff, "bangkv_cover_max_abs_diff": diff_b,
           "max_abs_logit": float(full.abs().max())}
    if cfg.n_experts:
        # The fraction of routed assignments dropped at the published capacity.
        base = lm_config(name, n_layers=LM_CUT_LAYERS, dtype="float32")
        h = embed_inputs(cfg, lm.params, tokens, None)
        with torch.no_grad():
            _, aux, _ = decoder_stack(base, lm.params, h, mode="prefill")
        out["capacity_factor"] = cfg.capacity_factor
        out["dropped_frac_default_capacity"] = float(aux.dropped_frac) / base.n_layers
        out["default_capacity_factor"] = base.capacity_factor
    log(f"[lm] 7c {cfg.name} ({cfg.n_layers} layers"
        + (f" + {cfg.n_encoder_layers} encoder layers" if cfg.n_encoder_layers else "")
        + f", d_model {cfg.d_model}, f32): decode against prefill max |diff| {diff:.3g}"
        + ("" if diff_b is None else f", BANG-KV (top-L {S}, window 4) {diff_b:.3g}")
        + f" (bound 2e-2 + 2e-2 |x|; logits up to {out['max_abs_logit']:.3g})"
        + (f"; dropped_frac at capacity {out['default_capacity_factor']}: "
           f"{out['dropped_frac_default_capacity']:.4f}" if cfg.n_experts else ""))
    return out


def map_caches(fn, caches):
    """`fn` applied to every tensor of a (nested) cache tuple."""
    if hasattr(caches, "_fields"):
        return type(caches)(*(fn(t) for t in caches))
    if isinstance(caches, tuple):
        return tuple(map_caches(fn, c) for c in caches)
    return fn(caches)


def bf16_ulps(a, b) -> tuple[int, float]:
    """Entries of two tensors of bf16 values that differ, and the largest
    difference in bf16 ulps (at the larger magnitude)."""
    import torch

    a, b = a.float(), b.float()
    diff = (a - b).abs()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(torch.finfo(torch.bfloat16).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return int((diff > 0).sum()), float((diff / ulp).max()) if diff.numel() else 0.0


def lm_card_vs_cpu(dev, name: str) -> dict:
    """7d: `name` reduced, float32, one set of parameters on the card and on
    the CPU: the prefill's logits and caches, then LM_CPU_STEPS exact steps
    and, where the family has attention, LM_CPU_STEPS BANG-KV steps (random
    codebooks, the prompt's keys encoded), logits within rtol 1e-4, atol
    1e-5; and one BANG-KV stage on each device's final caches (the first
    attention stack), the retrieved positions compared.

    An SSM's prefill rounds its conv window through bf16 (as the
    reference's), so an entry an ulp from a rounding boundary on one device
    can round the other way on the other: the window is held to within one
    bf16 ulp an entry, and the card decodes twice, from the CPU's prefill
    state (held to 1e-4, 1e-5) and from its own (held to 7c's 2e-2)."""
    import copy

    import torch

    import repro_torch.configs as configs
    from repro_torch.models import LM, init_params
    from repro_torch.models import retrieval_attention as bkv
    from repro_torch.models.transformer import attention_caches

    cfg = configs.get(name).reduced(dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(SEED + 2), "cpu")
    rng = np.random.default_rng(SEED + 2)
    B, S, n = 2, 24, LM_CPU_STEPS
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 2 * n)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    q = rng.standard_normal((B, 1, cfg.n_heads, cfg.head_dim)).astype(np.float32)
    has_attn = "bangkv_codebooks" in params
    has_ssm = cfg.family in ("ssm", "hybrid")
    res = {}
    for where, d in (("cpu", torch.device("cpu")), ("card", torch.device(dev))):
        lm = LM(cfg, copy.deepcopy(params).to(d))
        t = torch.from_numpy(tokens).to(d)
        batch = {"tokens": t[:, :S]}
        if cfg.arch_kind == "encdec":
            batch["frontend"] = torch.from_numpy(frames).to(d)
        logits, own = lm.prefill(batch, s_max=S + n)
        starts = {"own": own}
        if where == "card" and has_ssm:
            starts["cpu_state"] = map_caches(lambda x: x.to(d, copy=True), res["cpu"]["prefill_caches"])
        res[where] = {"prefill": logits.cpu(), "prefill_caches": map_caches(lambda x: x.cpu().clone(), own)}
        forced = t[:, S:].T.reshape(2 * n, B, 1)
        for key, state in starts.items():
            bang = encoded(lm, state) if has_attn else None
            le, _, _, _ = decode_run(lm, state, None, n, d, forced=forced[:n])
            res[where][f"{key}_exact_decode"] = le.cpu()
            if has_attn:
                lb, _, _, bang = decode_run(lm, bang, None, n, d, bangkv=True, forced=forced[n:])
                res[where][f"{key}_bangkv_decode"] = lb.cpu()
                if key == "own":
                    kv = attention_caches(cfg, bang)
                    _, top = bkv.bangkv_decode_attention(
                        lm.params["bangkv_codebooks"][0], torch.from_numpy(q).to(d),
                        type(kv)(*(x[0] for x in kv)), top_l=cfg.bangkv_topl,
                        window=cfg.bangkv_window, return_top_idx=True)
                    res[where]["top"] = top.cpu()
    cpu, card = res["cpu"], res["card"]
    out = {"arch": cfg.name}

    def hold(what, a, b, rtol, atol):
        out[f"{what}_max_abs_diff"] = float((a - b).abs().max())
        if not torch.allclose(b, a, rtol=rtol, atol=atol):
            raise AssertionError(f"7d {cfg.name} {what}: card and CPU differ by {out[f'{what}_max_abs_diff']}")

    hold("prefill", cpu["prefill"], card["prefill"], 1e-4, 1e-5)
    kinds = ("exact_decode", "bangkv_decode") if has_attn else ("exact_decode",)
    for kind in kinds:
        if has_ssm:
            # The card from the CPU's state; and from its own, at 7c's bound.
            hold(kind, cpu[f"own_{kind}"], card[f"cpu_state_{kind}"], 1e-4, 1e-5)
            hold(f"own_state_{kind}", cpu[f"own_{kind}"], card[f"own_{kind}"], 2e-2, 2e-2)
        else:
            hold(kind, cpu[f"own_{kind}"], card[f"own_{kind}"], 1e-4, 1e-5)
    kv_a, kv_b = attention_caches(cfg, cpu["prefill_caches"]), attention_caches(cfg, card["prefill_caches"])
    if kv_a is not None:
        hold("prefill_k", kv_a.k, kv_b.k, 1e-4, 1e-5)
        hold("prefill_v", kv_a.v, kv_b.v, 1e-4, 1e-5)
    if has_ssm:
        ssm_of = lambda c: c if cfg.family == "ssm" else c[0]  # noqa: E731
        a, b = ssm_of(cpu["prefill_caches"]), ssm_of(card["prefill_caches"])
        hold("prefill_ssm_state", a.state, b.state, 1e-4, 1e-5)
        differ, worst = bf16_ulps(a.conv, b.conv)
        out.update(prefill_conv_entries=a.conv.numel(), prefill_conv_entries_differing=differ,
                   prefill_conv_max_bf16_ulps=worst)
        if worst > 1.0:
            raise AssertionError(f"7d {cfg.name}: the conv windows differ by {worst} bf16 ulps")
    if has_attn:
        ta, tb = cpu["top"], card["top"]
        same = [len(set(x.tolist()) & set(y.tolist())) for x, y in zip(ta.flatten(0, 1), tb.flatten(0, 1))]
        out["top_l_overlap"] = sum(same) / (len(same) * cfg.bangkv_topl)
    log(f"[lm] 7d {cfg.name} f32: card against CPU, max |logit diff| prefill "
        f"{out['prefill_max_abs_diff']:.3g}, exact decode {out['exact_decode_max_abs_diff']:.3g}"
        + (f", BANG-KV decode {out['bangkv_decode_max_abs_diff']:.3g}" if has_attn else "")
        + " (bound 1e-5 + 1e-4 |x|)"
        + ("; from the card's own prefill state: exact "
           f"{out['own_state_exact_decode_max_abs_diff']:.3g}"
           + (f", BANG-KV {out['own_state_bangkv_decode_max_abs_diff']:.3g}" if has_attn else "")
           + f" (bound 2e-2), its conv window {out['prefill_conv_entries_differing']} of "
           f"{out['prefill_conv_entries']} entries rounded the other way to bf16 (at most "
           f"{out['prefill_conv_max_bf16_ulps']:.2f} ulp)" if has_ssm else "")
        + (f"; BANG-KV top-L overlap {out['top_l_overlap']:.4f}" if has_attn else ""))
    return out


def lm_phase(dev, card: str) -> dict:
    """Phase 7: the LM's serve path (prefill, exact-KV and BANG-KV decode).

    7a serves glm4-9b at full width and depth in bf16 (about 9.4 B
    parameters, 18.8 GB, drawn on the card); 7b decodes one request of
    S_long = LM_LONG = 32,768 tokens (`LM_SHAPES["decode_32k"]`'s length)
    with exact KV and with BANG-KV: the largest power of two up to 32,768
    that keeps phase 7 within about 120 s, which the whole phase met on the
    H100 (its prefill dominates: float32 scores, as the reference's, at 2.1
    GB a 512-query chunk); 7e, 7f and 7g serve mamba2-2.7b, zamba2-2.7b and
    whisper-medium at full width and depth in bf16; 7c checks
    prefill-decode consistency at full width in float32 for glm4-9b,
    phi3.5-moe and mamba2 cut to LM_CUT_LAYERS layers, zamba2 to
    HYBRID_CUT_LAYERS (two groups) and whisper to LM_CUT_LAYERS + LM_CUT_LAYERS;
    7d holds the card against the CPU on the reduced glm4-9b, mamba2,
    zamba2 and whisper. No port kernel lies on this path: the launch
    counts, set to 0 before 7a, are read after 7d and must all be 0. The
    result's "ctx" holds host copies of 7b's BANG-KV state before its
    decode, its codebooks and first token (phase 10 decodes from them)."""
    t0 = time.perf_counter()
    mem = free_device(dev)
    if mem is not None:
        log(f"[lm] device memory before phase 7: {mem['allocated_bytes'] / 1e9:.2f} GB in use, "
            f"{mem['reserved_bytes'] / 1e9:.2f} GB reserved")
    reset_launches()
    out = lm_serve(dev, card)
    for key, fn in (("ssm", ssm_serve), ("hybrid", hybrid_serve), ("encdec", encdec_serve)):
        free_device(dev)
        t1 = time.perf_counter()
        out[key] = fn(dev, card)
        out[key]["phase_s"] = time.perf_counter() - t1
        log(f"[lm] {out[key]['arch']}: {out[key]['phase_s']:.1f} s")
    free_device(dev)
    out["consistency"] = [lm_consistency(dev, LM_ARCH),
                          lm_consistency(dev, LM_MOE_ARCH, capacity_factor=16.0),
                          lm_consistency(dev, SSM_ARCH),
                          lm_consistency(dev, HYBRID_ARCH, n_layers=HYBRID_CUT_LAYERS),
                          lm_consistency(dev, ENCDEC_ARCH, n_encoder_layers=LM_CUT_LAYERS)]
    free_device(dev)
    out["card_vs_cpu"] = [lm_card_vs_cpu(dev, name)
                          for name in (LM_ARCH, SSM_ARCH, HYBRID_ARCH, ENCDEC_ARCH)]
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"the LM path launched port kernels: {launches}")
    out["kernel_launches"] = launches
    out["memory_before"] = mem
    out["phase_s"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------------- phase 8
TRAIN_ARCH = "granite-3-2b"     # 8a: full width and depth
TRAIN_SEQ = 4_096               # 8a, 8b: LM_SHAPES["train_4k"]'s sequence length
TRAIN_BATCH = 2                 # 8a, 8b: LM_SHAPES["train_4k"]'s 256 sequences cut to 2 for one card
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_PEAK_LR = 8, 2, 3e-4
CUT_TRAIN_STEPS = 3             # 8b: steps of each cut-depth family
MOE_TRAIN_LAYERS = 2            # 8b: phi3.5-moe's cut (4 layers: 84 GB of weights, grads, AdamW)
ENCDEC_TRAIN_TOKENS = 448       # 8b: whisper's decoder tokens (its context) after 1,500 frames
CPU_TRAIN_STEPS = 3             # 8c: train_loop steps, card against CPU
BF16_DENSE_FLOPS = 989.4e12     # H100 SXM bf16 dense tensor-core peak (data sheet)


def train_run(dev, label: str, cfg, params, seq: int, steps: int, card: str, **loop) -> dict:
    """`train_loop` on `dev` from `params` (trained in place): each step's
    loss and grad norm (finite), the median step after the first, tokens/s
    and peak memory. Returns the measures and the loop's summary."""
    import torch

    from repro_torch.runtime import TrainLoopConfig, train_loop

    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tcfg = TrainLoopConfig(steps=steps, seq_len=seq, global_batch=TRAIN_BATCH, log_every=0,
                           seed=SEED, **loop)
    seen = []
    out = train_loop(cfg, tcfg, params=params, device=dev, on_step=lambda s, m: seen.append(m))
    sync(dev)
    losses, gnorms = [m["loss"] for m in seen], [m["grad_norm"] for m in seen]
    if len(seen) != steps or not np.all(np.isfinite(losses + gnorms)):
        raise AssertionError(f"8 {label}: losses {losses}, grad norms {gnorms}")
    ms = [1e3 * t for t in out["step_s"]]
    med = float(np.median(ms[1:]))
    st = {"arch": cfg.name, "layers": cfg.n_layers, "encoder_layers": cfg.n_encoder_layers,
          "dtype": cfg.dtype, "batch": TRAIN_BATCH, "seq_len": seq, "steps": steps,
          "params": sum(p.numel() for p in out["params"].parameters()),
          "losses": losses, "grad_norms": gnorms, "lrs": [m["lr"] for m in seen],
          "metrics_last": seen[-1], "step_ms": ms, "ms_per_step": med,
          "tokens_per_s": TRAIN_BATCH * seq / (med / 1e3), "memory": device_mem(dev)}
    log(f"[train] {label} {cfg.name} ({cfg.n_layers} layers"
        + (f" + {cfg.n_encoder_layers} encoder layers" if cfg.n_encoder_layers else "")
        + f", d_model {cfg.d_model}, {cfg.dtype}, {st['params']:,} parameters, remat {cfg.remat}): "
        f"{steps} steps of {TRAIN_BATCH} x {seq} tokens, {med:.1f} ms a step (median after the first; "
        f"first {ms[0]:.1f}), {st['tokens_per_s']:.0f} tokens/s; losses "
        + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
        + ", ".join(f"{x:.3f}" for x in gnorms)
        + f"; peak device memory {(st['memory'] or {}).get('peak_bytes', 0) / 1e9:.2f} GB [{card}]")
    return st, out


def train_full(dev, card: str) -> dict:
    """8a: granite-3-2b at full width and depth in bf16 with remat, its
    parameters drawn on the card, the reference's float32 AdamW state (12
    bytes a parameter): TRAIN_STEPS steps of TRAIN_BATCH x 4,096 tokens of
    the synthetic stream. Then the optimizer step alone (CUDA events, on the
    last step's gradients) and one more step under the profiler."""
    import torch

    from repro_torch.data import TokenStream
    from repro_torch.models import LM, init_params
    from repro_torch.optim import adamw_update
    from repro_torch.runtime.train_loop import TrainLoopConfig, make_train_step
    from repro_torch.tree import flat_dict

    cfg = lm_config(TRAIN_ARCH)
    free_device(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(dev).manual_seed(SEED + 6), dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    seq = TRAIN_SEQ
    st, out = train_run(dev, "8a", cfg, params, seq, TRAIN_STEPS, card, warmup=TRAIN_WARMUP,
                        peak_lr=TRAIN_PEAK_LR)
    params, opt_state = out["params"], out["opt_state"]
    n = cfg.param_count()   # without the BANG-KV codebooks, which training does not read
    st["init_s"] = init_s
    st["param_bytes"] = sum(p.numel() * p.element_size() for p in params.parameters())
    st["state_bytes"] = st["param_bytes"] + sum(
        t.numel() * t.element_size() for d in (opt_state.mu, opt_state.nu, opt_state.master)
        for t in d.values())
    st["model_flops_per_step"] = 6 * n * TRAIN_BATCH * seq
    st["mfu"] = st["model_flops_per_step"] / (st["ms_per_step"] / 1e3) / BF16_DENSE_FLOPS
    # The optimizer step alone, on the last step's gradients (each call
    # updates the state once more).
    grads = {k: p.grad for k, p in flat_dict(params).items()}
    opt_ms = []
    for _ in range(3):
        if torch.device(dev).type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            adamw_update(grads, opt_state, params, TRAIN_PEAK_LR)
            b.record()
            b.synchronize()
            opt_ms.append(a.elapsed_time(b))
        else:
            t1 = time.perf_counter()
            adamw_update(grads, opt_state, params, TRAIN_PEAK_LR)
            opt_ms.append((time.perf_counter() - t1) * 1e3)
    st["optimizer_ms"] = float(np.median(opt_ms))
    del grads
    prof = None
    if torch.device(dev).type == "cuda":
        lm_step = make_train_step(LM(cfg, params), TrainLoopConfig(
            steps=TRAIN_STEPS, warmup=TRAIN_WARMUP, peak_lr=TRAIN_PEAK_LR))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 TokenStream(cfg.vocab_size, seq, TRAIN_BATCH, seed=SEED).batch_at(TRAIN_STEPS).items()}
        prof = device_profile("8a one training step", lambda: lm_step(params, opt_state, None, batch),
                              st["ms_per_step"])
    st["device_busy_ms_per_step"] = None if prof is None else prof["busy_ms"]
    st["device_events_per_step"] = None if prof is None else prof["device_events"]
    st["idle_share"] = None if prof is None else 1.0 - prof["busy_ms"] / st["ms_per_step"]
    st["memory"] = device_mem(dev)
    log(f"[train] 8a {cfg.name}: {n:,} parameters (param_count) drawn on {dev} in {init_s:.2f} s; "
        f"parameters and "
        f"AdamW state {st['state_bytes'] / 1e9:.2f} GB; model FLOPs 6 N tokens = "
        f"{st['model_flops_per_step']:.3g} a step, {100 * st['mfu']:.2f}% of {BF16_DENSE_FLOPS / 1e12:.1f} "
        f"TFLOP/s (bf16 dense); the optimizer step alone {st['optimizer_ms']:.1f} ms (median of 3); "
        "idle " + ("not measured" if st["idle_share"] is None else
                   f"{100 * st['idle_share']:.1f}% ({st['device_busy_ms_per_step']:.1f} ms busy in "
                   f"{st['device_events_per_step']} device events)")
        + f"; peak device memory {(st['memory'] or {}).get('peak_bytes', 0) / 1e9:.2f} GB [{card}]")
    return st


def train_cut(dev, card: str, name: str, seq: int, **overrides) -> dict:
    """8b: `name` at its full width in bf16, cut in depth by `overrides`,
    CUT_TRAIN_STEPS steps from parameters drawn on the card."""
    import torch

    from repro_torch.models import init_params

    cfg = lm_config(name, **overrides)
    free_device(dev)
    params = init_params(cfg, torch.Generator(dev).manual_seed(SEED + 7), dev)
    st, _ = train_run(dev, "8b", cfg, params, seq, CUT_TRAIN_STEPS, card, warmup=1)
    return st


def train_card_vs_cpu(dev, name: str) -> dict:
    """8c: `name` reduced, float32, one set of parameters on the card and on
    the CPU: `LM.loss` and its metrics, the global grad norm, then
    CPU_TRAIN_STEPS `train_loop` steps, each step's loss and grad norm, and
    the master parameters after the last. Bounds: loss, metrics, grad
    norms rtol 1e-4, atol 1e-5 (7d's); the masters every entry within 2e-6,
    save at most 1 in 1,000 within 2 sum(lr) -- Adam's normalised step can
    take the other sign where a gradient is near 0 (tests/test_torch_train_loop.py)."""
    import copy

    import torch

    import repro_torch.configs as configs
    from repro_torch.data import TokenStream
    from repro_torch.models import LM, init_params
    from repro_torch.optim import global_norm, warmup_cosine
    from repro_torch.runtime import TrainLoopConfig, train_loop
    from repro_torch.tree import flat_dict

    cfg = configs.get(name).reduced(dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(SEED + 8), "cpu")
    frontend = (cfg.frontend_len, cfg.d_model) if cfg.frontend != "none" else None
    S = 24 - (cfg.frontend_len if cfg.frontend == "vision_stub" else 0)
    batch = TokenStream(cfg.vocab_size, S, 2, seed=SEED, frontend=frontend).batch_at(0)
    tcfg = dict(steps=CPU_TRAIN_STEPS, seq_len=24, global_batch=2, warmup=1, peak_lr=3e-4,
                log_every=0, seed=SEED)
    res = {}
    for where, d in (("cpu", torch.device("cpu")), ("card", torch.device(dev))):
        lm = LM(cfg, copy.deepcopy(params).to(d))
        lm.params.requires_grad_(True)
        loss, metrics = lm.loss({k: torch.from_numpy(v).to(d) for k, v in batch.items()})
        loss.backward()
        gnorm = global_norm(p.grad for p in lm.params.parameters())
        seen = []
        out = train_loop(cfg, TrainLoopConfig(**tcfg), params=copy.deepcopy(params), device=d,
                         on_step=lambda s, m: seen.append(m))
        res[where] = {"loss": float(loss.detach()), **{k: float(v) for k, v in metrics.items()},
                      "grad_norm": float(gnorm), "losses": [m["loss"] for m in seen],
                      "grad_norms": [m["grad_norm"] for m in seen],
                      "master": {k: v.cpu() for k, v in out["opt_state"].master.items()}}
    cpu, card = res["cpu"], res["card"]
    out = {"arch": cfg.name}
    for key in ("loss", "ce", "load_balance", "router_z", "dropped_frac", "grad_norm"):
        out[f"{key}_abs_diff"] = abs(card[key] - cpu[key])
        if out[f"{key}_abs_diff"] > 1e-5 + 1e-4 * abs(cpu[key]):
            raise AssertionError(f"8c {cfg.name} {key}: card {card[key]} and CPU {cpu[key]}")
    for key in ("losses", "grad_norms"):
        a, b = np.array(cpu[key]), np.array(card[key])
        out[f"{key}_max_abs_diff"] = float(np.abs(a - b).max())
        if not np.allclose(b, a, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"8c {cfg.name} {key}: card {b} and CPU {a}")
    lrs = [float(warmup_cosine(s, peak=3e-4, warmup=1, total=CPU_TRAIN_STEPS))
           for s in range(CPU_TRAIN_STEPS)]
    worst, flipped, total = 0.0, 0, 0
    for k, a in cpu["master"].items():
        d = (card["master"][k] - a).abs()
        worst = max(worst, float(d.max()))
        flipped += int((d > 2e-6).sum())
        total += d.numel()
    out.update(master_max_abs_diff=worst, master_entries_over_2e6=flipped, master_entries=total,
               flip_allowance=2 * sum(lrs))
    if worst > 2 * sum(lrs) or flipped > 1e-3 * total:
        raise AssertionError(f"8c {cfg.name}: masters differ by up to {worst} in {flipped} entries")
    log(f"[train] 8c {cfg.name} f32: card against CPU, loss diff {out['loss_abs_diff']:.3g}, grad norm "
        f"diff {out['grad_norm_abs_diff']:.3g} (bound 1e-5 + 1e-4 |x|); {CPU_TRAIN_STEPS} train_loop "
        f"steps: losses within {out['losses_max_abs_diff']:.3g}, grad norms "
        f"{out['grad_norms_max_abs_diff']:.3g}, masters {worst:.3g} ({flipped} of {total} entries "
        f"over 2e-6, allowance {out['flip_allowance']:.3g})")
    return out


def train_resume(dev, root: Path) -> dict:
    """8d: reduced granite (bf16) on the card: checkpoints every 3 steps, an
    injected failure at step 7, resumed from step 6; its losses, parameters
    and master copies held bit-equal to an uninterrupted run. No MoE on this
    path: the embedding's backward (`index_put_` with accumulate, which
    PyTorch sorts on CUDA) and cuBLAS's products give the same bits run to
    run on one card."""
    import shutil

    import torch

    import repro_torch.configs as configs
    from repro_torch.runtime import TrainLoopConfig, train_loop
    from repro_torch.runtime.train_loop import InjectedFailure
    from repro_torch.tree import flat_dict

    cfg = configs.get(TRAIN_ARCH).reduced()
    ckpt = root / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    common = dict(steps=8, seq_len=16, global_batch=2, log_every=0, seed=SEED)
    try:
        try:
            train_loop(cfg, TrainLoopConfig(ckpt_dir=str(ckpt), ckpt_every=3, fail_at_step=7, **common),
                       device=dev)
            raise AssertionError("8d: the injected failure did not happen")
        except InjectedFailure:
            pass
        resumed = train_loop(cfg, TrainLoopConfig(ckpt_dir=str(ckpt), ckpt_every=3, **common), device=dev)
        whole = train_loop(cfg, TrainLoopConfig(**common), device=dev)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if len(resumed["losses"]) != 2 or resumed["losses"] != whole["losses"][6:]:
        raise AssertionError(f"8d: resumed losses {resumed['losses']}, uninterrupted {whole['losses']}")
    for a, b in ((resumed["params"], whole["params"]),
                 (resumed["opt_state"].master, whole["opt_state"].master)):
        fa, fb = flat_dict(a), flat_dict(b)
        if not all(torch.equal(fa[k].detach(), fb[k].detach()) for k in fa):
            raise AssertionError("8d: the resumed run's parameters differ from the uninterrupted run's")
    log(f"[train] 8d {cfg.name} on {dev}: failed at step 7, resumed from step 6, losses "
        + ", ".join(f"{x:.6f}" for x in resumed["losses"])
        + " bit-equal to the uninterrupted run's, and every parameter and master copy")
    return {"arch": cfg.name, "resumed_losses": resumed["losses"], "whole_losses": whole["losses"],
            "bit_equal": True}


def train_phase(dev, card: str) -> dict:
    """Phase 8: training on the card. 8a granite-3-2b at full width and
    depth; 8b phi3.5-moe, mamba2-2.7b, zamba2-2.7b, whisper-medium at full
    width cut in depth as 7c cuts them (phi3.5-moe to MOE_TRAIN_LAYERS) and
    internvl2-1b at full depth, all bf16; 8c five reduced configs card
    against CPU; 8d failure and resume on the card. No port kernel lies on
    the training path: the launch counts, set to 0 before 8a, are read after
    8d and must all be 0."""
    t0 = time.perf_counter()
    reset_launches()
    seq = TRAIN_SEQ
    out = {"full": train_full(dev, card)}
    out["cut"] = [
        train_cut(dev, card, LM_MOE_ARCH, seq, n_layers=MOE_TRAIN_LAYERS),
        train_cut(dev, card, SSM_ARCH, seq, n_layers=LM_CUT_LAYERS),
        train_cut(dev, card, HYBRID_ARCH, seq, n_layers=HYBRID_CUT_LAYERS),
        train_cut(dev, card, ENCDEC_ARCH, ENCDEC_TRAIN_TOKENS, n_layers=LM_CUT_LAYERS,
                  n_encoder_layers=LM_CUT_LAYERS),
        train_cut(dev, card, "internvl2-1b", seq),
    ]
    free_device(dev)
    out["card_vs_cpu"] = [train_card_vs_cpu(dev, name) for name in
                          (TRAIN_ARCH, LM_MOE_ARCH, SSM_ARCH, HYBRID_ARCH, ENCDEC_ARCH)]
    out["resume"] = train_resume(dev, ROOT)
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"the training path launched port kernels: {launches}")
    out["kernel_launches"] = launches
    out["phase_s"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------------- phase 9
MESH_STEPS = 3                  # 9a: steps each way, mesh step then plain step
# ------------------------------------------------------------ phase 10
COLLECTIVE_REPS = 200           # 10a: one-element collectives timed on the one-rank group


def bf16_within(a, b, lr: float, steps: int) -> tuple[int, float, bool]:
    """(entries that differ, the largest difference, within the bound):
    at most 1 in 1,000 entries differ, each by at most 2 lr a step plus one
    bf16 ulp of its value (ROADMAP C15's bound, in the parameters' dtype)."""
    import torch

    if torch.equal(a, b):
        return 0, 0.0, True
    d = (a.float() - b.float()).abs()
    differ = d > 0
    n = int(differ.sum())
    worst = float(d.max()) if n else 0.0
    ulp = b.float().abs() * 2.0 ** -7
    ok = n <= 1e-3 * d.numel() and bool((d <= 2 * lr * steps + ulp).all())
    return n, worst, ok


def mesh_phase(dev, card: str) -> dict:
    """Phase 9: the mesh training step on the (1, 1) mesh (a one-rank
    NCCL group on the card, gloo on the CPU). 9a: granite-3-2b at 8a's
    shape, MESH_STEPS steps of `step_and_specs`'s train step, one more
    under the profiler, then MESH_STEPS plain steps from the same
    parameters (the two sets of state do not fit the card together); 9b:
    `compressed_psum` on the data group against `ef_int8_compress`. The
    launch counts, set to 0 first, must all be 0 after."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import TokenStream
    from repro_torch.distributed import make_mesh, shard_tree
    from repro_torch.launch.specs import LR, step_and_specs
    from repro_torch.models import LM, init_params
    from repro_torch.optim import (adamw_init, adamw_update, compressed_psum, compression_init,
                                   ef_int8_compress)
    from repro_torch.tree import flat_dict

    t_phase = time.perf_counter()
    reset_launches()
    cfg = lm_config(TRAIN_ARCH)
    seq = TRAIN_SEQ
    free_device(dev)
    made = not dist.is_initialized()
    mesh = make_mesh((1, 1), ("data", "model"), dev)
    out = {"arch": cfg.name, "mesh": dict(mesh.shape), "backend": dist.get_backend(),
           "steps": MESH_STEPS, "batch": TRAIN_BATCH, "seq_len": seq, "lr": LR}
    try:
        stream = TokenStream(cfg.vocab_size, seq, TRAIN_BATCH, seed=SEED)
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in stream.batch_at(s).items()}
                   for s in range(MESH_STEPS + 1)]
        # The plain steps draw the same parameters again from the seed:
        # each tensor's float64 sum is held equal.
        params = init_params(cfg, torch.Generator(dev).manual_seed(SEED + 6), dev)
        sums = torch.stack([p.detach().double().sum() for p in params.parameters()]).cpu()
        step, _, place = step_and_specs(cfg, ShapeSpec("train_4k", "train", seq, TRAIN_BATCH), mesh)
        mparams = shard_tree(params, place[0], mesh)   # one rank: a copy
        del params
        opt = adamw_init(mparams)
        free_device(dev)
        mc = step.mesh_context
        mesh_ms, mesh_losses = [], []
        for s in range(MESH_STEPS):
            sync(dev)
            t0 = time.perf_counter()
            mparams, opt, loss = step(mparams, opt, shard_tree(batches[s], place[2], mesh))
            mesh_losses.append(loss.item())
            sync(dev)
            mesh_ms.append((time.perf_counter() - t0) * 1e3)
        counts = {k: v / MESH_STEPS for k, v in mc.counts.items()}
        mem = device_mem(dev)
        t0 = time.perf_counter()
        mesh_after = {k: p.detach().cpu() for k, p in flat_dict(mparams).items()}
        copy_s = time.perf_counter() - t0
        med = float(np.median(mesh_ms[1:]))
        prof = None
        t0 = time.perf_counter()
        if torch.device(dev).type == "cuda":
            prof = device_profile("9a one mesh step (1, 1)", lambda: step(
                mparams, opt, shard_tree(batches[MESH_STEPS], place[2], mesh)), med, cpu_ops=False)
        profile_s = time.perf_counter() - t0
        out["mesh_step"] = {
            "losses": mesh_losses, "step_ms": mesh_ms, "ms_per_step": med,
            "tokens_per_s": TRAIN_BATCH * seq / (med / 1e3), "collectives_per_step": counts,
            "memory": mem,
            "device_profile": prof,
            "nccl_share_of_device_time": None if prof is None else prof["nccl_ms"] / prof["busy_ms"],
            "idle_share": None if prof is None else 1.0 - prof["busy_ms"] / med}
        log(f"[mesh] 9a {cfg.name} on the {dict(mesh.shape)} mesh ({dist.get_backend()}, one rank), "
            f"{MESH_STEPS} steps of {TRAIN_BATCH} x {seq} tokens: {med:.1f} ms a step (median after the "
            f"first; first {mesh_ms[0]:.1f}); losses " + ", ".join(f"{x:.6f}" for x in mesh_losses)
            + "; collectives a step " + ", ".join(f"{k} {v:.0f}" for k, v in sorted(counts.items()))
            + ("; NCCL not measured" if prof is None else
               f"; NCCL {prof['nccl_events']} kernels, {prof['nccl_ms']:.2f} ms = "
               f"{100 * prof['nccl_ms'] / prof['busy_ms']:.2f}% of {prof['busy_ms']:.1f} ms device busy "
               f"({prof['device_events']} events, idle {100 * (1 - prof['busy_ms'] / med):.1f}%); device "
               f"copies {prof['copy_events']}, {prof['copy_ms']:.2f} ms")
            + f"; peak device memory {(mem or {}).get('peak_bytes', 0) / 1e9:.2f} GB [{card}]")

        # 9b: the profiled step's gradients, the optimizer state freed first.
        grads = {k: p.grad for k, p in flat_dict(mparams).items() if p.grad is not None}
        del opt, mparams
        free_device(dev)
        sync(dev)
        t0 = time.perf_counter()
        deq, state = compressed_psum(grads, mesh.group("data"), compression_init(grads))
        sync(dev)
        psum_ms = (time.perf_counter() - t0) * 1e3
        ef_deq, ef_state = ef_int8_compress(grads, compression_init(grads))
        equal = all(torch.equal(deq[k], ef_deq[k]) and torch.equal(state.err[k], ef_state.err[k])
                    for k in grads)
        n_entries = sum(g.numel() for g in grads.values())
        del deq, state, ef_deq, ef_state, grads
        if not equal:
            raise AssertionError("9b: compressed_psum over one rank differs from ef_int8_compress")
        out["compressed_psum"] = {"bit_equal_to_ef_int8": equal, "ms": psum_ms, "entries": n_entries}
        log(f"[mesh] 9b compressed_psum over the one-rank data group, {n_entries:,} gradient entries: "
            f"dequantised sums and residuals bit-equal to ef_int8_compress; {psum_ms:.1f} ms [{card}]")

        # 9a's plain steps from the same parameters.
        free_device(dev)
        params = init_params(cfg, torch.Generator(dev).manual_seed(SEED + 6), dev)
        again = torch.stack([p.detach().double().sum() for p in params.parameters()]).cpu()
        if not torch.equal(sums, again):
            raise AssertionError("9a: the parameters drawn again from the seed differ")
        lm = LM(cfg, params)
        popt = adamw_init(params)
        params.requires_grad_(True)
        plain_ms, plain_losses = [], []
        for s in range(MESH_STEPS):
            sync(dev)
            t0 = time.perf_counter()
            for p in params.parameters():
                p.grad = None
            loss, _ = lm.loss(batches[s])
            loss.backward()
            _, popt, _ = adamw_update({k: p.grad for k, p in flat_dict(params).items()}, popt, params, LR)
            plain_losses.append(loss.item())
            sync(dev)
            plain_ms.append((time.perf_counter() - t0) * 1e3)
        pmem = device_mem(dev)
        t0 = time.perf_counter()
        plain_after = {k: p.detach().cpu() for k, p in flat_dict(params).items()}
        copy_s += time.perf_counter() - t0
        del lm, params, popt
        free_device(dev)
        pmed = float(np.median(plain_ms[1:]))
        out["plain_step"] = {"losses": plain_losses, "step_ms": plain_ms, "ms_per_step": pmed,
                             "memory": pmem}
        loss_bits = mesh_losses == plain_losses
        if not loss_bits and not np.allclose(mesh_losses, plain_losses, rtol=1e-5, atol=0):
            raise AssertionError(f"9a: mesh losses {mesh_losses}, plain {plain_losses}")
        t0 = time.perf_counter()
        differ, worst, total = 0, 0.0, 0
        for k, a in mesh_after.items():
            n, w, ok = bf16_within(a, plain_after[k], LR, MESH_STEPS)
            if not ok:
                raise AssertionError(f"9a: {k} differs in {n} entries, by up to {w}")
            differ, worst, total = differ + n, max(worst, w), total + a.numel()
        out["seconds"] = {"host_copies": copy_s, "profiled_step": profile_s,
                          "compare": time.perf_counter() - t0}
        out["parity"] = {"losses_bit_equal": loss_bits, "param_entries": total,
                         "param_entries_differing": differ, "param_max_abs_diff": worst,
                         "bit_equal": loss_bits and differ == 0}
        out["mesh_over_plain"] = med / pmed
        log(f"[mesh] 9a plain steps from the same parameters: {pmed:.1f} ms a step (first "
            f"{plain_ms[0]:.1f}); losses " + ", ".join(f"{x:.6f}" for x in plain_losses)
            + f"; mesh / plain step time {med / pmed:.4f}; peak device memory "
            f"{(pmem or {}).get('peak_bytes', 0) / 1e9:.2f} GB; losses "
            + ("bit-equal" if loss_bits else "within rtol 1e-5")
            + f", bf16 parameters after step {MESH_STEPS}: {differ} of {total:,} entries differ "
            f"(max {worst:.3g}); host copies {copy_s:.1f} s, the profiled step {profile_s:.1f} s, "
            f"the comparison {out['seconds']['compare']:.1f} s [{card}]")
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"the mesh training path launched port kernels: {launches}")
    out["kernel_launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------------------ phase 10
def recorded_top_l(run):
    """run() with every BANG-KV top-L selection's ids kept: (its result,
    the ids of each layer and step stacked)."""
    import torch

    from repro_torch.models import retrieval_attention as bkv

    taken, ids = bkv._retrieve_top_l, []

    def recording(*args, **kwargs):
        top = taken(*args, **kwargs)
        ids.append(top.clone())   # the flat selection is a view of the whole sort's indices
        return top

    bkv._retrieve_top_l = recording
    try:
        return run(), torch.stack(ids)
    finally:
        bkv._retrieve_top_l = taken


def same(name: str, a, b) -> None:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
        raise AssertionError(f"{name}: the mesh path's differ from the plain path's")


def mesh_serve_phase(dev, card: str, long_ctx: dict) -> dict:
    """Phase 10: prefill and decode on the (1, 1) mesh (a one-rank NCCL
    group on the card, gloo on the CPU), through `launch.specs.step_and_specs`'s
    prefill and decode steps, glm4-9b at full width and depth in bf16 with
    `opt_hier_topk` on, its parameters drawn again from 7a's seed and cut
    to this rank's blocks (a copy on one rank). 10a: 7a's LM_REQUESTS x
    LM_PROMPT tokens (7a's draw), prefilled and decoded LM_DECODE greedy
    exact-KV steps by the plain `LM` and by the mesh steps, on the same
    parameter tensors; 10b: LM_LONG_DECODE greedy BANG-KV steps of each
    from 7b's state before its decode (`long_ctx`: host copies, its
    codebooks set), the mesh's top-L the hierarchical one. Logits, tokens,
    caches and every layer's top-L ids must be the plain path's bit for
    bit. One more mesh step of each is then profiled on the device alone.
    The launch counts, set to 0 before 10a, must all be 0 after 10b."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import make_mesh, shard_caches, shard_tree
    from repro_torch.distributed.collectives import MeshContext
    from repro_torch.launch.specs import step_and_specs
    from repro_torch.models import LM

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(lm_config(LM_ARCH), opt_hier_topk=True)
    free_device(dev)
    made = not dist.is_initialized()
    mesh = make_mesh((1, 1), ("data", "model"), dev)
    out = {"arch": cfg.name, "mesh": dict(mesh.shape), "backend": dist.get_backend(),
           "hier_topk": cfg.opt_hier_topk}
    try:
        reset_launches()
        g = torch.Generator(dev).manual_seed(SEED)
        full = LM(cfg, device=dev, generator=g).params
        B, S, V = LM_REQUESTS, LM_PROMPT, cfg.vocab_size
        tokens = torch.randint(0, V, (B, S), generator=g, device=dev)   # 7a's prompts
        s_max = S + LM_DECODE + 1   # the steps and one profiled step
        prefill, _, (p_place, b_place) = step_and_specs(
            cfg, ShapeSpec("prefill_7a", "prefill", S, B), mesh)
        serve, _, _ = step_and_specs(cfg, ShapeSpec("decode_7a", "decode", s_max, B), mesh)
        params = shard_tree(full, p_place, mesh)   # one rank: the whole tensors, copied
        del full
        lm = LM(cfg, params)                       # the plain path on the same tensors

        # 10a: 7a's requests, plain then mesh; the plain run's results on the host.
        runs = {}
        for name in ("plain", "mesh"):
            resident = free_device(dev)
            sync(dev)
            t0 = time.perf_counter()
            if name == "plain":
                logits, caches = lm.prefill({"tokens": tokens}, s_max=s_max)
                step = lambda c, t: lm.decode_step(c, t)   # noqa: E731
            else:
                logits, caches = prefill(params, shard_tree({"tokens": tokens}, b_place, mesh),
                                         s_max=s_max)
                step = lambda c, t: serve(params, c, t)   # noqa: E731
            sync(dev)
            prefill_ms = (time.perf_counter() - t0) * 1e3
            finite(f"10a {name} prefill logits", logits, (B, 1, V))
            tok = logits[:, 0].argmax(dim=-1, keepdim=True).to(torch.int32)
            dl, fed, ms, caches = greedy_run(step, caches, tok, LM_DECODE, dev)
            finite(f"10a {name} decode logits", dl, (LM_DECODE, B, V))
            runs[name] = {"prefill_ms": prefill_ms, **step_stats(ms, B), "memory": device_mem(dev),
                          "memory_at_start": resident,
                          "host": [x.cpu() for x in (logits, dl, fed, *caches)]}
            del logits, dl
            if name == "plain":
                del caches, fed
        for what, a, b in zip(("prefill logits", "decode logits", "tokens", "K caches", "V caches",
                               "cache indices"), runs["plain"].pop("host"), runs["mesh"].pop("host")):
            same(f"10a {what}", a, b)
        exact = runs
        exact["mesh"]["prefill_collectives"] = dict(prefill.mesh_context.counts)
        exact["mesh"]["collectives_per_step"] = {k: v / LM_DECODE
                                                 for k, v in serve.mesh_context.counts.items()}
        exact["mesh_over_plain"] = exact["mesh"]["ms_per_step"] / exact["plain"]["ms_per_step"]
        exact["prefill_mesh_over_plain"] = exact["mesh"]["prefill_ms"] / exact["plain"]["prefill_ms"]
        tok = fed[-1]
        prof = None
        if torch.device(dev).type == "cuda":
            prof = device_profile("10a one mesh exact-KV decode step (1, 1)",
                                  lambda: serve(params, caches, tok), exact["mesh"]["ms_per_step"],
                                  cpu_ops=False)
        exact["mesh"]["device_profile"] = prof
        del caches, fed
        out["exact"] = exact
        # The host time of one collective on the one-rank group, which the
        # mesh step issues hundreds of: one-element all-reduces and
        # all-gathers through a context of their own (its counts apart),
        # and through torch.distributed directly.
        own = MeshContext(mesh, cfg)
        x = torch.zeros(1, device=dev)
        group = mesh.group("model")
        cost = {}
        for kind, fn in (("all_reduce", lambda: own.reduce_model(x)),
                         ("all_gather", lambda: own.gather_model(x, 0)),
                         ("dist.all_reduce", lambda: dist.all_reduce(x, group=group)),
                         ("dist.all_gather", lambda: dist.all_gather([torch.empty_like(x)], x,
                                                                     group=group))):
            fn()
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(COLLECTIVE_REPS):
                fn()
            sync(dev)
            cost[kind] = (time.perf_counter() - t0) * 1e6 / COLLECTIVE_REPS
        per_step = exact["mesh"]["collectives_per_step"]
        out["collective_host_us"] = cost
        out["collectives_host_ms_per_step"] = sum(per_step[k] * cost[k] for k in per_step) / 1e3
        log(f"[mesh-serve] 10a {cfg.name} on the {dict(mesh.shape)} mesh ({dist.get_backend()}, "
            f"one rank), {B} x {S} tokens: prefill {exact['mesh']['prefill_ms']:.1f} ms against the "
            f"plain {exact['plain']['prefill_ms']:.1f} ({exact['prefill_mesh_over_plain']:.4f}); "
            f"exact-KV decode {exact['mesh']['ms_per_step']:.2f} ms a step against "
            f"{exact['plain']['ms_per_step']:.2f} ({exact['mesh_over_plain']:.4f}; medians of steps "
            f"2-{LM_DECODE}); collectives: prefill "
            + ", ".join(f"{k} {v}" for k, v in sorted(exact["mesh"]["prefill_collectives"].items()))
            + ", a decode step "
            + ", ".join(f"{k} {v:.0f}" for k, v in sorted(exact["mesh"]["collectives_per_step"].items()))
            + ("; NCCL not measured" if prof is None else
               f"; one profiled step: {prof['nccl_events']} NCCL kernels, {prof['device_events']} "
               f"device events, {prof['busy_ms']:.2f} ms busy, device copies {prof['copy_events']} "
               f"({prof['copy_ms']:.3f} ms)")
            + f"; peak device memory {(exact['mesh']['memory'] or {}).get('peak_bytes', 0) / 1e9:.2f} "
            f"GB against {(exact['plain']['memory'] or {}).get('peak_bytes', 0) / 1e9:.2f}; logits, "
            f"tokens and caches bit-equal [{card}]")
        log(f"[mesh-serve] 10a one collective on the one-rank group, host us (the mean of "
            f"{COLLECTIVE_REPS}): all_reduce {cost['all_reduce']:.1f}, all_gather "
            f"{cost['all_gather']:.1f} (torch.distributed's alone: {cost['dist.all_reduce']:.1f}, "
            f"{cost['dist.all_gather']:.1f}); the mesh context's times the decode step's counts: "
            f"{out['collectives_host_ms_per_step']:.1f} ms a step [{card}]")

        # 10b: 7b's state, BANG-KV with the hierarchical top-L.
        host = long_ctx["bang"]
        lm.set_codebooks(long_ctx["codebooks"].to(dev))   # the tensor the mesh step reads too
        s_long = host.k.shape[2]
        bang_step, _, _ = step_and_specs(cfg, ShapeSpec("long_500k", "decode", s_long, 1), mesh)
        if not bang_step.bangkv:
            raise AssertionError("10b: the long_500k decode step does not decode with BANG-KV")
        tok = long_ctx["token"].to(dev)
        runs, kept = {}, {}
        for name in ("plain", "mesh"):
            resident = free_device(dev)
            if name == "plain":
                state = type(host)(*(t.to(dev) for t in host))
                step = lambda c, t: lm.decode_step(c, t, bangkv=True)   # noqa: E731
            else:
                state = type(host)(*(t.to(dev) for t in shard_caches(host, mesh, batch_divisible=True)))
                step = lambda c, t: bang_step(params, c, t)   # noqa: E731
            peaks = []
            (dl, fed, ms, state), ids = recorded_top_l(
                lambda: greedy_run(step, state, tok, LM_LONG_DECODE, dev, peaks=peaks))
            finite(f"10b {name} BANG-KV logits", dl, (LM_LONG_DECODE, 1, V))
            mem = device_mem(dev)
            if mem is not None:   # the run's peak: the largest of its steps'
                mem["peak_bytes"] = max(peaks)
            runs[name] = {**step_stats(ms, 1), "memory": mem, "memory_at_start": resident,
                          "step_peak_bytes": peaks}
            kept[name] = (dl, fed, ids, *state)
            if name == "plain":   # on the host, out of the mesh run's memory
                kept[name] = tuple(x.cpu() for x in kept[name])
                del dl, fed, ids, state
        for what, a, b in zip(("logits", "tokens", "top-L ids", "codes", "K caches", "V caches",
                               "cache indices"), kept["plain"], kept["mesh"]):
            same(f"10b {what}", a, b.cpu())
        n_ids = kept["mesh"][2].numel()
        del kept["plain"]
        bang = runs
        bang["mesh"]["collectives_per_step"] = {k: v / LM_LONG_DECODE
                                                for k, v in bang_step.mesh_context.counts.items()}
        bang["mesh_over_plain"] = bang["mesh"]["ms_per_step"] / bang["plain"]["ms_per_step"]
        bang["top_l_ids_compared"] = n_ids
        prof = None
        if torch.device(dev).type == "cuda":
            tok = kept["mesh"][0][-1].argmax(dim=-1, keepdim=True).to(torch.int32)
            prof = device_profile("10b one mesh BANG-KV decode step (1, 1)",
                                  lambda: bang_step(params, state, tok), bang["mesh"]["ms_per_step"],
                                  cpu_ops=False)
        bang["mesh"]["device_profile"] = prof
        del kept, state
        out["bangkv"] = bang
        log(f"[mesh-serve] 10b one request of {s_long - LM_LONG_DECODE - 1} tokens (7b's state), "
            f"{LM_LONG_DECODE} greedy BANG-KV steps (hierarchical top-L {cfg.bangkv_topl}): "
            f"{bang['mesh']['ms_per_step']:.2f} ms a step against the plain {bang['plain']['ms_per_step']:.2f} "
            f"({bang['mesh_over_plain']:.4f}); collectives a step "
            + ", ".join(f"{k} {v:.0f}" for k, v in sorted(bang["mesh"]["collectives_per_step"].items()))
            + ("; NCCL not measured" if prof is None else
               f"; one profiled step: {prof['nccl_events']} NCCL kernels, {prof['device_events']} "
               f"device events, {prof['busy_ms']:.2f} ms busy")
            + f"; peak device memory {(bang['mesh']['memory'] or {}).get('peak_bytes', 0) / 1e9:.2f} GB "
            f"against {(bang['plain']['memory'] or {}).get('peak_bytes', 0) / 1e9:.2f}; logits, tokens, "
            f"codes, caches and {n_ids:,} top-L ids bit-equal [{card}]")
        del lm, params
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"the mesh serve path launched port kernels: {launches}")
    free_device(dev)
    out["kernel_launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------------------ phase 11
MOE_MESH_TRAIN_LAYERS = 2       # 11a: phi3.5-moe cut to 2 of 32 layers, as 8b
MOE_SERVE_LAYERS = 8            # 11b: phi3.5-moe cut to 8 of 32 layers (about 21 GB in bf16)
SCOUT_ARCH = "llama4-scout-17b-a16e"
SCOUT_SERVE_LAYERS = 4          # 11c: llama4-scout cut to 4 of 48 layers (about 22 GB in bf16)
SCOUT_DECODE = 16               # 11c: greedy exact-KV steps each way


def recorded_drops(run):
    """run() with every MoE layer's dropped fraction kept, on the device:
    (its result, the fractions of each layer and call stacked)."""
    import torch

    from repro_torch.models import transformer

    block, drops = transformer.moe_block, []

    def recording(*args, **kwargs):
        y, aux = block(*args, **kwargs)
        drops.append(aux.dropped_frac.detach())
        return y, aux

    transformer.moe_block = recording
    try:
        return run(), torch.stack(drops)
    finally:
        transformer.moe_block = block


def mesh_train(dev, card: str, mesh, label: str, tag: str, name: str, layers: int | None,
               seq: int | None = None, profile: bool = False) -> dict:
    """11a, 12a, 13a: `name` at full width cut to `layers` layers (its full
    depth when None), bf16 with remat, MESH_STEPS steps of
    `step_and_specs`'s train step on TRAIN_BATCH x `seq` tokens (TRAIN_SEQ
    when None; whisper's with its `frontend_len` seeded frames), then
    MESH_STEPS plain steps from the same draw (the two states do not fit
    the card together): losses within rtol 1e-5, the bf16 parameters
    within C15's bound (an MoE dispatch's backward sums with atomics,
    C17), compared on the card one tensor at a time from host copies.
    With `profile`, one more step of each, after the comparison's copies,
    is profiled on the device alone. `tag` heads its log line."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import TokenStream
    from repro_torch.distributed import shard_tree
    from repro_torch.launch.specs import LR, step_and_specs
    from repro_torch.models import LM, init_params
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.tree import flat_dict

    full_depth = lm_config(name).n_layers
    cfg = lm_config(name) if layers is None else lm_config(name, n_layers=layers)
    seq = TRAIN_SEQ if seq is None else seq
    free_device(dev)
    frames = (cfg.frontend_len, cfg.d_model) if cfg.frontend == "audio_stub" else None
    stream = TokenStream(cfg.vocab_size, seq, TRAIN_BATCH, seed=SEED, frontend=frames)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in stream.batch_at(s).items()}
               for s in range(MESH_STEPS)]
    draw = lambda: init_params(cfg, torch.Generator(dev).manual_seed(SEED + 7), dev)   # noqa: E731
    params = draw()
    sums = torch.stack([p.detach().double().sum() for p in params.parameters()]).cpu()
    n_params = sum(p.numel() for p in params.parameters())
    step, _, place = step_and_specs(cfg, ShapeSpec("train_4k", "train", seq, TRAIN_BATCH), mesh)
    mparams = shard_tree(params, place[0], mesh)   # one rank: a copy
    del params
    opt = adamw_init(mparams)
    free_device(dev)
    mesh_ms, mesh_losses, metrics = [], [], []
    for s in range(MESH_STEPS):
        sync(dev)
        t0 = time.perf_counter()
        mparams, opt, loss = step(mparams, opt, shard_tree(batches[s], place[2], mesh))
        mesh_losses.append(loss.item())
        sync(dev)
        mesh_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in step.metrics.items()})
    counts = {k: v / MESH_STEPS for k, v in step.mesh_context.counts.items()}
    mem = device_mem(dev)
    mesh_after = {k: p.detach().cpu() for k, p in flat_dict(mparams).items()}
    med = float(np.median(mesh_ms[1:]))
    prof = pprof = None
    if profile and torch.device(dev).type == "cuda":
        prof = device_profile(f"{label} one mesh training step (1, 1)", lambda: step(
            mparams, opt, shard_tree(batches[0], place[2], mesh)), med, cpu_ops=False)
    del opt, mparams
    free_device(dev)

    params = draw()
    if not torch.equal(sums, torch.stack([p.detach().double().sum() for p in params.parameters()]).cpu()):
        raise AssertionError(f"{label}: the parameters drawn again from the seed differ")
    lm = LM(cfg, params)
    popt = adamw_init(params)
    params.requires_grad_(True)
    plain_ms, plain_losses = [], []

    def plain_step(batch):
        nonlocal popt
        for p in params.parameters():
            p.grad = None
        loss, _ = lm.loss(batch)
        loss.backward()
        _, popt, _ = adamw_update({k: p.grad for k, p in flat_dict(params).items()}, popt, params, LR)
        return loss

    for s in range(MESH_STEPS):
        sync(dev)
        t0 = time.perf_counter()
        plain_losses.append(plain_step(batches[s]).item())
        sync(dev)
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    pmem = device_mem(dev)
    loss_bits = mesh_losses == plain_losses
    if not loss_bits and not np.allclose(mesh_losses, plain_losses, rtol=1e-5, atol=0):
        raise AssertionError(f"{label}: mesh losses {mesh_losses}, plain {plain_losses}")
    differ, worst, total = 0, 0.0, 0
    with torch.no_grad():
        for k, p in flat_dict(params).items():
            n, w, ok = bf16_within(mesh_after.pop(k).to(dev), p.detach(), LR, MESH_STEPS)
            if not ok:
                raise AssertionError(f"{label}: {k} differs in {n} entries, by up to {w}")
            differ, worst, total = differ + n, max(worst, w), total + p.numel()
    pmed = float(np.median(plain_ms[1:]))
    if profile and torch.device(dev).type == "cuda":
        pprof = device_profile(f"{label} one plain training step", lambda: plain_step(batches[0]),
                               pmed, cpu_ops=False)
    del lm, params, popt
    free_device(dev)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "layers_published": full_depth,
           "encoder_layers": cfg.n_encoder_layers, "frames": frames[0] if frames else 0,
           "parameters": n_params, "dtype": cfg.dtype, "remat": cfg.remat, "steps": MESH_STEPS,
           "batch": TRAIN_BATCH, "seq_len": seq, "lr": LR,
           "mesh_step": {"losses": mesh_losses, "metrics": metrics, "step_ms": mesh_ms,
                         "ms_per_step": med, "collectives_per_step": counts, "memory": mem,
                         "device_profile": prof},
           "plain_step": {"losses": plain_losses, "step_ms": plain_ms, "ms_per_step": pmed,
                          "memory": pmem, "device_profile": pprof},
           "mesh_over_plain": med / pmed,
           "parity": {"losses_bit_equal": loss_bits, "param_entries": total,
                      "param_entries_differing": differ, "param_max_abs_diff": worst,
                      "bit_equal": loss_bits and differ == 0}}
    moe = (f"; the last step's dropped_frac {metrics[-1]['dropped_frac']:.4f} and load_balance "
           f"{metrics[-1]['load_balance']:.4f} (sums over the layers, as the loss takes them)"
           if cfg.n_experts else "")
    enc = f" + {cfg.n_encoder_layers} encoder layers" if cfg.n_encoder_layers else ""
    after = f" after {frames[0]:,} frames" if frames else ""
    log(f"[{tag}] {label} {cfg.name} ({cfg.n_layers} of {full_depth} layers{enc}, {cfg.dtype}, remat, "
        f"{n_params:,} parameters) on the {dict(mesh.shape)} mesh ({dist.get_backend()}, one rank), "
        f"{MESH_STEPS} steps of {TRAIN_BATCH} x {seq} tokens{after}: {med:.1f} ms a step against the plain "
        f"{pmed:.1f} ({med / pmed:.4f}; medians after the first); losses "
        + ", ".join(f"{x:.6f}" for x in mesh_losses) + " (plain "
        + ", ".join(f"{x:.6f}" for x in plain_losses) + ("; bit-equal" if loss_bits else "; within rtol 1e-5")
        + f"){moe}; collectives a step "
        + ", ".join(f"{k} {v:.0f}" for k, v in sorted(counts.items()))
        + f"; bf16 parameters after step {MESH_STEPS}: {differ} of {total:,} entries differ (max "
        f"{worst:.3g})"
        + ("" if prof is None or pprof is None else
           f"; one profiled step each: busy {prof['busy_ms']:.1f} ms in {prof['device_events']} device "
           f"events (copies {prof['copy_events']}, {prof['copy_ms']:.2f} ms) against {pprof['busy_ms']:.1f} "
           f"in {pprof['device_events']} ({pprof['copy_events']}, {pprof['copy_ms']:.2f} ms)")
        + f"; peak device memory {(mem or {}).get('peak_bytes', 0) / 1e9:.2f} GB against "
        f"{(pmem or {}).get('peak_bytes', 0) / 1e9:.2f} [{card}]")
    return out


def caches_on_host(caches) -> list:
    """Every tensor of a decode state, field by field, copied to the host."""
    import torch

    if isinstance(caches, torch.Tensor):
        return [caches.cpu()]
    return [t for c in caches for t in caches_on_host(c)]


def mesh_serve(dev, card: str, mesh, label: str, tag: str, name: str, *, seed: int, steps: int,
               layers: int | None = None, bang_steps: int = 0, profile: bool = False,
               prompt: int | None = None) -> dict:
    """11b, 11c, 12b, 12c, 13b, 13c: `name` at full width in bf16 (cut to
    `layers` layers when given), its parameters and LM_REQUESTS x `prompt`
    tokens (LM_PROMPT when None; whisper's after `frontend_len` frames)
    drawn on the card from `seed`; each path, the plain `LM` and then
    `step_and_specs`'s prefill and decode steps on the same parameter
    tensors, prefills and decodes `steps` greedy exact-KV steps, then
    `bang_steps` greedy BANG-KV steps from that state with the
    hierarchical top-L (`opt_hier_topk`), the codebooks fitted once on
    the plain path's keys (as 7f) and every decoded key encoded with them.
    Logits, tokens, every cache tensor, the top-L ids and an MoE's every
    layer's dropped fraction must be bit-equal. With `profile`, one more
    mesh exact-KV step is profiled on the device alone. `tag` heads the
    log line."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import shard_tree
    from repro_torch.launch.specs import step_and_specs
    from repro_torch.models import LM
    from repro_torch.models import retrieval_attention as bkv
    from repro_torch.models.transformer import attention_caches, clone_caches, with_attention_caches

    full_depth = lm_config(name).n_layers
    cfg = lm_config(name) if layers is None else lm_config(name, n_layers=layers)
    if bang_steps:
        cfg = dataclasses.replace(cfg, opt_hier_topk=True)
    moe = bool(cfg.n_experts)
    free_device(dev)
    g = torch.Generator(dev).manual_seed(seed)
    full = LM(cfg, device=dev, generator=g).params
    n_params = sum(p.numel() for p in full.parameters())
    B, S, V = LM_REQUESTS, LM_PROMPT if prompt is None else prompt, cfg.vocab_size
    batch = {"tokens": torch.randint(0, V, (B, S), generator=g, device=dev)}
    if cfg.frontend == "audio_stub":
        batch["frontend"] = torch.randn((B, cfg.frontend_len, cfg.d_model), generator=g, device=dev)
    fill = S + steps
    s_max = fill + bang_steps + 1   # the steps and one profiled step
    prefill, _, (p_place, b_place) = step_and_specs(cfg, ShapeSpec("prefill_7a", "prefill", S, B), mesh)
    serve, _, _ = step_and_specs(cfg, ShapeSpec("decode_7a", "decode", s_max, B), mesh)
    if bang_steps:
        bang, _, _ = step_and_specs(cfg, ShapeSpec("long_500k", "decode", s_max, B), mesh)
        if not bang.bangkv:
            raise AssertionError(f"{label}: the long_500k decode step does not decode with BANG-KV")
    params = shard_tree(full, p_place, mesh)   # one rank: the whole tensors, copied
    del full
    lm = LM(cfg, params)                       # the plain path on the same tensors
    runs, codebooks = {}, None
    for path in ("plain", "mesh"):
        resident = free_device(dev)

        def run():
            sync(dev)
            t0 = time.perf_counter()
            if path == "plain":
                logits, caches = lm.prefill(batch, s_max=s_max)
                step = lambda c, t: lm.decode_step(c, t)   # noqa: E731
            else:
                logits, caches = prefill(params, shard_tree(batch, b_place, mesh), s_max=s_max)
                step = lambda c, t: serve(params, c, t)   # noqa: E731
            sync(dev)
            prefill_ms = (time.perf_counter() - t0) * 1e3
            tok = logits[:, 0].argmax(dim=-1, keepdim=True).to(torch.int32)
            return prefill_ms, logits, greedy_run(step, caches, tok, steps, dev)

        if moe:
            (prefill_ms, logits, (dl, fed, ms, caches)), drops = recorded_drops(run)
        else:
            (prefill_ms, logits, (dl, fed, ms, caches)), drops = run(), None
        finite(f"{label} {path} prefill logits", logits, (B, 1, V))
        finite(f"{label} {path} decode logits", dl, (steps, B, V))
        out = {"prefill_ms": prefill_ms, **step_stats(ms, B), "memory": device_mem(dev),
               "memory_at_start": resident}
        host = [x.cpu() for x in (logits, dl, fed)]
        if moe:
            out["dropped_frac_prefill"] = drops[:cfg.n_layers].float().mean().item()
            out["dropped_frac_decode"] = drops[cfg.n_layers:].float().mean().item()
            host.append(drops.cpu())
        host += caches_on_host(caches)
        if bang_steps:
            state = clone_caches(caches)
            kv = attention_caches(cfg, state)
            if codebooks is None:   # fitted once, on the plain path's keys
                codebooks, _ = bkv.fit_bangkv_caches(kv, fill, cfg.bangkv_m, iters=LM_FIT_ITERS)
                lm.set_codebooks(codebooks)   # the tensor the mesh step reads too
            codes = torch.zeros((*kv.k.shape[:4], cfg.bangkv_m), dtype=torch.uint8, device=dev)
            for i in range(kv.k.shape[0]):
                codes[i, :, :fill] = bkv.encode_keys(codebooks[i], kv.k[i, :, :fill])
            state = with_attention_caches(cfg, state, bkv.BangKVCache(codes, kv.k, kv.v, kv.index))
            step = (lambda c, t: lm.decode_step(c, t, bangkv=True)) if path == "plain" else (
                lambda c, t: bang(params, c, t))
            first = dl[-1].argmax(dim=-1, keepdim=True).to(torch.int32)
            (bl, _, bms, state), ids = recorded_top_l(
                lambda: greedy_run(step, state, first, bang_steps, dev))
            finite(f"{label} {path} BANG-KV logits", bl, (bang_steps, B, V))
            out["bangkv"] = step_stats(bms, B)
            host += [bl.cpu(), ids.cpu()] + caches_on_host(state)
            del state, bl, ids
        out["host"] = host
        runs[path] = out
        del logits, dl, drops
        if path == "plain":
            del caches, fed
    plain_host, mesh_host = runs["plain"].pop("host"), runs["mesh"].pop("host")
    for i, (a, b) in enumerate(zip(plain_host, mesh_host)):
        same(f"{label} tensor {i} (logits, tokens{', dropped fractions' if moe else ''}, the caches"
             f"{', BANG-KV' if bang_steps else ''})", a, b)
    out = runs
    out.update(arch=cfg.name, layers=cfg.n_layers, layers_published=full_depth,
               encoder_layers=cfg.n_encoder_layers, frames=cfg.frontend_len if "frontend" in batch else 0,
               parameters=n_params, dtype=cfg.dtype, requests=B, prompt=S, steps=steps,
               bangkv_steps=bang_steps, tensors_compared=len(mesh_host))
    out["mesh"]["prefill_collectives"] = dict(prefill.mesh_context.counts)
    out["mesh"]["collectives_per_step"] = {k: v / steps for k, v in serve.mesh_context.counts.items()}
    out["mesh_over_plain"] = out["mesh"]["ms_per_step"] / out["plain"]["ms_per_step"]
    out["prefill_mesh_over_plain"] = out["mesh"]["prefill_ms"] / out["plain"]["prefill_ms"]
    extra = ""
    if moe:
        extra += (f"; dropped_frac prefill {out['mesh']['dropped_frac_prefill']:.4f}, decode "
                  f"{out['mesh']['dropped_frac_decode']:.4f}")
    if bang_steps:
        out["mesh"]["bangkv"]["collectives_per_step"] = {
            k: v / bang_steps for k, v in bang.mesh_context.counts.items()}
        out["bangkv_mesh_over_plain"] = (out["mesh"]["bangkv"]["ms_per_step"]
                                         / out["plain"]["bangkv"]["ms_per_step"])
        extra += (f"; {bang_steps} BANG-KV steps (hierarchical top-L {cfg.bangkv_topl}) "
                  f"{out['mesh']['bangkv']['ms_per_step']:.2f} ms a step against "
                  f"{out['plain']['bangkv']['ms_per_step']:.2f} ({out['bangkv_mesh_over_plain']:.4f}), "
                  "collectives a step " + ", ".join(
                      f"{k} {v:.0f}" for k, v in sorted(out["mesh"]["bangkv"]["collectives_per_step"].items())))
    prof = None
    if profile and torch.device(dev).type == "cuda":
        tok = fed[-1]
        prof = device_profile(f"{label} one mesh exact-KV decode step (1, 1)",
                              lambda: serve(params, caches, tok), out["mesh"]["ms_per_step"],
                              cpu_ops=False)
    out["mesh"]["device_profile"] = prof
    del caches, fed, lm, params, batch
    free_device(dev)
    enc = f" + {cfg.n_encoder_layers} encoder layers" if cfg.n_encoder_layers else ""
    after = f" after {out['frames']:,} frames" if out["frames"] else ""
    log(f"[{tag}] {label} {cfg.name} ({cfg.n_layers} of {full_depth} layers{enc}, {cfg.dtype}, "
        f"{n_params:,} parameters) on the {dict(mesh.shape)} mesh ({dist.get_backend()}, one rank), "
        f"{B} x {S} tokens{after}: prefill {out['mesh']['prefill_ms']:.1f} ms against the plain "
        f"{out['plain']['prefill_ms']:.1f} ({out['prefill_mesh_over_plain']:.4f}); exact-KV decode "
        f"{out['mesh']['ms_per_step']:.2f} ms a step against {out['plain']['ms_per_step']:.2f} "
        f"({out['mesh_over_plain']:.4f}; medians of steps 2-{steps}); collectives: prefill "
        + ", ".join(f"{k} {v}" for k, v in sorted(out["mesh"]["prefill_collectives"].items()))
        + ", a decode step "
        + ", ".join(f"{k} {v:.0f}" for k, v in sorted(out["mesh"]["collectives_per_step"].items()))
        + extra
        + ("" if prof is None else
           f"; one profiled step: {prof['nccl_events']} NCCL kernels, {prof['device_events']} device "
           f"events, {prof['busy_ms']:.2f} ms busy, device copies {prof['copy_events']} "
           f"({prof['copy_ms']:.3f} ms)")
        + f"; peak device memory {(out['mesh']['memory'] or {}).get('peak_bytes', 0) / 1e9:.2f} GB "
        f"against {(out['plain']['memory'] or {}).get('peak_bytes', 0) / 1e9:.2f}; {len(mesh_host)} "
        f"tensors bit-equal [{card}]")
    return out


def mesh_moe_phase(dev, card: str) -> dict:
    """Phase 11: the moe family's mesh steps on the (1, 1) mesh (a one-rank
    NCCL group on the card, gloo on the CPU), every expert on the one
    `model` rank: 11a phi3.5-moe training (`mesh_train`), 11b
    phi3.5-moe cut to MOE_SERVE_LAYERS layers and 11c llama4-scout cut to
    SCOUT_SERVE_LAYERS layers, its shared expert included, serving
    (`mesh_serve`). The launch counts, set to 0 before 11a, must all
    be 0 after 11c."""
    import torch.distributed as dist

    from repro_torch.distributed import make_mesh

    t_phase = time.perf_counter()
    reset_launches()
    made = not dist.is_initialized()
    mesh = make_mesh((1, 1), ("data", "model"), dev)
    out = {"mesh": dict(mesh.shape), "backend": dist.get_backend()}
    try:
        t0 = time.perf_counter()
        out["train"] = mesh_train(dev, card, mesh, "11a", "mesh-moe", LM_MOE_ARCH,
                                  MOE_MESH_TRAIN_LAYERS)
        out["train"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["phi_serve"] = mesh_serve(dev, card, mesh, "11b", "mesh-moe", LM_MOE_ARCH, seed=SEED,
                                      steps=LM_DECODE, layers=MOE_SERVE_LAYERS, profile=True)
        out["phi_serve"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["scout_serve"] = mesh_serve(dev, card, mesh, "11c", "mesh-moe", SCOUT_ARCH, seed=SEED,
                                        steps=SCOUT_DECODE, layers=SCOUT_SERVE_LAYERS)
        out["scout_serve"]["phase_s"] = time.perf_counter() - t0
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"the moe mesh path launched port kernels: {launches}")
    free_device(dev)
    out["kernel_launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------------------ phase 12
SSM_MESH_SEED, HYBRID_MESH_SEED = SEED + 3, SEED + 4   # 12b, 12c: 7e's and 7f's draws


def mesh_ssm_phase(dev, card: str) -> dict:
    """Phase 12: the ssm and hybrid families' mesh steps on the (1, 1) mesh
    (a one-rank NCCL group on the card, gloo on the CPU), every width of
    the Mamba2 block on the one `model` rank: 12a mamba2-2.7b cut to
    LM_CUT_LAYERS and zamba2-2.7b to HYBRID_CUT_LAYERS layers training
    (`mesh_train`, 8b's cuts and shape), 12b mamba2-2.7b at full depth
    serving 7e's requests and 12c zamba2-2.7b at full depth serving 7f's,
    exact-KV then BANG-KV (`mesh_serve`). The launch counts, set to 0
    before 12a, must all be 0 after 12c."""
    import torch.distributed as dist

    from repro_torch.distributed import make_mesh

    t_phase = time.perf_counter()
    reset_launches()
    made = not dist.is_initialized()
    mesh = make_mesh((1, 1), ("data", "model"), dev)
    out = {"mesh": dict(mesh.shape), "backend": dist.get_backend()}
    try:
        for key, label, name, layers in (("ssm_train", "12a", SSM_ARCH, LM_CUT_LAYERS),
                                         ("hybrid_train", "12a", HYBRID_ARCH, HYBRID_CUT_LAYERS)):
            t0 = time.perf_counter()
            out[key] = mesh_train(dev, card, mesh, label, "mesh-ssm", name, layers)
            out[key]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["ssm_serve"] = mesh_serve(dev, card, mesh, "12b", "mesh-ssm", SSM_ARCH, seed=SSM_MESH_SEED,
                                      steps=LM_DECODE, profile=True)
        out["ssm_serve"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["hybrid_serve"] = mesh_serve(dev, card, mesh, "12c", "mesh-ssm", HYBRID_ARCH,
                                         seed=HYBRID_MESH_SEED, steps=LM_DECODE,
                                         bang_steps=LM_LONG_DECODE)
        out["hybrid_serve"]["phase_s"] = time.perf_counter() - t0
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"the ssm and hybrid mesh path launched port kernels: {launches}")
    free_device(dev)
    out["kernel_launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------------------ phase 13
ENCDEC_MESH_SEED = SEED + 5     # 13b, 13c: 7g's draw
ENCDEC_BANG_PROMPT = 448        # 13c: whisper's decoder context, past BANG-KV's window of 256
ENCDEC_BANG_EXACT = 4           # 13c: exact-KV steps before the BANG-KV ones


def mesh_encdec_phase(dev, card: str) -> dict:
    """Phase 13: the encdec family's mesh steps on the (1, 1) mesh (a
    one-rank NCCL group on the card, gloo on the CPU), whisper-medium at
    full width and depth, its encoder, self- and cross-attention and FFN
    on the one `model` rank: 13a training (`mesh_train`, 8b's shape at
    full depth), 13b 7g's requests served exact-KV and 13c LM_LONG_DECODE
    BANG-KV steps with the hierarchical top-L from ENCDEC_BANG_PROMPT-token
    prompts (`mesh_serve`). The launch counts, set to 0 before 13a, must
    all be 0 after 13c."""
    import torch.distributed as dist

    from repro_torch.distributed import make_mesh

    t_phase = time.perf_counter()
    reset_launches()
    made = not dist.is_initialized()
    mesh = make_mesh((1, 1), ("data", "model"), dev)
    out = {"mesh": dict(mesh.shape), "backend": dist.get_backend()}
    try:
        t0 = time.perf_counter()
        out["train"] = mesh_train(dev, card, mesh, "13a", "mesh-encdec", ENCDEC_ARCH, None,
                                  seq=ENCDEC_TRAIN_TOKENS, profile=True)
        out["train"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["serve"] = mesh_serve(dev, card, mesh, "13b", "mesh-encdec", ENCDEC_ARCH,
                                  seed=ENCDEC_MESH_SEED, steps=LM_DECODE, prompt=ENCDEC_PROMPT,
                                  profile=True)
        out["serve"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["bangkv"] = mesh_serve(dev, card, mesh, "13c", "mesh-encdec", ENCDEC_ARCH,
                                   seed=ENCDEC_MESH_SEED, steps=ENCDEC_BANG_EXACT,
                                   prompt=ENCDEC_BANG_PROMPT, bang_steps=LM_LONG_DECODE)
        out["bangkv"]["phase_s"] = time.perf_counter() - t0
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"the encdec mesh path launched port kernels: {launches}")
    free_device(dev)
    out["kernel_launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------------------ phase 14
# 14a: the serve CLI's defaults (n = 4,000, d = 64, 3 batches of 128, t =
# 64). Its recall@10 floor a batch: the reference package's CLI
# (`python -m repro.launch.serve`, the same arguments) on a CPU, JAX's
# recall unrounded (it prints 0.777, 0.760, 0.703).
SERVE_ARGS = ()                 # 14a: the CLI's own defaults
SERVE_REFERENCE_RECALL = (0.7765625, 0.76015625, 0.703125)
LAUNCH_LAYERS = 4               # 14b: granite-3-2b cut to 4 of 40 layers
LAUNCH_TRAIN_STEPS = 2          # 14b: training steps each way
LAUNCH_DECODE = 4               # 14b: greedy exact-KV steps each way
# 14c: one cell a family, shape-only on the 2 x 16 x 16 fake group, at
# full width and depth, and the sharded search at its reference shapes.
DRYRUN_CELLS = (("granite-3-2b", "decode_32k"), ("internvl2-1b", "decode_32k"),
                ("phi3.5-moe-42b-a6.6b", "decode_32k"), ("mamba2-2.7b", "decode_32k"),
                ("zamba2-2.7b", "decode_32k"), ("whisper-medium", "decode_32k"))
DRYRUN_MESH = (2, 16, 16)
DRYRUN = r"""
import json, sys
import torch
import repro_torch.configs as configs
from repro_torch.configs.base import LM_SHAPES, ShapeSpec
from repro_torch.launch import dryrun

cell, mesh, reduced, out = json.loads(sys.argv[1])
if cell is None:
    rec = dryrun.sharded_search_dryrun(mesh_shape=tuple(mesh))
else:
    arch, shape = cell
    cfg = configs.get(arch)
    sh = LM_SHAPES[shape]
    if reduced:   # the CPU rehearsal: reduced widths, a short sequence
        cfg = cfg.reduced(dtype="float32", n_layers=4 if cfg.family == "hybrid" else 2)
        sh = ShapeSpec(shape, sh.kind, 64, 8)
    rec = dryrun.run_cell(arch, shape, True, out, force=True, cfg=cfg, shape=sh, mesh_shape=tuple(mesh))
print(json.dumps(dict(rec, torch=torch.__version__)))
"""


def launch_phase(dev, card: str) -> dict:
    """Phase 14: the launch slice. 14a: the ANN serve CLI
    (`launch.serve.main`, its defaults, on the card): each batch's QPS and
    recall@10, the recall no lower than the reference CLI's on the CPU for
    the same arguments (`SERVE_REFERENCE_RECALL`). It runs the ANN main
    path, so it launches K1-K3: its counts are reported beside it. 14b: a
    (1, 1, 1) ("pod", "data", "model") mesh (a one-rank NCCL group on the
    card, gloo on the CPU): granite-3-2b at 9a's shape cut to LAUNCH_LAYERS
    layers, LAUNCH_TRAIN_STEPS training steps, then a prefill and
    LAUNCH_DECODE greedy exact-KV steps, each bit-equal to the plain path
    on the same parameters; the launch counts, set to 0 first, must be 0
    after. 14c, after them: in subprocesses (a fake process group cannot
    share a process with NCCL), one a cell and one for the search, all
    started together, `launch.dryrun` shape-only on the 2 x 16 x 16 fake
    group: one cell a family (`DRYRUN_CELLS`) and the sharded search at
    the reference's `--dryrun-sharded` shapes; each cell's wall, peak
    bytes a rank and dominant term. Its numbers are estimates from
    shapes."""
    import os

    import torch

    t_phase = time.perf_counter()
    out = {}
    _launch_card(dev, card, out)
    t0 = time.perf_counter()
    # One process a cell and one for the search, started together.
    procs = [subprocess.Popen(
        [sys.executable, "-c", DRYRUN, json.dumps([cell, list(DRYRUN_MESH), torch.device(dev).type == "cpu",
                                                   str(ROOT / "build" / "dryrun_torch")])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"))) for cell in [*DRYRUN_CELLS, None]]
    try:
        runs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, stderr) in zip(procs, runs):
        if p.returncode != 0:
            raise AssertionError(f"14c: the dry run failed:\n{stderr[-4000:]}")
    *recs, sh = [json.loads(stdout.strip().splitlines()[-1]) for stdout, _ in runs]
    for rec in [*recs, sh]:
        if rec["status"] != "ok":
            raise AssertionError(f"14c: {rec.get('arch', 'sharded')} failed:\n{rec.get('traceback')}")
    cells = [{"arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"], "wall_s": r["wall_s"],
              "peak_bytes": r["memory"]["peak_bytes"], "argument_bytes": r["memory"]["argument_size_in_bytes"],
              "fits": r["memory"]["fits"], "dominant": r["roofline"]["dominant"],
              "collectives": {k: v["count"] for k, v in r["collectives"].items() if k != "total_bytes"},
              "collective_bytes": r["collectives"]["total_bytes"]} for r in recs]
    out["dryrun"] = {"torch": sh["torch"], "cells": cells, "process_s": time.perf_counter() - t0,
                     "sharded": {k: sh[k] for k in ("mesh", "n", "B", "n_loc", "queries_a_rank",
                                                     "max_iters", "bytes_a_rank", "collectives",
                                                     "search_bound", "wall_s")},
                     "s": sum(c["wall_s"] for c in cells) + sh["wall_s"]}
    for c in cells:
        log(f"[launch] 14c {c['arch']} {c['shape']} on {c['mesh']} (fake group, torch {sh['torch']}): "
            f"wall {c['wall_s']:.2f} s, peak {c['peak_bytes'] / 1e9:.3f} GB a rank (arguments "
            f"{c['argument_bytes'] / 1e9:.3f}), {c['dominant']}-bound; collectives {c['collectives']} "
            "(shape estimates)")
    log(f"[launch] 14c sharded search (n {sh['n']:,}, B {sh['B']:,}) on {sh['mesh']}: "
        f"{sh['bytes_a_rank']['total'] / 1e6:.1f} MB a rank, a hop's all-reduces "
        f"{sh['collectives']['hop']['all-reduce']}, bound over {sh['max_iters']} hops "
        f"{sh['search_bound']['total_bytes'] / 1e6:.1f} MB; wall {sh['wall_s']:.2f} s; cells and search "
        f"{out['dryrun']['s']:.1f} s in {len(procs)} processes side by side, {out['dryrun']['process_s']:.1f} s")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _launch_card(dev, card: str, out: dict) -> None:
    """Phase 14a and 14b, on the card (see `launch_phase`)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import TokenStream
    from repro_torch.distributed import POD_AXES, make_mesh, shard_tree
    from repro_torch.launch import serve
    from repro_torch.launch.specs import LR, step_and_specs
    from repro_torch.models import LM, init_params
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.tree import flat_dict

    # 14a: the serve CLI.
    free_device(dev)
    reset_launches()
    t0 = time.perf_counter()
    rows = serve.main([*SERVE_ARGS, "--device", torch.device(dev).type])
    out["serve"] = {"batches": rows, "reference_recall_at_10": list(SERVE_REFERENCE_RECALL),
                    "kernel_launches": read_launches(), "s": time.perf_counter() - t0}
    for r, floor in zip(rows, SERVE_REFERENCE_RECALL):
        if not r["recall_at_10"] >= floor:
            raise AssertionError(f"14a batch {r['batch']}: recall@10 {r['recall_at_10']} below the "
                                 f"reference CLI's {floor}")
    log(f"[launch] 14a serve CLI {' '.join(SERVE_ARGS) or '(n 4,000, d 64, 3 x 128 queries, t 64)'}: "
        + "; ".join(
        f"batch {r['batch']} {r['qps']:.1f} QPS recall@10 {r['recall_at_10']:.3f}" for r in rows)
        + f"; the reference CLI's recall on the CPU {SERVE_REFERENCE_RECALL}; launches "
        + ", ".join(f"{k} {v}" for k, v in out["serve"]["kernel_launches"].items() if v) + f" [{card}]")

    # 14b: the (1, 1, 1) pod mesh against the plain path.
    t0 = time.perf_counter()
    free_device(dev)
    reset_launches()
    cfg = lm_config(TRAIN_ARCH, n_layers=LAUNCH_LAYERS)
    seq, B = TRAIN_SEQ, TRAIN_BATCH
    made = not dist.is_initialized()
    mesh = make_mesh((1, 1, 1), POD_AXES, dev)
    res = {"arch": cfg.name, "layers": LAUNCH_LAYERS, "mesh": dict(mesh.shape),
           "backend": dist.get_backend(), "batch": B, "seq_len": seq}
    try:
        stream = TokenStream(cfg.vocab_size, seq, B, seed=SEED)
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in stream.batch_at(s).items()}
                   for s in range(LAUNCH_TRAIN_STEPS)]
        full = init_params(cfg, torch.Generator(dev).manual_seed(SEED + 14), dev)
        step, _, place = step_and_specs(cfg, ShapeSpec("train_4k", "train", seq, B), mesh)
        mparams, plain = shard_tree(full, place[0], mesh), shard_tree(full, place[0], mesh)
        opt, popt = adamw_init(mparams), adamw_init(plain)
        lm = LM(cfg, plain)
        plain.requires_grad_(True)
        ms = {"mesh": [], "plain": []}
        for s in range(LAUNCH_TRAIN_STEPS):
            sync(dev)
            t1 = time.perf_counter()
            mparams, opt, loss = step(mparams, opt, shard_tree(batches[s], place[2], mesh))
            sync(dev)
            ms["mesh"].append((time.perf_counter() - t1) * 1e3)
            t1 = time.perf_counter()
            for p in plain.parameters():
                p.grad = None
            ploss, _ = lm.loss(batches[s])
            ploss.backward()
            _, popt, _ = adamw_update({k: p.grad for k, p in flat_dict(plain).items()}, popt, plain, LR)
            sync(dev)
            ms["plain"].append((time.perf_counter() - t1) * 1e3)
            same(f"14b training loss {s}", loss.detach(), ploss.detach())
        a, b = flat_dict(mparams), flat_dict(plain)
        for k in a:
            same(f"14b parameter {k}", a[k].detach(), b[k].detach())
        res["train"] = {"step_ms": ms, "collectives_per_step": {
            k: v / LAUNCH_TRAIN_STEPS for k, v in step.mesh_context.counts.items()},
            "bytes_per_step": {k: v / LAUNCH_TRAIN_STEPS for k, v in step.mesh_context.bytes.items()},
            "param_entries": sum(x.numel() for x in a.values()), "bit_equal": True}
        del opt, popt, lm, plain, a, b, batches
        free_device(dev)

        # Prefill and decode from the initial parameters.
        tokens = torch.from_numpy(stream.batch_at(LAUNCH_TRAIN_STEPS)["tokens"]).to(dev)
        s_max = seq + LAUNCH_DECODE
        prefill, _, (p_place, b_place) = step_and_specs(cfg, ShapeSpec("p", "prefill", seq, B), mesh)
        serve_step, _, _ = step_and_specs(cfg, ShapeSpec("d", "decode", s_max, B), mesh)
        params = shard_tree(full, p_place, mesh)
        lm = LM(cfg, full)
        sync(dev)
        t1 = time.perf_counter()
        logits, caches = prefill(params, shard_tree({"tokens": tokens}, b_place, mesh), s_max=s_max)
        sync(dev)
        mesh_prefill = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        plogits, pcaches = lm.prefill({"tokens": tokens}, s_max=s_max)
        sync(dev)
        plain_prefill = (time.perf_counter() - t1) * 1e3
        finite("14b prefill logits", logits, (B, 1, cfg.vocab_size))
        same("14b prefill logits", logits, plogits)
        tok = logits[:, 0].argmax(dim=-1, keepdim=True).to(torch.int32)
        dl, fed, mms, caches = greedy_run(lambda c, t: serve_step(params, c, t), caches, tok,
                                          LAUNCH_DECODE, dev)
        pdl, pfed, pms, pcaches = greedy_run(lambda c, t: lm.decode_step(c, t), pcaches, tok,
                                             LAUNCH_DECODE, dev)
        for what, x, y in (("decode logits", dl, pdl), ("tokens", fed, pfed),
                           *((f"cache {i}", c1, c2) for i, (c1, c2) in enumerate(zip(caches, pcaches)))):
            same(f"14b {what}", x, y)
        res["serve"] = {"prefill_ms": {"mesh": mesh_prefill, "plain": plain_prefill},
                        "decode_ms": {"mesh": mms, "plain": pms},
                        "prefill_collectives": dict(prefill.mesh_context.counts),
                        "collectives_per_step": {k: v / LAUNCH_DECODE
                                                 for k, v in serve_step.mesh_context.counts.items()},
                        "bit_equal": True}
        del full, params, lm, caches, pcaches, logits, plogits, dl, pdl
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
    free_device(dev)
    res["kernel_launches"] = read_launches()
    if any(res["kernel_launches"].values()):
        raise AssertionError(f"14b launched port kernels: {res['kernel_launches']}")
    res["s"] = time.perf_counter() - t0
    out["pod_mesh"] = res
    tr, sv = res["train"], res["serve"]
    log(f"[launch] 14b {cfg.name} ({LAUNCH_LAYERS} layers) on the {res['mesh']} mesh ({res['backend']}, "
        f"one rank): {LAUNCH_TRAIN_STEPS} training steps of {B} x {seq} tokens, mesh / plain ms "
        + ", ".join(f"{x:.1f} / {y:.1f}" for x, y in zip(tr["step_ms"]["mesh"], tr["step_ms"]["plain"]))
        + f"; prefill {sv['prefill_ms']['mesh']:.1f} / {sv['prefill_ms']['plain']:.1f} ms; "
        f"{LAUNCH_DECODE} decode steps, median after the first "
        f"{float(np.median(sv['decode_ms']['mesh'][1:])):.2f} / "
        f"{float(np.median(sv['decode_ms']['plain'][1:])):.2f} ms; losses, {tr['param_entries']:,} "
        "parameter entries, logits, tokens and caches bit-equal; collectives a training step "
        + ", ".join(f"{k} {v:.0f}" for k, v in sorted(tr["collectives_per_step"].items()))
        + f"; launches 0; {res['s']:.1f} s [{card}]")


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

    ctx = res.pop("ctx")
    t0 = time.perf_counter()
    paths.update(hostio_phase(dev, card, ctx))
    log(f"[hostio] phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    autotune = autotune_phase(dev, card, ctx)
    paths.update(autotune)
    log(f"[autotune] phase: {time.perf_counter() - t0:.1f} s")
    del ctx

    t0 = time.perf_counter()
    vamana = vamana_cell(dev, card)
    paths.update(vamana["paths"])
    log(f"[vamana] phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    mutation = mutation_phase(dev, card, vamana.pop("ctx"))
    paths.update(mutation["paths"])
    log(f"[mutation] phase: {time.perf_counter() - t0:.1f} s")
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

    lm = lm_phase(dev, card)
    long_ctx = lm.pop("ctx")
    log(f"[lm] phase: {lm['phase_s']:.1f} s")

    train = train_phase(dev, card)
    log(f"[train] phase: {train['phase_s']:.1f} s")

    mesh = mesh_phase(dev, card)
    log(f"[mesh] phase: {mesh['phase_s']:.1f} s")

    mesh_serve = mesh_serve_phase(dev, card, long_ctx)
    del long_ctx
    log(f"[mesh-serve] phase: {mesh_serve['phase_s']:.1f} s")

    mesh_moe = mesh_moe_phase(dev, card)
    log(f"[mesh-moe] phase: {mesh_moe['phase_s']:.1f} s")

    mesh_ssm = mesh_ssm_phase(dev, card)
    log(f"[mesh-ssm] phase: {mesh_ssm['phase_s']:.1f} s")

    mesh_encdec = mesh_encdec_phase(dev, card)
    log(f"[mesh-encdec] phase: {mesh_encdec['phase_s']:.1f} s")

    launch = launch_phase(dev, card)
    log(f"[launch] phase: {launch['phase_s']:.1f} s")

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
    at = autotune["autotune-inmem"]
    print(json.dumps({"kernels": rows, "main_path": summary, "nn_contrast": res["nn_contrast"],
                      "vamana_build": vamana["build"], "mutation": mutation["info"],
                      "autotune": {k: at[k] for k in ("winner", "sweep", "sweep_s", "device_kind")},
                      "small_recall_at_10": small, "lm": lm, "train": train, "mesh": mesh,
                      "mesh_serve": mesh_serve, "mesh_moe": mesh_moe, "mesh_ssm": mesh_ssm,
                      "mesh_encdec": mesh_encdec, "launch": launch,
                      "card": card}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
