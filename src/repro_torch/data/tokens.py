"""Deterministic synthetic token pipeline.

A copy of the reference package's `data/tokens.py` (numpy only): with the
same seed, step and shard its batches equal the reference's element for
element. The batches are host arrays; the train loop moves them to the
device.

Every batch is a pure function of (seed, step, shard) -- the property that
makes fault-tolerant resume trivial: after restoring a checkpoint at step k,
the stream "skips ahead" by construction, no iterator state to persist, and
elastic restarts with a different shard count re-partition the same global
stream deterministically.

The stream is a Zipf-ish unigram mixture with short-range copy structure so
that a ~100M-param model shows a real learning curve (loss falls well below
the unigram entropy) in a few hundred steps -- enough signal for the e2e
training example without any external corpus.

A host-side prefetch thread overlaps batch synthesis with device compute
(the CPU-side analogue of the paper's §4.3 transfer/compute overlap).
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class TokenStream:
    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        *,
        seed: int = 0,
        shard: int = 0,
        n_shards: int = 1,
        frontend: tuple[int, int] | None = None,  # (len, d_model) stub embeds
    ):
        assert global_batch % n_shards == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch // n_shards
        self.seed = seed
        self.shard = shard
        self.n_shards = n_shards
        self.frontend = frontend
        # Zipf unigram table (shared across steps)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._p = (p / p.sum()).astype(np.float64)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard])
        )
        toks = rng.choice(self.vocab, size=(self.batch, self.seq + 1), p=self._p)
        # short-range copy structure: with prob .5, token t+delta repeats token t
        delta = rng.integers(1, 8, size=(self.batch, self.seq + 1))
        copy = rng.random((self.batch, self.seq + 1)) < 0.5
        idx = np.maximum(np.arange(self.seq + 1)[None, :] - delta, 0)
        src = np.take_along_axis(toks, idx, axis=1)
        toks = np.where(copy, src, toks).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.frontend:
            flen, d = self.frontend
            out["frontend"] = rng.standard_normal((self.batch, flen, d)).astype(np.float32)
        return out

    # ------------------------------------------------------------- prefetch
    def prefetch(self, start_step: int, depth: int = 2):
        """Generator with a background synthesis thread (depth batches ahead)."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                q.put((step, self.batch_at(step)))
                step += 1

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
