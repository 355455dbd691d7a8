"""Deterministic synthetic token pipeline: seeded PRNG stream, sharded by
the data axis, double-buffered host prefetch (port of
`repro.data.pipeline`: numpy only, so its batches are the reference's,
byte for byte).

The stream is a mixture of Zipf-distributed tokens with local n-gram
structure so cross-entropy actually decreases during the example runs
(pure-uniform tokens would pin the loss at log V).
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticTokens:
    """Batch iterator of (tokens, labels) with next-token labels."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, shard_index: int = 0, num_shards: int = 1,
                 order: int = 3):
        self.V = vocab_size
        self.B = batch
        self.S = seq_len
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        rng = np.random.default_rng(seed)
        # fixed random n-gram transition structure (shared across shards)
        self.order = order
        self.table = rng.integers(0, vocab_size,
                                  size=(997,)).astype(np.int64)
        ranks = np.arange(1, vocab_size + 1)
        zipf = 1.0 / ranks ** 1.1
        self.zipf = zipf / zipf.sum()
        self._step = 0

    def _gen(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * self.num_shards
            + self.shard_index)
        B, S, V = self.B, self.S, self.V
        noise = rng.choice(V, size=(B, S), p=self.zipf)
        toks = noise.copy()
        # inject learnable structure: with p=0.5 the next token is a
        # deterministic hash of the previous one
        det = (self.table[toks[:, :-1] % 997] + toks[:, :-1]) % V
        coin = rng.random((B, S - 1)) < 0.5
        toks[:, 1:] = np.where(coin, det, toks[:, 1:])
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        labels[:, -1] = -1  # no target for the last position
        return {"tokens": toks.astype(np.int32),
                "labels": labels.astype(np.int32)}

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = self._gen(self._step)
        self._step += 1
        return b

    def state(self) -> dict:
        return {"step": self._step}

    def restore(self, state: dict) -> None:
        self._step = int(state["step"])


class Prefetcher:
    """Double-buffered background prefetch (host thread)."""

    def __init__(self, it, depth: int = 2):
        self.it = it
        self.q = queue.Queue(maxsize=depth)
        self.done = False
        self.t = threading.Thread(target=self._fill, daemon=True)
        self.t.start()

    def _fill(self):
        try:
            for item in self.it:
                if self.done:
                    return
                self.q.put(item)
        finally:
            self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def stop(self):
        self.done = True
