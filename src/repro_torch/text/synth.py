"""Synthetic scored query logs with AOL/MSN/EBAY-like statistics.

A verbatim copy of the JAX package's ``text/synth.py`` log generator
(``SynthLogConfig``, ``generate_query_log``), so that one seed gives the
same log in both packages. Zipf-distributed term reuse, ~3 terms/query,
configurable unique-term count and term length; scores are Zipf
frequencies.
"""
from __future__ import annotations

import dataclasses

import numpy as np

_ALPHA = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)


@dataclasses.dataclass
class SynthLogConfig:
    n_queries: int = 20_000
    vocab_size: int = 4_000
    zipf_s: float = 1.07            # term-draw skew (web-like)
    mean_terms: float = 3.0         # paper Table 2: ~3 terms/query
    mean_term_chars: float = 7.0    # EBAY-like short terms
    max_terms: int = 7
    seed: int = 0


def _make_vocab(rng: np.random.Generator, cfg: SynthLogConfig) -> list[str]:
    vocab = set()
    while len(vocab) < cfg.vocab_size:
        n = cfg.vocab_size - len(vocab)
        lens = np.clip(rng.poisson(cfg.mean_term_chars, n), 2, 16)
        for L in lens:
            chars = _ALPHA[rng.integers(0, 26, int(L))]
            vocab.add(bytes(chars).decode())
    return sorted(vocab)


def generate_query_log(cfg: SynthLogConfig = SynthLogConfig()):
    """-> (queries list[str], scores float64[N]); duplicates possible (scores
    are frequency-like, duplicates are merged by the builder with max score)."""
    rng = np.random.default_rng(cfg.seed)
    vocab = _make_vocab(rng, cfg)
    V = len(vocab)
    # Zipf ranks over a shuffled vocab so lexicographic and popularity order differ
    perm = rng.permutation(V)
    probs = 1.0 / np.arange(1, V + 1) ** cfg.zipf_s
    probs /= probs.sum()
    n_terms = np.clip(rng.poisson(cfg.mean_terms - 1, cfg.n_queries) + 1, 1, cfg.max_terms)
    queries = []
    for nt in n_terms:
        idx = perm[rng.choice(V, size=int(nt), p=probs)]
        queries.append(" ".join(vocab[i] for i in idx))
    # frequency-style scores: Zipf over query popularity ranks
    scores = rng.zipf(1.2, size=cfg.n_queries).astype(np.float64)
    return queries, scores
