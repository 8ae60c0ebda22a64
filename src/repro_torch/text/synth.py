"""Synthetic scored query logs with AOL/MSN/EBAY-like statistics, and
keystroke traces over them.

Verbatim copies of the JAX package's ``text/synth.py`` log generator
(``SynthLogConfig``, ``generate_query_log``) and online traffic generator
(``KeystrokeTraceConfig``, ``generate_keystroke_trace``), so that one seed
gives the same log and the same trace in both packages. Zipf-distributed
term reuse, ~3 terms/query, configurable unique-term count and term
length; scores are Zipf frequencies.
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


@dataclasses.dataclass
class KeystrokeTraceConfig:
    """Synthetic online QAC traffic: concurrent sessions typing queries
    keystroke by keystroke (the AmazonQAC-documented shape of real traffic —
    each request extends the previous prefix by one character, with
    occasional backspace runs)."""

    n_sessions: int = 64
    queries_per_session: int = 1
    mean_keystroke_ms: float = 150.0    # exponential inter-keystroke gap
    session_spread_ms: float = 2000.0   # session start times ~ U[0, spread)
    p_backspace: float = 0.06           # per-keystroke chance of a delete run
    max_backspace: int = 3
    popularity_zipf_s: float = 1.05     # target-query popularity skew
    seed: int = 0
    # open-loop offered load: when set, the whole trace's time
    # axis is rescaled so the emitted request rate equals ``target_qps``
    # regardless of how the generated trace was served — arrivals never
    # wait for completions, the definition of an open-loop saturation
    # sweep. Scaling time (rather than resampling sessions) keeps the
    # REQUEST SET identical across offered loads, so a QPS sweep compares
    # the same work at different arrival pressure; crank ``n_sessions``
    # too when the workload should also be *wider* (more concurrent
    # session caches), not just faster. Seeded-deterministic: the rescale
    # is a pure function of the base trace.
    target_qps: float | None = None


def generate_keystroke_trace(queries: list[str],
                             cfg: KeystrokeTraceConfig = KeystrokeTraceConfig()):
    """-> list[(t_us float, session_id int, partial_query str)], time-sorted.

    Each session draws Zipf-popular target queries from ``queries`` and
    emits every prefix on its way to typing them (including prefixes ending
    in a space — a complete term + empty suffix is a valid QAC request).
    Backspace runs re-emit the shorter prefixes, the backtracking pattern a
    prefix cache must survive. Inter-arrival gaps are exponential (Poisson
    keystrokes per session); session starts are staggered so ~all sessions
    overlap — the concurrent-session count IS ``n_sessions``.
    """
    rng = np.random.default_rng(cfg.seed)
    pool = list(queries)
    perm = rng.permutation(len(pool))
    # bounded Zipf over popularity ranks (NOT rng.zipf, whose unbounded tail
    # would clamp a majority of draws onto the single last rank)
    probs = 1.0 / np.arange(1, len(pool) + 1) ** cfg.popularity_zipf_s
    probs /= probs.sum()
    # ``rng.choice(len(pool), p=probs)``'s own draw (one ``random()`` into
    # the normalised cumulative sum), with the O(len(pool)) sum made once
    # instead of once a draw: the same targets from the same stream
    cdf = probs.cumsum()
    if cdf.size:
        cdf /= cdf[-1]
    events = []
    for s in range(cfg.n_sessions):
        t = rng.uniform(0.0, cfg.session_spread_ms) * 1e3
        for _ in range(cfg.queries_per_session):
            if not pool:
                raise ValueError("queries must not be empty")
            target = pool[perm[int(cdf.searchsorted(rng.random(), side="right"))]]
            n = 1
            while n <= len(target):
                t += rng.exponential(cfg.mean_keystroke_ms) * 1e3
                events.append((t, s, target[:n]))
                if (1 < n < len(target) and rng.random() < cfg.p_backspace):
                    for _ in range(int(rng.integers(1, cfg.max_backspace + 1))):
                        if n <= 1:
                            break
                        n -= 1
                        t += rng.exponential(cfg.mean_keystroke_ms / 2) * 1e3
                        events.append((t, s, target[:n]))
                n += 1
            t += rng.exponential(5 * cfg.mean_keystroke_ms) * 1e3  # dwell
    events.sort(key=lambda e: (e[0], e[1]))
    if cfg.target_qps is not None and len(events) > 1:
        if cfg.target_qps <= 0:
            raise ValueError(f"target_qps must be positive, "
                             f"got {cfg.target_qps}")
        t0, t1 = events[0][0], events[-1][0]
        if t1 > t0:
            # offered QPS of the base trace over its span; scale every
            # timestamp (session starts, keystroke gaps, backspace runs,
            # dwells alike) so the span carries target_qps requests/sec
            base_qps = (len(events) - 1) / (t1 - t0) * 1e6
            scale = base_qps / cfg.target_qps
            events = [((t - t0) * scale, s, q) for t, s, q in events]
    return events
