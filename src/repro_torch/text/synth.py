"""Synthetic scored query logs with AOL/MSN/EBAY-like statistics, keystroke
traces over them, and live-index mutation traces.

Copies of the JAX package's ``text/synth.py``: the log generator
(``SynthLogConfig``, ``generate_query_log``), the online traffic generator
(``KeystrokeTraceConfig``, ``generate_keystroke_trace``), the mutation
trace (``MutationEvent``, ``MutationTraceConfig``,
``generate_mutation_trace``) and ``make_eval_queries``, so that one seed
gives the same log, the same trace and the same events in both packages.
Where the JAX code loops in Python over the whole pool, the port computes
the same lists with numpy from the same numpy draws in the same order.
Zipf-distributed term reuse, ~3 terms/query, configurable unique-term
count and term length; scores are Zipf frequencies.
"""
from __future__ import annotations

import bisect
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


@dataclasses.dataclass
class MutationEvent:
    """One event of a live-index trace. ``kind`` is ``"request"`` (a
    keystroke; ``session`` >= 0, ``score`` unused), ``"insert"`` (a newly
    observed completion enters the corpus) or ``"trend"`` (an existing
    tail completion's score spikes past its old value). Mutations carry
    ``session == -1``: they come from the ingestion pipeline, not a
    typist."""

    t_us: float
    kind: str
    session: int
    query: str
    score: float = 0.0


@dataclasses.dataclass
class MutationTraceConfig:
    """Keystroke traffic interleaved with live corpus mutations.

    The request stream is exactly ``generate_keystroke_trace(queries,
    keystrokes)``; on top, ``max(1, round(mutation_rate * n_requests))``
    mutation events (or exactly ``n_mutations`` when set) land at uniform
    times over the trace span. A ``trend_fraction`` of them are score
    spikes on the bottom ``tail_fraction`` of the score-ranked pool (old
    score x ``trend_boost``, a strict raise: popularity drift); the rest
    are inserts of NEW completions recombining pool tokens (in-vocabulary,
    so they become visible immediately; ``p_oov_term`` of them instead
    mint an unseen term, exercising the deferred-to-rebuild path).
    ``follower_sessions`` extra sessions then type prefixes of mutated
    queries AFTER their mutation lands, so a correct delta tier must show
    up in the answers."""

    keystrokes: KeystrokeTraceConfig = dataclasses.field(
        default_factory=KeystrokeTraceConfig)
    mutation_rate: float = 0.02       # mutations per request
    n_mutations: int | None = None    # exact override
    trend_fraction: float = 0.5       # of mutations that are score spikes
    tail_fraction: float = 0.5        # trend targets: bottom half by score
    trend_boost: float = 4.0          # new score = old_max * boost
    p_oov_term: float = 0.1           # inserts minting an unseen term
    follower_sessions: int = 8        # sessions typing mutated queries
    seed: int = 0

    def __post_init__(self):
        if self.mutation_rate < 0:
            raise ValueError(f"mutation_rate must be >= 0, "
                             f"got {self.mutation_rate}")
        if self.n_mutations is not None and self.n_mutations < 0:
            raise ValueError(f"n_mutations must be >= 0, "
                             f"got {self.n_mutations}")
        for name in ("trend_fraction", "tail_fraction", "p_oov_term"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.trend_boost <= 1.0:
            raise ValueError(f"trend_boost must be > 1 (a strict raise), "
                             f"got {self.trend_boost}")
        if self.follower_sessions < 0:
            raise ValueError(f"follower_sessions must be >= 0, "
                             f"got {self.follower_sessions}")


class _PoolScores:
    """The running max score per distinct pool string, as the JAX
    generator's ``best`` dict holds it, without a dict over the pool: the
    distinct strings sorted (code-point order, Python's), their max
    scores in an array (NaN ignored, -inf when all NaN: Python's ``max``
    from -inf), and the strings the trace adds in a small dict."""

    def __init__(self, queries: list[str], scores: np.ndarray):
        # a stable sort by string; linear when the pool is already sorted
        # (the builder's ``kept`` is)
        order = np.asarray(sorted(range(len(queries)), key=queries.__getitem__),
                           dtype=np.int64)
        by_string = np.asarray(queries, dtype=object)[order]
        first = np.ones(len(order), dtype=bool)
        first[1:] = by_string[1:] != by_string[:-1]
        self.strings = by_string[first]              # object array, sorted
        group = np.cumsum(first) - 1
        self.best = np.full(len(self.strings), -np.inf)
        np.maximum.at(self.best, group,
                      np.where(np.isnan(scores), -np.inf, scores)[order])
        self.added: dict[str, float] = {}

    def _pos(self, q: str) -> int:
        i = bisect.bisect_left(self.strings, q)
        return i if i < len(self.strings) and self.strings[i] == q else -1

    def __contains__(self, q: str) -> bool:
        return q in self.added or self._pos(q) >= 0

    def __getitem__(self, q: str) -> float:
        if q in self.added:
            return self.added[q]
        return float(self.best[self._pos(q)])

    def __setitem__(self, q: str, score: float):
        i = self._pos(q)
        if i >= 0:
            self.best[i] = score
        else:
            self.added[q] = score

    def ascending(self, n: int) -> list[str]:
        """The first ``n`` distinct strings by (score, string), ascending:
        the JAX generator's ``sorted(best, key=lambda q: (best[q], q))[:n]``."""
        rank = np.arange(len(self.strings))
        return self.strings[np.lexsort((rank, self.best))[:n]].tolist()

    def vocab(self) -> list[str]:
        """The sorted distinct tokens of the pool."""
        return sorted(set("\n".join(self.strings.tolist()).split()))


def generate_mutation_trace(queries: list[str], scores,
                            cfg: MutationTraceConfig = MutationTraceConfig()):
    """-> list[MutationEvent], sorted by (t_us, kind, session).

    Invariants (held in tests/test_torch_mutation_trace.py): timestamps
    are non-decreasing; the request sub-stream is exactly the seeded
    keystroke trace plus follower sessions whose partials are all
    prefixes of their target; the mutation count is exactly
    ``n_mutations`` if set, else ``max(1, round(mutation_rate * n_base))``
    where n_base counts the base keystroke requests; every trend event
    strictly raises its target's max pool score; follower requests only
    occur after their target's mutation time. Event for event the JAX
    package's trace: the same draws in the same order.
    """
    rng = np.random.default_rng(cfg.seed ^ 0x5EED)
    scores = np.asarray(scores, dtype=np.float64)
    if len(queries) != len(scores):
        raise ValueError(f"{len(queries)} queries vs {len(scores)} scores")
    queries = list(queries)
    base = generate_keystroke_trace(queries, cfg.keystrokes)
    n_base = len(base)
    n_mut = (cfg.n_mutations if cfg.n_mutations is not None
             else max(1, round(cfg.mutation_rate * n_base)))
    t0 = base[0][0] if base else 0.0
    t1 = base[-1][0] if base else 1e6
    events = [MutationEvent(t_us=t, kind="request", session=s, query=q)
              for t, s, q in base]
    # max score per query string: trends must strictly beat the pool max,
    # or the delta would (correctly) treat the "spike" as a noop
    best = _PoolScores(queries, scores)
    n_best = len(best.strings)
    tail = best.ascending(max(1, int(n_best * cfg.tail_fraction))) if n_best else []
    vocab = best.vocab()
    insert_score = float(np.median(scores)) + 1.0 if scores.size else 1.0
    mut_times = np.sort(rng.uniform(t0, t1, size=n_mut))
    mutated: list[tuple[float, str]] = []
    for tm in mut_times:
        if rng.random() < cfg.trend_fraction and tail:
            target = tail[int(rng.integers(0, len(tail)))]
            events.append(MutationEvent(
                t_us=float(tm), kind="trend", session=-1, query=target,
                score=best[target] * cfg.trend_boost))
            best[target] = best[target] * cfg.trend_boost
            mutated.append((float(tm), target))
        else:
            # recombine pool tokens into a query unseen in the pool
            for _ in range(64):
                nt = int(rng.integers(1, 4))
                toks = [vocab[int(i)] for i in
                        rng.integers(0, len(vocab), size=nt)]
                if rng.random() < cfg.p_oov_term:
                    # mint an unseen term: deferred-to-rebuild path
                    toks[-1] = "zz" + toks[-1] + "q"
                q = " ".join(toks)
                if q not in best:
                    break
            events.append(MutationEvent(
                t_us=float(tm), kind="insert", session=-1, query=q,
                score=insert_score))
            best[q] = events[-1].score
            mutated.append((float(tm), q))
    # follower sessions: type prefixes of mutated queries AFTER the
    # mutation lands, the traffic that makes delta-tier hits observable
    n_follow = min(cfg.follower_sessions, len(mutated))
    base_sessions = cfg.keystrokes.n_sessions
    gap_us = cfg.keystrokes.mean_keystroke_ms * 1e3
    for i in range(n_follow):
        tm, q = mutated[int(rng.integers(0, len(mutated)))]
        t = tm + rng.exponential(gap_us)
        for n in range(1, len(q) + 1):
            t += rng.exponential(gap_us)
            events.append(MutationEvent(
                t_us=float(t), kind="request",
                session=base_sessions + i, query=q[:n]))
    events.sort(key=lambda e: (e.t_us, e.kind, e.session))
    return events


def make_eval_queries(kept: list[str], rng: np.random.Generator,
                      n_per_bucket: int, retain_pct: int):
    """Paper §4 methodology: sample completions per term-count bucket, keep
    ``retain_pct``% of the final token's characters (0% keeps 1 char).

    Returns dict: n_terms -> list of partial query strings.
    """
    by_terms: dict[int, list[str]] = {}
    for q in kept:
        by_terms.setdefault(len(q.split()), []).append(q)
    out = {}
    for d, qs in sorted(by_terms.items()):
        take = min(n_per_bucket, len(qs))
        sel = rng.choice(len(qs), size=take, replace=False)
        bucket = []
        for i in sel:
            toks = qs[i].split()
            last = toks[-1]
            keep = max(1, int(len(last) * retain_pct / 100))
            bucket.append(" ".join(toks[:-1] + [last[:keep]]))
        out[d] = bucket
    return out
