"""The port's mutation trace against the JAX package's: event for event
(``t_us``, ``kind``, ``session``, ``query``, ``score``) across rate-based
and exact counts, no mutations, OOV inserts, trends, followers and a pool
with duplicates and NaN scores; the same validation errors; the
invariants of ``tests/test_mutation_trace.py`` on the port's trace; and
``make_eval_queries``. Inputs come from seeds with numpy."""
import dataclasses

import numpy as np
import pytest
from _hyp import given, settings, st

from repro import text as jtext
from repro_torch import text as ttext


def _pool(seed=3, n=120, vocab=40):
    return jtext.generate_query_log(jtext.SynthLogConfig(
        n_queries=n, vocab_size=vocab, mean_term_chars=4.0, seed=seed))


def _cfgs(seed=0, n_sessions=6, **kw):
    """The same config in both packages."""
    ks = dict(n_sessions=n_sessions, queries_per_session=1,
              mean_keystroke_ms=2.0, seed=seed)
    return tuple(mod.MutationTraceConfig(keystrokes=mod.KeystrokeTraceConfig(**ks),
                                         seed=seed, **kw)
                 for mod in (jtext, ttext))


def _same(qs, sc, cfgs):
    want = jtext.generate_mutation_trace(qs, sc, cfgs[0])
    got = ttext.generate_mutation_trace(qs, sc, cfgs[1])
    # repr: exact for floats, and a NaN score (the median of a pool with
    # NaN scores) equals itself
    assert [repr(dataclasses.astuple(e)) for e in got] == \
        [repr(dataclasses.astuple(e)) for e in want]
    return got


CASES = {
    "rate": dict(mutation_rate=0.05),
    "exact": dict(n_mutations=17),
    "none": dict(n_mutations=0),
    "oov": dict(n_mutations=20, p_oov_term=1.0, trend_fraction=0.0),
    "trends": dict(n_mutations=15, trend_fraction=1.0, tail_fraction=0.2),
    "inserts": dict(n_mutations=15, trend_fraction=0.0),
    "followers": dict(n_mutations=9, follower_sessions=12),
    "no_followers": dict(n_mutations=9, follower_sessions=0),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 5])
def test_trace_equals_jax_event_for_event(case, seed):
    qs, sc = _pool(seed=seed)
    events = _same(qs, sc, _cfgs(seed=seed, **CASES[case]))
    kinds = {e.kind for e in events}
    if case == "trends":
        assert "trend" in kinds and "insert" not in kinds
    if case in ("oov", "inserts"):
        assert "insert" in kinds and "trend" not in kinds


def test_trace_equals_jax_on_duplicates_and_nan_scores():
    # a pool with repeated strings (the max score wins, NaN ignored; a
    # string whose every score is NaN ranks at -inf) and a tiny vocabulary,
    # so inserts collide with the pool and retry
    rng = np.random.default_rng(11)
    qs, sc = _pool(seed=2, n=80, vocab=6)
    qs = qs + qs[:30] + ["solo"]
    sc = np.concatenate([sc, rng.integers(1, 9, 30).astype(np.float64), [np.nan]])
    sc[rng.integers(0, len(sc), 12)] = np.nan
    for seed in (1, 4):
        _same(qs, sc, _cfgs(seed=seed, n_mutations=30, tail_fraction=1.0))


def test_validation_errors_equal_jax():
    bad = [dict(trend_boost=1.0), dict(mutation_rate=-0.1),
           dict(tail_fraction=1.5), dict(trend_fraction=-0.1),
           dict(p_oov_term=2.0), dict(n_mutations=-1),
           dict(follower_sessions=-2)]
    for kw in bad:
        msgs = []
        for mod in (jtext, ttext):
            with pytest.raises(ValueError) as e:
                mod.MutationTraceConfig(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    msgs = []
    for mod in (jtext, ttext):
        with pytest.raises(ValueError) as e:
            mod.generate_mutation_trace(["a"], [1.0, 2.0])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _invariants(seed, n_mut=8, followers=6):
    """tests/test_mutation_trace.py's invariants, on the port's trace."""
    qs, sc = _pool(seed=seed % 4)
    cfg = _cfgs(seed=seed, n_mutations=n_mut, follower_sessions=followers)[1]
    events = ttext.generate_mutation_trace(qs, sc, cfg)
    ts = [e.t_us for e in events]
    assert ts == sorted(ts)
    assert sum(e.kind != "request" for e in events) == n_mut
    by_session, best, mut_t = {}, {}, {}
    for q, s in zip(qs, sc):
        best[q] = max(best.get(q, -np.inf), float(s))
    for e in events:
        if e.kind == "request":
            assert e.session >= 0
            by_session.setdefault(e.session, []).append(e)
            continue
        assert e.session == -1 and e.score > 0
        mut_t.setdefault(e.query, e.t_us)
        if e.kind == "trend":
            assert e.score > best[e.query]
        else:
            assert e.query not in best
        best[e.query] = e.score
    for s, evs in by_session.items():
        final = max((e.query for e in evs), key=len)
        assert all(final.startswith(e.query) for e in evs)
        if s >= cfg.keystrokes.n_sessions:
            assert min(e.t_us for e in evs) > mut_t[final]
    assert any(s >= cfg.keystrokes.n_sessions for s in by_session)


@given(seed=st.integers(0, 63), n_mut=st.integers(1, 12))
@settings(max_examples=10, deadline=None)
def test_invariants_hold_on_the_port(seed, n_mut):
    _invariants(seed, n_mut)


@pytest.mark.parametrize("seed", [0, 7, 23])
def test_invariants_fixed_seeds(seed):
    _invariants(seed)


@pytest.mark.parametrize("retain_pct", [0, 50, 100])
def test_make_eval_queries_equals_jax(retain_pct):
    qs, _ = _pool(seed=1, n=400)
    kept = sorted(set(" ".join(q.split()) for q in qs))
    want = jtext.make_eval_queries(kept, np.random.default_rng(3), 20, retain_pct)
    got = ttext.make_eval_queries(kept, np.random.default_rng(3), 20, retain_pct)
    assert got == want and len(got) > 2
