"""The port's online runtime (``serve/runtime.py``) and keystroke traces
against the JAX package, over a small index that both packages build from
one ``generate_query_log``.

Rows are held bit-identical to JAX's uncached ``QACFrontend.complete`` at
each request's k (computed in batches, ``_torch_pairs.complete_rows``), the
traces event for event, ``prepare_requests`` field for field, and the path
counts under the synchronous schedule (``max_batch=1, slack_us=0``: every
miss dispatches inside ``submit``, so the counts do not depend on timing)
to JAX's own runtime. The truncated-scan guard and the scheduler are held
to the port's own uncached frontend, which ``test_torch_frontend.py``
holds to JAX's.
"""
import numpy as np
import pytest

from repro.core import build_qac_index as jax_build
from repro.serve import QACFrontend as JaxFrontend
from repro.serve.runtime import (QACOnlineRuntime as JaxRuntime,
                                 RuntimeConfig as JaxRuntimeConfig,
                                 RuntimeTelemetry as JaxTelemetry,
                                 prepare_requests as jax_prepare)
from repro.text import (KeystrokeTraceConfig as JaxTraceConfig,
                        generate_keystroke_trace as jax_trace)
from repro_torch.core import build_qac_index
from repro_torch.core.types import INF_DOCID
from repro_torch.serve import QACFrontend
from repro_torch.serve.runtime import (QACOnlineRuntime, RuntimeConfig,
                                       RuntimeTelemetry, prepare_requests,
                                       run_naive_trace)
from repro_torch.text import (KeystrokeTraceConfig, SynthLogConfig,
                              generate_keystroke_trace, generate_query_log)

from _torch_pairs import RowOracle, as_jax_requests

SYNC = dict(max_batch=1, slack_us=0.0)
TRACE = dict(n_sessions=12, mean_keystroke_ms=5.0, session_spread_ms=20.0, seed=3)


@pytest.fixture(scope="module")
def built():
    qs, sc = generate_query_log(SynthLogConfig(n_queries=600, vocab_size=150,
                                               mean_term_chars=4.0, seed=5))
    jq, jkept, _ = jax_build(qs, sc)
    tq, kept, _ = build_qac_index(qs, sc, device="cpu")
    assert kept == jkept
    fe = QACFrontend(tq, k=10, specialize_list_pad=False)
    jfe = JaxFrontend(jq, k=10, use_kernel=False, specialize_list_pad=False)
    return dict(jq=jq, tq=tq, kept=kept, fe=fe, jfe=jfe, oracle=RowOracle(jfe, batch=8),
                own=RowOracle(fe, pad=False))


def _keystrokes(queries, session0=0, t0=0.0, gap=1000.0):
    """Every prefix of every query, one session per query, a fixed gap."""
    events, t = [], t0
    for s, q in enumerate(queries):
        for n in range(1, len(q) + 1):
            t += gap
            events.append((t, session0 + s, q[:n]))
    return sorted(events)


def _assert_rows(got, want, reqs):
    assert len(got) == len(want) == len(reqs)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.int32 and g.shape == (reqs[i].k,)
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}: {reqs[i].query!r}")


@pytest.mark.parametrize("cfg", [dict(), dict(target_qps=400.0),
                                 dict(n_sessions=40, queries_per_session=2, seed=7),
                                 dict(n_sessions=9, p_backspace=0.5, seed=2,
                                      target_qps=3_000.0)])
def test_keystroke_trace_equals_jax(built, cfg):
    kept = built["kept"]
    got = generate_keystroke_trace(kept, KeystrokeTraceConfig(**cfg))
    want = jax_trace(kept, JaxTraceConfig(**cfg))
    assert got == want and len(got) > 50
    if cfg.get("target_qps"):
        span_s = (got[-1][0] - got[0][0]) / 1e6
        assert (len(got) - 1) / span_s == pytest.approx(cfg["target_qps"], rel=1e-6)
    with pytest.raises(ValueError):
        generate_keystroke_trace(kept, KeystrokeTraceConfig(n_sessions=2, target_qps=-1.0))


def test_prepare_requests_equals_jax(built):
    trace = generate_keystroke_trace(built["kept"], KeystrokeTraceConfig(**TRACE))
    trace += [(1e9, 99, "zzzzzzqx"), (1e9 + 1, 99, built["kept"][0] + " "),
              (1e9 + 2, 99, ""), (1e9 + 3, 99, "nosuchterm x")]
    ks = np.random.default_rng(0).choice([3, 10, 33], len(trace))
    got = prepare_requests(built["tq"], trace, k=ks)
    want = jax_prepare(built["jq"], trace, k=ks)
    assert len(got) == len(want) == len(trace)
    for g, w in zip(got, want):
        for f in ("idx", "t_us", "session", "query", "k", "plen", "ok", "slen",
                  "lo", "hi", "key", "deadline"):
            assert getattr(g, f) == getattr(w, f), f
        for f in ("pids", "suf"):
            a, b = getattr(g, f), np.asarray(getattr(w, f))
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tiers", [(0, 0), (1 << 10, 0), (0, 1 << 10), (1 << 10, 1 << 10),
                                   (3, 2), "per_request_k"])
def test_run_trace_rows_equal_jax(built, tiers):
    trace = generate_keystroke_trace(built["kept"], KeystrokeTraceConfig(**TRACE))
    if tiers == "per_request_k":
        ks = np.random.default_rng(1).choice([4, 10], len(trace))
        cfg = RuntimeConfig(max_batch=8, slack_us=2_000.0)
    else:
        ks = 10
        cfg = RuntimeConfig(max_batch=8, slack_us=2_000.0, cache_entries=tiers[0],
                            session_entries=tiers[1])
    reqs = prepare_requests(built["tq"], trace, k=ks)
    rt = QACOnlineRuntime(built["fe"], cfg)
    got = rt.run_trace(reqs)
    _assert_rows(got, built["oracle"](reqs), reqs)
    s = rt.telemetry.snapshot()
    assert s["n_requests"] == len(reqs) == sum(s["paths"].values())
    assert max(s["batch_hist"]) <= 8 and s["paths"]["miss"] > 0
    if cfg.cache_entries == 0:
        assert "hit_exact" not in s["paths"]
    if cfg.session_entries == 0:
        assert "hit_session" not in s["paths"]


def test_path_counts_equal_jax_at_max_batch_one(built):
    trace = generate_keystroke_trace(built["kept"], KeystrokeTraceConfig(**TRACE))
    reqs = prepare_requests(built["tq"], trace, k=10)
    rt = QACOnlineRuntime(built["fe"], RuntimeConfig(**SYNC))
    got = rt.run_trace(reqs)
    jrt = JaxRuntime(built["jfe"], JaxRuntimeConfig(**SYNC))
    want = jrt.run_trace(as_jax_requests(reqs))
    _assert_rows(got, [np.asarray(w) for w in want], reqs)
    s, js = rt.telemetry.snapshot(), jrt.telemetry.snapshot()
    assert s["paths"] == js["paths"]
    assert s["paths"]["hit_exact"] > 0 and s["paths"]["hit_session"] > 0
    for key in ("n_requests", "n_batches", "mean_batch_size", "batch_hist", "triggers",
                "queue_peak", "cache_hit_rate", "per_generation"):
        assert s[key] == js[key], key
    assert rt.done_path == jrt.done_path


def test_session_filter_and_backtracking(built):
    """A session typing a long multi-term query end to end at k=64 (the
    filter path serves its deep prefixes, across the space that promotes a
    term), then deleting a one-term query back to its first character (the
    exact LRU serves every re-typed prefix)."""
    kept = built["kept"]
    target = max((q for q in kept if len(q.split()) >= 2), key=len)
    reqs = prepare_requests(built["tq"], _keystrokes([target + " "]), k=64)
    rt = QACOnlineRuntime(built["fe"], RuntimeConfig(**SYNC))
    _assert_rows(rt.run_trace(reqs), built["own"](reqs), reqs)
    assert rt.telemetry.paths["hit_session"] >= 1
    q = max((s for s in kept if len(s.split()) == 1), key=len)
    strokes = [q[:n] for n in range(1, len(q) + 1)] + [q[:n] for n in range(len(q) - 1, 0, -1)]
    reqs = prepare_requests(built["tq"], [(1000.0 * i, 7, s) for i, s in enumerate(strokes)], k=10)
    rt = QACOnlineRuntime(built["fe"], RuntimeConfig(**SYNC))
    _assert_rows(rt.run_trace(reqs), built["oracle"](reqs), reqs)
    assert rt.telemetry.paths["hit_exact"] >= len(q) - 1


def test_truncated_multi_scan_never_poisons_session_cache(built):
    """The multi-term engine stops its driver scan at ``tile * max_tiles``
    candidates (``conjunctive_topk``'s cap), so an INF-padded row is not
    always the whole match set: ``_scan_exact`` must refuse to build a
    session set from a scan that may have been cut, and ``_reusable`` must
    refuse the filter path where the request's own scan would be cut. The
    JAX package's test of the same guard, held to the port's own uncached
    frontend under ``tile=8, max_tiles=1``."""
    tq, kept = built["tq"], built["kept"]
    fe2 = QACFrontend(tq, k=10, tile=8, max_tiles=1, specialize_list_pad=False)
    own = RowOracle(fe2, pad=False)
    rt = QACOnlineRuntime(fe2, RuntimeConfig(**SYNC))
    long_term = int(np.argmax(fe2._list_lens))
    assert int(fe2._list_lens[long_term]) > 8
    fake = prepare_requests(tq, [(0.0, 0, kept[0])], k=10)[0]
    fake.pids = np.asarray([long_term] + [0] * (fake.pids.size - 1), np.int32)
    fake.plen = 1
    assert not rt._scan_exact(fake)                           # long driver: unprovable
    assert rt._scan_exact(prepare_requests(tq, [(0.0, 0, kept[0].split()[0])], k=10)[0])
    firsts = sorted({q.split()[0] for q in kept if len(q.split()) >= 2})
    ids = {w: int(r.pids[0]) for w, r in zip(
        firsts, prepare_requests(tq, [(0.0, 0, w + " ") for w in firsts]))}
    long_toks = [w for w in firsts if fe2._list_lens[ids[w]] > 8]
    assert long_toks, "the corpus lost its long posting lists"
    # k=64: the single-term stage is complete (a session set forms) while
    # 'tok ' matches more docids than the 8 the engine scans; without the
    # guard the filter path would answer where the engine truncates
    reqs = prepare_requests(tq, _keystrokes([t + " " for t in long_toks[:3]]), k=64)
    rt64 = QACOnlineRuntime(fe2, RuntimeConfig(**SYNC))
    _assert_rows(rt64.run_trace(reqs), own(reqs), reqs)
    multis = [q for q in kept if len(q.split()) >= 2][:6]
    reqs = prepare_requests(tq, _keystrokes(multis), k=10)
    _assert_rows(rt.run_trace(reqs), own(reqs), reqs)


def test_trivial_reject_path(built):
    base = built["kept"][0].split()[0]
    reqs = prepare_requests(built["tq"], _keystrokes(
        ["zzzzzzqx", base + " zzzzzzqx", "qzzzzzy zz"], gap=500.0), k=10)
    rt = QACOnlineRuntime(built["fe"], RuntimeConfig(max_batch=4, slack_us=100.0))
    got = rt.run_trace(reqs)
    _assert_rows(got, built["oracle"](reqs), reqs)
    assert rt.telemetry.paths["trivial"] > 0
    assert all((g == INF_DOCID).all() for g, r in zip(got, reqs)
               if "zzz" in r.query.split()[-1])


def test_full_bucket_drain_and_tick(built):
    kept, fe = built["kept"], built["fe"]
    events = [(float(i), i, kept[i % len(kept)]) for i in range(11)]   # 1 us apart
    reqs = prepare_requests(built["tq"], events, k=10)
    rt = QACOnlineRuntime(fe, RuntimeConfig(max_batch=4, slack_us=1e9, cache_entries=0,
                                            session_entries=0))
    _assert_rows(rt.run_trace(reqs), built["oracle"](reqs), reqs)
    s = rt.telemetry.snapshot()
    assert s["paths"] == {"miss": 11} and s["triggers"] == {"full": 2, "drain": 1}
    assert s["batch_hist"] == {3: 1, 4: 2}
    rt = QACOnlineRuntime(fe, RuntimeConfig(max_batch=64, slack_us=1_000.0,
                                            cache_entries=0, session_entries=0))
    rt.submit(prepare_requests(built["tq"], [(0.0, 0, kept[10])], k=10)[0])
    rt.tick(500.0)
    assert len(rt.queue) == 1                 # before the deadline: still queued
    rt.tick(2_000.0)
    assert not rt.queue and rt.telemetry.paths["miss"] == 1


def test_one_request_per_dispatch_matches_naive(built):
    kept, fe = built["kept"], built["fe"]
    reqs = prepare_requests(built["tq"], _keystrokes([kept[3], kept[40]], gap=2_000.0), k=10)
    rt = QACOnlineRuntime(fe, RuntimeConfig(max_batch=1, slack_us=0.0, cache_entries=0,
                                            session_entries=0))
    got = rt.run_trace(reqs)
    naive, stats = run_naive_trace(fe, reqs, warm=False)
    _assert_rows(got, naive, reqs)
    _assert_rows(got, built["oracle"](reqs), reqs)
    assert rt.telemetry.snapshot()["mean_batch_size"] == 1.0
    assert stats["n_requests"] == len(reqs) and set(stats) == {
        "n_requests", "p50_us", "p99_us", "mean_us"}


def test_deadline_violations_and_queue_gauge(built):
    words = sorted({q.split()[0] for q in built["kept"]})[:6]
    reqs = prepare_requests(built["tq"], [(0.0, s, w) for s, w in enumerate(words)], k=10)
    rt = QACOnlineRuntime(built["fe"], RuntimeConfig(**SYNC))
    rt.run_trace(reqs)
    assert rt.telemetry.snapshot()["deadline_violations"] == len(reqs) - 1
    rt2 = QACOnlineRuntime(built["fe"], RuntimeConfig(max_batch=64, slack_us=1e9))
    rt2.run_trace(reqs)
    s = rt2.telemetry.snapshot()
    assert s["max_queue_depth"] == s["queue_peak"] == len(reqs)
    assert s["deadline_violations"] == 0


def test_telemetry_snapshot_equals_jax():
    rng = np.random.default_rng(4)
    paths = rng.choice(["miss", "hit_exact", "trivial"], 50).tolist()
    lats = rng.exponential(300.0, 50).tolist()
    got, want = RuntimeTelemetry(), JaxTelemetry()
    assert got.snapshot() == want.snapshot()                  # empty: explicit None
    for t in (got, want):
        for path, lat in zip(paths, lats):
            t.record(path, lat, gen=int(lat) % 2)
        t.batch_sizes += [1, 4, 4, 8]
        t.triggers.update(["full", "deadline", "full"])
        t.queue_peak, t.deadline_violations, t.engine_wall_us = 9, 2, 123.5
        t.record_invalidation(0, 1, 5, 3)
    assert got.snapshot() == want.snapshot()


def test_install_generation_contract(built):
    """A swap flushes both tiers exactly once (recorded), is idempotent on
    the same generation, moves forward only, refuses while requests are
    queued, and tags what follows with the new generation."""
    tq, kept, fe = built["tq"], built["kept"], built["fe"]
    reqs = prepare_requests(tq, _keystrokes(kept[:3]), k=10)
    rt = QACOnlineRuntime(fe, RuntimeConfig(**SYNC))
    rt.run_trace(reqs)
    n_lru, n_sess = len(rt.cache), len(rt.sessions)
    assert n_lru and n_sess and all(key[0] == 0 for key in rt.cache)
    fe1 = QACFrontend(tq, k=10, specialize_list_pad=False)
    rt.install_generation(1, fe1)
    assert rt.generation == 1 and rt.fe is fe1 and not rt.cache and not rt.sessions
    rt.install_generation(1, fe1)                             # re-delivered: no-op
    assert rt.telemetry.snapshot()["invalidations"] == {
        "0->1": {"count": 1, "lru_entries": n_lru, "session_entries": n_sess}}
    with pytest.raises(ValueError):
        rt.install_generation(0, fe)
    got = rt.run_trace(prepare_requests(tq, [(t + 1e7, s, q) for t, s, q in
                                             _keystrokes(kept[:1])], k=10))
    assert all(key[0] == 1 for key in rt.cache)
    assert all(e.gen == 1 for e in rt.sessions.values())
    assert set(rt.telemetry.snapshot()["per_generation"]) == {0, 1} and got
    held = QACOnlineRuntime(fe, RuntimeConfig(max_batch=64, slack_us=1e9))
    held.submit(reqs[0])
    with pytest.raises(RuntimeError):
        held.install_generation(1, fe1)
    held.drain()
    held.install_generation(1, fe1)
    assert held.generation == 1
