"""The port's live index on the CPU: ``GenerationalQAC`` at
``device="cpu"`` held to the JAX package's gates (``tests/test_freshness.py``)
with the port's own time-indexed oracle: every answer equals a from-scratch
build of its own visible version (generation, seq) across mid-trace swaps;
a trace with no swap stays at generation 0; ``replay`` reproduces its
answers; ``complete_batch`` answers at the current version; the cluster's
``propagate_swap`` with timed parity; ``witness_answers`` against the
oracle; the dispatch log across generations; generation 0 handed an
index already built. No JAX here:
``FreshnessConfig`` and ``QACArch.freshness_config()`` are held to JAX's
in ``test_torch_freshness_jax.py``.

The runtime's clock reads 2**-9 s more each time: which version an answer
sees follows the runtime's service times, so a fixed clock makes every
run of a trace the same whatever the machine's load."""
import numpy as np
import pytest

import repro_torch.serve.runtime as runtime_mod
from _torch_clock import fix_clocks

from repro_torch.core import build_qac_index
from repro_torch.serve import QACFrontend
from repro_torch.serve.cluster import (ClusterConfig, QACServingCluster,
                                       check_cluster_parity_timed)
from repro_torch.serve.freshness import (FreshnessConfig, GenerationalQAC,
                                         parse_and_prepare, witness_answers)
from repro_torch.serve.runtime import RuntimeConfig
from repro_torch.text import (KeystrokeTraceConfig, MutationTraceConfig,
                              SynthLogConfig, generate_keystroke_trace,
                              generate_mutation_trace, generate_query_log)

_RT = dict(max_batch=8, slack_us=2_000.0)


@pytest.fixture(autouse=True)
def fixed_clock(monkeypatch):
    fix_clocks(monkeypatch, runtime_mod)


@pytest.fixture(scope="module")
def corpus():
    return generate_query_log(SynthLogConfig(n_queries=300, vocab_size=80,
                                             mean_term_chars=4.0, seed=17))


def _trace(corpus, seed, n_mut=10, sessions=8):
    qs, sc = corpus
    return generate_mutation_trace(qs, sc, MutationTraceConfig(
        keystrokes=KeystrokeTraceConfig(
            n_sessions=sessions, queries_per_session=1,
            mean_keystroke_ms=2.0, seed=seed),
        n_mutations=n_mut, follower_sessions=6, seed=seed))


def _gq(corpus, swap_threshold, **kw):
    qs, sc = corpus
    return GenerationalQAC(qs, sc, rt_cfg=RuntimeConfig(**_RT), device="cpu",
                           cfg=FreshnessConfig(k=10, delta_capacity=256,
                                               swap_threshold=swap_threshold),
                           **kw)


def _gates(gq, results, *, sample_every=1):
    s = gq.snapshot()
    assert s["n_swaps"] >= 1, "trace must cross at least one swap"
    assert s["delta_hit_answers"] > 0, "no answer was served from the delta"
    inv = s["runtime"]["invalidations"]
    assert len(inv) == s["n_swaps"]
    assert all(v["count"] == 1 for v in inv.values())
    per_gen = s["runtime"]["per_generation"]
    assert 0 in per_gen and s["generation"] in per_gen
    assert gq.check_parity(results, sample_every=sample_every) > 0
    for log in gq.swap_log:
        parts = ("drain_us", "absorb_us", "view_us", "install_us")
        assert log["swap_stall_us"] == pytest.approx(sum(log[p] for p in parts))
        assert log["rebuild_wall_us"] == pytest.approx(
            log["build_us"] + log["frontend_us"] + log["warm_us"])
        assert 0 < log["pack_us"] < log["build_us"]


def test_parity_across_swap(corpus):
    """Every answer == from-scratch build of its own visible version,
    across >= 1 mid-trace swap."""
    gq = _gq(corpus, 3)
    results = gq.run_mutation_trace(_trace(corpus, seed=1))
    assert all(r.gen >= 1 for r in results[-5:])
    _gates(gq, results)


@pytest.mark.parametrize("seed", [2, 5, 9])
def test_parity_fixed_seeds(corpus, seed):
    gq = _gq(corpus, 2)
    results = gq.run_mutation_trace(_trace(corpus, seed=seed, n_mut=6))
    _gates(gq, results, sample_every=3)


def test_no_swap_trace_stays_generation_zero(corpus):
    gq = _gq(corpus, 256)
    results = gq.run_mutation_trace(_trace(corpus, seed=3, n_mut=5))
    s = gq.snapshot()
    assert s["n_swaps"] == 0 and s["generation"] == 0
    assert s["runtime"]["invalidations"] == {}
    assert all(r.gen == 0 for r in results)
    assert gq.check_parity(results, sample_every=2) > 0


def test_replay_resets_and_reproduces(corpus):
    gq = _gq(corpus, 3)
    events = _trace(corpus, seed=4, n_mut=6)
    a = gq.replay(events)                 # warm pass + reset + measured
    view0 = gq.history[0].view
    gq.reset()                            # else b would re-mutate a's state
    assert gq.history[0].view is view0 and gq.history[0].delta.n == 0
    b = gq.replay(events, warm=False)
    assert [r.strings for r in a] == [r.strings for r in b]
    assert [(r.gen, r.seq) for r in a] == [(r.gen, r.seq) for r in b]


def test_built_generation_zero_answers_as_a_fresh_build(corpus, monkeypatch):
    """Handed the ``(qidx, kept, scores)`` that ``build_qac_index`` gave for
    its log, the live index serves that build as generation 0 and answers
    a trace across a swap exactly as one that builds it: every
    ``FreshResult`` field equal, each run on a clock counted from 0."""
    qs, sc = corpus
    events = _trace(corpus, seed=1)
    built = build_qac_index(qs, sc, k_default=10, device="cpu")
    runs = []
    for kw in ({}, {"built": built}):
        fix_clocks(monkeypatch, runtime_mod)
        gq = _gq(corpus, 3, **kw)
        runs.append(gq.run_mutation_trace(events))
        assert gq.snapshot()["n_swaps"] >= 1
    assert gq.history[0].qidx is built[0]
    assert runs[0] == runs[1]
    with pytest.raises(ValueError):
        GenerationalQAC(None, None, device="meta", built=built)


def test_complete_batch_answers_at_the_current_version(corpus):
    qs, _ = corpus
    gq = _gq(corpus, 3)
    gq.run_mutation_trace(_trace(corpus, seed=6, n_mut=8))
    g = gq._cur()
    rng = np.random.default_rng(2)
    raw = [q[: int(rng.integers(1, len(q) + 1))] for q in
           [qs[int(i)] for i in rng.integers(0, len(qs), 24)]]
    raw += [e.query[:4] for e in g.delta.entries[:4]] + ["zzqq"]
    got = gq.complete_batch(raw)
    assert got == [gq.oracle_answer(q, g.gen, g.delta.seq, 10) for q in raw]
    assert any(s is not None for row in got for s in row)


def test_witness_equals_the_oracle(corpus):
    gq = _gq(corpus, 3)
    results = gq.run_mutation_trace(_trace(corpus, seed=8, n_mut=10))
    want = [gq.oracle_answer(r.query, r.gen, r.seq, r.k) for r in results]
    assert witness_answers(gq, results) == want
    assert sum(r.n_delta > 0 for r in results) > 0


def test_dispatch_log_spans_generations(corpus):
    gq = _gq(corpus, 3)
    gq.begin_dispatch_log()
    gq.run_mutation_trace(_trace(corpus, seed=1))
    log = gq.end_dispatch_log()
    fes = {id(g.frontend): g.frontend for g in gq.history.values()}
    assert len(fes) == len(gq.history) >= 2
    engines = [key[0] for key, _ in log]
    assert engines.count("multi") + engines.count("single") > 0
    assert all(route == "torch_ref" for _, route in log)
    assert all(fe._dispatch_log is None for fe in fes.values())


def test_truncated_scan_branch_is_exact(corpus):
    """A frontend whose multi-term cap is 1 candidate sends every
    multi-term request with a longer shortest list down the exact-scan
    branch; the answers still equal the oracle, and the branch is counted."""
    gq = _gq(corpus, 3, frontend_kwargs=dict(tile=1, max_tiles=1))
    results = gq.run_mutation_trace(_trace(corpus, seed=2, n_mut=8))
    assert gq.snapshot()["truncated_scans"] > 0
    assert gq.check_parity(results) == len(results)


def test_cluster_propagate_swap_and_timed_parity(corpus):
    qs, sc = corpus
    qidx0, kept0, _ = build_qac_index(qs, sc, device="cpu")
    fe0 = QACFrontend(qidx0, k=10, specialize_list_pad=False)
    qidx1, _, _ = build_qac_index(list(qs) + ["newly trending completion",
                                              "another fresh one"],
                                  list(sc) + [99.0, 98.0], device="cpu")
    fe1 = QACFrontend(qidx1, k=10, specialize_list_pad=False)
    trace = generate_keystroke_trace(kept0, KeystrokeTraceConfig(
        n_sessions=8, mean_keystroke_ms=2.0, seed=23))
    cut = len(trace) // 2
    t_mid = (trace[cut - 1][0] + trace[cut][0]) / 2
    reqs0 = parse_and_prepare(qidx0, trace[:cut], k=10)
    reqs1 = parse_and_prepare(qidx1, trace[cut:], k=10)
    for i, r in enumerate(reqs1):
        r.idx = len(reqs0) + i
    relaxed = dict(degrade_pressure_us=1e12, shed_bulk_pressure_us=1e12,
                   shed_pressure_us=1e12)
    cl = QACServingCluster(qidx0, ClusterConfig(n_replicas=2, **relaxed),
                           RuntimeConfig(**_RT), frontends=[fe0, fe0])
    with pytest.raises(ValueError):
        cl.propagate_swap(1, [fe1])
    for r in reqs0:
        cl.submit(r)
    cl.propagate_swap(1, [fe1, fe1], t_us=t_mid)
    for r in reqs1:
        cl.submit(r)
    cl.drain()
    results = [cl._results[r.idx] for r in reqs0 + reqs1]
    assert all(r.status == "ok" for r in results)
    assert {r.gen for r in results[:cut]} == {0}
    assert {r.gen for r in results[cut:]} == {1}
    assert check_cluster_parity_timed({0: fe0, 1: fe1}, reqs0 + reqs1,
                                      results) == len(results)
    with pytest.raises(AssertionError):
        check_cluster_parity_timed({0: fe0}, reqs0 + reqs1, results)
    for rep in cl.replicas:
        inv = rep.runtime.telemetry.snapshot()["invalidations"]
        assert list(inv) == ["0->1"] and inv["0->1"]["count"] == 1
