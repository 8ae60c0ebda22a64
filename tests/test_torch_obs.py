"""The port's ``obs`` against the JAX package's on the same inputs:
``percentiles``, ``fmt``, ``Histogram``, ``MetricsRegistry.snapshot``, the
``Tracer``'s JSONL and Chrome exports and ``request_trees``, ``SLOMonitor``
burn rates and ``ObsConfig``. Then the port's ``JitAuditor`` (freeze,
violations, strict mode, synchronising on a CUDA output only) and the
frontend's ``auditor`` hook: after a runtime's measured-replay warmup and
``freeze()``, a new k bucket is exactly one violation."""
import json

import numpy as np
import pytest

from repro import obs as jobs
from repro.obs import metrics as jmetrics, tracing as jtracing
from repro_torch import obs
from repro_torch.core import build_qac_index
from repro_torch.obs import jit_audit, metrics, tracing
from repro_torch.serve import QACFrontend
from repro_torch.serve.runtime import QACOnlineRuntime, RuntimeConfig, prepare_requests
from repro_torch.text import (KeystrokeTraceConfig, SynthLogConfig,
                              generate_keystroke_trace, generate_query_log)

VALUES = [[], [5.0], [3.0, 1.0, 4.0, 1.0, 5.0, 926.0, 5.0, 3.0, 589.0],
          np.random.default_rng(0).exponential(1e3, 1001).tolist()]


@pytest.mark.parametrize("vals", range(len(VALUES)))
@pytest.mark.parametrize("kw", [dict(), dict(qs=(50, 99.9), mean=True, vmax=True),
                                dict(suffix="_ms", mean=True), dict(qs=(0, 100), suffix="")])
def test_percentiles_equal_jax(vals, kw):
    got = metrics.percentiles(VALUES[vals], **kw)
    assert got == jmetrics.percentiles(VALUES[vals], **kw)
    if VALUES[vals]:
        for q in kw.get("qs", metrics.DEFAULT_QS):
            assert got[f"p{q}{kw.get('suffix', '_us')}"] == float(np.percentile(VALUES[vals], q))
    assert metrics.DEFAULT_QS == jmetrics.DEFAULT_QS == (50, 95, 99)


def test_fmt_histogram_and_registry_equal_jax():
    for args in [(None,), (1234.0, 1e3, 2, "ms"), (50.0,), (0.5, 1.0, 3)]:
        assert metrics.fmt(*args) == jmetrics.fmt(*args)
    h, jh = metrics.Histogram(capacity=4), jmetrics.Histogram(capacity=4)
    for x in [5.0, 1.0, 3.0] + [float(i) for i in range(10)]:
        h.observe(x)
        jh.observe(x)
        assert h.snapshot() == jh.snapshot()
    assert h.snapshot()["truncated"] and h.snapshot()["n"] == 13
    with pytest.raises(ValueError):
        metrics.Histogram(capacity=0)
    regs = [metrics.MetricsRegistry(hist_capacity=8), jmetrics.MetricsRegistry(hist_capacity=8)]
    for reg in regs:
        reg.counter("requests", 3)
        reg.counter("requests")
        reg.gauge("queue_depth", 7)
        for v in range(12):
            reg.observe("lat", float(v * v))
        reg.observe("other", 1.5)
        reg.register_collector("rt", lambda: {"x": 1})
        reg.register_collector("rt", lambda: {"x": 2})      # re-register replaces
        with pytest.raises(TypeError):
            reg.register_collector("bad", 42)
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].snapshot()["collectors"] == {"rt": {"x": 2}}


def _record(tr):
    root = tr.span("request", 0.0, 100.0, req=0, path="miss", session=3)
    tr.span("queue.wait", 0.0, 60.0, cat="queue", req=0, parent=root)
    tr.span("engine.service", 60.0, 40.0, cat="engine", req=0, parent=root)
    r4 = tr.span("request", 10.0, 5.0, req=4, path="hit_exact")
    tr.span("cache.hit_exact", 10.0, 5.0, cat="cache", req=4, parent=r4, reason="lru")
    tr.span("batch.dispatch", 60.0, 40.0, cat="batch", size=3, trigger="full")
    tr.instant("jit.compile", 5.0, cat="jit", key="k")
    tr.instant("admission", 7.0, cat="cluster", req=4, decision="admit_full")


def test_tracer_exports_and_trees_equal_jax(tmp_path):
    tr, jtr = tracing.Tracer(sample_every=4), jtracing.Tracer(sample_every=4)
    assert [i for i in range(9) if tr.want(i)] == [i for i in range(9) if jtr.want(i)]
    _record(tr)
    _record(jtr)
    assert (tr.spans, tr.instants) == (jtr.spans, jtr.instants)
    files = {}
    for name, t in (("port", tr), ("jax", jtr)):
        files[name] = (t.to_jsonl(str(tmp_path / f"{name}.jsonl")),
                       t.to_chrome(str(tmp_path / f"{name}.json")))
    for a, b in zip(files["port"], files["jax"]):
        assert open(a).read() == open(b).read()
    spans, instants = tracing.load_jsonl(files["port"][0])
    assert (spans, instants) == jtracing.load_jsonl(files["jax"][0])
    assert tracing.span_children(spans) == jtracing.span_children(spans)
    trees = tracing.request_trees(spans)
    assert trees == jtracing.request_trees(spans) and sorted(trees) == [0, 4]
    root, kids = trees[0]
    assert sum(c["dur_us"] for c in kids) == root["dur_us"]
    with open(files["port"][1]) as f:
        assert {e["ph"] for e in json.load(f)["traceEvents"]} == {"X", "i"}


def test_tracer_capacity_and_clear():
    tr = tracing.Tracer(capacity=2)
    ids = [tr.span("s", 0.0, 1.0) for _ in range(4)]
    tr.instant("i", 0.0)
    tr.instant("i", 0.0)
    tr.instant("i", 0.0)
    assert ids[2] is None and tr.dropped == 3
    tr.clear()
    assert tr.spans == [] and tr.dropped == 0
    assert tr.span("s", 0.0, 1.0) not in set(ids[:2])        # ids advance across clears
    for kw in (dict(sample_every=0), dict(capacity=0)):
        with pytest.raises(ValueError):
            tracing.Tracer(**kw)


@pytest.mark.parametrize("windows", [((1_000.0, 100.0, 2.0),), obs.DEFAULT_WINDOWS,
                                     ((500.0, 500.0, 1.0), (5_000.0, 50.0, 9.0))])
def test_slo_burn_rates_equal_jax(windows):
    mons = [m.SLOMonitor(target_us=100.0, objective=0.9, windows=windows)
            for m in (obs, jobs)]
    rng = np.random.default_rng(6)
    t = 0.0
    for _ in range(400):
        t += float(rng.exponential(20.0))
        lat = float(rng.exponential(60.0))
        for m in mons:
            m.observe(t, lat)
        for w in (50.0, 1_000.0, 1e9):
            assert mons[0].burn_rate(w) == mons[1].burn_rate(w)
            assert mons[0].burn_rate(w, now=t / 2) == mons[1].burn_rate(w, now=t / 2)
    ev = mons[0].evaluate()
    assert ev == mons[1].evaluate() and ev["n_violations"] > 0
    assert obs.SLOMonitor().burn_rate(10.0) is None
    for kw in (dict(target_us=0.0), dict(objective=1.0), dict(windows=((1.0, 2.0, 1.0),)),
               dict(windows=((2.0, 1.0, 0.0),))):
        with pytest.raises(ValueError):
            obs.SLOMonitor(**kw)


def test_obs_config_equals_jax():
    assert vars(obs.ObsConfig()) == vars(jobs.ObsConfig())
    cfg = obs.ObsConfig(trace_sample_every=4, strict_jit_audit=True)
    assert cfg.tracer().sample_every == 4 and cfg.auditor().strict
    assert cfg.registry().snapshot() == jobs.ObsConfig().registry().snapshot()
    assert cfg.slo_monitor().target_us == 50_000.0
    for kw in (dict(trace_sample_every=0), dict(trace_capacity=0), dict(hist_capacity=0),
               dict(slo_target_us=0.0), dict(slo_objective=1.0)):
        with pytest.raises(ValueError):
            jobs.ObsConfig(**kw)
        with pytest.raises(ValueError):
            obs.ObsConfig(**kw)


def test_jit_auditor_freeze_violations_and_strict():
    tr = tracing.Tracer()
    aud = obs.JitAuditor(tracer=tr)
    f = aud.wrap(("single", 8, 10, 0), lambda x: x + 1)
    assert f(1) == 2 and f(2) == 3
    assert len(aud.compiles) == 1 and not aud.compiles[0]["frozen"]
    aud.freeze()
    aud.assert_closed()
    g = aud.wrap(("multi", 8, 10, 16), lambda x: x * 2, label="intersect[raw]")
    assert g(3) == 6 and g(4) == 8
    assert [v["label"] for v in aud.violations] == ["intersect[raw]"]
    with pytest.raises(obs.JitAuditError):
        aud.assert_closed()
    snap = aud.snapshot()
    assert snap["n_variants"] == 2 and snap["n_violations"] == 1 and snap["frozen"]
    json.dumps(snap)
    assert [e["name"] for e in tr.instants] == ["jit.compile"] * 2
    strict = obs.JitAuditor(strict=True)
    strict.freeze()
    with pytest.raises(obs.JitAuditError):
        strict.wrap("k", lambda: 0)()


def test_jit_auditor_synchronises_only_on_cuda_outputs(monkeypatch):
    import torch
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    jit_audit._block((torch.zeros(2), True))
    jit_audit._block(np.zeros(2))
    assert calls == []
    assert not jit_audit._holds_cuda([torch.zeros(1), (torch.ones(1), 3)])


@pytest.fixture(scope="module")
def small():
    qs, sc = generate_query_log(SynthLogConfig(n_queries=400, vocab_size=120,
                                               mean_term_chars=4.0, seed=9))
    qidx, kept, _ = build_qac_index(qs, sc, device="cpu")
    trace = generate_keystroke_trace(kept, KeystrokeTraceConfig(
        n_sessions=8, mean_keystroke_ms=5.0, session_spread_ms=20.0, seed=4))
    return qidx, prepare_requests(qidx, trace, k=10)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_frontend_auditor_hook(small, use_kernel):
    """The measured-replay protocol (warmup, a full pass, reset, freeze, the
    measured pass) mints nothing after the freeze; a new k bucket then
    mints exactly one callable per engine it reaches, each recorded once
    with the route it takes."""
    qidx, reqs = small
    aud = obs.JitAuditor()
    fe = QACFrontend(qidx, k=10, specialize_list_pad=False, use_kernel=use_kernel,
                     auditor=aud)
    rt = QACOnlineRuntime(fe, RuntimeConfig(max_batch=16, slack_us=2_000.0))
    rt.warmup(reqs)
    rt.run_trace(reqs)
    rt.reset()
    n_warm = len(aud.compiles)
    assert n_warm == len(fe._cache) and {k[:2] for k in fe._cache} >= {
        ("single", 8), ("single", 16), ("multi", 8), ("multi", 16)}
    aud.freeze()
    rt.run_trace(reqs)
    aud.assert_closed()
    single = next(r for r in reqs if r.plen == 0 and r.hi > r.lo)
    fe.complete(single.pids[None], np.asarray([0], np.int32), single.suf[None],
                np.asarray([single.slen], np.int32), k=16)
    assert len(aud.violations) == 1
    assert aud.violations[0]["key"] == ("single", 8, 16, 0)
    assert aud.violations[0]["label"] == fe.describe_route("single")
    with pytest.raises(obs.JitAuditError):
        aud.assert_closed()
    fe.complete(single.pids[None], np.asarray([0], np.int32), single.suf[None],
                np.asarray([single.slen], np.int32), k=16)
    assert len(aud.violations) == 1                           # recorded once
