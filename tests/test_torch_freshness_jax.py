"""One short mutation trace through the JAX package's ``GenerationalQAC``
and the port's (``device="cpu"``): every ``FreshResult`` field equal, and
the mutation outcomes and swap count. Both runtimes' clocks are fixed (each
reading 2**-9 s after the one before), so batching, cache paths and
latencies are the same in both packages. No JAX oracle here: the port's
own from-scratch oracle holds its answers in ``test_torch_freshness.py``.
Also ``FreshnessConfig``'s validation and ``QACArch.freshness_config()``
against JAX's."""
import dataclasses

import pytest

import repro.serve.runtime as jax_runtime_mod
import repro_torch.serve.runtime as runtime_mod
from _torch_clock import fix_clocks
from repro_torch.configs import get_arch
from repro_torch.configs.qac_common import QACArch
from repro.serve.freshness import (FreshnessConfig as JaxConfig,
                                   GenerationalQAC as JaxGQ)
from repro.serve.runtime import RuntimeConfig as JaxRT
from repro_torch.serve.freshness import FreshnessConfig, GenerationalQAC
from repro_torch.serve.runtime import RuntimeConfig
from repro_torch.text import (KeystrokeTraceConfig, MutationTraceConfig,
                              SynthLogConfig, generate_mutation_trace,
                              generate_query_log)

@pytest.mark.parametrize("fe_kw", [{}, dict(tile=1, max_tiles=1)],
                         ids=["engine-caps", "truncated-scans"])
def test_fresh_results_equal_jax(monkeypatch, fe_kw):
    """With a one-posting cap every multi-term request whose shortest list
    has two postings takes the merge's exact-scan branch: the port's device
    scan, cut at k + |shadowed|, against JAX's whole numpy scan."""
    fix_clocks(monkeypatch, runtime_mod, jax_runtime_mod)
    qs, sc = generate_query_log(SynthLogConfig(n_queries=300, vocab_size=80,
                                               mean_term_chars=4.0, seed=17))
    events = generate_mutation_trace(qs, sc, MutationTraceConfig(
        keystrokes=KeystrokeTraceConfig(n_sessions=6, queries_per_session=1,
                                        mean_keystroke_ms=2.0, seed=2),
        n_mutations=6, follower_sessions=4, seed=2))
    rt = dict(max_batch=8, slack_us=2_000.0)
    fc = dict(k=10, delta_capacity=64, swap_threshold=2)
    jq = JaxGQ(qs, sc, cfg=JaxConfig(**fc), rt_cfg=JaxRT(**rt),
               frontend_kwargs=fe_kw)
    tq = GenerationalQAC(qs, sc, cfg=FreshnessConfig(**fc),
                         rt_cfg=RuntimeConfig(**rt), frontend_kwargs=fe_kw,
                         device="cpu")
    want = jq.run_mutation_trace(events)
    got = tq.run_mutation_trace(events)
    assert len(got) == len(want) > 50
    # idx, query, k, gen, seq, strings, scores, path, n_delta, escalations,
    # and with the fixed clocks lat_us too
    for a, b in zip(got, want):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    js, ts = jq.snapshot(), tq.snapshot()
    assert ts["n_swaps"] == js["n_swaps"] >= 1
    assert ts["mutation_outcomes"] == js["mutation_outcomes"]
    assert ts["delta_hit_answers"] == js["delta_hit_answers"] > 0
    assert ts["escalations"] == js["escalations"]
    assert (ts["truncated_scans"] > 0) == bool(fe_kw)
    assert ts["runtime"]["paths"] == js["runtime"]["paths"]
    assert ts["runtime"]["per_generation"] == js["runtime"]["per_generation"]
    assert [(s["gen"], s["folded"], s["folded_seq"], s["deferred"])
            for s in tq.swap_log] == [(s["gen"], s["folded"], s["folded_seq"],
                                       s["deferred"]) for s in jq.swap_log]


BAD_CONFIGS = [dict(k=0), dict(k=10, delta_capacity=4),
               dict(delta_capacity=64, swap_threshold=65),
               dict(swap_threshold=0)]


@pytest.mark.parametrize("kw", BAD_CONFIGS)
def test_config_validation_equals_jax(kw):
    from repro.serve.freshness import FreshnessConfig as JaxConfig

    msgs = []
    for cls in (JaxConfig, FreshnessConfig):
        with pytest.raises(ValueError) as e:
            cls(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    FreshnessConfig(k=5, delta_capacity=8, swap_threshold=8)


def test_arch_freshness_config_equals_jax():
    from repro.configs import get_arch as jax_get_arch
    from repro.configs.qac_common import QACArch as JaxArch

    for kw in ({}, dict(freshness_delta_capacity=256,
                        freshness_swap_threshold=128)):
        got = QACArch(**kw).freshness_config()
        want = JaxArch(**kw).freshness_config()
        assert isinstance(got, FreshnessConfig)
        assert vars(got) == vars(want)
    assert vars(get_arch("qac-ebay").freshness_config()) == \
        vars(jax_get_arch("qac-ebay").freshness_config())
    assert vars(get_arch("qac-ebay").freshness_config()) == dict(
        k=10, delta_capacity=4096, swap_threshold=1024)
    with pytest.raises(ValueError):
        QACArch(freshness_swap_threshold=0).freshness_config()
