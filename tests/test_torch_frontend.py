"""The port's ``QACFrontend.complete`` against the JAX package's
``QACFrontend(use_kernel=False)`` on identical index arrays: mixed,
single-class, empty-suffix-range, bounded-engine-fallback and per-request-k
batches, every route of the port, and equal ``stats``."""
import numpy as np
import pytest

from repro.core import parse_queries as jax_parse
from repro.serve import QACFrontend as JaxFrontend
from repro_torch.core import parse_queries
from repro_torch.serve import QACFrontend, route_classes

from _torch_pairs import build_pair, host, partials

INF = 2**31 - 1
ROUTES = [dict(), dict(use_kernel=True), dict(use_kernel=True, heap_kernel=False)]


@pytest.fixture(scope="module")
def pair():
    jq, tq, kept = build_pair(600, 150, seed=5)
    return jq, tq, kept, JaxFrontend(jq, k=10, use_kernel=False)


def _check(pair, batch, fe, k=10, jfe=None):
    jq, tq, _, jfe0 = pair
    jfe = jfe or jfe0
    jp = jax_parse(jq.dictionary, batch)
    tp = parse_queries(tq.dictionary, batch)
    want = np.asarray(jfe.complete(jp[0], jp[1], jp[3], jp[4], k=k))
    got = fe.complete(tp[0], tp[1], tp[3], tp[4], k=k)
    assert isinstance(got, np.ndarray) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("route", range(len(ROUTES)))
def test_mixed_batches(pair, route):
    _, tq, kept, _ = pair
    fe = QACFrontend(tq, k=10, **ROUTES[route])
    rng = np.random.default_rng(0)
    for B, pct in [(32, 50), (64, 80), (17, 50), (5, 60)]:
        _check(pair, partials(kept, rng, B, pct, pct_garbage=10), fe)
    assert fe.describe_route("single") == ["torch_ref", "heap_topk[raw]",
                                           "per_pop_rmq[kernel]"][route]
    assert fe.describe_route("multi") == ["torch_ref", "intersect[raw]",
                                          "intersect[raw]"][route]


def test_single_class_and_empty_suffix_batches(pair):
    _, tq, kept, _ = pair
    fe = QACFrontend(tq, k=10)
    rng = np.random.default_rng(1)
    _check(pair, partials(kept, rng, 32, 100), fe)
    assert fe.stats["multi_queries"] == 0
    _check(pair, partials(kept, rng, 32, 0), fe)
    _check(pair, partials(kept, rng, 1, 100), fe)
    _check(pair, partials(kept, rng, 1, 0), fe)
    got = _check(pair, ["zzzzzzqx", kept[0].split()[0] + " zzzzzzqx", ""], fe)
    assert (got[:2] == INF).all() and (got[2] < INF).any()
    words = sorted({w for q in kept for w in q.split()})
    _check(pair, [w + " " for w in words[:9]], fe)   # complete term, empty suffix


def test_bounded_engine_fallback_and_stats(pair):
    jq, tq, kept, _ = pair
    jfe = JaxFrontend(jq, k=10, trips=1, use_kernel=False)
    rng = np.random.default_rng(2)
    batch = partials(kept, rng, 48, 60, pct_garbage=5)
    fes = [QACFrontend(tq, k=10, trips=1, **kw) for kw in ROUTES]
    for fe in fes:
        _check(pair, batch, fe, jfe=jfe)
        fe.begin_dispatch_log()
        _check(pair, batch[:8], fe, jfe=jfe)
        log = fe.end_dispatch_log()
        assert [key[0] for key, _ in log][:2] == ["single", "single_full"]
    assert jfe.stats["single_fallbacks"] > 0
    for fe in fes:
        assert fe.stats == {k: v // len(fes) for k, v in jfe.stats.items()}


def test_per_request_k(pair):
    _, tq, kept, _ = pair
    fe = QACFrontend(tq, k=10)
    rng = np.random.default_rng(3)
    batch = partials(kept, rng, 40, 50, pct_garbage=5)
    ks = rng.choice([1, 3, 10, 16], size=len(batch))
    got = _check(pair, batch, fe, k=ks)
    assert got.shape == (40, 16)
    full = _check(pair, batch, fe, k=16)
    for i, ki in enumerate(ks):
        np.testing.assert_array_equal(got[i, :ki], full[i, :ki])
    _check(pair, batch, fe, k=np.full(len(batch), 10))
    assert fe.complete(*[np.zeros((0, 8), np.int32), np.zeros(0, np.int32),
                         np.zeros((0, 24), np.uint8), np.zeros(0, np.int32)],
                       k=np.zeros(0, np.int64)).shape == (0, 0)


def test_route_classes_and_host_inputs(pair):
    jq, tq, kept, jfe = pair
    rng = np.random.default_rng(4)
    batch = partials(kept, rng, 20, 50)
    tp = parse_queries(tq.dictionary, batch)
    single, multi = route_classes(tp[1])
    assert np.array_equal(np.sort(np.concatenate([single, multi])), np.arange(20))
    fe = QACFrontend(tq, k=10)
    from_tensors = fe.complete(tp[0], tp[1], tp[3], tp[4])
    from_numpy = fe.complete(*(host(tp[i]) for i in (0, 1, 3, 4)))
    np.testing.assert_array_equal(from_tensors, from_numpy)
