"""The remaining QAC engines and host references against the JAX
package's, bit for bit, on the ``_torch_pairs`` corpus (the JAX index
carried into the port on identical arrays): ``RangeMin.query``,
``topk_in_range(_batch)``, ``Completions.locate_prefix``, the per-query
engines and their ``*_vmap`` serve forms, ``complete_conjunctive_batch``
and ``qac_serve_step`` (also against the routed frontend). ``RangeMin.query``
and ``topk_in_range(_batch)`` are in ``test_torch_rmq.py``, the host
references in ``test_torch_ref_engines.py``. Inputs come from seeds
with numpy."""
import functools

import jax
import numpy as np
import pytest
import torch
from _torch_pairs import build_pair, host, partials

from repro.core import parse_queries as jax_parse
from repro.core import search as jsearch
from repro.serve import qac as jqac
from repro_torch.core import parse_queries
from repro_torch.core import search as tsearch
from repro_torch.serve import QACFrontend
from repro_torch.serve import qac as tqac

INF = 2**31 - 1
B = 28


@pytest.fixture(scope="module")
def pair():
    jq, tq, kept = build_pair(1500, 120, seed=4)
    raw = partials(kept, np.random.default_rng(8), B, pct_single=45, pct_garbage=10)
    jp = jax_parse(jq.dictionary, raw)
    tp = parse_queries(tq.dictionary, raw)
    for a, b in zip(jp, tp):
        assert np.array_equal(host(a), host(b))
    tl, th = tq.dictionary.locate_prefix(tp[3], tp[4])
    return jq, tq, kept, raw, jp, tp, tl, th


@pytest.fixture(scope="module")
def jax_full_single(pair):
    """JAX's unbounded single-term engine over the batch, compiled once for
    every ``trips`` case."""
    jq, _, _, _, _, _, tl, th = pair
    return host(jax.jit(jax.vmap(functools.partial(
        jsearch.single_term_topk, jq.index, jq.rmq_minimal, k=10)))(host(tl), host(th)))


@pytest.fixture(scope="module")
def jax_step(pair):
    """JAX's fused step (plain route) over the whole mixed batch, compiled
    once; its rows answer each row alone, so each class's rows are a slice."""
    jq, _, _, _, jp, _, _, _ = pair
    return host(jax.jit(functools.partial(jqac.qac_serve_step, jq, k=10, use_kernel=False))(
        host(jp[0]), host(jp[1]), host(jp[3]), host(jp[4])))


def test_locate_prefix_and_prefix_search_equal_jax(pair):
    jq, tq, _, _, jp, tp, tl, th = pair
    pids, plen = host(jp[0]), host(jp[1])
    tl_h, th_h = host(tl), host(th)
    wp, wq = jax.jit(jax.vmap(jq.completions.locate_prefix))(pids, plen, tl_h, th_h)
    got = [tuple(int(x) for x in tq.completions.locate_prefix(tp[0][b], tp[1][b], tl[b], th[b]))
           for b in range(B)]
    assert got == list(zip(host(wp).tolist(), host(wq).tolist()))
    assert sum(q > p for p, q in got) > 5
    # a prefix as long as a row gives (0, 0)
    full = np.arange(1, 9, dtype=np.int32)
    assert [int(x) for x in tq.completions.locate_prefix(full, 8, 1, 5)] == [0, 0]
    want = jax.jit(jax.vmap(functools.partial(
        jsearch.prefix_search_topk, jq.completions, jq.rmq_docids, k=10)))(pids, plen, tl_h, th_h)
    got = torch.stack([tsearch.prefix_search_topk(tq.completions, tq.rmq_docids, tp[0][b],
                                                  tp[1][b], tl[b], th[b], 10) for b in range(B)])
    assert np.array_equal(host(got), host(want)) and (host(got) < INF).any()


@pytest.mark.parametrize("trips", [2, 20])
def test_single_term_per_query_equals_jax(pair, jax_full_single, trips):
    jq, tq, _, _, _, _, tl, th = pair
    tl_h, th_h = host(tl), host(th)
    wo, wd = jax.jit(jax.vmap(functools.partial(
        jsearch.single_term_topk_bounded, jq.index, jq.rmq_minimal, k=10, trips=trips)))(tl_h, th_h)
    got = [tsearch.single_term_topk_bounded(tq.index, tq.rmq_minimal, tl[b], th[b], 10, trips)
           for b in range(B)]
    assert np.array_equal(np.stack([host(o) for o, _ in got]), host(wo))
    assert [bool(d) for _, d in got] == host(wd).tolist()
    if trips == 2:
        assert not all(bool(d) for _, d in got)
    assert np.array_equal(np.stack([host(tsearch.single_term_topk(
        tq.index, tq.rmq_minimal, tl[b], th[b], 10)) for b in range(B)]), jax_full_single)


@pytest.mark.parametrize("tile,max_tiles", [(128, 4096), (4, 2)])
def test_conjunctive_multi_per_query_equals_jax(pair, tile, max_tiles):
    jq, tq, _, _, jp, tp, tl, th = pair
    args = (host(jp[0]), host(jp[1]), host(tl), host(th))
    want = jax.jit(jax.vmap(functools.partial(
        jsearch.conjunctive_multi, jq.index, jq.completions, k=10, tile=tile,
        max_tiles=max_tiles)))(*args)
    got = torch.stack([tsearch.conjunctive_multi(
        tq.index, tq.completions, tp[0][b], tp[1][b], tl[b], th[b], 10, tile=tile,
        max_tiles=max_tiles) for b in range(B)])
    assert np.array_equal(host(got), host(want))
    assert (host(got)[host(tp[1]) > 0] < INF).any()


def test_vmap_serve_forms_equal_jax(pair):
    jq, tq, _, _, jp, tp, _, _ = pair
    tp = tuple(a[:16] for a in tp)
    jargs = tuple(host(a)[:16] for a in jp)
    jit = lambda fn, **kw: jax.jit(functools.partial(fn, jq, **kw))
    so, sd = tqac.serve_single_term_vmap(tq, tp[3], tp[4], k=10, trips=4)
    wo, wd = jit(jqac.serve_single_term_vmap, k=10, trips=4)(jargs[3], jargs[4])
    assert np.array_equal(host(so), host(wo)) and np.array_equal(host(sd), host(wd))
    mo = tqac.serve_multi_term_vmap(tq, tp[0], tp[1], tp[3], tp[4], k=10)
    wm = jit(jqac.serve_multi_term_vmap, k=10)(jargs[0], jargs[1], jargs[3], jargs[4])
    assert np.array_equal(host(mo), host(wm))
    fo = tqac.qac_serve_step_vmap(tq, tp[0], tp[1], tp[3], tp[4], k=10)
    wf = jit(jqac.qac_serve_step_vmap, k=10)(jargs[0], jargs[1], jargs[3], jargs[4])
    assert np.array_equal(host(fo), host(wf))


@pytest.mark.parametrize("rows", ["mixed", "single", "multi"])
def test_qac_serve_step_equals_jax_and_the_frontend(pair, jax_step, rows):
    _, tq, _, _, _, tp, _, _ = pair
    plen = host(tp[1])
    sel = {"mixed": np.arange(B), "single": np.flatnonzero(plen == 0),
           "multi": np.flatnonzero(plen > 0)}[rows]
    targs = tuple(a[torch.from_numpy(sel)] for a in tp)
    got = tqac.qac_serve_step(tq, targs[0], targs[1], targs[3], targs[4], k=10)
    assert got.dtype == torch.int32 and np.array_equal(host(got), jax_step[sel])
    fe = QACFrontend(tq, k=10)
    assert np.array_equal(fe.complete(targs[0], targs[1], targs[3], targs[4]), host(got))
    assert np.array_equal(host(tqac.qac_serve_step_vmap(
        tq, targs[0], targs[1], targs[3], targs[4], k=10)), host(got))


def test_complete_conjunctive_per_query_equals_jax(pair):
    jq, tq, _, _, jp, tp, tl, th = pair
    want = jax.jit(jax.vmap(functools.partial(
        jsearch.complete_conjunctive, jq.index, jq.completions, jq.rmq_minimal, k=5)))(
        host(jp[0]), host(jp[1]), host(tl), host(th))
    got = torch.stack([tsearch.complete_conjunctive(
        tq.index, tq.completions, tq.rmq_minimal, tp[0][b], tp[1][b], tl[b], th[b], 5)
        for b in range(B)])
    assert np.array_equal(host(got), host(want))
