"""The docid-striped index against the JAX package's, at S = 2 and 4, on a
small log: ``build_striped``'s arrays field for field (raw, "ef" and
"bitpack"), the stripes' ``local_index`` views, ``qac_serve_striped`` on the
CPU bit for bit against JAX's loop path and the port's unstriped
``qac_serve_step`` (a mixed batch, and batches of only one class), an index
carried across by ``convert.striped_index_from_arrays``, and the multi-term
engine reading a stripe's forward rows through ``fwd_stride`` against JAX's
``conjunctive_multi_batch`` over ``LocalFwd``. Inputs come from seeds with
numpy."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from _torch_pairs import host, partials

from repro.core import build_qac_index as jax_build
from repro.core import parse_queries as jax_parse
from repro.core.builder import build_corpus as jax_corpus
from repro.core.search import conjunctive_multi_batch as jax_multi
from repro.core.striped import build_striped as jax_striped
from repro.core.striped import local_index as jax_local
from repro.serve.qac import qac_serve_striped as jax_serve_striped
from repro.text import SynthLogConfig, generate_query_log
from repro_torch.convert import striped_index_from_arrays
from repro_torch.core import build_qac_index, parse_queries
from repro_torch.core.builder import build_corpus
from repro_torch.core.completions import rank_rows
from repro_torch.core.search import conjunctive_lanes, conjunctive_multi_batch
from repro_torch.core.striped import StripedQACIndex, build_striped, local_index
from repro_torch.kernels.intersect import ops as isect_ops
from repro_torch.kernels.intersect.ref import (conjunctive_topk_packed_ref,
                                               conjunctive_topk_ref, fwd_rows_of)
from repro_torch.serve import qac_serve_step, qac_serve_striped

INF = 2**31 - 1
B = 32


@pytest.fixture(scope="module")
def log():
    qs, sc = generate_query_log(SynthLogConfig(n_queries=600, vocab_size=150,
                                               mean_term_chars=4.0, seed=9))
    dictionary, rows, sc2, _ = jax_corpus(qs, sc)
    order = np.lexsort(tuple(rows[:, j] for j in range(rows.shape[1] - 1, -1, -1)) + (-sc2,))
    d_of_row = np.empty(len(rows), dtype=np.int32)
    d_of_row[order] = np.arange(len(rows), dtype=np.int32)
    jq, kept, _ = jax_build(qs, sc, postings_codec=None)
    tq, kept_t, _ = build_qac_index(qs, sc, postings_codec=None, device="cpu")
    assert kept_t == kept
    raw = partials(kept, np.random.default_rng(5), B, pct_single=40, pct_garbage=10)
    return qs, sc, rows, d_of_row, dictionary.n_terms, jq, tq, raw


def to_numpy(striped):
    """(arrays, meta) of a JAX or a port ``StripedQACIndex``."""
    arrays, meta = {}, {}
    for f in dataclasses.fields(striped):
        v = getattr(striped, f.name)
        if v is None or isinstance(v, (int, str)):
            meta[f.name] = v
        else:
            arrays[f.name] = host(v)
    return arrays, meta


def assert_same(a, b):
    (aa, am), (ba, bm) = to_numpy(a), to_numpy(b)
    assert am == bm
    assert sorted(aa) == sorted(ba)
    for key in aa:
        assert aa[key].dtype == ba[key].dtype, key
        np.testing.assert_array_equal(aa[key], ba[key], err_msg=key)


@pytest.mark.parametrize("S", [2, 4])
def test_build_striped_equals_jax(log, S):
    qs, sc, rows, d_of_row, n_terms, _, _, _ = log
    for codec in (None, "ef", "bitpack"):
        got = build_striped(rows, d_of_row, n_terms, S, codec, device="cpu")
        assert_same(got, jax_striped(rows, d_of_row, n_terms, S, codec))
        assert got.pp_codec == codec
    # the port's own corpus and ranking give the same rows and docids
    _, rows_t, sc_t, _ = build_corpus(qs, sc, device="cpu")
    d_t, _ = rank_rows(rows_t, sc_t)
    np.testing.assert_array_equal(rows_t, rows)
    np.testing.assert_array_equal(d_t, d_of_row)


@pytest.mark.parametrize("S", [2, 4])
def test_local_index_views_equal_jax(log, S):
    _, _, rows, d_of_row, n_terms, _, _, _ = log
    jst = jax_striped(rows, d_of_row, n_terms, S, "ef")
    tst = build_striped(rows, d_of_row, n_terms, S, "ef", device="cpu")
    docids = torch.tensor(np.r_[np.arange(-2, len(rows) + 2 * S), INF], dtype=torch.int32)
    for s in range(S):
        (ji, jf, jr), (ti, tf, tr) = jax_local(jst, s), local_index(tst, s)
        for f in ("postings", "offsets", "minimal"):
            np.testing.assert_array_equal(host(getattr(ti, f)), host(getattr(ji, f)))
        assert (ti.n_terms, ti.n_postings) == (ji.n_terms, ji.n_postings)
        for f in ("words", "base", "meta", "wordoff"):
            np.testing.assert_array_equal(host(getattr(ti.packed, f)),
                                          host(getattr(ji.packed, f)))
        assert (ti.packed.n_post, ti.packed.codec) == (ji.packed.n_post, ji.packed.codec)
        for f in ("values", "st_pos", "ib"):
            np.testing.assert_array_equal(host(getattr(tr, f)), host(getattr(jr, f)))
        assert (tr.n, tr.n_blocks, tr.levels) == (jr.n, jr.n_blocks, jr.levels)
        assert tf.fwd_stride == S
        want = jax.vmap(jf.extract)(host(docids))      # JAX's takes one docid
        for got, w in zip(tf.extract(docids), want):
            np.testing.assert_array_equal(host(got), host(w))
        np.testing.assert_array_equal(host(fwd_rows_of(tf.fwd_terms, docids[None], S)[0]),
                                      host(want[0]))


def serve_both(log, S, codec, sl, with_jax=True):
    """(JAX's loop path or None, the port's loop path on its plain versions
    and on the CPU kernel wrappers, the port's unstriped fused step) on the
    batch's queries ``sl``."""
    _, _, rows, d_of_row, n_terms, jq, tq, raw = log
    tst = build_striped(rows, d_of_row, n_terms, S, codec, device="cpu")
    tp = parse_queries(tq.dictionary, [raw[i] for i in sl])
    args = (tp[0], tp[1], tp[3], tp[4])
    want = None
    if with_jax:
        jst = jax_striped(rows, d_of_row, n_terms, S, codec)
        jp = [host(x) for x in jax_parse(jq.dictionary, [raw[i] for i in sl])]
        want = host(jax.jit(functools.partial(
            jax_serve_striped, jst, jq.dictionary, k=10, postings_codec=codec))(
                *(jp[i] for i in (0, 1, 3, 4))))
    plain = qac_serve_striped(tst, tq.dictionary, *args, k=10, postings_codec=codec)
    wrapped = qac_serve_striped(tst, tq.dictionary, *args, k=10, postings_codec=codec,
                                use_kernel=True)
    return want, host(plain), host(wrapped), host(qac_serve_step(tq, *args, k=10))


@pytest.mark.parametrize("S", [2, 4])
def test_serve_striped_equals_jax_and_serve_step(log, S):
    raw = log[-1]
    want, plain, wrapped, step = serve_both(log, S, None, range(B))
    assert plain.shape == (B, 10) and plain.dtype == np.int32
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(wrapped, want)
    np.testing.assert_array_equal(plain, step)
    assert (plain < INF).any(axis=1).sum() >= B // 2
    # batches of one class only: each engine alone on every stripe. A lane's
    # answer depends on its own inputs only, so JAX's rows are the slice of
    # its answer to the whole batch
    single = [i for i, q in enumerate(raw) if len(q.split()) == 1][:6]
    multi = [i for i, q in enumerate(raw) if len(q.split()) > 1][:6]
    for sl in (single, multi):
        _, plain, wrapped, step = serve_both(log, S, None, sl, with_jax=False)
        np.testing.assert_array_equal(plain, want[sl])
        np.testing.assert_array_equal(wrapped, want[sl])
        np.testing.assert_array_equal(plain, step)


@pytest.mark.parametrize("codec", ["ef", "bitpack"])
def test_serve_striped_packed_equals_serve_step(log, codec):
    """Each stripe's compressed postings on both engines: the answers of the
    raw route (held to JAX above) and of the unstriped step."""
    _, plain, wrapped, step = serve_both(log, 2, codec, range(B), with_jax=False)
    np.testing.assert_array_equal(plain, step)
    np.testing.assert_array_equal(wrapped, step)


def test_striped_index_from_arrays_serves_the_same(log):
    _, _, rows, d_of_row, n_terms, jq, tq, raw = log
    jst = jax_striped(rows, d_of_row, n_terms, 4, "ef")
    carried = striped_index_from_arrays(*to_numpy(jst), device="cpu")
    assert isinstance(carried, StripedQACIndex)
    assert_same(carried, build_striped(rows, d_of_row, n_terms, 4, "ef", device="cpu"))
    tp = parse_queries(tq.dictionary, raw)
    args = (tp[0], tp[1], tp[3], tp[4])
    np.testing.assert_array_equal(
        host(qac_serve_striped(carried, tq.dictionary, *args, k=10, postings_codec="ef")),
        host(qac_serve_step(tq, *args, k=10)))
    with pytest.raises(KeyError):
        striped_index_from_arrays({}, {"n_stripes": 4}, device="cpu")


@pytest.mark.parametrize("S,tile,max_tiles", [(2, 128, 4096), (4, 2, 3)])
def test_strided_topk_equals_jax_over_local_fwd(log, S, tile, max_tiles):
    """``conjunctive_topk_ref``/``_packed_ref`` with ``fwd_stride`` S on one
    stripe, at the engine's cap and at a cut one, equal JAX's multi-term
    engine over the stripe's ``LocalFwd``; the CPU wrappers give the same."""
    _, _, rows, d_of_row, n_terms, jq, tq, raw = log
    jst = jax_striped(rows, d_of_row, n_terms, S, "ef")
    tst = build_striped(rows, d_of_row, n_terms, S, "ef", device="cpu")
    tp = parse_queries(tq.dictionary, raw)
    mq = torch.nonzero(tp[1] > 0)[:, 0]
    pids, plen = tp[0][mq], tp[1][mq]
    tl, th = tq.dictionary.locate_prefix(tp[3][mq], tp[4][mq])
    s = S - 1
    (ji, jf, _), (ti, tf, _) = jax_local(jst, s), local_index(tst, s)
    lanes = conjunctive_lanes(ti, pids, plen, tl, th)
    iters = min(31, max(1, ti.postings.shape[0].bit_length()))
    kw = dict(k=10, tile=tile, max_tiles=max_tiles, iters=iters, fwd_stride=S)
    want = host(jax.jit(lambda *a: jax_multi(
        ji, jf, *a, k=10, tile=tile, max_tiles=max_tiles, use_kernel=False,
        probe_iters=iters))(host(pids), host(plen), host(tl), host(th)))
    fargs = (*lanes, tf.fwd_terms, tl, th)
    for got in (conjunctive_topk_ref(ti.postings, *fargs, **kw),
                conjunctive_topk_packed_ref(ti.postings, ti.packed, *fargs, **kw),
                isect_ops.conjunctive_topk(ti.postings, *fargs, **kw),
                isect_ops.conjunctive_topk_packed(ti.postings, ti.packed, *fargs, **kw),
                conjunctive_multi_batch(ti, tf, pids, plen, tl, th, 10, tile=tile,
                                        max_tiles=max_tiles)):
        np.testing.assert_array_equal(host(got), want)
    assert (want < INF).any()
    # the stride matters: the same rows read unstrided give other answers
    kw["fwd_stride"] = 1
    assert not np.array_equal(host(conjunctive_topk_ref(ti.postings, *fargs, **kw)), want)


def test_stride_one_leaves_answers_unchanged(log):
    """``fwd_stride=1`` is the unstriped engine: the forward rows are
    ``Completions.extract``'s, and the top-k is the default's."""
    tq, raw = log[6], log[7]
    comps = tq.completions
    assert comps.fwd_stride == 1
    docids = torch.tensor([[-1, 0, 3, comps.n - 1, comps.n, INF]], dtype=torch.int32)
    np.testing.assert_array_equal(host(fwd_rows_of(comps.fwd_terms, docids, 1)),
                                  host(comps.extract(docids)[0]))
    tp = parse_queries(tq.dictionary, raw)
    tl, th = tq.dictionary.locate_prefix(tp[3], tp[4])
    lanes = conjunctive_lanes(tq.index, tp[0], tp[1], tl, th)
    kw = dict(k=10, tile=4, max_tiles=5, iters=12)
    fargs = (tq.index.postings, *lanes, comps.fwd_terms, tl, th)
    np.testing.assert_array_equal(host(conjunctive_topk_ref(*fargs, **kw, fwd_stride=1)),
                                  host(conjunctive_topk_ref(*fargs, **kw)))
