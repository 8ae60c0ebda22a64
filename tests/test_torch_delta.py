"""The port's delta tier against the JAX package's: ``MainCorpusView``'s
maps on the same index, and one seeded insert sequence through both
``DeltaIndex``es (outcomes, stats, ``seq``, ``oplog``, entries, rows,
postings, ``fold_corpus``), ``shadowed`` and ``matches``/``topk`` at every
``upto`` over a grid of (pids, plen, lo, hi), overflow and ``score_at``.
The JAX index is carried into the port on identical arrays."""
import numpy as np
import pytest
from _torch_pairs import qac_index_from_arrays, qac_index_to_arrays

from repro.core import build_qac_index as jax_build
from repro.core.delta import DeltaIndex as JDelta, MainCorpusView as JView
from repro.text import SynthLogConfig, generate_query_log
from repro_torch.core.delta import DeltaIndex, MainCorpusView

TINY = (["alpha beta", "alpha gamma", "beta gamma", "delta", "alpha",
         "gamma delta", "beta", "epsilon", "alpha delta"],
        [9.0, 8.0, 7.0, 6.0, 5.0, 4.0, 3.0, 2.0, 1.0])


def _views(qs, sc):
    jq, kept, scores = jax_build(qs, sc)
    tq = qac_index_from_arrays(*qac_index_to_arrays(jq), device="cpu")
    return JView(jq, kept, scores), MainCorpusView(tq, kept, scores)


@pytest.fixture(scope="module")
def small():
    return _views(*generate_query_log(SynthLogConfig(
        n_queries=400, vocab_size=60, mean_term_chars=4.0, seed=7)))


@pytest.fixture(scope="module")
def tiny():
    return _views(*TINY)


@pytest.fixture(scope="module")
def odd():
    # a control character sorts below the space that joins tokens, so the
    # strings' order differs from the rows' lexicographic order: the view
    # takes its dict path
    return _views(["ab\x01 x", "ab c", "ab", "c ab\x01", "x", "ab x c"],
                  [3.0, 5.0, 1.0, 2.0, 4.0, 6.0])


@pytest.mark.parametrize("which", ["tiny", "small", "odd"])
def test_view_maps_equal_jax(which, request):
    jv, tv = request.getfixturevalue(which)
    assert isinstance(tv.docid_of_string, dict) == (which == "odd")
    assert tv.term_id == jv.term_id
    assert tv.string_of_docid == jv.string_of_docid
    assert len(tv.tokens_of_docid) == len(jv.tokens_of_docid)
    assert list(tv.tokens_of_docid) == jv.tokens_of_docid
    assert tv.tokens_of_docid[3] == jv.tokens_of_docid[3]
    assert np.array_equal(tv.score_of_docid, jv.score_of_docid)
    assert tv.score_of_docid.dtype == np.float64
    assert tv.docid_of_string == jv.docid_of_string
    assert tv.kept == jv.kept and np.array_equal(tv.scores, jv.scores)
    for s in jv.string_of_docid[:20] + ["no such completion", ""]:
        assert tv.lookup(s) == jv.lookup(s)


def test_view_takes_the_host_forward_index(small):
    jv, tv = small
    again = MainCorpusView(tv.qidx, tv.kept, tv.scores,
                           fwd=tv.qidx.completions.fwd_terms.numpy())
    assert again.string_of_docid == jv.string_of_docid
    with pytest.raises(ValueError):
        MainCorpusView(tv.qidx, tv.kept[:-1], tv.scores)


def _insert_stream(view, rng, n):
    """Seeded inserts: new combinations, raises and noops of earlier ones,
    main completions above and below their score, OOV terms, empty and
    too-long queries, odd whitespace."""
    vocab = sorted(view.term_id)
    mains = view.string_of_docid
    done = []
    for _ in range(n):
        r = int(rng.integers(0, 100))
        if r < 40 or not done:
            q = " ".join(vocab[int(i)] for i in rng.integers(0, len(vocab),
                                                            int(rng.integers(1, 4))))
        elif r < 55:
            q = done[int(rng.integers(0, len(done)))]
        elif r < 75:
            q = mains[int(rng.integers(0, len(mains)))]
        elif r < 85:
            q = vocab[int(rng.integers(0, len(vocab)))] + " zzoov" + str(int(rng.integers(0, 5)))
        elif r < 90:
            q = "  " + " \t".join(vocab[:2]) + " "
        elif r < 95:
            q = ""
        else:
            q = " ".join(vocab[:9])
        done.append(q)
        yield q, float(rng.integers(1, 400))


def _same_state(td, jd):
    assert td.seq == jd.seq and td.n == jd.n
    assert td.oplog == jd.oplog
    assert td.stats() == jd.stats()
    assert np.array_equal(td.rows, jd.rows) and np.array_equal(td.scores, jd.scores)
    assert td.postings == jd.postings and td.by_query == jd.by_query
    assert td.shadow_docids == jd.shadow_docids and td.deferred == jd.deferred
    assert td._born == jd._born
    for a, b in zip(td.entries, jd.entries):
        assert (a.query, a.tokens, a.born, a.hist, a.shadow_docid) == \
            (b.query, b.tokens, b.born, b.hist, b.shadow_docid)
        assert np.array_equal(a.row, b.row) and a.score == b.score
    assert td.fold_corpus() == jd.fold_corpus()


@pytest.mark.parametrize("seed", [0, 3])
def test_insert_sequence_equals_jax(small, seed):
    jv, tv = small
    jd, td = JDelta(jv, capacity=512), DeltaIndex(tv, capacity=512)
    outcomes = []
    for q, s in _insert_stream(tv, np.random.default_rng(seed), 200):
        out = td.insert(q, s)
        assert out == jd.insert(q, s), (q, s)
        outcomes.append(out)
    assert set(outcomes) == {"applied", "updated", "noop", "deferred", "dropped"}
    _same_state(td, jd)
    assert td.shadowed() and td.shadowed() == jd.shadowed()


def test_reads_equal_jax_at_every_upto(small):
    jv, tv = small
    jd, td = JDelta(jv, capacity=256), DeltaIndex(tv, capacity=256)
    for q, s in _insert_stream(tv, np.random.default_rng(5), 120):
        jd.insert(q, s)
        td.insert(q, s)
    rng = np.random.default_rng(9)
    V = len(tv.term_id)
    ids = np.asarray(sorted({int(t) for e in td.entries for t in e.row if t}))
    hits = 0
    for upto in range(td.seq + 1):
        assert td.shadowed(upto) == jd.shadowed(upto)
        assert td._n_visible(upto) == jd._n_visible(upto)
        for _ in range(12):
            plen = int(rng.integers(0, 3))
            pids = np.zeros(8, np.int64)
            pids[:plen] = rng.choice(ids, plen)
            if rng.integers(0, 10) == 0 and plen:
                pids[0] = 0                       # unknown prefix term
            lo = int(rng.integers(1, V + 2))
            hi = int(rng.integers(lo - 1, V + 2)) if rng.integers(0, 8) else lo - 1
            if rng.integers(0, 3) == 0:
                lo, hi = 1, V + 1                 # every term
            got = td.matches(pids, plen, lo, hi, upto=upto)
            assert got == jd.matches(pids, plen, lo, hi, upto=upto)
            assert td.topk(pids, plen, lo, hi, 3, upto=upto) == \
                jd.topk(pids, plen, lo, hi, 3, upto=upto)
            hits += bool(got)
    assert td.matches(pids, plen, lo, hi) == jd.matches(pids, plen, lo, hi)
    assert hits > 50, "the grid degenerated to empty matches"


def test_overflow_and_score_at_equal_jax(tiny):
    jv, tv = tiny
    for mod_view, Delta in ((jv, JDelta), (tv, DeltaIndex)):
        d = Delta(mod_view, capacity=1)
        assert d.insert("alpha epsilon", 4.0) == "applied"
        with pytest.raises(OverflowError, match="delta full"):
            d.insert("beta epsilon", 4.0)
        assert d.insert("alpha epsilon", 9.0) == "updated"
        assert d.insert("zzq", 1.0) == "deferred"
        e = d.entries[0]
        assert (e.score_at(1), e.score_at(2), e.score) == (4.0, 9.0, 9.0)
        with pytest.raises(ValueError, match="born at seq 1 queried at 0"):
            e.score_at(0)
    for Delta, view in ((JDelta, jv), (DeltaIndex, tv)):
        with pytest.raises(ValueError, match="capacity must be >= 1"):
            Delta(view, capacity=0)
