"""The port's vectorised host build against the JAX package on logs made to
hit its edges: whitespace variants of one query, duplicates whose best
score comes first, last or twice, NaN, infinite and signed-zero scores,
empty and over-long queries, multi-byte and below-space characters (whose
rows do not follow their strings' order, so ``rank_rows`` must sort them),
the whole index built from such a log, ``encode_strings``, and the
postings packed and unpacked block by block against JAX's bit streams."""
import numpy as np
import pytest
import torch

from repro.core import build_qac_index as jax_build
from repro.core import codecs as jc
from repro.core.builder import build_corpus as jax_corpus
from repro.core.strings import encode_strings as jax_encode
from repro_torch.core import build_qac_index, codecs as tc
from repro_torch.core.builder import build_corpus
from repro_torch.core.completions import rank_rows
from repro_torch.core.strings import encode_strings

from _torch_pairs import qac_index_to_arrays

WORDS = ["a", "b", "ab", "ba", "a\x01", "\x01", "é", "zz", "x!y", "q" * 30]


def _log(seed, n=300):
    rng = np.random.default_rng(seed)
    seps = [" ", "  ", "\t", " \n "]
    qs = []
    for _ in range(n):
        toks = rng.choice(WORDS, int(rng.integers(0, 10))).tolist()
        q = "".join(t + str(rng.choice(seps)) for t in toks)
        qs.append(q if rng.random() < 0.5 else " " + q)
    sc = rng.choice([0.0, -0.0, 1.0, 2.0, 7.0, np.nan, np.inf, -np.inf], n)
    return qs, sc


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("max_terms", [2, 8])
def test_build_corpus_equals_jax(seed, max_terms):
    qs, sc = _log(seed)
    d, rows, got_sc, kept = build_corpus(qs, sc, max_terms, device=torch.device("cpu"))
    jd, jrows, jsc, jkept = jax_corpus(qs, sc, max_terms)
    assert kept == jkept and rows.dtype == np.int32
    np.testing.assert_array_equal(rows, jrows)
    assert got_sc.dtype == np.float64 and np.array_equal(got_sc, jsc, equal_nan=True)
    np.testing.assert_array_equal(np.signbit(got_sc), np.signbit(jsc))
    np.testing.assert_array_equal(d.chars.numpy(), np.asarray(jd.chars))
    np.testing.assert_array_equal(d.keys.numpy(), np.asarray(jd.keys))


@pytest.mark.parametrize("case", ["log", "kept", "kept_and_new", "one_not_ascii",
                                  "one_double_space", "one_trailing_space"])
def test_build_corpus_of_a_normalized_log_equals_jax(case):
    """Logs whose queries already are their keys (single spaces, ASCII),
    in log order and in key order as a rebuild's ``kept`` is, and the same
    with one query that is not, which takes the tokenizing path."""
    rng = np.random.default_rng(7)
    words = ["a", "b", "ab", "ba", "x!y", "zz", "q" * 30]
    qs = [" ".join(rng.choice(words, int(rng.integers(1, 10))).tolist())
          for _ in range(400)]
    sc = rng.choice([0.0, -0.0, 1.0, 2.0, 7.0, np.nan, np.inf, -np.inf], len(qs))
    if case != "log":
        _, _, sc, qs = jax_corpus(qs, sc, 8)
        sc = np.asarray(sc).copy()
        if case == "kept_and_new":
            qs, sc = qs + ["a zz", "zz a b"], np.append(sc, [9.0, -1.0])
    edit = {"one_not_ascii": "ab \u00e9", "one_double_space": "ab  b",
            "one_trailing_space": "ab b "}
    if case in edit:
        qs = list(qs)
        qs[len(qs) // 2] = edit[case]
    d, rows, got_sc, kept = build_corpus(qs, sc, 8, device=torch.device("cpu"))
    jd, jrows, jsc, jkept = jax_corpus(qs, sc, 8)
    assert kept == jkept and all(type(q) is str for q in kept)
    np.testing.assert_array_equal(rows, jrows)
    assert np.array_equal(got_sc, jsc, equal_nan=True)
    np.testing.assert_array_equal(np.signbit(got_sc), np.signbit(jsc))
    np.testing.assert_array_equal(d.chars.numpy(), np.asarray(jd.chars))


@pytest.mark.parametrize("seed", range(3))
def test_index_from_an_unordered_log_equals_jax(seed):
    qs, sc = _log(100 + seed, 500)
    sc = np.where(np.isnan(sc), 3.0, sc)
    jq, jkept, _ = jax_build(qs, sc)
    tq, kept, _ = build_qac_index(qs, sc, device="cpu")
    assert kept == jkept
    ja, jm = qac_index_to_arrays(jq)
    ta, tm = qac_index_to_arrays(tq)
    assert sorted(ta) == sorted(ja) and tm == jm
    for key in ja:
        assert ta[key].dtype == ja[key].dtype, key
        np.testing.assert_array_equal(ta[key], ja[key], err_msg=key)


def test_rank_rows_sorts_rows_out_of_order():
    rng = np.random.default_rng(7)
    for _ in range(50):
        rows = rng.integers(0, 4, (int(rng.integers(0, 40)), 3)).astype(np.int32)
        sc = rng.choice([1.0, 2.0, 0.0, -0.0], len(rows))
        for r in (rows, np.unique(rows, axis=0)):
            d, lex = rank_rows(r, sc[: len(r)])
            keys = tuple(r[:, j] for j in range(2, -1, -1))
            order = np.lexsort(keys + (-sc[: len(r)],))
            want = np.empty(len(r), np.int32)
            want[order] = np.arange(len(r))
            np.testing.assert_array_equal(d, want)
            np.testing.assert_array_equal(lex, np.lexsort(keys))


def test_encode_strings_equals_jax():
    strs = ["", "a", "héllo wörld" * 3, "x" * 40, "\x00b", "日本語", "z"]
    for m in (1, 3, 24):
        np.testing.assert_array_equal(encode_strings(strs, m), jax_encode(strs, m))
        np.testing.assert_array_equal(encode_strings([s.encode() for s in strs], m),
                                      jax_encode(strs, m))
    assert encode_strings([], 5).shape == (0, 5)


@pytest.mark.parametrize("codec", tc.CODECS)
def test_pack_many_blocks_equals_jax(codec):
    """Thousands of blocks of every width, EF and not, the tail padded."""
    rng = np.random.default_rng(11)
    parts = [np.sort(rng.integers(0, 2 ** int(rng.integers(1, 31)), int(rng.integers(1, 400))))
             for _ in range(300)]
    v = np.concatenate(parts + [rng.integers(0, 2**31 - 1, 333)]).astype(np.int32)
    jp, tp = jc.pack_postings(v, codec), tc.pack_postings(v, codec, device="cpu")
    for f in ("words", "base", "meta", "wordoff"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)))
    np.testing.assert_array_equal(tc.unpack_postings(tp), v)
    widths = tp.meta.numpy() & 63
    assert len(np.unique(widths)) > 10
    if codec == "ef":
        assert 0 < int((tp.meta.numpy() >> 6).sum()) < len(widths)
