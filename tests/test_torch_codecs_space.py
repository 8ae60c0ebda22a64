"""The space-study codecs of ``repro_torch.core.codecs`` against the JAX
package's, on the same seeded inputs: the bit streams of ``BitWriter``
(scalar, vectorized and unary), ``EFList``'s fields and ``ef_decode``,
``pef_bits``, the ``vbyte_encode`` bytes and their decode, ``bitpack_bits``
and ``index_bpi`` for every method, with the sweeps of ``tests/
test_codecs.py`` and its two hypothesis round trips held field for field.
No JAX runs: both modules are host numpy."""
import numpy as np
import pytest
from _hyp import given, settings, st

from repro.core import codecs as jc
from repro_torch.core import codecs as tc

EDGES = [(0, 1), (1, 1), (1, 1 << 31), (127, 1000), (128, 1000), (129, 10**6),
         (500, 1 << 31)]


def _sorted_values(rng, n, universe):
    return np.sort(rng.integers(0, universe, size=n).astype(np.int64))


def assert_ef_equal(v):
    got, want = tc.ef_encode(v), jc.ef_encode(v)
    assert (got.n, got.universe, got.low_bits, got.bits()) == \
        (want.n, want.universe, want.low_bits, want.bits())
    np.testing.assert_array_equal(got.words, want.words)
    np.testing.assert_array_equal(tc.ef_decode(got), jc.ef_decode(want))
    np.testing.assert_array_equal(tc.ef_decode(got), v)


def test_bit_io_streams_equal_jax():
    rng = np.random.default_rng(0)
    tw, jw = tc.BitWriter(), jc.BitWriter()
    for _ in range(200):
        nb = int(rng.integers(0, 48))
        v = int(rng.integers(0, 1 << nb)) if nb else 0
        tw.write(v, nb)
        jw.write(v, nb)
    for nb in (0, 1, 5, 7, 13, 31, 32, 47, 63):
        vals = rng.integers(0, (1 << nb) if nb else 1, size=257)
        tw.write_many(vals, nb)
        jw.write_many(vals, nb)
    gaps = rng.integers(0, 9, size=300)
    tw.unary_many(gaps)
    jw.unary_many(gaps)
    tw.unary(5)
    jw.unary(5)
    assert tw.n_bits() == jw.n_bits()
    np.testing.assert_array_equal(tw.array(), jw.array())
    r = tc.BitReader(tw.array())
    r.pos = tw.n_bits() - 6 - 300 - int(gaps.sum())
    np.testing.assert_array_equal(r.unary_many(300), gaps)
    assert r.unary() == 5


@pytest.mark.parametrize("n,universe", EDGES)
def test_ef_equals_jax_edges(n, universe):
    assert_ef_equal(_sorted_values(np.random.default_rng(n + universe % 97), n, universe))


def test_ef_vbyte_bitpack_pef_equal_jax():
    for v in (np.full(130, 42, dtype=np.int64), np.arange(256, dtype=np.int64)):
        assert_ef_equal(v)
    rng = np.random.default_rng(3)
    for n in (0, 1, 3, 100, 1000):
        v = _sorted_values(rng, n, 1 << 31)
        data = tc.vbyte_encode(v)
        assert data == jc.vbyte_encode(v)
        np.testing.assert_array_equal(tc.vbyte_decode(data, n), v)
        assert tc.bitpack_bits(v) == jc.bitpack_bits(v)
        if n:
            assert tc.pef_bits(v) == jc.pef_bits(v)
            assert tc.pef_bits(v, partition=32) == jc.pef_bits(v, partition=32)


def test_index_bpi_equals_jax():
    rng = np.random.default_rng(4)
    lists = [np.sort(rng.choice(10**5, size=int(rng.integers(0, 300)), replace=False))
             for _ in range(40)]
    for method in ("ef", "pef", "vbyte", "bitpack", "raw32"):
        assert tc.index_bpi(lists, method) == jc.index_bpi(lists, method)
    with pytest.raises(ValueError):
        tc.index_bpi(lists, "bic")


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(0, 2**31 - 1), min_size=0, max_size=600))
def test_hyp_ef_equals_jax(vals):
    assert_ef_equal(np.sort(np.asarray(vals, dtype=np.int64)))


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(0, 2**31 - 1), min_size=0, max_size=300))
def test_hyp_vbyte_equals_jax(vals):
    v = np.sort(np.asarray(vals, dtype=np.int64))
    assert tc.vbyte_encode(v) == jc.vbyte_encode(v)
    np.testing.assert_array_equal(tc.vbyte_decode(tc.vbyte_encode(v), len(v)), v)
