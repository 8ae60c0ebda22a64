"""The port's compressed postings format against the JAX package: the
fixed-width bit fields, ``pack_postings``'s four arrays (bit-identical, dtype included),
``unpack_postings``'s round trip, and the plain ``packed_lookup`` and
``popcount32`` on every pointer (negative ones and ones past the end
included), for both codecs over empty, single, block-edge, near-2**31 and
unsorted inputs. Every comparison is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codecs as jc
from repro_torch.core import codecs as tc


def _csr_like(rng, n_lists, max_len, universe):
    """Concatenated ascending lists: sorted within a list, not across."""
    parts = [np.sort(rng.choice(universe, size=rng.integers(1, max_len),
                                replace=False))
             for _ in range(n_lists)]
    return np.concatenate(parts).astype(np.int64)


def _values(name):
    rng = np.random.default_rng(sum(name.encode()))
    if name.startswith("sorted"):
        n = int(name.split("-")[1])
        return np.sort(rng.integers(0, 50_000, n))
    return {
        "universe-2**31": np.sort(np.concatenate(
            [[0, 2**31 - 1], rng.integers(0, 2**31 - 1, 300)])),
        "dense-equal": np.full(300, 7),
        "unsorted-blocks": rng.integers(0, 10**6, 700),
        "csr-lists": _csr_like(rng, 40, 200, 5000),
        "long-runs": np.concatenate([np.arange(0, 5000, 3),
                                     np.arange(10**6, 10**6 + 900)]),
    }[name]


CASES = [f"sorted-{n}" for n in (0, 1, 127, 128, 129, 1000)] + [
    "universe-2**31", "dense-equal", "unsorted-blocks", "csr-lists",
    "long-runs"]


@pytest.mark.parametrize("codec", tc.CODECS)
@pytest.mark.parametrize("case", CASES)
def test_pack_unpack_lookup_equal_jax(case, codec):
    v = _values(case).astype(np.int32)
    jp = jc.pack_postings(v, codec)
    tp = tc.pack_postings(v, codec, device="cpu")
    for f in ("words", "base", "meta", "wordoff"):
        want, got = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        assert got.dtype == want.dtype == np.int32, f
        assert np.array_equal(got, want), f
    assert (tp.n_post, tp.codec, tp.has_ef) == (jp.n_post, jp.codec, jp.has_ef)
    assert tp.nbytes() == jp.nbytes() and tp.bits_per_int() == jp.bits_per_int()
    assert np.array_equal(tc.unpack_postings(tp), v)
    ptr = np.concatenate([np.arange(-3, len(v) + 4),
                          [-2**31, 2**31 - 1]]).astype(np.int32)
    want = jc.packed_lookup(jp.words, jp.base, jp.meta, jp.wordoff,
                            jnp.asarray(ptr), n_post=jp.n_post, ef=jp.has_ef)
    got = tp.lookup(torch.from_numpy(ptr))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    if len(v):
        assert np.array_equal(got.numpy()[3:3 + len(v)], v)
    if codec == "ef" and case in ("sorted-1000", "long-runs", "universe-2**31"):
        assert (tp.meta.numpy() >> 6).any(), "expected EF blocks"


def test_packed_lookup_ef_false_on_bitpack_equals_jax():
    """The static ``ef=False`` decode (no bitmap select) on a bitpack index,
    and ``ef=True`` on the same index, agree with JAX and with each other."""
    v = _values("sorted-1000").astype(np.int32)
    jp = jc.pack_postings(v, "bitpack")
    tp = tc.pack_postings(v, "bitpack", device="cpu")
    ptr = torch.arange(-5, 1010, dtype=torch.int32)
    for ef in (False, True):
        got = tc.packed_lookup(tp.words, tp.base, tp.meta, tp.wordoff, ptr,
                               n_post=tp.n_post, ef=ef)
        want = jc.packed_lookup(jp.words, jp.base, jp.meta, jp.wordoff,
                                jnp.asarray(ptr.numpy()), n_post=jp.n_post,
                                ef=ef)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_popcount_equals_jax():
    rng = np.random.default_rng(3)
    u = np.concatenate([[0, 1, 0x80000000, 0xFFFFFFFF, 0x55555555],
                        rng.integers(0, 2**32, 500)]).astype(np.uint32)
    want = np.asarray(jc._popcount32(jnp.asarray(u.view(np.int32))))
    got = tc.popcount32(torch.from_numpy(u.astype(np.int64)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert np.array_equal(got.numpy(), [bin(x).count("1") for x in u.tolist()])


@pytest.mark.parametrize("n_bits", [0, 1, 5, 13, 31, 32, 47, 63])
def test_bit_streams_equal_jax(n_bits):
    """Blocks of PACK_BLOCK fixed-width fields, packed by the port's
    ``_pack_fields`` all at once, equal JAX's ``BitWriter`` stream written a
    block at a time; ``_unpack_fields`` reads them back."""
    rng = np.random.default_rng(n_bits)
    vals = rng.integers(0, (1 << n_bits) if n_bits else 1, size=(3, tc.PACK_BLOCK))
    bw = jc.BitWriter()
    for row in vals:
        bw.write_many(row, n_bits)
    want = bw.array().view("<u4")[: 3 * 4 * n_bits]
    got = tc._pack_fields(vals, n_bits)
    assert got.dtype == np.uint32 and got.shape == (3, 4 * n_bits)
    assert np.array_equal(got.reshape(-1), want)
    assert np.array_equal(tc._unpack_fields(got, n_bits), vals)


def test_pack_rejects_unknown_codec():
    with pytest.raises(ValueError):
        tc.pack_postings(np.arange(10), "vbyte", device="cpu")
