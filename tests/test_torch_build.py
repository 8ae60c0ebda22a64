"""The port's host build against the JAX package: the same log, the same
index arrays (np.array_equal, dtype included), the same parsed batches, and
the array bridge between the two."""
import numpy as np
import pytest
import torch

from repro.core import build_qac_index as jax_build, parse_queries as jax_parse
from repro.text import SynthLogConfig as JaxCfg, generate_query_log as jax_log
from repro_torch.convert import qac_index_from_arrays
from repro_torch.core import build_qac_index, parse_queries
from repro_torch.text import SynthLogConfig, generate_query_log

from _torch_pairs import host, partials, qac_index_to_arrays

CORPORA = [dict(n_queries=600, vocab_size=150, mean_term_chars=4.0, seed=5),
           dict(n_queries=500, vocab_size=80, mean_term_chars=4.0, seed=9),
           dict(n_queries=300, vocab_size=2000, seed=1)]


@pytest.fixture(scope="module", params=range(len(CORPORA)))
def both(request):
    cfg = CORPORA[request.param]
    qs, sc = jax_log(JaxCfg(**cfg))
    jq, jkept, _ = jax_build(qs, sc)          # both default to "ef" postings
    tq, tkept, tsc = build_qac_index(qs, sc, device="cpu")
    return cfg, qs, sc, jq, jkept, tq, tkept


def test_query_log_is_the_same(both):
    cfg, qs, sc, *_ = both
    tqs, tsc = generate_query_log(SynthLogConfig(**cfg))
    assert tqs == qs
    assert np.array_equal(tsc, sc) and tsc.dtype == sc.dtype


def test_every_index_array_equals_jax(both):
    _, _, _, jq, jkept, tq, tkept = both
    assert tkept == jkept
    ja, jm = qac_index_to_arrays(jq)
    ta, tm = qac_index_to_arrays(tq)
    assert sorted(ja) == sorted(ta) and len(ta) == 19     # 4 packed arrays
    for key in ja:
        assert ta[key].dtype == ja[key].dtype, key
        assert np.array_equal(ta[key], ja[key]), key
    assert tm == jm


def test_parse_queries_equals_jax(both):
    _, _, _, jq, jkept, tq, _ = both
    rng = np.random.default_rng(3)
    batch = partials(jkept, rng, 40, pct_single=40, pct_garbage=15)
    batch += ["", " ", jkept[0] + " ", "a\tb", "nosuchterm x"]
    for want, got in zip(jax_parse(jq.dictionary, batch),
                         parse_queries(tq.dictionary, batch)):
        assert host(got).dtype == host(want).dtype
        assert np.array_equal(host(got), host(want))


def test_dictionary_lookups_equal_jax(both):
    _, _, _, jq, _, tq, _ = both
    rng = np.random.default_rng(4)
    V = jq.dictionary.n_terms
    chars = np.asarray(jq.dictionary.chars)
    lens = rng.integers(0, 6, 64).astype(np.int32)
    rows = chars[rng.integers(0, V, 64)].copy()
    rows[5] = 0
    rows[6, :3] = 255
    got_l, got_r = tq.dictionary.locate_prefix(torch.from_numpy(rows), torch.from_numpy(lens))
    want_l, want_r = jq.dictionary.locate_prefix(rows, lens)
    assert np.array_equal(host(got_l), host(want_l))
    assert np.array_equal(host(got_r), host(want_r))
    ids = np.concatenate([np.arange(-1, V + 2), rng.integers(0, V + 1, 20)]).astype(np.int32)
    assert np.array_equal(host(tq.dictionary.extract(torch.from_numpy(ids))),
                          host(jq.dictionary.extract(ids)))
    assert np.array_equal(host(tq.dictionary.locate(torch.from_numpy(rows))),
                          host(jq.dictionary.locate(rows)))


def test_arrays_round_trip(both):
    _, _, _, jq, _, tq, _ = both
    ja, jm = qac_index_to_arrays(jq)
    from_jax = qac_index_from_arrays(ja, jm, device="cpu")
    back, back_meta = qac_index_to_arrays(from_jax)
    again, _ = qac_index_to_arrays(qac_index_from_arrays(*qac_index_to_arrays(tq), device="cpu"))
    assert back_meta == jm
    for key in ja:
        assert np.array_equal(back[key], ja[key]) and back[key].dtype == ja[key].dtype
        assert np.array_equal(again[key], ja[key])
    assert from_jax.index.packed.codec == "ef"
    raw = {k: v for k, v in ja.items() if not k.startswith("index.packed.")}
    raw_meta = {k: v for k, v in jm.items() if not k.startswith("index.packed.")}
    assert qac_index_from_arrays(raw, raw_meta, device="cpu").index.packed is None
    with pytest.raises(KeyError):
        qac_index_from_arrays({**ja, "index.unknown": ja["index.postings"]}, jm, device="cpu")
    with pytest.raises(KeyError):
        qac_index_from_arrays({**raw, "index.packed": ja["index.postings"]},
                              raw_meta, device="cpu")
    with pytest.raises(KeyError):
        qac_index_from_arrays({k: v for k, v in ja.items() if k != "index.offsets"},
                              jm, device="cpu")
