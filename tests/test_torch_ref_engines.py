"""The port's host references against the JAX package's on one seeded
corpus: ``HostIndex`` (the paper's Heap, Fwd and single-term engines and
the brute-force oracles), ``HybIndex`` (Bast-Weber HYB), and
``FrontCodedStore`` on the CPU (``extract``, ``locate``, ``locate_prefix``,
``encoded_bytes``, ``space_bytes``), bit for bit."""
import jax
import numpy as np
import pytest
import torch
from _torch_pairs import host

from repro.core.builder import build_corpus as jax_build_corpus
from repro.core.fc import FrontCodedStore as JaxFC
from repro.core.ref_engines import HostIndex as JaxHost, HybIndex as JaxHyb
from repro.core.strings import encode_strings as jenc
from repro.text import SynthLogConfig, generate_query_log
from repro_torch.core.fc import FrontCodedStore
from repro_torch.core.ref_engines import HostIndex, HybIndex


@pytest.fixture(scope="module")
def kept():
    qs, _ = generate_query_log(SynthLogConfig(n_queries=1500, vocab_size=120,
                                              mean_term_chars=4.0, seed=4))
    return sorted({" ".join(q.split()) for q in qs})


@pytest.fixture(scope="module")
def hosts(kept):
    _, rows, sc, _ = jax_build_corpus(kept, np.arange(len(kept), 0, -1, dtype=np.float64))
    order = np.lexsort(tuple(rows[:, j] for j in range(rows.shape[1] - 1, -1, -1)) + (-sc,))
    doc_of_row = np.empty(len(rows), np.int32)
    doc_of_row[order] = np.arange(len(rows), dtype=np.int32)
    n_terms = int(rows.max())
    return (JaxHost(rows, doc_of_row, n_terms), HostIndex(rows, doc_of_row, n_terms))


def test_host_and_hyb_indexes_equal_jax(hosts):
    jh, th = hosts
    assert th.lists == jh.lists and np.array_equal(th.fwd, jh.fwd)
    assert np.array_equal(th.docids, jh.docids)
    rng = np.random.default_rng(3)
    jy, ty = JaxHyb(jh, c=0.05), HybIndex(th, c=0.05)
    assert ty.space_bytes() == jy.space_bytes() and len(ty.blocks) == len(jy.blocks)
    nonempty = 0
    for _ in range(60):
        prefix = list(rng.integers(1, th.n_terms + 1, int(rng.integers(0, 3))))
        lo = int(rng.integers(1, th.n_terms + 1))
        hi = int(rng.integers(lo, min(lo + 30, th.n_terms + 2)))
        for name in ("brute_conjunctive", "brute_prefix_search", "heap_conjunctive",
                     "fwd_conjunctive"):
            got = getattr(th, name)(prefix, lo, hi, 10)
            assert got == getattr(jh, name)(prefix, lo, hi, 10), name
        assert ty.conjunctive(prefix, lo, hi, 10) == jy.conjunctive(prefix, lo, hi, 10)
        assert th.single_term_classic(lo, hi, 10) == jh.single_term_classic(lo, hi, 10)
        assert th.single_term_rmq(lo, hi, 10) == jh.single_term_rmq(lo, hi, 10)
        nonempty += bool(th.fwd_conjunctive(prefix, lo, hi, 10))
    assert nonempty > 10


@pytest.mark.parametrize("bucket,max_chars", [(16, 64), (4, 12)])
def test_front_coded_store_equals_jax(kept, bucket, max_chars):
    strings = sorted(set(kept))[:600]
    jfc = JaxFC.build(strings, bucket_size=bucket, max_chars=max_chars)
    tfc = FrontCodedStore.build(strings, bucket_size=bucket, max_chars=max_chars,
                                device="cpu")
    assert tfc.encoded_bytes() == jfc.encoded_bytes()
    assert tfc.space_bytes() == jfc.space_bytes()
    ids = np.arange(-2, len(strings) + 3, dtype=np.int32)
    assert np.array_equal(host(tfc.extract(torch.from_numpy(ids))),
                          host(jax.jit(jfc.extract)(ids)))
    rng = np.random.default_rng(bucket)
    probes = [strings[int(i)] for i in rng.integers(0, len(strings), 16)]
    probes += [s[: int(rng.integers(1, len(s) + 1))] for s in probes[:10]]
    probes += ["", "zzzz", "a", strings[0], strings[-1] + "z"]
    chars = jenc(probes, max_chars)
    lens = np.asarray([min(len(p.encode()), max_chars) for p in probes], np.int32)
    got = host(tfc.locate(torch.from_numpy(chars)))
    assert np.array_equal(got, host(jax.jit(jfc.locate)(chars))) and (got >= 0).sum() > 12
    tl, tr = tfc.locate_prefix(torch.from_numpy(chars), torch.from_numpy(lens))
    jl, jr = jax.jit(jfc.locate_prefix)(chars, lens)
    assert np.array_equal(host(tl), host(jl)) and np.array_equal(host(tr), host(jr))
    assert (host(tr) - host(tl) > 1).any()
