"""``QACFrontend(postings_codec=...)`` of the port against the JAX package's
frontend with the same codec and ``heap_kernel=True``, its kernels in
interpret mode: both engines through the compressed postings, on a mixed
batch with empty suffix ranges, for "ef" and "bitpack". Every route of the
port, and its raw route, give the same docids; ``describe_route`` gives the
JAX package's strings. Every comparison is exact."""
import dataclasses

import numpy as np
import pytest

from repro.core import parse_queries as jax_parse
from repro.serve import QACFrontend as JaxFrontend
from repro_torch.core import parse_queries
from repro_torch.kernels.heap_topk import ops as heap_ops
from repro_torch.kernels.intersect import ops as isect_ops
from repro_torch.serve import QACFrontend

from _torch_pairs import build_pair, partials, with_codec

INF = 2**31 - 1


@pytest.fixture(scope="module")
def corpus():
    jq, _, kept = build_pair(600, 150, seed=5, postings_codec="ef")
    rng = np.random.default_rng(21)
    batch = partials(kept, rng, 14, 50, pct_garbage=15) + ["zzzzzzqx", ""]
    return jq, kept, batch


@pytest.mark.parametrize("codec", ["ef", "bitpack"])
def test_packed_frontend_equals_jax(corpus, codec):
    jq, kept, batch = corpus
    jq, tq = with_codec(jq, codec)
    jfe = JaxFrontend(jq, k=10, use_kernel=True, interpret=True,
                      heap_kernel=True, postings_codec=codec)
    jp = jax_parse(jq.dictionary, batch)
    want = np.asarray(jfe.complete(jp[0], jp[1], jp[3], jp[4]))
    assert (want == INF).all(axis=1).any() and (want < INF).any()
    tp = parse_queries(tq.dictionary, batch)
    counts = (heap_ops.launches, heap_ops.packed_launches, isect_ops.launches,
              isect_ops.packed_launches)
    for kw in (dict(use_kernel=True), dict(), dict(use_kernel=True, heap_kernel=False)):
        fe = QACFrontend(tq, k=10, postings_codec=codec, **kw)
        got = fe.complete(tp[0], tp[1], tp[3], tp[4])
        np.testing.assert_array_equal(got, want, err_msg=str(kw))
        if kw == dict(use_kernel=True):
            for engine in ("single", "multi"):
                assert fe.describe_route(engine) == jfe.describe_route(engine)
            assert fe.describe_route("multi") == "intersect[packed]"
            assert fe.describe_route("single") == f"heap_topk[{codec}]"
            assert fe.stats == jfe.stats
    # CPU tensors: every wrapper ran its plain version
    assert counts == (heap_ops.launches, heap_ops.packed_launches,
                      isect_ops.launches, isect_ops.packed_launches)
    raw = QACFrontend(tq, k=10, use_kernel=True)
    np.testing.assert_array_equal(raw.complete(tp[0], tp[1], tp[3], tp[4]), want)
    assert raw.describe_route("multi") == "intersect[raw]"
    ks = np.random.default_rng(5).choice([1, 3, 10, 16], size=len(batch))
    fe = QACFrontend(tq, k=10, postings_codec=codec, use_kernel=True)
    np.testing.assert_array_equal(fe.complete(tp[0], tp[1], tp[3], tp[4], k=ks),
                                  raw.complete(tp[0], tp[1], tp[3], tp[4], k=ks))


def test_frontend_codec_must_match_the_index(corpus):
    jq, _, _ = corpus
    _, tq = with_codec(jq, "ef")
    with pytest.raises(ValueError, match="packed as"):
        QACFrontend(tq, postings_codec="bitpack")
    bare = dataclasses.replace(tq, index=dataclasses.replace(tq.index, packed=None))
    with pytest.raises(ValueError, match="no packed postings"):
        QACFrontend(bare, postings_codec="ef")
    with pytest.raises(ValueError):
        QACFrontend(tq, postings_codec="vbyte")
    for codec in (None, "auto", "raw"):
        fe = QACFrontend(bare, postings_codec=codec, use_kernel=True)
        assert (fe.describe_route("single"), fe.describe_route("multi")) == (
            "heap_topk[raw]", "intersect[raw]")
