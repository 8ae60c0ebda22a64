"""The port's single-term engine against the JAX package: the plain
``heap_topk_ref`` against JAX's ``heap_topk_ref`` (``out`` and ``done``),
and every route of ``single_term_topk_bounded_batch`` against JAX's, over
empty, inverted and full term ranges and duplicate-docid trip starvation."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core.search import single_term_topk_bounded_batch as jax_bounded
from repro.kernels.heap_topk.ref import heap_topk_ref as jax_heap_ref
from repro_torch.core import parse_queries
from repro_torch.core.search import single_term_topk_bounded_batch
from repro_torch.kernels.heap_topk import ops as heap_ops
from repro_torch.kernels.heap_topk.ref import heap_topk_ref
from repro_torch.kernels.rmq import ops as rmq_ops

from _torch_pairs import build_pair, host, partials


@pytest.fixture(scope="module")
def pair():
    # small vocab => heavy term co-occurrence => duplicate docids across the
    # lists of a suffix range (the dedup / trip-starvation stressor)
    jq, tq, kept = build_pair(500, 80, seed=9)
    rng = np.random.default_rng(0)
    _, _, _, suf, slen = parse_queries(tq.dictionary,
                                       partials(kept, rng, 90, 100, 25))
    tl, th = tq.dictionary.locate_prefix(suf, slen)
    V = tq.index.n_terms
    extra_lo = torch.tensor([1, 5, 7, 0, V, V + 1, 3], dtype=torch.int32)
    extra_hi = torch.tensor([V + 1, 3, 7, 2, V + 1, V + 2, 4], dtype=torch.int32)
    return jq, tq, torch.cat([tl, extra_lo]), torch.cat([th, extra_hi])


CASES = [(k, t) for k in (1, 10, 16) for t in (k + 2, 2 * k)]


@pytest.mark.parametrize("k,trips", CASES)
def test_plain_heap_topk_equals_jax(pair, k, trips):
    jq, tq, tl, th = pair
    rm, idx = tq.rmq_minimal, tq.index
    out, done = heap_topk_ref(rm.values, rm.st_pos, rm.ib, idx.offsets,
                              idx.postings, tl, th, k=k, trips=trips, n=rm.n,
                              n_terms=idx.n_terms)
    jrm, jidx = jq.rmq_minimal, jq.index
    ref = jax.jit(functools.partial(jax_heap_ref, k=k, trips=trips, n=jrm.n,
                                    n_terms=jidx.n_terms))
    want_out, want_done = ref(jrm.values, jrm.st_pos, jrm.ib, jidx.offsets,
                              jidx.postings, tl.numpy(), th.numpy())
    assert np.array_equal(out.numpy(), host(want_out))
    assert np.array_equal(done.numpy(), host(want_done))
    if k > 1 and trips == k + 2:
        assert not done.all()       # the corpus starves some lane's budget


@pytest.mark.parametrize("k,trips", [(10, 12), (10, 20), (16, 18), (16, 32)])
def test_every_route_equals_jax_engine(pair, k, trips):
    jq, tq, tl, th = pair
    want_out, want_done = jax.jit(functools.partial(
        jax_bounded, k=k, trips=trips, use_kernel=False))(
        jq.index, jq.rmq_minimal, tl.numpy(), th.numpy())
    counts = (heap_ops.launches, rmq_ops.launches)
    for kw in (dict(use_kernel=False), dict(use_kernel=True),
               dict(use_kernel=True, heap_kernel=False)):
        out, done = single_term_topk_bounded_batch(
            tq.index, tq.rmq_minimal, tl, th, k, trips, **kw)
        assert np.array_equal(out.numpy(), host(want_out)), kw
        assert np.array_equal(done.numpy(), host(want_done)), kw
    # CPU tensors: the wrappers ran their plain versions, no kernel launched
    assert (heap_ops.launches, rmq_ops.launches) == counts
