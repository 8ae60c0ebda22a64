"""The port's multi-term engine against the JAX package: the span-form
plain ``conjunctive_scan_ref`` against JAX's ``conjunctive_scan_ref`` on
probe lists gathered from the same spans, ``conjunctive_multi_batch``
against JAX's at the probe depths the frontend passes with and without
per-sub-batch list-pad specialisation, and the plain top-k engine
(``conjunctive_topk_ref``, through the CPU wrapper) against JAX's engine
at several tiles, caps and k, bit-identical."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core.search import conjunctive_multi_batch as jax_multi
from repro.kernels.intersect.ref import conjunctive_scan_ref as jax_scan_ref
from repro_torch.core import parse_queries
from repro_torch.core.search import conjunctive_lanes, conjunctive_multi_batch
from repro_torch.kernels.intersect import ops as isect_ops
from repro_torch.kernels.intersect.ref import (conjunctive_scan_ref, conjunctive_topk_ref,
                                               fwd_rows_of)
from repro_torch.serve import QACFrontend

from _torch_pairs import build_pair, host, jax_multi_answers, partials, without_list

INF = 2**31 - 1


@pytest.fixture(scope="module")
def pair():
    jq, tq, kept = build_pair(600, 150, seed=5)
    rng = np.random.default_rng(1)
    batch = partials(kept, rng, 30, pct_single=0, pct_garbage=10)
    batch += [kept[0].split()[0] + " " + kept[1].split()[0] + " ", "nosuch x",
              " ".join(kept[2].split()[:1] * 3)]
    return jq, tq, parse_queries(tq.dictionary, batch)


def test_span_scan_equals_jax_list_scan(pair):
    jq, tq, (pids, plen, _, suf, slen) = pair
    rng = np.random.default_rng(2)
    idx = tq.index
    tl, th = tq.dictionary.locate_prefix(suf, slen)
    starts, ends = idx.list_bounds(pids)
    need = (torch.arange(pids.shape[1])[None, :] < plen[:, None]) & \
        torch.from_numpy(rng.random(pids.shape) < 0.8)
    starts = torch.where(need, starts, 0)
    ends = torch.where(need, ends, 0)
    B, T = pids.shape[0], 24
    post = idx.postings.numpy()
    cands = post[rng.integers(0, len(post), (B, T))].astype(np.int32)
    cands[:, -3:] = INF
    cands[0, :4] = [0, -1, 10**6, INF - 1]
    L = 1 << int(max(1, (ends - starts).max().item()) - 1).bit_length()
    s, e = starts.numpy(), ends.numpy()
    lists = np.full((B, pids.shape[1], L), INF, np.int32)
    for b in range(B):
        for p in range(pids.shape[1]):
            lists[b, p, : e[b, p] - s[b, p]] = post[s[b, p]:e[b, p]]
    tc = torch.from_numpy(cands)
    fwd = tq.completions.fwd_terms
    got = conjunctive_scan_ref(tc, starts, ends, idx.postings, fwd, tl, th,
                               iters=L.bit_length())
    rows = fwd_rows_of(fwd, tc)
    want = jax_scan_ref(cands, lists, (ends - starts).numpy(), rows.numpy(),
                        tl.numpy(), th.numpy())
    assert np.array_equal(got.numpy(), host(want))
    assert got.any() and not got.all()
    want_rows = jax.vmap(jax.vmap(lambda d: jq.completions.extract(d)[0]))(cands)
    assert np.array_equal(rows.numpy(), host(want_rows))


@pytest.mark.parametrize("specialize,tile,max_tiles", [(True, 16, 4096),
                                                       (False, 128, 4096),
                                                       (True, 8, 2)])
def test_multi_engine_equals_jax(pair, specialize, tile, max_tiles):
    jq, tq, (pids, plen, _, suf, slen) = pair
    fe = QACFrontend(tq, specialize_list_pad=specialize)
    lp = fe._multi_list_pad(pids.numpy(), plen.numpy())
    if not specialize:
        assert lp == fe.list_pad
    tl, th = tq.dictionary.locate_prefix(suf, slen)
    k = 10
    want = jax.jit(functools.partial(
        jax_multi, k=k, tile=tile, max_tiles=max_tiles, use_kernel=False,
        probe_iters=lp.bit_length()))(
        jq.index, jq.completions, pids.numpy(), plen.numpy(), tl.numpy(), th.numpy())
    before = isect_ops.launches
    for use_kernel in (False, True):
        got = conjunctive_multi_batch(tq.index, tq.completions, pids, plen, tl,
                                      th, k, tile=tile, max_tiles=max_tiles,
                                      use_kernel=use_kernel,
                                      probe_iters=lp.bit_length())
        assert np.array_equal(got.numpy(), host(want)), use_kernel
    assert isect_ops.launches == before
    assert (got.numpy() < INF).any() and (got.numpy() == INF).any()


@pytest.fixture(scope="module")
def topk_batch(pair):
    """The pair's batch on a stripe of its index that holds none of the
    postings of the repeated-term query's term: that lane needs an empty list
    (dead); the batch's bad lanes are a suffix matching no term and an
    unknown prefix term. With the JAX engine's answers by (k, tile,
    max_tiles)."""
    jq, _, (pids, plen, _, suf, slen) = pair
    jq, tq = without_list(jq, int(pids[-1, 0]))
    tl, th = tq.dictionary.locate_prefix(suf, slen)
    iters = QACFrontend(tq)._multi_list_pad(pids.numpy(), plen.numpy()).bit_length()
    want = jax_multi_answers(jq, pids, plen, tl, th, iters)
    return tq, (pids, plen, tl, th), iters, want


TOPK_CASES = [(k, tile, max_tiles) for tile, max_tiles in [(16, 4096), (128, 4096), (8, 2)]
              for k in (1, 10, 128)]


@pytest.mark.parametrize("k,tile,max_tiles", TOPK_CASES)
def test_plain_topk_equals_jax_engine(topk_batch, k, tile, max_tiles):
    tq, (pids, plen, tl, th), iters, want = topk_batch
    lanes = conjunctive_lanes(tq.index, pids, plen, tl, th)
    assert bool(lanes[4][-1]) and bool(lanes[4][:-1].any()) and not bool(lanes[4].all())
    before = (isect_ops.launches, isect_ops.topk_launches)
    got = isect_ops.conjunctive_topk(tq.index.postings, *lanes, tq.completions.fwd_terms,
                                     tl, th, k=k, tile=tile, max_tiles=max_tiles,
                                     iters=iters)
    assert (isect_ops.launches, isect_ops.topk_launches) == before   # CPU: the plain version
    plain = conjunctive_topk_ref(tq.index.postings, *lanes, tq.completions.fwd_terms,
                                 tl, th, k=k, tile=tile, max_tiles=max_tiles, iters=iters)
    assert torch.equal(got, plain)
    assert np.array_equal(got.numpy(), want(k, tile, max_tiles))
    assert (got[-1] == INF).all() and (got < INF).any()


@pytest.mark.parametrize("k", [10, 128])
@pytest.mark.parametrize("caps", [((8, 64), (16, 32), (128, 4)), ((2, 16), (8, 4), (32, 1))])
def test_cap_not_tile_defines_the_answer(topk_batch, k, caps):
    """JAX's engine at equal max_tiles * tile gives one answer whatever the
    tile: the fact a kernel that walks the candidates in its own chunks
    rests on. The second set's cap (32) cuts some driver lists."""
    tq, (pids, plen, tl, th), _, want = topk_batch
    answers = [want(k, tile, max_tiles) for tile, max_tiles in caps]
    for a in answers[1:]:
        assert np.array_equal(a, answers[0])
    cap = caps[0][0] * caps[0][1]
    d_start, d_end, *_ = conjunctive_lanes(tq.index, pids, plen, tl, th)
    if cap < int((d_end - d_start).max()):
        assert not np.array_equal(answers[0], want(k, 128, 4096))
