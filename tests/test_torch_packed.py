"""The port's compressed-postings path against the JAX package, for both
codecs: the plain packed ``heap_topk`` against JAX's Pallas kernel in
interpret mode (``out`` and ``done``), the plain packed ``conjunctive_scan``
against JAX's ``conjunctive_scan_packed`` kernel in interpret mode, both
engines under ``postings_codec`` against JAX's raw engines, the plain
packed top-k engine (``conjunctive_topk_packed_ref``, through the CPU
wrapper) against JAX's engine at several tiles, caps and k, and the codec
checks. Every comparison is exact."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.search import (conjunctive_multi_batch as jax_multi,
                               single_term_topk_bounded_batch as jax_bounded)
from repro.kernels.heap_topk.ops import heap_topk as jax_heap_topk
from repro.kernels.intersect.ops import conjunctive_scan_packed as jax_scan_packed
from repro_torch.core import parse_queries
from repro_torch.core.search import (conjunctive_lanes, conjunctive_multi_batch,
                                     describe_single_route,
                                     single_term_topk_bounded_batch)
from repro_torch.kernels.heap_topk import ops as heap_ops
from repro_torch.kernels.intersect import ops as isect_ops
from repro_torch.kernels.intersect.ref import conjunctive_topk_packed_ref, fwd_rows_of
from repro_torch.serve import QACFrontend

from _torch_pairs import build_pair, host, jax_multi_answers, partials, with_codec, without_list

INF = 2**31 - 1
CODECS = ("ef", "bitpack")


@pytest.fixture(scope="module")
def single():
    # small vocab => heavy co-occurrence => duplicate docids across the lists
    # of a suffix range, and long lists => EF blocks
    jq, _, kept = build_pair(500, 80, seed=9, postings_codec="ef")
    rng = np.random.default_rng(0)
    pairs = {c: with_codec(jq, c) for c in CODECS}
    tq = pairs["ef"][1]
    _, _, _, suf, slen = parse_queries(tq.dictionary, partials(kept, rng, 45, 100, 25))
    tl, th = tq.dictionary.locate_prefix(suf, slen)
    V = tq.index.n_terms
    tl = torch.cat([tl, torch.tensor([1, 5, 0], dtype=torch.int32)])
    th = torch.cat([th, torch.tensor([V + 1, 3, 2], dtype=torch.int32)])
    assert (tq.index.packed.meta >> 6).any(), "expected EF blocks"
    return pairs, tl, th


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("trips", [3, 12])
def test_plain_packed_heap_topk_equals_jax_kernel(single, codec, trips):
    pairs, tl, th = single
    jq, tq = pairs[codec]
    rm, idx = tq.rmq_minimal, tq.index
    before = heap_ops.packed_launches
    out, done = heap_ops.heap_topk_packed(
        rm.values, rm.st_pos, rm.ib, idx.offsets, idx.packed, tl, th, k=10,
        trips=trips, n=rm.n, n_terms=idx.n_terms)
    assert heap_ops.packed_launches == before     # CPU: the plain version
    jrm, jidx = jq.rmq_minimal, jq.index
    want_out, want_done = jax_heap_topk(
        jrm.values, jrm.st_pos, jrm.ib, jidx.offsets, jidx.postings,
        jnp.asarray(tl.numpy()), jnp.asarray(th.numpy()), k=10, trips=trips,
        n=jrm.n, n_terms=jidx.n_terms, use_kernel=True, interpret=True,
        packed=jidx.packed)
    assert np.array_equal(out.numpy(), host(want_out))
    assert np.array_equal(done.numpy(), host(want_done))
    raw_out, raw_done = heap_ops.heap_topk(
        rm.values, rm.st_pos, rm.ib, idx.offsets, idx.postings, tl, th, k=10,
        trips=trips, n=rm.n, n_terms=idx.n_terms)
    assert torch.equal(out, raw_out) and torch.equal(done, raw_done)


@pytest.mark.parametrize("codec", CODECS)
def test_single_term_engine_routes_under_codec(single, codec):
    pairs, tl, th = single
    jq, tq = pairs[codec]
    k, trips = 10, 12
    want_out, want_done = jax.jit(functools.partial(
        jax_bounded, k=k, trips=trips, use_kernel=False))(
        jq.index, jq.rmq_minimal, tl.numpy(), th.numpy())
    routes = {(False, None): "torch_ref", (True, None): f"heap_topk[{codec}]",
              (True, False): "per_pop_rmq[kernel]"}
    for (use_kernel, heap_kernel), route in routes.items():
        assert describe_single_route(use_kernel=use_kernel, heap_kernel=heap_kernel,
                                     postings_codec=codec) == route
        out, done = single_term_topk_bounded_batch(
            tq.index, tq.rmq_minimal, tl, th, k, trips, use_kernel=use_kernel,
            heap_kernel=heap_kernel, postings_codec=codec)
        assert np.array_equal(out.numpy(), host(want_out)), route
        assert np.array_equal(done.numpy(), host(want_done)), route
    other = "bitpack" if codec == "ef" else "ef"
    with pytest.raises(ValueError, match="packed as"):
        single_term_topk_bounded_batch(tq.index, tq.rmq_minimal, tl, th, k, trips,
                                       postings_codec=other)
    bare = dataclasses.replace(tq.index, packed=None)
    with pytest.raises(ValueError, match="no packed postings"):
        single_term_topk_bounded_batch(bare, tq.rmq_minimal, tl, th, k, trips,
                                       postings_codec=codec)


@pytest.fixture(scope="module")
def multi():
    jq, _, kept = build_pair(600, 150, seed=5, postings_codec="ef")
    pairs = {c: with_codec(jq, c) for c in CODECS}
    rng = np.random.default_rng(1)
    batch = partials(kept, rng, 24, pct_single=0, pct_garbage=10)
    batch += [kept[0].split()[0] + " " + kept[1].split()[0] + " ", "nosuch x"]
    return pairs, parse_queries(pairs["ef"][1].dictionary, batch)


@pytest.mark.parametrize("codec", CODECS)
def test_plain_packed_scan_equals_jax_kernel(multi, codec):
    pairs, (pids, plen, _, suf, slen) = multi
    jq, tq = pairs[codec]
    rng = np.random.default_rng(2)
    idx = tq.index
    tl, th = tq.dictionary.locate_prefix(suf, slen)
    starts, ends = idx.list_bounds(pids)
    P = 3
    need = torch.arange(P)[None, :] < plen[:, None]
    starts = torch.where(need, starts[:, :P], 0)
    ends = torch.where(need, ends[:, :P], 0)
    B, T = pids.shape[0], 128
    post = idx.postings.numpy()
    cands = post[rng.integers(0, len(post), (B, T))].astype(np.int32)
    cands[:, -3:] = INF
    cands[0, :4] = [0, -1, 10**6, INF - 1]
    tc_ = torch.from_numpy(cands)
    fwd = tq.completions.fwd_terms
    iters = int((ends - starts).max()).bit_length() + 1
    before = isect_ops.packed_launches
    got = isect_ops.conjunctive_scan_packed(tc_, starts, ends, idx.packed, fwd,
                                            tl, th, iters=iters)
    assert isect_ops.packed_launches == before
    want = jax_scan_packed(cands, starts.numpy(), ends.numpy(),
                           fwd_rows_of(fwd, tc_).numpy(), tl.numpy(), th.numpy(),
                           jq.index.packed, use_kernel=True, interpret=True,
                           probe_iters=iters)
    assert np.array_equal(got.numpy(), host(want))
    assert got.any() and not got.all()
    raw = isect_ops.conjunctive_scan(tc_, starts, ends, idx.postings, fwd, tl,
                                     th, iters=iters)
    assert torch.equal(got, raw)


@pytest.mark.parametrize("codec", CODECS)
def test_multi_term_engine_under_codec(multi, codec):
    pairs, (pids, plen, _, suf, slen) = multi
    jq, tq = pairs[codec]
    tl, th = tq.dictionary.locate_prefix(suf, slen)
    lp = QACFrontend(tq)._multi_list_pad(pids.numpy(), plen.numpy())
    want = jax.jit(functools.partial(
        jax_multi, k=10, tile=16, use_kernel=False, probe_iters=lp.bit_length()))(
        jq.index, jq.completions, pids.numpy(), plen.numpy(), tl.numpy(), th.numpy())
    for use_kernel in (False, True):
        got = conjunctive_multi_batch(tq.index, tq.completions, pids, plen, tl,
                                      th, 10, tile=16, use_kernel=use_kernel,
                                      probe_iters=lp.bit_length(),
                                      postings_codec=codec)
        assert np.array_equal(got.numpy(), host(want)), use_kernel
    assert (got.numpy() < INF).any() and (got.numpy() == INF).any()
    bare = dataclasses.replace(tq.index, packed=None)
    with pytest.raises(ValueError, match="no packed postings"):
        conjunctive_multi_batch(bare, tq.completions, pids, plen, tl, th, 10,
                                postings_codec=codec)


@pytest.fixture(scope="module")
def packed_topk(multi):
    """The multi batch plus a repeated-term lane, on a stripe of the "ef"
    index that holds none of that term's postings (the lane is dead), each
    codec's port copy of it, and the JAX engine's answers by (k, tile,
    max_tiles)."""
    pairs, (pids, plen, _, suf, slen) = multi
    row = int(torch.nonzero(plen >= 1)[0, 0])
    pids = torch.cat([pids, pids[row:row + 1]])
    pids[-1, 1] = pids[-1, 0]
    plen = torch.cat([plen, torch.tensor([2], dtype=plen.dtype)])
    suf, slen = torch.cat([suf, suf[row:row + 1]]), torch.cat([slen, slen[row:row + 1]])
    jq, _ = without_list(pairs["ef"][0], int(pids[-1, 0]))
    tqs = {c: with_codec(jq, c)[1] for c in CODECS}
    tl, th = tqs["ef"].dictionary.locate_prefix(suf, slen)
    iters = QACFrontend(tqs["ef"])._multi_list_pad(pids.numpy(), plen.numpy()).bit_length()
    want = jax_multi_answers(jq, pids, plen, tl, th, iters)
    return tqs, (pids, plen, tl, th), iters, want


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("k,tile,max_tiles", [(k, tile, max_tiles) for tile, max_tiles in
                                              [(16, 4096), (128, 4096), (8, 2)]
                                              for k in (1, 10, 128)])
def test_plain_packed_topk_equals_jax_engine(packed_topk, codec, k, tile, max_tiles):
    tqs, (pids, plen, tl, th), iters, want = packed_topk
    tq = tqs[codec]
    lanes = conjunctive_lanes(tq.index, pids, plen, tl, th)
    assert bool(lanes[4][-1]) and not bool(lanes[4].all())
    before = (isect_ops.packed_launches, isect_ops.topk_packed_launches)
    got = isect_ops.conjunctive_topk_packed(
        tq.index.postings, tq.index.packed, *lanes, tq.completions.fwd_terms, tl, th,
        k=k, tile=tile, max_tiles=max_tiles, iters=iters)
    assert (isect_ops.packed_launches, isect_ops.topk_packed_launches) == before
    plain = conjunctive_topk_packed_ref(
        tq.index.postings, tq.index.packed, *lanes, tq.completions.fwd_terms, tl, th,
        k=k, tile=tile, max_tiles=max_tiles, iters=iters)
    assert torch.equal(got, plain)
    assert np.array_equal(got.numpy(), want(k, tile, max_tiles))
    assert (got[-1] == INF).all() and (got < INF).any()
