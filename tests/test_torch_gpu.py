"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a card; run them on the
card with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_*.py``.
This file imports nothing of JAX (the card's machine need not have it):
the plain versions are the oracle, and they are held against the JAX
package by the CPU tests. The packed kernels run for both codecs: the
"ef" postings of ``build_qac_index`` and a "bitpack" packing of the same
lists. Integer outputs must be bit-identical; RMQ ``pos`` is compared
wherever ``val < INF``. ``fm_pairwise`` is float: rtol 1e-5 and atol 1e-6,
the atol scaled by the two sums the sum-square identity subtracts (as in
``test_torch_fm_pairwise.py``), unscaled at the models' embedding scale;
``fm_forward`` the same, plus in bf16 one bf16 unit in the last place for
each of its two roundings (the linear sum, then bias + lin).
``flash_attention`` is held to its plain version with the tolerances of
``tests/test_kernels.py``: rtol and atol 2e-5 in fp32, 2e-2 in bf16; the LM
at smoke width (fp32) to the plain route within rtol and atol 1e-4. The
backward kernels (``flash_attention_bwd``, ``fm_pairwise_bwd``) are held
norm-relative per gradient, 1e-4 in fp32 and 2e-2 in bf16 (attention), 1e-6
and 1e-2 (FM), with controls the attention check must reject; one LM and
one FM train step go through them against the plain route.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.core import build_qac_index, parse_queries
from repro_torch.configs import get_arch
from repro_torch.core.codecs import pack_postings
from repro_torch.data import recsys_batch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.fm_pairwise import ops as fm_ops
from repro_torch.kernels.fm_pairwise.ref import (clamp_rows, fm_forward_ref,
                                                 fm_pairwise_bwd_ref, fm_pairwise_ref)
from repro_torch.kernels.heap_topk import ops as heap_ops
from repro_torch.kernels.heap_topk.ref import heap_topk_ref
from repro_torch.kernels.intersect import ops as isect_ops
from repro_torch.core.search import conjunctive_lanes, conjunctive_multi_batch
from repro_torch.kernels.intersect.ref import (conjunctive_scan_packed_ref,
                                               conjunctive_scan_ref,
                                               conjunctive_topk_packed_ref,
                                               conjunctive_topk_ref)
from repro_torch.kernels.rmq import ops as rmq_ops
from repro_torch.kernels.rmq.ref import rmq_window_batch
from repro_torch.models.recsys import FMModel
from repro_torch.serve import QACFrontend
from repro_torch.serve.lm import greedy_generate, prefill_step
from repro_torch.text import SynthLogConfig, generate_query_log

INF = 2**31 - 1
pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def built():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    qs, sc = generate_query_log(SynthLogConfig(n_queries=3000, vocab_size=300,
                                               mean_term_chars=4.0, seed=3))
    qidx, kept, _ = build_qac_index(qs, sc, device="cuda")    # "ef" postings
    assert bool((qidx.index.packed.meta >> 6).any()), "expected EF blocks"
    return qidx, kept


def _packed(qidx, codec):
    if codec == "ef":
        return qidx.index.packed
    return pack_postings(qidx.index.postings.cpu().numpy(), codec, device="cuda")


def _partials(kept, rng, B, pct_single=50, pct_garbage=10):
    multis = [q for q in kept if len(q.split()) >= 2]
    out = []
    for _ in range(B):
        r = rng.integers(0, 100)
        if r < pct_garbage:
            out.append("zzzzzzqx")
        elif r < pct_garbage + pct_single:
            t = kept[rng.integers(0, len(kept))].split()[0]
            out.append(t[: rng.integers(1, len(t) + 1)])
        else:
            toks = multis[rng.integers(0, len(multis))].split()
            out.append(" ".join(toks[:-1] + [toks[-1][: rng.integers(1, len(toks[-1]) + 1)]]))
    return out


def test_rmq_kernel_matches_plain(built):
    qidx, _ = built
    rm = qidx.rmq_docids
    rng = np.random.default_rng(0)
    p = torch.tensor(rng.integers(-5, rm.n + 5, 4096), dtype=torch.int32, device="cuda")
    q = torch.tensor(rng.integers(-5, rm.n + 5, 4096), dtype=torch.int32, device="cuda")
    q[:512] = p[:512] + torch.tensor(rng.integers(0, 128, 512), dtype=torch.int32, device="cuda")
    before = rmq_ops.launches
    pos, val = rmq_ops.rmq_query(rm.values, rm.ib, rm.st_pos, p, q, n=rm.n)
    torch.cuda.synchronize()
    assert rmq_ops.launches == before + 1
    wpos, wval = rmq_window_batch(rm.values, rm.ib, rm.st_pos, p, q, n=rm.n)
    assert torch.equal(val, wval)
    live = wval < INF
    assert torch.equal(pos[live], wpos[live])


@pytest.mark.parametrize("k,trips", [(10, 12), (10, 20), (1, 2), (64, 66), (128, 256)])
def test_heap_topk_kernel_matches_plain(built, k, trips):
    qidx, kept = built
    rng = np.random.default_rng(k + trips)
    _, _, _, suf, slen = parse_queries(qidx.dictionary, _partials(kept, rng, 200, 100, 20))
    tl, th = qidx.dictionary.locate_prefix(suf, slen)
    tl = torch.cat([tl, torch.tensor([5, 1, 0], dtype=torch.int32, device="cuda")])
    th = torch.cat([th, torch.tensor([3, 1, qidx.index.n_terms + 1], dtype=torch.int32, device="cuda")])
    rm, idx = qidx.rmq_minimal, qidx.index
    args = (rm.values, rm.st_pos, rm.ib, idx.offsets, idx.postings, tl, th)
    kw = dict(k=k, trips=trips, n=rm.n, n_terms=idx.n_terms)
    out, done = heap_ops.heap_topk(*args, **kw)
    torch.cuda.synchronize()
    want_out, want_done = heap_topk_ref(*args, **kw)
    assert torch.equal(out, want_out)
    assert torch.equal(done, want_done)


@pytest.mark.parametrize("codec", ["ef", "bitpack"])
@pytest.mark.parametrize("k,trips", [(10, 12), (1, 2), (64, 128), (128, 256)])
def test_packed_heap_topk_kernel_matches_plain(built, codec, k, trips):
    qidx, kept = built
    pk = _packed(qidx, codec)
    rng = np.random.default_rng(k + trips + 1)
    _, _, _, suf, slen = parse_queries(qidx.dictionary, _partials(kept, rng, 200, 100, 20))
    tl, th = qidx.dictionary.locate_prefix(suf, slen)
    tl = torch.cat([tl, torch.tensor([5, 1, 0], dtype=torch.int32, device="cuda")])
    th = torch.cat([th, torch.tensor([3, 1, qidx.index.n_terms + 1], dtype=torch.int32, device="cuda")])
    rm, idx = qidx.rmq_minimal, qidx.index
    kw = dict(k=k, trips=trips, n=rm.n, n_terms=idx.n_terms)
    before = heap_ops.packed_launches
    out, done = heap_ops.heap_topk_packed(rm.values, rm.st_pos, rm.ib, idx.offsets,
                                          pk, tl, th, **kw)
    torch.cuda.synchronize()
    assert heap_ops.packed_launches == before + 1
    want_out, want_done = heap_topk_ref(rm.values, rm.st_pos, rm.ib, idx.offsets,
                                        None, tl, th, **kw, packed=pk)
    assert torch.equal(out, want_out)
    assert torch.equal(done, want_done)


@pytest.fixture(scope="module")
def dup_built():
    """The duplicate-heavy corpus of the CPU tests (``_torch_pairs.build_pair(
    500, 80, seed=9)``: the same log through the port's builder, which the
    CPU tests hold equal to JAX's): a small vocabulary, so one docid often
    sits in a range slot and an iterator slot at once and the first-minimum
    tie rule decides, and duplicate runs starve lanes of their trip budget.
    Its single-term ranges plus empty, inverted and whole-vocabulary ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    qs, sc = generate_query_log(SynthLogConfig(n_queries=500, vocab_size=80,
                                               mean_term_chars=4.0, seed=9))
    qidx, kept, _ = build_qac_index(qs, sc, device="cuda")
    rng = np.random.default_rng(0)
    _, _, _, suf, slen = parse_queries(qidx.dictionary, _partials(kept, rng, 90, 100, 25))
    tl, th = qidx.dictionary.locate_prefix(suf, slen)
    V = qidx.index.n_terms
    extra_lo = torch.tensor([1, 5, 7, 0, V, V + 1, 3], dtype=torch.int32, device="cuda")
    extra_hi = torch.tensor([V + 1, 3, 7, 2, V + 1, V + 2, 4], dtype=torch.int32, device="cuda")
    return qidx, torch.cat([tl, extra_lo]), torch.cat([th, extra_hi])


def _heap(qidx, codec, tl, th, k, trips, plain=False):
    """heap_topk (codec None) or heap_topk_packed, the kernel or its plain
    version, on these ranges."""
    rm, idx = qidx.rmq_minimal, qidx.index
    kw = dict(k=k, trips=trips, n=rm.n, n_terms=idx.n_terms)
    head = (rm.values, rm.st_pos, rm.ib, idx.offsets)
    if codec is None:
        fn = heap_topk_ref if plain else heap_ops.heap_topk
        return fn(*head, idx.postings, tl, th, **kw)
    pk = _packed(qidx, codec)
    if plain:
        return heap_topk_ref(*head, None, tl, th, **kw, packed=pk)
    return heap_ops.heap_topk_packed(*head, pk, tl, th, **kw)


@pytest.mark.parametrize("codec", [None, "ef", "bitpack"])
def test_heap_topk_kernel_keeps_the_tie_rule(dup_built, codec):
    """The duplicate-heavy corpus at the frontend's first budget (10, 12):
    equal docids in several slots, lanes cut short by their budget."""
    qidx, tl, th = dup_built
    counts = lambda: (heap_ops.launches, heap_ops.packed_launches)
    before = counts()
    out, done = _heap(qidx, codec, tl, th, 10, 12)
    torch.cuda.synchronize()
    assert counts() == ((before[0] + 1, before[1]) if codec is None
                        else (before[0], before[1] + 1))
    want_out, want_done = _heap(qidx, codec, tl, th, 10, 12, plain=True)
    assert torch.equal(out, want_out)
    assert torch.equal(done, want_done)
    assert not bool(want_done.all())        # some lane ran out of budget


@pytest.mark.parametrize("codec", [None, "ef", "bitpack"])
@pytest.mark.parametrize("B", [1, 3, 37, 130])
def test_heap_topk_kernel_at_any_batch(dup_built, codec, B):
    """B = 1, and batches that leave a block's last warps spare (the plan
    puts up to 4 lanes in a block)."""
    qidx, tl, th = dup_built
    rows = torch.arange(B, device="cuda") % tl.numel()
    assert B % heap_ops.plan_heap_launch(10, 20, B).warps or B == 1
    out, done = _heap(qidx, codec, tl[rows], th[rows], 10, 20)
    torch.cuda.synchronize()
    want_out, want_done = _heap(qidx, codec, tl[rows], th[rows], 10, 20, plain=True)
    assert torch.equal(out, want_out)
    assert torch.equal(done, want_done)


@pytest.mark.parametrize("codec", [None, "ef", "bitpack"])
def test_heap_topk_kernel_repeats_bit_for_bit(dup_built, codec):
    qidx, tl, th = dup_built
    first = _heap(qidx, codec, tl, th, 64, 128)
    second = _heap(qidx, codec, tl, th, 64, 128)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    want_out, want_done = _heap(qidx, codec, tl, th, 64, 128, plain=True)
    assert torch.equal(first[0], want_out) and torch.equal(first[1], want_done)


@pytest.mark.parametrize("codec", ["ef", "bitpack"])
def test_packed_lookup_in_kernel_matches_plain(built, codec):
    """Every pointer of the index through the packed scan: a one-slot span
    [p, p+1) holds candidate c iff lookup(p) == c."""
    qidx, _ = built
    pk = _packed(qidx, codec)
    idx = qidx.index
    n = idx.n_postings
    ptrs = torch.arange(n, dtype=torch.int32, device="cuda")
    want = pk.lookup(ptrs)
    assert torch.equal(want, idx.postings)
    B = ptrs.numel()
    starts = ptrs[:, None]
    fwd = qidx.completions.fwd_terms
    lo = torch.full((B,), -1, dtype=torch.int32, device="cuda")
    hi = torch.full((B,), 2**31 - 2, dtype=torch.int32, device="cuda")
    cands = torch.stack([want, want + 1], dim=1)
    got = isect_ops.conjunctive_scan_packed(cands, starts, starts + 1, pk, fwd, lo,
                                            hi, iters=2)
    torch.cuda.synchronize()
    plain = conjunctive_scan_packed_ref(cands, starts, starts + 1, pk, fwd, lo, hi,
                                        iters=2)
    assert torch.equal(got, plain)
    assert bool(got[:, 0].all()) and not bool(got[:, 1].any())


@pytest.mark.parametrize("codec", [None, "ef", "bitpack"])
def test_conjunctive_scan_kernel_matches_plain(built, codec):
    qidx, kept = built
    rng = np.random.default_rng(7)
    pids, plen, _, suf, slen = parse_queries(qidx.dictionary, _partials(kept, rng, 64, 0, 0))
    tl, th = qidx.dictionary.locate_prefix(suf, slen)
    idx = qidx.index
    starts, ends = idx.list_bounds(pids)
    need = torch.arange(pids.shape[1], device="cuda")[None, :] < plen[:, None]
    starts = torch.where(need, starts, 0)
    ends = torch.where(need, ends, 0)
    cands = idx.postings[torch.tensor(rng.integers(0, idx.n_postings, (64, 128)),
                                      device="cuda")]
    cands[:, -8:] = INF
    postings = idx.postings if codec is None else _packed(qidx, codec)
    args = (cands, starts, ends, postings, qidx.completions.fwd_terms, tl, th)
    iters = idx.n_postings.bit_length()
    if codec is None:
        got = isect_ops.conjunctive_scan(*args, iters=iters)
        want = conjunctive_scan_ref(*args, iters=iters)
    else:
        got = isect_ops.conjunctive_scan_packed(*args, iters=iters)
        want = conjunctive_scan_packed_ref(*args, iters=iters)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool(got.any())


def _topk_inputs(qidx, kept, seed):
    """Lanes of 64 multi-term partial queries (bad ones among them), one lane
    marked dead over a live lane's driver list, and two lanes whose driver
    is the whole postings array, each needing the longest list: many chunks
    of the kernel. -> (the kernel's arguments after the postings, iters)."""
    rng = np.random.default_rng(seed)
    pids, plen, _, suf, slen = parse_queries(qidx.dictionary, _partials(kept, rng, 64, 0, 10))
    tl, th = qidx.dictionary.locate_prefix(suf, slen)
    idx = qidx.index
    d_start, d_end, starts, ends, dead = conjunctive_lanes(idx, pids, plen, tl, th)
    live = int(torch.nonzero(~dead & (d_end - d_start > 8))[0, 0])
    term = int(torch.argmax(idx.offsets[1:] - idx.offsets[:-1]))
    span = torch.zeros((2, starts.shape[1]), dtype=torch.int32, device="cuda")
    whole = torch.zeros_like(span)
    span[:, 0], whole[:, 0] = idx.offsets[term], idx.offsets[term + 1]

    def add(t, *v):
        return torch.cat([t, torch.stack([torch.as_tensor(x, device="cuda") for x in v])
                          .to(t.dtype)])
    n = idx.n_postings
    lanes = (add(d_start, d_start[live], 0, 0), add(d_end, d_end[live], n, n),
             torch.cat([starts, starts[live:live + 1], span]),
             torch.cat([ends, ends[live:live + 1], whole]),
             add(dead, True, False, False), qidx.completions.fwd_terms,
             add(tl, tl[live], 0, 1), add(th, th[live], idx.n_terms + 1, 5))
    return lanes, idx.n_postings.bit_length()


TOPK_GPU_CASES = [(8, 2, 10), (8, 2, 1), (16, 100, 128), (1000, 1, 10), (128, 4096, 1),
                  (128, 4096, 10), (128, 4096, 128)]


@pytest.mark.parametrize("codec", [None, "ef", "bitpack"])
@pytest.mark.parametrize("tile,max_tiles,k", TOPK_GPU_CASES)
def test_conjunctive_topk_kernel_matches_plain(built, codec, tile, max_tiles, k):
    """The one-launch engine against its tile loop: caps that cut inside the
    kernel's first chunk (16), in its second (1,600) and just short of one
    chunk (1,000), and the full cap over the whole postings array."""
    qidx, kept = built
    lanes, iters = _topk_inputs(qidx, kept, tile + k)
    kw = dict(k=k, tile=tile, max_tiles=max_tiles, iters=iters)
    post = qidx.index.postings
    if codec is None:
        before = isect_ops.topk_launches
        got = isect_ops.conjunctive_topk(post, *lanes, **kw)
        torch.cuda.synchronize()
        assert isect_ops.topk_launches == before + 1
        want = conjunctive_topk_ref(post, *lanes, **kw)
    else:
        pk = _packed(qidx, codec)
        before = isect_ops.topk_packed_launches
        got = isect_ops.conjunctive_topk_packed(post, pk, *lanes, **kw)
        torch.cuda.synchronize()
        assert isect_ops.topk_packed_launches == before + 1
        want = conjunctive_topk_packed_ref(post, pk, *lanes, **kw)
    assert torch.equal(got, want)
    assert bool((got[-3] == INF).all()) and bool((got[-2:] < INF).any())


@pytest.mark.parametrize("codec", [None, "ef", "bitpack"])
def test_conjunctive_topk_kernel_repeats_bit_for_bit(built, codec):
    qidx, kept = built
    lanes, iters = _topk_inputs(qidx, kept, 5)
    kw = dict(k=128, tile=128, max_tiles=4096, iters=iters)
    post = qidx.index.postings
    pk = None if codec is None else _packed(qidx, codec)
    run = (lambda: isect_ops.conjunctive_topk(post, *lanes, **kw)) if codec is None else (
        lambda: isect_ops.conjunctive_topk_packed(post, pk, *lanes, **kw))
    first = run()
    for _ in range(3):
        assert torch.equal(run(), first)


@pytest.mark.parametrize("codec", [None, "ef", "bitpack"])
def test_multi_engine_launches_the_topk_kernel_once(built, codec):
    qidx, kept = built
    rng = np.random.default_rng(13)
    pids, plen, _, suf, slen = parse_queries(qidx.dictionary, _partials(kept, rng, 64, 0, 10))
    tl, th = qidx.dictionary.locate_prefix(suf, slen)
    q = qidx if codec != "bitpack" else dataclasses.replace(
        qidx, index=dataclasses.replace(qidx.index, packed=_packed(qidx, codec)))
    counts = lambda: (isect_ops.launches, isect_ops.packed_launches,
                      isect_ops.topk_launches, isect_ops.topk_packed_launches)
    before = counts()
    got = conjunctive_multi_batch(q.index, q.completions, pids, plen, tl, th, 10,
                                  use_kernel=True, postings_codec=codec)
    after = counts()
    want = (0, 0, 1, 0) if codec is None else (0, 0, 0, 1)
    assert tuple(a - b for a, b in zip(after, before)) == want
    plain = conjunctive_multi_batch(q.index, q.completions, pids, plen, tl, th, 10,
                                    use_kernel=False, postings_codec=codec)
    assert counts() == after
    assert torch.equal(got, plain)


def test_frontend_routes_agree_on_card(built):
    qidx, kept = built
    rng = np.random.default_rng(11)
    parsed = parse_queries(qidx.dictionary, _partials(kept, rng, 256))
    pids, plen, _, suf, slen = parsed
    counts = (heap_ops.launches, rmq_ops.launches, isect_ops.topk_launches)
    kernel = QACFrontend(qidx).complete(pids, plen, suf, slen)
    per_pop = QACFrontend(qidx, heap_kernel=False).complete(pids, plen, suf, slen)
    plain = QACFrontend(qidx, use_kernel=False).complete(pids, plen, suf, slen)
    np.testing.assert_array_equal(kernel, plain)
    np.testing.assert_array_equal(per_pop, plain)
    after = (heap_ops.launches, rmq_ops.launches, isect_ops.topk_launches)
    assert all(a > b for a, b in zip(after, counts))
    for codec in ("ef", "bitpack"):
        q = qidx if codec == "ef" else dataclasses.replace(
            qidx, index=dataclasses.replace(qidx.index, packed=_packed(qidx, codec)))
        counts = (heap_ops.launches, isect_ops.topk_launches,
                  heap_ops.packed_launches, isect_ops.topk_packed_launches)
        got = QACFrontend(q, postings_codec=codec).complete(pids, plen, suf, slen)
        np.testing.assert_array_equal(got, plain)
        after = (heap_ops.launches, isect_ops.topk_launches,
                 heap_ops.packed_launches, isect_ops.topk_packed_launches)
        assert after[:2] == counts[:2] and all(a > b for a, b in zip(after[2:], counts[2:]))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _assert_fm_close(got, want, e, scaled=True):
    e = e.double()
    scale = 1 + (e.sum(1) ** 2 + (e * e).sum(1)).sum(1) if scaled else 1.0
    err = (got.double() - want.double()).abs()
    assert bool((err <= 1e-5 * want.double().abs() + 1e-6 * scale).all()), float(err.max())


@pytest.mark.parametrize("B,F,D,dtype", [(1, 39, 10, torch.float32),
                                         (300, 39, 10, torch.float32),
                                         (512, 13, 8, torch.float32),
                                         (64, 64, 128, torch.float32),
                                         (256, 39, 16, torch.bfloat16)])
def test_fm_pairwise_kernel_matches_plain(B, F, D, dtype):
    _card()
    rng = np.random.default_rng(B * F + D)
    for scale in (1.0, 0.02):
        e = torch.tensor(rng.normal(size=(B, F, D)) * scale, dtype=torch.float32,
                         device="cuda").to(dtype)
        before = fm_ops.launches
        got = fm_ops.fm_pairwise(e)
        torch.cuda.synchronize()
        assert fm_ops.launches == before + 1
        assert got.dtype == torch.float32 and got.shape == (B,)
        _assert_fm_close(got, fm_pairwise_ref(e), e.float(), scaled=scale == 1.0)


def test_fm_pairwise_kernel_refuses_what_it_does_not_take():
    _card()
    before = fm_ops.launches
    empty = fm_ops.fm_pairwise(torch.zeros((0, 39, 10), device="cuda"))
    assert empty.shape == (0,) and fm_ops.launches == before
    e = torch.randn((16, 10, 39), device="cuda")
    for bad in (e.transpose(1, 2), e.double(), torch.randn((16, 65, 8), device="cuda"),
                torch.randn((16, 8, 129), device="cuda"), e[0],
                e.clone().requires_grad_().transpose(1, 2)):   # the grad path checks too
        with pytest.raises(ValueError):
            fm_ops.fm_pairwise(bad)
    assert fm_ops.launches == before
    got = fm_ops.fm_pairwise(e.transpose(1, 2).contiguous())
    _assert_fm_close(got, fm_pairwise_ref(e.transpose(1, 2)), e.transpose(1, 2))


def _fm_inputs(B, F, D, dtype, scale, seed, V=97, offset=0, device="cuda"):
    """ids int32 [B, F] with out-of-range ids mixed in, and FM weights of
    ``dtype`` on ``device``; ``offset`` elements shift the tables' address."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, size=(B, F))
    mask = rng.random((B, F)) < 0.2
    ids[mask] = rng.choice([-1, -V, -V - 1, -(2**31), V, V + 3, 2**31 - 1], size=int(mask.sum()))
    buf = torch.tensor(rng.normal(size=F * V * D + offset) * scale, dtype=torch.float32)
    tables = buf.to(dtype).to(device)[offset:].view(F, V, D)
    linear = torch.tensor(rng.normal(size=(F, V, 1)) * scale, dtype=torch.float32)
    bias = torch.tensor(float(rng.normal()) * scale, dtype=torch.float32)
    return (torch.from_numpy(ids.astype(np.int32)).to(device), tables,
            linear.to(dtype).to(device), bias.to(dtype).to(device))


def _assert_fm_forward_close(got, want, args, scaled, close=True):
    """``_assert_fm_close`` on the gathered embeddings; in bf16 also one
    bf16 unit in the last place (at most 2**-7 of the value) for each of
    the two roundings, the linear sum and then bias + lin, which the kernel
    and the plain version may take to neighbouring values because their
    fp32 sums run in other orders: 2**-6 * (|lin| + |bias|) in all.
    ``close=False`` asserts that the check fails."""
    ids, tables, linear, bias = args
    V = tables.shape[1]
    i = clamp_rows(ids, V)
    f = torch.arange(tables.shape[0], device=ids.device)
    e = tables[f, i].double()
    scale = 1 + (e.sum(1) ** 2 + (e * e).sum(1)).sum(1) if scaled else 1.0
    bound = 1e-5 * want.double().abs() + 1e-6 * scale
    if tables.dtype == torch.bfloat16:
        bound = bound + 2.0**-6 * (bias.double().abs() + linear[f, i, 0].double().sum(1).abs())
    ok = bool(((got.double() - want.double()).abs() <= bound).all())
    assert ok == close, float((got.double() - want.double()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F,D", [(1, 1), (13, 8), (39, 10), (39, 17), (64, 128)])
@pytest.mark.parametrize("B", [1, 300, 4099])
def test_fm_forward_kernel_matches_plain(B, F, D, dtype):
    """One launch against fm_forward_ref, at unit scale (tolerance scaled
    by the sum-square identity's two sums) and at the models' 0.02 scale
    (unscaled); a control, the plain version with the last field dropped,
    must fail the same check."""
    _card()
    for scale in (1.0, 0.02):
        args = _fm_inputs(B, F, D, dtype, scale, seed=B * F + D)
        before = (fm_ops.launches, fm_ops.forward_launches)
        got = fm_ops.fm_forward(*args)
        torch.cuda.synchronize()
        assert (fm_ops.launches, fm_ops.forward_launches) == (before[0], before[1] + 1)
        assert got.dtype == torch.float32 and got.shape == (B,)
        want = fm_forward_ref(*args)
        _assert_fm_forward_close(got, want, args, scaled=scale == 1.0)
        ids, tables, linear, bias = args
        dropped = (fm_forward_ref(ids[:, :-1].contiguous(), tables[:-1], linear[:-1], bias)
                   if F > 1 else bias.float().expand(B))
        _assert_fm_forward_close(got, dropped, args, scaled=scale == 1.0, close=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F,D", [(39, 10), (64, 128)])
def test_fm_forward_kernel_on_unaligned_tables(F, D, dtype):
    """Tables one element past an aligned address take the narrowest loads
    (4 bytes in fp32, 2 in bf16)."""
    _card()
    args = _fm_inputs(300, F, D, dtype, 1.0, seed=F + D, offset=1)
    assert fm_ops.plan_fm_forward(300, F, D, args[1].element_size(),
                                  math.gcd(args[1].data_ptr(), 16)).vec == args[1].element_size()
    got = fm_ops.fm_forward(*args)
    _assert_fm_forward_close(got, fm_forward_ref(*args), args, scaled=True)


def test_fm_forward_kernel_refuses_what_it_does_not_take():
    _card()
    ids, tables, linear, bias = _fm_inputs(16, 13, 8, torch.float32, 1.0, seed=1)
    before = fm_ops.forward_launches
    empty = fm_ops.fm_forward(ids[:0], tables, linear, bias)
    assert empty.shape == (0,) and fm_ops.forward_launches == before
    wide = _fm_inputs(4, 65, 8, torch.float32, 1.0, seed=2)
    deep = _fm_inputs(4, 13, 129, torch.float32, 1.0, seed=3)
    bad = [
        (ids.long(), tables, linear, bias),                       # int64 ids
        (ids.t().contiguous().t(), tables, linear, bias),         # ids not contiguous
        (ids[0], tables, linear, bias),                           # ids not [B, F]
        (ids.cpu(), tables, linear, bias),                        # ids off the card
        (ids[:, :12].contiguous(), tables, linear, bias),         # F mismatched
        (ids, tables.transpose(1, 2).contiguous().transpose(1, 2), linear, bias),
        (ids, tables.double(), linear.double(), bias.double()),   # float64
        (ids, tables, linear[..., 0], bias),                      # linear not [F, V, 1]
        (ids, tables, linear.to(torch.bfloat16), bias),           # linear's dtype
        (ids, tables, linear, bias.to(torch.bfloat16)),           # bias's dtype
        (ids, tables, linear, bias.expand(2).contiguous()),       # bias not one value
        wide, deep,                                               # F > 64, D > 128
        (ids, tables.clone().requires_grad_(), linear, bias),     # grad enabled
    ]
    for args in bad:
        with pytest.raises(ValueError):
            fm_ops.fm_forward(*args)
    assert fm_ops.forward_launches == before


def test_fm_model_launches_the_kernel_once_per_forward():
    """FMModel's kernel route is one fm_forward launch (no fm_pairwise),
    allocating only its output: no [B, F, D] or int64 index tensor; the
    plain route launches nothing; the two agree."""
    _card()
    cfg = get_arch("fm").smoke_cfg
    model = FMModel(cfg, device="cuda")
    feats, _ = recsys_batch(cfg, 300, np.random.default_rng(0))
    feats = {k: torch.from_numpy(v).cuda() for k, v in feats.items()}
    with torch.inference_mode():
        model(feats)                                  # build and load the kernel first
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = (fm_ops.launches, fm_ops.forward_launches)
        routed = model(feats)
        torch.cuda.synchronize()
        assert (fm_ops.launches, fm_ops.forward_launches) == (before[0], before[1] + 1)
        assert torch.cuda.max_memory_allocated() - base <= 2048     # the [300] output
        model.use_kernel = False
        plain = model(feats)
        assert (fm_ops.launches, fm_ops.forward_launches) == (before[0], before[1] + 1)
    torch.testing.assert_close(routed, plain, rtol=1e-5, atol=1e-6)


FA_CASES = [  # B, H, G, Sq, Skv, D, causal, window, softcap, kv_len
    (2, 4, 2, 256, 256, 32, True, 0, 0.0, None),            # GQA
    (1, 4, 1, 384, 384, 64, True, 128, 0.0, None),          # MQA + window
    (1, 2, 2, 256, 256, 128, True, 0, 50.0, None),          # softcap
    (1, 8, 4, 300, 300, 256, True, 100, 50.0, None),        # gemma2's heads, ragged
    (2, 4, 4, 130, 130, 64, False, 0, 0.0, None),           # bidirectional
    (3, 8, 4, 1, 700, 256, True, 0, 50.0, (700, 1, 333)),   # decode, kv_len
    (2, 8, 4, 1, 4096, 128, True, 0, 0.0, (4096, 2049)),    # decode, long cache
    (2, 15, 5, 37, 211, 64, True, 50, 0.0, (150, 211)),     # offset, window, kv_len
    (2, 4, 2, 64, 40, 32, True, 0, 0.0, None),              # Sq > Skv: rows of 0
    # the bf16 kernels' edges: the prefill kernel (wgmma, TMA ring) and the
    # split-KV decode kernel (Sq <= 8 and rep * Sq <= 64)
    (1, 4, 2, 100, 333, 64, True, 0, 0.0, None),            # Skv no multiple of a kv tile
    (2, 8, 4, 1, 1000, 256, True, 0, 50.0, (1000, 517)),    # decode: Skv no multiple of a split
    (2, 4, 2, 45, 300, 128, True, 0, 0.0, None),            # Sq in 2..63: a partial q tile
    (2, 8, 2, 1, 777, 32, True, 0, 0.0, (777, 300)),        # decode at D = 32
    (1, 4, 4, 200, 200, 32, True, 64, 30.0, None),          # prefill at D = 32, 64-byte swizzle
    (1, 8, 1, 1, 32768, 128, True, 0, 0.0, None),           # B * G = 1: 64 splits
    (2, 4, 2, 1, 2048, 64, True, 0, 0.0, (1, 2048)),        # kv_len 1 and Skv in one batch
    (2, 8, 4, 9, 1500, 256, True, 0, 50.0, (1500, 800)),    # Sq 9: just above the decode rule
    (1, 16, 2, 8, 1000, 128, True, 64, 0.0, None),          # decode, 64 rows of one kv head
    (1, 32, 2, 8, 512, 64, True, 0, 0.0, (400,)),           # Sq 8 but rep * Sq > 64: prefill
    (2, 6, 2, 3, 900, 64, True, 100, 0.0, (900, 450)),      # decode, Sq 3 with a window
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_kernel_matches_plain(case, dtype):
    _card()
    B, H, G, Sq, Skv, D, causal, window, softcap, kv_len = case
    rng = np.random.default_rng(Sq * 7 + Skv + D)
    q, k, v = (torch.tensor(rng.normal(size=s), dtype=torch.float32, device="cuda").to(dtype)
               for s in ((B, H, Sq, D), (B, G, Skv, D), (B, G, Skv, D)))
    kl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, kl, **kw)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    want = fa_ops.flash_attention(q, k, v, kl, use_kernel=False, **kw)
    assert fa_ops.launches == before + 1 and got.dtype == dtype
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if Sq == 1:
        dec = fa_ops.flash_decode(q[:, :, 0], k, v, kl, softcap=softcap)
        torch.testing.assert_close(dec, got[:, :, 0], rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(2, 8, 4, 300, 300, 256), (16, 8, 4, 1, 4096, 256),
                                   (4, 40, 8, 1, 3000, 128)])
def test_flash_attention_kernel_repeats_bit_for_bit(shape):
    """Two identical calls give the same bits: prefill, and decode with its
    split merge (a fixed order, no float atomics)."""
    _card()
    B, H, G, Sq, Skv, D = shape
    rng = np.random.default_rng(Skv)
    q, k, v = (torch.tensor(rng.normal(size=s), dtype=torch.bfloat16, device="cuda")
               for s in ((B, H, Sq, D), (B, G, Skv, D), (B, G, Skv, D)))
    kl = torch.tensor(rng.integers(1, Skv + 1, B), dtype=torch.int32, device="cuda")
    if Sq == 1:
        assert fa_ops.plan_splits(B, H, G, Sq, Skv)[0] > 1
    first = fa_ops.flash_attention(q, k, v, kl, softcap=50.0)
    second = fa_ops.flash_attention(q, k, v, kl, softcap=50.0)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("Sq,Skv", [(512, 512), (1, 4096)])
@pytest.mark.parametrize("spread", [1.0, 3.0])
def test_flash_attention_softcap_near_the_cap(Sq, Skv, spread):
    """Scores s with s / softcap at 1.2 and 3.6, all within a few percent of
    each other: the tanh saturates and the softmax weighs many columns
    alike, so the error of the kernel's tanh.approx.f32 weighs most. Each
    output row stays within 1.25e-2 of its own norm (chip_smoke.py's
    FLASH_ROW_TOL in bf16), as at ordinary scores."""
    _card()
    rng = np.random.default_rng(int(spread * 10) + Sq)
    B, H, G, D = 2, 8, 4, 256
    base = rng.normal(size=(1, 1, 1, D))
    q = rng.normal(size=(B, H, Sq, D)) * 0.1 + base * spread
    k = rng.normal(size=(B, G, Skv, D)) * 0.3 + base * 4
    q, k, v = (torch.tensor(x, dtype=torch.bfloat16, device="cuda")
               for x in (q, k, rng.normal(size=(B, G, Skv, D))))
    got = fa_ops.flash_attention(q, k, v, softcap=50.0)
    want = fa_ops.flash_attention(q, k, v, softcap=50.0, use_kernel=False)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    err = ((got.double() - want.double()).norm(dim=-1) / want.double().norm(dim=-1)).max()
    assert float(err) <= 1.25e-2


def test_flash_decode_counts_one_launch():
    _card()
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.normal(size=(4, 8, 256)), dtype=torch.bfloat16, device="cuda")
    k, v = (torch.tensor(rng.normal(size=(4, 4, 5000, 256)), dtype=torch.bfloat16,
                         device="cuda") for _ in range(2))
    kl = torch.tensor([5000, 1, 2500, 4097], dtype=torch.int32, device="cuda")
    before = fa_ops.launches
    got = fa_ops.flash_decode(q, k, v, kl, softcap=50.0)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    want = fa_ops.flash_decode(q, k, v, kl, softcap=50.0, use_kernel=False)
    assert fa_ops.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


def test_flash_attention_kernel_refuses_what_it_does_not_take():
    _card()
    q = torch.randn((1, 4, 64, 64), device="cuda")
    k = torch.randn((1, 2, 64, 64), device="cuda")
    before = fa_ops.launches
    bad = [(q[..., :48].contiguous(), k[..., :48].contiguous(), None),   # D = 48
           (q, k.to(torch.bfloat16), None),                              # mixed dtypes
           (q.transpose(2, 3), k, None),                                 # not contiguous
           (q.double(), k.double(), None),
           (q[:, :3].contiguous(), k, None),                             # H % G
           (q, k, torch.tensor([64], device="cuda")),                    # int64 kv_len
           (q, k, torch.tensor([64, 64], dtype=torch.int32, device="cuda")),
           (q.clone().requires_grad_(), k,                               # kv_len under grad
            torch.tensor([64], dtype=torch.int32, device="cuda"))]
    for qq, kk, kl in bad:
        with pytest.raises(ValueError):
            fa_ops.flash_attention(qq, kk, kk, kl)
    assert fa_ops.launches == before


def test_lm_smoke_width_kernel_route_matches_plain_route():
    """gemma2-2b at smoke width (fp32) on the card: forward, prefill, 20
    decode steps (the 16-token local ring wraps) and greedy generation
    through the kernel and the plain route, one launch per layer per call."""
    _card()
    arch = get_arch("gemma2-2b")
    model = arch.smoke_model(device="cuda")
    n_layers = model.cfg.n_layers
    toks = torch.tensor(np.random.default_rng(0).integers(0, model.cfg.vocab, (2, 40)),
                        dtype=torch.int32, device="cuda")
    routes = {}
    for use_flash in (None, False):
        model.cfg = dataclasses.replace(arch.smoke_cfg, use_flash=use_flash)
        want = 0 if use_flash is False else n_layers
        before = fa_ops.launches
        logits, _, _ = model(toks)
        assert fa_ops.launches == before + want
        last = prefill_step(model, toks)
        assert fa_ops.launches == before + 2 * want
        cache, steps = model.init_cache(2, 64), []
        for t in range(20):
            step_logits, cache = model.decode_step(cache, toks[:, t])
            steps.append(step_logits)
        torch.cuda.synchronize()
        assert fa_ops.launches == before + 22 * want
        routes[use_flash] = (logits, last, torch.stack(steps),
                             greedy_generate(model, toks[:, :8], 8, 32))
    for got, plain in zip(routes[None][:3], routes[False][:3]):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
    assert torch.equal(routes[None][3], routes[False][3])


def test_online_runtime_and_cluster_on_card(built):
    """The runtime's measured replay and a 2-replica kill drill on the card:
    every row equal to the plain route's on a CPU build of the same log, the
    measured pass's heap_topk and conjunctive_topk launches what its
    dispatch log predicts (none of rmq_query), and no callable minted after
    the audit's freeze."""
    from repro_torch.obs import JitAuditor
    from repro_torch.runtime import FaultInjector, ReplicaFault
    from repro_torch.serve import (ClusterConfig, QACOnlineRuntime, QACServingCluster,
                                   RuntimeConfig, prepare_requests)
    from repro_torch.text import KeystrokeTraceConfig, generate_keystroke_trace

    qidx, kept = built
    qs, sc = generate_query_log(SynthLogConfig(n_queries=3000, vocab_size=300,
                                               mean_term_chars=4.0, seed=3))
    plain = QACFrontend(build_qac_index(qs, sc, device="cpu")[0], k=10)
    reqs = prepare_requests(qidx, generate_keystroke_trace(kept, KeystrokeTraceConfig(
        n_sessions=24, mean_keystroke_ms=20.0, session_spread_ms=100.0, seed=5)), k=10)

    def want(r, k):
        return plain.complete(r.pids[None], np.asarray([r.plen], np.int32), r.suf[None],
                              np.asarray([r.slen], np.int32), k=k)[0]

    auditor = JitAuditor()
    fe = QACFrontend(qidx, k=10, specialize_list_pad=False, auditor=auditor)
    assert fe.describe_route("single") == "heap_topk[raw]"
    rt = QACOnlineRuntime(fe, RuntimeConfig(max_batch=16, slack_us=2_000.0))
    rt.warmup(reqs)
    rt.run_trace(reqs)
    rt.reset()
    auditor.freeze()
    counts = lambda: (heap_ops.launches, isect_ops.topk_launches, rmq_ops.launches,
                      heap_ops.packed_launches, isect_ops.topk_packed_launches)
    before, fallbacks = counts(), fe.stats["single_fallbacks"]
    fe.begin_dispatch_log()
    rows = rt.run_trace(reqs)
    engines = [key[0] for key, _ in fe.end_dispatch_log()]
    delta = tuple(a - b for a, b in zip(counts(), before))
    assert engines.count("single_full") == fe.stats["single_fallbacks"] - fallbacks
    assert delta == (engines.count("single") + engines.count("single_full"),
                     engines.count("multi"), 0, 0, 0) and delta[0] and delta[1]
    auditor.assert_closed()
    for r, row in zip(reqs, rows):
        np.testing.assert_array_equal(row, want(r, r.k))
    shared = QACFrontend(qidx, k=10, specialize_list_pad=False)
    t_kill = reqs[len(reqs) // 2].t_us
    cl = QACServingCluster(qidx, ClusterConfig(
        n_replicas=2, heartbeat_timeout_us=50_000.0, degrade_pressure_us=1e12,
        shed_bulk_pressure_us=1e12, shed_pressure_us=1e12),
        RuntimeConfig(max_batch=16, slack_us=2_000.0), frontends=[shared, shared],
        injector=FaultInjector([], replica_faults=[ReplicaFault(0, t_kill)]))
    res = cl.replay(reqs)
    assert all(r.status == "ok" for r in res) and cl.telemetry.snapshot()["rerouted"] > 0
    for r, got in zip(reqs, res):
        np.testing.assert_array_equal(got.row, want(r, got.k_served))


def _fresh_trace(qs, sc, seed, n_mut=12, sessions=10):
    from repro_torch.text import (KeystrokeTraceConfig, MutationTraceConfig,
                                  generate_mutation_trace)
    return generate_mutation_trace(qs, sc, MutationTraceConfig(
        keystrokes=KeystrokeTraceConfig(n_sessions=sessions, queries_per_session=1,
                                        mean_keystroke_ms=2.0, seed=seed),
        n_mutations=n_mut, follower_sessions=6, seed=seed))


def test_live_index_on_card_equals_plain_route(monkeypatch):
    """A GenerationalQAC trace across swaps on the card: every FreshResult
    (strings, scores, version, delta count, escalations) equal to the plain
    route's on the card, every answer equal to the from-scratch oracle, and
    the kernel route's launches what its dispatch log predicts. Which
    requests a mutation finds answered follows the runtime's service times,
    so the runtime's clock reads 2**-9 s more each time on both routes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import repro_torch.serve.runtime as runtime_mod
    from _torch_clock import fix_clocks
    from repro_torch.serve import FreshnessConfig, GenerationalQAC, RuntimeConfig

    qs, sc = generate_query_log(SynthLogConfig(n_queries=3000, vocab_size=300,
                                               mean_term_chars=4.0, seed=3))
    events = _fresh_trace(qs, sc, seed=1)
    kw = dict(cfg=FreshnessConfig(k=10, delta_capacity=64, swap_threshold=4),
              rt_cfg=RuntimeConfig(max_batch=8, slack_us=2_000.0), device="cuda")
    runs = {}
    for route, fe_kw in (("kernels", {}), ("plain", {"use_kernel": False})):
        fix_clocks(monkeypatch, runtime_mod)
        gq = GenerationalQAC(qs, sc, frontend_kwargs=fe_kw, **kw)
        before = (heap_ops.launches, isect_ops.topk_launches, rmq_ops.launches)
        gq.begin_dispatch_log()
        runs[route] = (gq, gq.run_mutation_trace(events))
        engines = [key[0] for key, _ in gq.end_dispatch_log()]
        delta = tuple(a - b for a, b in zip(
            (heap_ops.launches, isect_ops.topk_launches, rmq_ops.launches), before))
        if route == "kernels":
            assert delta == (engines.count("single") + engines.count("single_full"),
                             engines.count("multi"), 0) and delta[0] and delta[1]
        else:
            assert delta == (0, 0, 0)
    (gk, rk), (_, rp) = runs["kernels"], runs["plain"]
    fields = lambda r: (r.idx, r.strings, r.scores, r.gen, r.seq, r.n_delta, r.escalations)
    assert [fields(r) for r in rk] == [fields(r) for r in rp]
    assert gk.snapshot()["n_swaps"] >= 2 and gk.snapshot()["delta_hit_answers"] > 0
    assert gk.check_parity(rk) == len(rk)


def test_freshness_witness_equals_the_oracle_on_card():
    """``witness_answers`` (the at-scale check of chip_smoke.py's phase 9)
    against the from-scratch oracle on a small index on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.serve import (FreshnessConfig, GenerationalQAC, RuntimeConfig,
                                   witness_answers)

    qs, sc = generate_query_log(SynthLogConfig(n_queries=2000, vocab_size=200,
                                               mean_term_chars=4.0, seed=6))
    gq = GenerationalQAC(qs, sc, cfg=FreshnessConfig(k=10, delta_capacity=64,
                                                     swap_threshold=5),
                         rt_cfg=RuntimeConfig(max_batch=8, slack_us=2_000.0),
                         device="cuda", frontend_kwargs=dict(tile=4, max_tiles=2))
    results = gq.run_mutation_trace(_fresh_trace(qs, sc, seed=4, n_mut=14))
    assert gq.snapshot()["truncated_scans"] > 0
    assert witness_answers(gq, results) == [
        gq.oracle_answer(r.query, r.gen, r.seq, r.k) for r in results]


def test_qac_serve_step_on_kernels_equals_plain_route(built):
    """The fused step through heap_topk and one conjunctive_topk launch
    equals its plain route and the routed frontend, on a mixed batch and on
    each class alone."""
    from repro_torch.serve import qac_serve_step

    qidx, kept = built
    raw = _partials(kept, np.random.default_rng(12), 200, pct_single=40)
    pids, plen, _, suf, slen = parse_queries(qidx.dictionary, raw)
    fe = QACFrontend(qidx, k=10)
    for sel in (slice(None), plen == 0, plen > 0):
        args = (pids[sel], plen[sel], suf[sel], slen[sel])
        before = (heap_ops.launches, isect_ops.topk_launches)
        got = qac_serve_step(qidx, *args, k=10)
        torch.cuda.synchronize()
        launched = (heap_ops.launches - before[0], isect_ops.topk_launches - before[1])
        assert launched == (int(bool((args[1] == 0).any())), int(bool((args[1] > 0).any())))
        plain = qac_serve_step(qidx, *args, k=10, use_kernel=False)
        assert torch.equal(got, plain)
        assert np.array_equal(fe.complete(*args), got.cpu().numpy())


@pytest.fixture(scope="module")
def striped4(built):
    """The built index's own rows (row d = docid d) in 4 docid stripes on
    the card, "ef" packed."""
    from repro_torch.core.striped import build_striped

    qidx, _ = built
    fwd = qidx.completions.fwd_terms.cpu().numpy()
    return build_striped(fwd, np.arange(len(fwd), dtype=np.int32), qidx.index.n_terms,
                         4, device="cuda")


@pytest.mark.parametrize("codec", [None, "ef"])
@pytest.mark.parametrize("tile,max_tiles,k", [(128, 4096, 10), (8, 2, 10), (16, 100, 128)])
def test_strided_conjunctive_topk_kernel_matches_plain(built, striped4, codec, tile,
                                                       max_tiles, k):
    """conjunctive_topk reading a stripe's forward rows (fwd_stride 4, row
    d // 4) against its plain version with the stride, on every stripe."""
    from repro_torch.core.striped import local_index

    qidx, kept = built
    raw = _partials(kept, np.random.default_rng(31), 160, pct_single=0)
    pids, plen, _, suf, slen = parse_queries(qidx.dictionary, raw)
    tl, th = qidx.dictionary.locate_prefix(suf, slen)
    for s in range(4):
        idx, fwd, _ = local_index(striped4, s)
        lanes = conjunctive_lanes(idx, pids, plen, tl, th)
        kw = dict(k=k, tile=tile, max_tiles=max_tiles,
                  iters=idx.postings.shape[0].bit_length(), fwd_stride=4)
        fargs = (*lanes, fwd.fwd_terms, tl, th)
        if codec is None:
            got = isect_ops.conjunctive_topk(idx.postings, *fargs, **kw)
            want = conjunctive_topk_ref(idx.postings, *fargs, **kw)
        else:
            got = isect_ops.conjunctive_topk_packed(idx.postings, idx.packed, *fargs, **kw)
            want = conjunctive_topk_packed_ref(idx.postings, idx.packed, *fargs, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert bool((got < INF).any())


@pytest.mark.parametrize("codec", [None, "ef"])
def test_qac_serve_striped_on_card_equals_serve_step(built, striped4, codec):
    """The striped step on the card (heap_topk and conjunctive_topk once a
    stripe when both classes are present) equals the unstriped fused step."""
    from repro_torch.serve import qac_serve_step, qac_serve_striped

    qidx, kept = built
    raw = _partials(kept, np.random.default_rng(13), 200, pct_single=40)
    pids, plen, _, suf, slen = parse_queries(qidx.dictionary, raw)
    args = (pids, plen, suf, slen)
    counters = ((heap_ops, "launches"), (isect_ops, "topk_launches")) if codec is None \
        else ((heap_ops, "packed_launches"), (isect_ops, "topk_packed_launches"))
    before = [getattr(m, c) for m, c in counters]
    got = qac_serve_striped(striped4, qidx.dictionary, *args, k=10, postings_codec=codec)
    torch.cuda.synchronize()
    assert [getattr(m, c) - b for (m, c), b in zip(counters, before)] == [4, 4]
    assert torch.equal(got, qac_serve_step(qidx, *args, k=10))


# -- the backward kernels ------------------------------------------------------
# flash_attention_bwd and fm_pairwise_bwd against their plain versions,
# norm-relative over each gradient: ||kernel - plain|| / ||plain|| within
# 1e-4 in fp32 (fp32 sums in other orders) and 2e-2 in bf16 (the gradients'
# own rounding, ~2^-9, carried through the products).
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-300))


def _bwd_inputs(B, H, G, Sq, Skv, D, dtype, seed, causal, window, softcap, qscale=1.0):
    """q, k, v, the forward kernel's o and lse (as a train step hands them to
    the backward) and a cotangent; ``qscale`` widens the scores (x ~ qscale
    * N(0, 1)) so that a softcap of 50 bends them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g, device="cuda").to(dtype)
               for s in ((B, H, Sq, D), (B, G, Skv, D), (B, G, Skv, D)))
    q = (q.float() * qscale).to(dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = fa_ops.flash_attention_fwd(q, k, v, **kw)
    do = torch.randn((B, H, Sq, D), generator=g, device="cuda").to(dtype)
    return q, k, v, o, lse, do, kw


@pytest.mark.parametrize("B,H,G,Sq,Skv,D,dtype,causal,window,softcap,qscale", [
    (1, 4, 2, 256, 256, 32, torch.float32, True, 0, 0.0, 1.0),
    (2, 6, 2, 100, 100, 64, torch.float32, True, 33, 5.0, 1.0),        # ragged, window, softcap
    (1, 4, 4, 70, 130, 128, torch.float32, True, 0, 0.0, 1.0),         # decode offset
    (1, 2, 1, 90, 40, 64, torch.float32, True, 0, 0.0, 1.0),           # rows with no column
    (1, 4, 2, 64, 96, 256, torch.float32, False, 20, 0.0, 1.0),        # not causal, window
    (1, 8, 4, 512, 512, 256, torch.bfloat16, True, 0, 50.0, 1.0),      # gemma2's heads
    (1, 8, 4, 256, 256, 256, torch.float32, True, 0, 50.0, 20.0),     # the softcap bends
    (1, 8, 4, 384, 384, 256, torch.bfloat16, True, 128, 50.0, 1.0),
    (2, 15, 5, 300, 300, 64, torch.bfloat16, True, 0, 0.0, 1.0),       # smollm's heads
    (1, 40, 8, 256, 256, 128, torch.bfloat16, True, 0, 0.0, 1.0),      # qwen3's heads
    # the bf16 kernels at every head width, with GQA, a window, the causal
    # offset (Sq < Skv), the softcap, rows with no live column (Sq > Skv),
    # no causal mask, and Sq and Skv that are no multiple of a tile
    (2, 4, 2, 100, 100, 32, torch.bfloat16, True, 33, 5.0, 3.0),
    (1, 4, 4, 70, 130, 32, torch.bfloat16, True, 0, 0.0, 1.0),
    (1, 6, 3, 90, 40, 64, torch.bfloat16, True, 0, 0.0, 1.0),
    (1, 4, 2, 131, 77, 64, torch.bfloat16, False, 20, 10.0, 4.0),
    (1, 8, 2, 190, 257, 128, torch.bfloat16, True, 70, 0.0, 1.0),
    (2, 2, 1, 150, 50, 128, torch.bfloat16, True, 0, 30.0, 8.0),
    (1, 4, 2, 65, 200, 256, torch.bfloat16, True, 0, 50.0, 20.0),
    (1, 2, 1, 201, 129, 256, torch.bfloat16, True, 64, 0.0, 1.0)])
def test_flash_attention_bwd_kernel_matches_plain(B, H, G, Sq, Skv, D, dtype, causal,
                                                  window, softcap, qscale):
    _card()
    q, k, v, o, lse, do, kw = _bwd_inputs(B, H, G, Sq, Skv, D, dtype, Sq + D, causal, window,
                                          softcap, qscale)
    before = fa_ops.bwd_launches
    got = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert fa_ops.bwd_launches == before + 1
    want = fa_ops.flash_attention_bwd_ref(q, k, v, o, do, lse=lse, **kw)
    own = fa_ops.flash_attention_bwd_ref(q, k, v, o, do, **kw)   # with its own lse
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, own):
        assert a.dtype == dtype and a.shape == b.shape
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, b) <= GRAD_TOL[dtype], (name, _rel(a, b))
        assert _rel(a, c) <= GRAD_TOL[dtype], (name, _rel(a, c))
    if causal and Sq > Skv:    # rows that see no column get a zero gradient
        assert float(got[0][:, :, :Sq - Skv].abs().max()) == 0.0


@pytest.mark.parametrize("H,G,S,D,window,softcap", [(8, 4, 640, 256, 0, 50.0),
                                                    (8, 2, 300, 128, 100, 0.0),
                                                    (6, 3, 200, 64, 0, 0.0),
                                                    (4, 1, 150, 32, 0, 20.0)])
def test_flash_attention_bwd_kernel_is_deterministic(H, G, S, D, window, softcap):
    """No float atomics: two calls give the same bytes."""
    _card()
    q, k, v, o, lse, do, kw = _bwd_inputs(1, H, G, S, S, D, torch.bfloat16, 7, True, window,
                                          softcap)
    first = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    second = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,G,Sq,Skv,D,window,softcap,qscale", [
    (8, 4, 300, 300, 256, 0, 50.0, 20.0), (4, 2, 100, 170, 128, 30, 0.0, 1.0),
    (6, 3, 90, 40, 64, 0, 0.0, 1.0), (2, 1, 77, 77, 32, 0, 5.0, 3.0)])
def test_flash_attention_forward_lse_matches_plain(dtype, H, G, Sq, Skv, D, window, softcap,
                                                    qscale):
    """The forward kernels' lse (bf16 prefill and fp32) against the plain
    route's: +inf on the same rows (none live), else within 1e-4 (fp32) or
    2e-2 (bf16, whose softcap takes tanh.approx.f32: ~2^-11 of c in s)."""
    _card()
    q, k, v, o, lse, _, kw = _bwd_inputs(1, H, G, Sq, Skv, D, dtype, 11, True, window,
                                         softcap, qscale)
    want_o, want = fa_ops.flash_attention_fwd(*(t.cpu() for t in (q, k, v)), **kw)
    assert lse.shape == (1, H, Sq) and lse.dtype == torch.float32
    lse = lse.cpu()
    empty = torch.isinf(want)
    assert torch.equal(torch.isinf(lse), empty) and bool((lse[empty] > 0).all())
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert float((lse[~empty] - want[~empty]).abs().max()) <= tol
    o_tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.cpu().float(), want_o.float(), rtol=o_tol, atol=o_tol)


def test_flash_attention_serving_call_writes_no_lse():
    """A serving call (no grad) launches the forward without an lse; under
    grad the same call launches it with one."""
    _card()
    q, k, v, _, _, _, kw = _bwd_inputs(1, 8, 4, 200, 200, 256, torch.bfloat16, 3, True, 0,
                                       50.0)
    before = (fa_ops.launches, fa_ops.lse_launches)
    with torch.no_grad():
        fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (fa_ops.launches - before[0], fa_ops.lse_launches - before[1]) == (1, 0)
    leaf = q.clone().requires_grad_()
    fa_ops.flash_attention(leaf, k, v, **kw)
    assert (fa_ops.launches - before[0], fa_ops.lse_launches - before[1]) == (2, 1)


def test_flash_attention_bwd_controls_are_rejected():
    """The check above rejects a backward without the softcap's factor and a
    dK without the sum over the group's heads."""
    _card()
    q, k, v, o, lse, do, kw = _bwd_inputs(1, 8, 4, 256, 256, 256, torch.bfloat16, 5, True, 0,
                                          50.0, qscale=20.0)
    got = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = fa_ops.flash_attention_bwd_ref(q, k, v, o, do, lse=lse, **kw)
    no_cap = fa_ops.flash_attention_bwd_ref(q, k, v, o, do, lse=lse, cap_grad=False, **kw)
    no_sum = fa_ops.flash_attention_bwd_ref(q, k, v, o, do, lse=lse, group_sum=False, **kw)
    tol = GRAD_TOL[torch.bfloat16]
    assert max(_rel(a, b) for a, b in zip(got, want)) <= tol
    assert _rel(no_cap[0], want[0]) > tol and _rel(no_sum[1], want[1]) > tol


def test_flash_attention_function_grads_on_the_card():
    """Under grad the kernel route goes through FlashAttention: one forward
    and one backward launch, gradients equal to the plain route's autograd."""
    _card()
    q, k, v, _, _, do, kw = _bwd_inputs(1, 4, 2, 200, 200, 64, torch.float32, 3, True, 50,
                                        30.0)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    f0, b0 = fa_ops.launches, fa_ops.bwd_launches
    out = fa_ops.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (fa_ops.launches - f0, fa_ops.bwd_launches - b0) == (1, 1)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa_ops.flash_attention(*plain, use_kernel=False, **kw), plain, do)
    for a, b in zip(got, want):
        assert _rel(a, b) <= GRAD_TOL[torch.float32]


@pytest.mark.parametrize("B,F,D,dtype", [(65_536, 39, 10, torch.float32),
                                         (4096, 39, 10, torch.bfloat16),
                                         (300, 13, 8, torch.float32),
                                         (64, 64, 128, torch.float32)])
def test_fm_pairwise_bwd_kernel_matches_plain(B, F, D, dtype):
    _card()
    g = torch.Generator(device="cuda").manual_seed(B + F)
    e = (torch.randn((B, F, D), generator=g, device="cuda") * 0.05).to(dtype)
    cot = torch.randn(B, generator=g, device="cuda")
    before = fm_ops.bwd_launches
    got = fm_ops.fm_pairwise_bwd(e, cot)
    torch.cuda.synchronize()
    assert fm_ops.bwd_launches == before + 1
    want = fm_pairwise_bwd_ref(e, cot)
    assert got.dtype == dtype and got.shape == e.shape
    assert _rel(got, want) <= (1e-6 if dtype == torch.float32 else 1e-2)
    leaf = e.clone().requires_grad_()
    (through,) = torch.autograd.grad(fm_ops.fm_pairwise(leaf), leaf, cot)
    assert torch.equal(through, got)


def test_dedup_row_grads_is_deterministic_on_the_card():
    """The sparse update's segment sum over duplicate rows gives the same
    bytes from call to call (Zipf-like ids: thousands of duplicates a hot
    row), so FM's sparse step is reproducible."""
    from repro_torch.optim import dedup_row_grads

    _card()
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(np.minimum(rng.zipf(1.1, 200_000), 50_000)).cuda()
    grads = torch.from_numpy(rng.normal(size=(200_000, 10)).astype(np.float32)).cuda()
    first = dedup_row_grads(ids, grads, 50_001)
    second = dedup_row_grads(ids, grads, 50_001)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    # the CPU's sums, in another order: up to ~10^4 N(0, 1) terms a row
    cpu = dedup_row_grads(ids.cpu(), grads.cpu(), 50_001)
    assert torch.equal(first[0].cpu(), cpu[0])
    torch.testing.assert_close(first[1].cpu(), cpu[1], rtol=1e-4, atol=1e-3)


def test_lm_train_step_kernel_route_matches_plain_route():
    """gemma2-2b at smoke width (fp32) on the card: the loss and every
    parameter's gradient through the kernel route (one forward and one
    backward attention launch a layer) against the plain route on the same
    weights, norm-relative within 1e-4; then a train step on the kernel
    route launches the same and reports the same loss. (Parameters after
    Adam steps are not compared: Adam moves a parameter by ~lr whatever
    its gradient, so a gradient at its rounding floor may move it either
    way.)"""
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, make_lm_train_step

    _card()
    arch = get_arch("gemma2-2b")
    model = arch.smoke_model(device="cuda")
    L = model.cfg.n_layers
    t = torch.tensor(np.random.default_rng(1).integers(0, arch.smoke_cfg.vocab, (4, 65)),
                     dtype=torch.int32, device="cuda")
    batch = {"tokens": t[:, :-1], "targets": t[:, 1:], "mask": torch.ones((4, 64), device="cuda")}
    routes = {}
    for use_flash in (None, False):
        model.cfg = dataclasses.replace(arch.smoke_cfg, use_flash=use_flash)
        before = (fa_ops.launches, fa_ops.bwd_launches)
        loss = model.loss_fn(batch["tokens"], batch["targets"], batch["mask"])
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        n = 0 if use_flash is False else L
        assert (fa_ops.launches - before[0], fa_ops.bwd_launches - before[1]) == (n, n)
        routes[use_flash] = (float(loss.detach()), grads)
    np.testing.assert_allclose(routes[None][0], routes[False][0], rtol=1e-5)
    for (name, _), a, b in zip(model.named_parameters(), routes[None][1], routes[False][1]):
        assert bool(torch.isfinite(a).all()) and _rel(a, b) <= 1e-4, (name, _rel(a, b))
    model.cfg = arch.smoke_cfg
    step = make_lm_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4))
    before = (fa_ops.launches, fa_ops.bwd_launches)
    _, m = step(init_train_state(dict(model.named_parameters())), batch)
    assert (fa_ops.launches - before[0], fa_ops.bwd_launches - before[1]) == (L, L)
    np.testing.assert_allclose(float(m["loss"]), routes[None][0], rtol=1e-6)


def test_fm_sparse_train_step_kernel_route_matches_plain_route():
    """Three lazy sparse steps of FM at smoke width on the card: one
    fm_pairwise and one fm_pairwise_bwd launch a step, no fm_forward;
    losses, tables and moments as the plain route's within rtol 1e-5."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, make_fm_sparse_train_step

    _card()
    cfg = get_arch("fm").smoke_cfg
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(3):
        feats, labels = recsys_batch(cfg, 512, rng)
        batches.append({"feats": {k: torch.from_numpy(v).cuda() for k, v in feats.items()},
                        "labels": torch.from_numpy(labels).cuda()})
    routes = {}
    for use_kernel in (None, False):
        model = FMModel(dataclasses.replace(cfg, use_kernel=use_kernel), device="cuda")
        state = init_train_state(dict(model.named_parameters()))
        step = make_fm_sparse_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1,
                                                            total_steps=3))
        before = (fm_ops.launches, fm_ops.bwd_launches, fm_ops.forward_launches)
        losses = [float(step(state, b)[1]["loss"]) for b in batches]
        n = 0 if use_kernel is False else 3
        assert (fm_ops.launches - before[0], fm_ops.bwd_launches - before[1],
                fm_ops.forward_launches - before[2]) == (n, n, 0)
        routes[use_kernel] = (losses, state)
    np.testing.assert_allclose(routes[None][0], routes[False][0], rtol=1e-5)
    ks, ps = routes[None][1], routes[False][1]
    for a, b in ((ks.params["tables"], ps.params["tables"]),
                 (ks.opt["mu"]["tables"], ps.opt["mu"]["tables"]),
                 (ks.opt["nu"]["linear"], ps.opt["nu"]["linear"]), (ks.params["bias"],
                                                                   ps.params["bias"])):
        a, b = a.detach(), b.detach()
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))
