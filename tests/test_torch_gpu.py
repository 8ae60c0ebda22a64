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
``test_torch_fm_pairwise.py``), unscaled at the models' embedding scale.
``flash_attention`` is held to its plain version with the tolerances of
``tests/test_kernels.py``: rtol and atol 2e-5 in fp32, 2e-2 in bf16; the LM
at smoke width (fp32) to the plain route within rtol and atol 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import build_qac_index, parse_queries
from repro_torch.configs import get_arch
from repro_torch.core.codecs import pack_postings
from repro_torch.data import recsys_batch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.fm_pairwise import ops as fm_ops
from repro_torch.kernels.fm_pairwise.ref import fm_pairwise_ref
from repro_torch.kernels.heap_topk import ops as heap_ops
from repro_torch.kernels.heap_topk.ref import heap_topk_ref
from repro_torch.kernels.intersect import ops as isect_ops
from repro_torch.kernels.intersect.ref import (conjunctive_scan_packed_ref,
                                               conjunctive_scan_ref)
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
@pytest.mark.parametrize("k,trips", [(10, 12), (1, 2), (64, 128)])
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


def test_frontend_routes_agree_on_card(built):
    qidx, kept = built
    rng = np.random.default_rng(11)
    parsed = parse_queries(qidx.dictionary, _partials(kept, rng, 256))
    pids, plen, _, suf, slen = parsed
    counts = (heap_ops.launches, rmq_ops.launches, isect_ops.launches)
    kernel = QACFrontend(qidx).complete(pids, plen, suf, slen)
    per_pop = QACFrontend(qidx, heap_kernel=False).complete(pids, plen, suf, slen)
    plain = QACFrontend(qidx, use_kernel=False).complete(pids, plen, suf, slen)
    np.testing.assert_array_equal(kernel, plain)
    np.testing.assert_array_equal(per_pop, plain)
    after = (heap_ops.launches, rmq_ops.launches, isect_ops.launches)
    assert all(a > b for a, b in zip(after, counts))
    for codec in ("ef", "bitpack"):
        q = qidx if codec == "ef" else dataclasses.replace(
            qidx, index=dataclasses.replace(qidx.index, packed=_packed(qidx, codec)))
        counts = (heap_ops.launches, isect_ops.launches,
                  heap_ops.packed_launches, isect_ops.packed_launches)
        got = QACFrontend(q, postings_codec=codec).complete(pids, plen, suf, slen)
        np.testing.assert_array_equal(got, plain)
        after = (heap_ops.launches, isect_ops.launches,
                 heap_ops.packed_launches, isect_ops.packed_launches)
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
                e.clone().requires_grad_()):
        with pytest.raises(ValueError):
            fm_ops.fm_pairwise(bad)
    assert fm_ops.launches == before
    got = fm_ops.fm_pairwise(e.transpose(1, 2).contiguous())
    _assert_fm_close(got, fm_pairwise_ref(e.transpose(1, 2)), e.transpose(1, 2))


def test_fm_model_launches_the_kernel_once_per_forward():
    _card()
    cfg = get_arch("fm").smoke_cfg
    model = FMModel(cfg, device="cuda")
    feats, _ = recsys_batch(cfg, 300, np.random.default_rng(0))
    feats = {k: torch.from_numpy(v).cuda() for k, v in feats.items()}
    with torch.inference_mode():
        before = fm_ops.launches
        routed = model(feats)
        assert fm_ops.launches == before + 1
        model.use_kernel = False
        plain = model(feats)
        assert fm_ops.launches == before + 1
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
           (q.clone().requires_grad_(), k, None)]
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
