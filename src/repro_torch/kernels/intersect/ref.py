"""Plain PyTorch version of the fused conjunctive probe (paper Fig 5 inner loop).

Span form: each candidate lane binary-searches each slot's ``[start, end)``
span of the raw ``postings`` with ``iters`` valid-guarded halvings (the loop
of the JAX package's packed probe, ``kernels/intersect/ref.py::
conjunctive_scan_packed_ref``, with a raw lookup), ANDs the hits, and
applies the forward-index suffix-range test. A slot with ``start == end`` is
skipped (unused, or an empty list whose lane the caller kills). It gives the
same mask as the JAX ``conjunctive_scan_ref`` over lists gathered from the
same spans, without materialising a [B, P, L] probe-list tile.

Inputs: cands int32[B, T] (INF-padded), starts/ends int32[B, P],
postings int32[n_post], fwd_terms int32[N, M] (docid -> term row; a docid
outside [0, N) reads a row of zeros, as ``Completions.extract`` does),
term_lo/term_hi int32[B]. Output: bool[B, T].

``conjunctive_scan_packed_ref`` is the same loop over a ``PackedPostings``
(``packed_lookup`` decodes in place of the raw reads): the plain version of
the packed kernel, as the JAX package's ``conjunctive_scan_packed_ref``.
"""
from __future__ import annotations

import torch

INF = 2**31 - 1


def fwd_rows_of(fwd_terms, cands):
    """``Completions.extract`` rows of ``cands`` [B, T] -> [B, T, M]."""
    n = fwd_terms.shape[0]
    valid = (cands >= 0) & (cands < n)
    return torch.where(valid[..., None], fwd_terms[cands.clamp(0, n - 1)], 0)


def conjunctive_scan_ref(cands, starts, ends, postings, fwd_terms, term_lo,
                         term_hi, *, iters: int):
    n_post = postings.shape[0]
    return _scan(cands, starts, ends, lambda p: postings[p.clamp(0, n_post - 1)],
                 fwd_terms, term_lo, term_hi, iters)


def conjunctive_scan_packed_ref(cands, starts, ends, packed, fwd_terms,
                                term_lo, term_hi, *, iters: int):
    return _scan(cands, starts, ends, packed.lookup, fwd_terms, term_lo,
                 term_hi, iters)


def _scan(cands, starts, ends, lookup, fwd_terms, term_lo, term_hi, iters):
    B, T = cands.shape
    member = torch.ones((B, T), dtype=torch.bool, device=cands.device)
    for p in range(starts.shape[1]):
        s = starts[:, p:p + 1].to(torch.int32)
        e = ends[:, p:p + 1].to(torch.int32)
        if not bool((e > s).any()):
            continue                      # a slot no row needs changes nothing
        lo = s.expand(B, T)
        hi = e.expand(B, T)
        for _ in range(iters):
            mid = (lo + hi) // 2
            go = lookup(mid) < cands
            valid = lo < hi
            lo, hi = (torch.where(valid & go, mid + 1, lo),
                      torch.where(valid & ~go, mid, hi))
        hit = (lo < e) & (lookup(lo) == cands)
        member &= torch.where(e > s, hit, True)
    rows = fwd_rows_of(fwd_terms, cands)
    fwd_ok = ((rows >= term_lo[:, None, None])
              & (rows < term_hi[:, None, None])).any(dim=2)
    return member & fwd_ok & (cands != INF)
