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

``conjunctive_topk_ref`` and ``conjunctive_topk_packed_ref`` are the plain
versions of the top-k kernels: the multi-term engine's tile loop (the JAX
package's ``core/search.py::conjunctive_multi_batch`` body), one
``tile``-wide chunk of every lane's driver list a step, probed by the scan
above, first-k compaction in driver-list order, a lane active while
``t * tile < d_len``, ``found < k`` and ``t < max_tiles``; a host sync a
step. Lane inputs: d_start/d_end int32[B] (the driver list's span of the
raw ``postings``, which give the candidates on every codec), the needed
spans starts/ends int32[B, P], dead bool[B] (the lane answers all INF).
Output: int32[B, k], INF-padded. ``fwd_stride`` S > 1 reads a docid
stripe's forward rows (``fwd_rows_of``); the per-tile scans take none, as
their kernels, off every serving path, read an unstriped index.
"""
from __future__ import annotations

import torch

INF = 2**31 - 1


def fwd_rows_of(fwd_terms, cands, stride: int = 1):
    """Forward rows of ``cands`` [B, T] -> [B, T, M]: ``Completions.extract``
    with ``stride`` 1; a docid stripe's ``LocalFwd.extract`` with ``stride``
    S, where docid d is row d // S and valid while 0 <= d < n_rows * S."""
    n = fwd_terms.shape[0]
    if stride == 1:
        valid = (cands >= 0) & (cands < n)
        row = cands.clamp(0, n - 1)
    else:
        valid = (cands >= 0) & (cands.to(torch.int64) < n * stride)
        row = torch.div(cands, stride, rounding_mode="floor").clamp(0, n - 1)
    return torch.where(valid[..., None], fwd_terms[row], 0)


def conjunctive_scan_ref(cands, starts, ends, postings, fwd_terms, term_lo,
                         term_hi, *, iters: int):
    n_post = postings.shape[0]
    return _scan(cands, starts, ends, lambda p: postings[p.clamp(0, n_post - 1)],
                 fwd_terms, term_lo, term_hi, iters)


def conjunctive_scan_packed_ref(cands, starts, ends, packed, fwd_terms,
                                term_lo, term_hi, *, iters: int):
    return _scan(cands, starts, ends, packed.lookup, fwd_terms, term_lo,
                 term_hi, iters)


def _scan(cands, starts, ends, lookup, fwd_terms, term_lo, term_hi, iters,
          fwd_stride=1):
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
    rows = fwd_rows_of(fwd_terms, cands, fwd_stride)
    fwd_ok = ((rows >= term_lo[:, None, None])
              & (rows < term_hi[:, None, None])).any(dim=2)
    return member & fwd_ok & (cands != INF)


def conjunctive_topk_ref(postings, d_start, d_end, starts, ends, dead,
                         fwd_terms, term_lo, term_hi, *, k: int, tile: int,
                         max_tiles: int, iters: int, fwd_stride: int = 1):
    n_post = postings.shape[0]
    scan = lambda cand: _scan(cand, starts, ends,
                              lambda p: postings[p.clamp(0, n_post - 1)],
                              fwd_terms, term_lo, term_hi, iters, fwd_stride)
    return _topk(postings, d_start, d_end, dead, scan, k, tile, max_tiles)


def conjunctive_topk_packed_ref(postings, packed, d_start, d_end, starts, ends,
                                dead, fwd_terms, term_lo, term_hi, *, k: int,
                                tile: int, max_tiles: int, iters: int,
                                fwd_stride: int = 1):
    scan = lambda cand: _scan(cand, starts, ends, packed.lookup, fwd_terms,
                              term_lo, term_hi, iters, fwd_stride)
    return _topk(postings, d_start, d_end, dead, scan, k, tile, max_tiles)


def _topk(postings, d_start, d_end, dead, scan, k, tile, max_tiles):
    dev = d_start.device
    B = d_start.shape[0]
    n_post = postings.shape[0]
    d_len = d_end - d_start
    lane = torch.arange(tile, dtype=torch.int32, device=dev)
    t = torch.zeros(B, dtype=torch.int32, device=dev)
    found = torch.zeros(B, dtype=torch.int32, device=dev)
    res = torch.full((B, k + 1), INF, dtype=torch.int32, device=dev)
    while True:
        active = (t * tile < d_len) & (found < k) & (t < max_tiles)
        if not bool(active.any()):
            break
        base = d_start + t * tile
        in_list = (base[:, None] + lane[None, :]) < d_end[:, None]
        cand = postings[(base[:, None] + lane[None, :]).clamp(max=n_post - 1)]
        mask = scan(torch.where(in_list, cand, INF))
        hits = mask & in_list & ~dead[:, None] & active[:, None]
        # first-k compaction in docid order (per lane); column k is the sink
        pos_out = found[:, None] + torch.cumsum(hits.to(torch.int32), 1) - 1
        write = hits & (pos_out < k)
        res.scatter_(1, torch.where(write, pos_out, k).to(torch.int64),
                     torch.where(write, cand, INF))
        found = (found + hits.sum(dim=1, dtype=torch.int32)).clamp(max=k)
        t = torch.where(active, t + 1, t)
    return res[:, :k]
