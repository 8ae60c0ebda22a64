"""The fused conjunctive probe and the multi-term engine, as CUDA kernels.

``conjunctive_scan`` probes one [B, T] tile of candidates over raw
postings, ``conjunctive_scan_packed`` over a ``PackedPostings`` (the
kernel's "ef" or "bitpack" instantiation, picked by ``packed.has_ef``): one
thread per (row, candidate); they read an unstriped forward index, are off
every serving path and take no stride. ``conjunctive_topk`` and
``conjunctive_topk_packed`` run the multi-term engine's whole candidate
loop in one launch (one block per lane) and return its first-k docids;
``fwd_stride`` S > 1 reads a docid stripe's forward rows (row d // S). On
CUDA tensors each launches its kernel in ``csrc/intersect.cu``; on CPU
tensors each runs its plain version in ``ref``. ``launches``,
``packed_launches``, ``topk_launches`` and ``topk_packed_launches`` count
kernel launches only.
"""
from __future__ import annotations

import ctypes

import torch

from ... import backend
from .ref import (conjunctive_scan_packed_ref, conjunctive_scan_ref,
                  conjunctive_topk_packed_ref, conjunctive_topk_ref)

launches = 0
packed_launches = 0
topk_launches = 0
topk_packed_launches = 0

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
_PACKED_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p] \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
_TOPK_HEAD = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
_TOPK_TAIL = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 \
    + [ctypes.c_int] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 2 \
    + [ctypes.c_void_p]
_TOPK_ARGS = _TOPK_HEAD + _TOPK_TAIL
_TOPK_PACKED_ARGS = _TOPK_HEAD + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
    + _TOPK_TAIL


def _check(cands, starts, ends, fwd_terms, term_lo, term_hi, **more):
    """Validate what the kernel takes; returns the int32 contiguous inputs."""
    cands, starts, ends, term_lo, term_hi = (
        t.to(torch.int32).contiguous()
        for t in (cands, starts, ends, term_lo, term_hi))
    backend.require_cuda_int32("conjunctive_scan", cands=cands, starts=starts,
                               ends=ends, fwd_terms=fwd_terms,
                               term_lo=term_lo, term_hi=term_hi, **more)
    if ends.shape != starts.shape or starts.shape[0] != cands.shape[0]:
        raise ValueError("conjunctive_scan: starts/ends must be [B, P]")
    return cands, starts, ends, term_lo, term_hi


def conjunctive_scan(cands, starts, ends, postings, fwd_terms, term_lo,
                     term_hi, *, iters: int):
    """bool[B, T] conjunctive hits; see ``ref.conjunctive_scan_ref``."""
    global launches
    if not cands.is_cuda:
        return conjunctive_scan_ref(cands, starts, ends, postings, fwd_terms,
                                    term_lo, term_hi, iters=iters)
    cands, starts, ends, term_lo, term_hi = _check(
        cands, starts, ends, fwd_terms, term_lo, term_hi, postings=postings)
    B, T = cands.shape
    P = starts.shape[1]
    out = torch.empty((B, T), dtype=torch.bool, device=cands.device)
    if B * T == 0:
        return out
    fn = backend.load("intersect", "conjunctive_scan_launch", _ARGS)
    err = fn(backend.ptr(cands), backend.ptr(starts), backend.ptr(ends),
             backend.ptr(postings), postings.shape[0], backend.ptr(fwd_terms),
             fwd_terms.shape[0], fwd_terms.shape[1], backend.ptr(term_lo),
             backend.ptr(term_hi), backend.ptr(out), B, T, P, iters,
             backend.stream(cands.device))
    backend.check("intersect", err)
    launches += 1
    return out


def conjunctive_scan_packed(cands, starts, ends, packed, fwd_terms, term_lo,
                            term_hi, *, iters: int):
    """``conjunctive_scan`` probing compressed postings: ``packed`` is the
    index's ``PackedPostings``; "ef" and "bitpack" each run their
    instantiation of the kernel. See ``ref.conjunctive_scan_packed_ref``."""
    global packed_launches
    if not cands.is_cuda:
        return conjunctive_scan_packed_ref(cands, starts, ends, packed,
                                           fwd_terms, term_lo, term_hi,
                                           iters=iters)
    cands, starts, ends, term_lo, term_hi = _check(
        cands, starts, ends, fwd_terms, term_lo, term_hi, words=packed.words,
        base=packed.base, meta=packed.meta, wordoff=packed.wordoff)
    B, T = cands.shape
    P = starts.shape[1]
    out = torch.empty((B, T), dtype=torch.bool, device=cands.device)
    if B * T == 0:
        return out
    fn = backend.load("intersect", "conjunctive_scan_packed_launch", _PACKED_ARGS)
    err = fn(backend.ptr(cands), backend.ptr(starts), backend.ptr(ends),
             backend.ptr(packed.words), backend.ptr(packed.base),
             backend.ptr(packed.meta), backend.ptr(packed.wordoff),
             packed.words.shape[0], packed.n_post, int(packed.has_ef),
             backend.ptr(fwd_terms), fwd_terms.shape[0], fwd_terms.shape[1],
             backend.ptr(term_lo), backend.ptr(term_hi), backend.ptr(out),
             B, T, P, iters, backend.stream(cands.device))
    backend.check("intersect", err)
    packed_launches += 1
    return out


def _check_topk(postings, d_start, d_end, starts, ends, dead, fwd_terms,
                term_lo, term_hi, **more):
    """Validate what the top-k kernel takes; returns the int32 contiguous
    lane inputs (``dead`` as 0/1)."""
    d_start, d_end, starts, ends, dead, term_lo, term_hi = (
        t.to(torch.int32).contiguous()
        for t in (d_start, d_end, starts, ends, dead, term_lo, term_hi))
    backend.require_cuda_int32("conjunctive_topk", postings=postings,
                               d_start=d_start, d_end=d_end, starts=starts,
                               ends=ends, dead=dead, fwd_terms=fwd_terms,
                               term_lo=term_lo, term_hi=term_hi, **more)
    B = d_start.shape[0]
    if starts.dim() != 2 or ends.shape != starts.shape or starts.shape[0] != B \
            or any(t.shape != (B,) for t in (d_end, dead, term_lo, term_hi)):
        raise ValueError("conjunctive_topk: lanes must be [B] and spans [B, P]")
    return d_start, d_end, starts, ends, dead, term_lo, term_hi


def _topk_launch(fn_name, argtypes, postings, lanes, middle, fwd_terms,
                 fwd_stride, out, cap, iters):
    d_start, d_end, starts, ends, dead, term_lo, term_hi = lanes
    B, P = starts.shape
    if fwd_stride < 1:
        raise ValueError(f"conjunctive_topk: fwd_stride must be >= 1, got {fwd_stride}")
    fn = backend.load("intersect", fn_name, argtypes)
    err = fn(backend.ptr(postings), postings.shape[0], backend.ptr(d_start),
             backend.ptr(d_end), backend.ptr(starts), backend.ptr(ends),
             backend.ptr(dead), *middle, backend.ptr(fwd_terms),
             fwd_terms.shape[0], fwd_stride, fwd_terms.shape[1], backend.ptr(term_lo),
             backend.ptr(term_hi), backend.ptr(out), B, out.shape[1], cap, P,
             iters, backend.stream(d_start.device))
    backend.check("intersect", err)


def conjunctive_topk(postings, d_start, d_end, starts, ends, dead, fwd_terms,
                     term_lo, term_hi, *, k: int, tile: int, max_tiles: int,
                     iters: int, fwd_stride: int = 1):
    """int32[B, k]: each lane's first k conjunctive hits among the first
    ``max_tiles * tile`` candidates of its driver list, in one launch; see
    ``ref.conjunctive_topk_ref`` (``fwd_stride``: docid d's forward row is
    row d // fwd_stride, a docid stripe's rows)."""
    global topk_launches
    if not d_start.is_cuda:
        return conjunctive_topk_ref(postings, d_start, d_end, starts, ends, dead,
                                    fwd_terms, term_lo, term_hi, k=k, tile=tile,
                                    max_tiles=max_tiles, iters=iters,
                                    fwd_stride=fwd_stride)
    lanes = _check_topk(postings, d_start, d_end, starts, ends, dead, fwd_terms,
                        term_lo, term_hi)
    out = torch.empty((lanes[0].shape[0], k), dtype=torch.int32,
                      device=d_start.device)
    if out.numel() == 0:
        return out
    _topk_launch("conjunctive_topk_launch", _TOPK_ARGS, postings, lanes, (),
                 fwd_terms, fwd_stride, out, max_tiles * tile, iters)
    topk_launches += 1
    return out


def conjunctive_topk_packed(postings, packed, d_start, d_end, starts, ends, dead,
                            fwd_terms, term_lo, term_hi, *, k: int, tile: int,
                            max_tiles: int, iters: int, fwd_stride: int = 1):
    """``conjunctive_topk`` probing compressed postings: the candidates come
    from the raw ``postings``, the probes decode ``packed`` (the same lists),
    in the "ef" or "bitpack" instantiation. See
    ``ref.conjunctive_topk_packed_ref``."""
    global topk_packed_launches
    if not d_start.is_cuda:
        return conjunctive_topk_packed_ref(postings, packed, d_start, d_end,
                                           starts, ends, dead, fwd_terms, term_lo,
                                           term_hi, k=k, tile=tile,
                                           max_tiles=max_tiles, iters=iters,
                                           fwd_stride=fwd_stride)
    if packed.n_post != postings.shape[0]:
        raise ValueError("conjunctive_topk_packed: packed postings hold "
                         f"{packed.n_post} postings, the raw ones {postings.shape[0]}")
    lanes = _check_topk(postings, d_start, d_end, starts, ends, dead, fwd_terms,
                        term_lo, term_hi, words=packed.words, base=packed.base,
                        meta=packed.meta, wordoff=packed.wordoff)
    middle = (backend.ptr(packed.words), backend.ptr(packed.base),
              backend.ptr(packed.meta), backend.ptr(packed.wordoff),
              packed.words.shape[0], int(packed.has_ef))
    out = torch.empty((lanes[0].shape[0], k), dtype=torch.int32,
                      device=d_start.device)
    if out.numel() == 0:
        return out
    _topk_launch("conjunctive_topk_packed_launch", _TOPK_PACKED_ARGS, postings,
                 lanes, middle, fwd_terms, fwd_stride, out, max_tiles * tile, iters)
    topk_packed_launches += 1
    return out
