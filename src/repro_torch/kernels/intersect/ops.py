"""``conjunctive_scan``: the fused conjunctive probe, as a CUDA kernel.

Two wrappers: ``conjunctive_scan`` probes raw postings,
``conjunctive_scan_packed`` decodes a ``PackedPostings`` (the kernel's
"ef" or "bitpack" instantiation, picked by ``packed.has_ef``). On CUDA
tensors each launches ``csrc/intersect.cu`` (one thread per (row,
candidate)); on CPU tensors each runs its plain version,
``ref.conjunctive_scan_ref`` or ``ref.conjunctive_scan_packed_ref``.
``launches`` and ``packed_launches`` count kernel launches only.
"""
from __future__ import annotations

import ctypes

import torch

from ... import backend
from .ref import conjunctive_scan_packed_ref, conjunctive_scan_ref

launches = 0
packed_launches = 0

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
_PACKED_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p] \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]


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
