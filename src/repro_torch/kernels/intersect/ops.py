"""``conjunctive_scan``: the fused conjunctive probe, as a CUDA kernel.

On CUDA tensors it launches ``csrc/intersect.cu`` (one thread per
(row, candidate)); on CPU tensors it runs the plain version
``ref.conjunctive_scan_ref``. ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes

import torch

from ... import backend
from .ref import conjunctive_scan_ref

launches = 0

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]


def conjunctive_scan(cands, starts, ends, postings, fwd_terms, term_lo,
                     term_hi, *, iters: int):
    """bool[B, T] conjunctive hits; see ``ref.conjunctive_scan_ref``."""
    global launches
    if not cands.is_cuda:
        return conjunctive_scan_ref(cands, starts, ends, postings, fwd_terms,
                                    term_lo, term_hi, iters=iters)
    cands, starts, ends, term_lo, term_hi = (
        t.to(torch.int32).contiguous()
        for t in (cands, starts, ends, term_lo, term_hi))
    backend.require_cuda_int32("conjunctive_scan", cands=cands, starts=starts,
                               ends=ends, postings=postings,
                               fwd_terms=fwd_terms, term_lo=term_lo,
                               term_hi=term_hi)
    B, T = cands.shape
    P = starts.shape[1]
    if ends.shape != starts.shape or starts.shape[0] != B:
        raise ValueError("conjunctive_scan: starts/ends must be [B, P]")
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
