"""Plain PyTorch version of the bounded-trip single-term engine (paper §3.3).

A transcription of the JAX package's ``kernels/heap_topk/ref.py``. Each
trip pops the per-lane minimum of ``cap = 2*trips + 1`` dense slots
(kind/lo/hi/pos/val; kind 0 is a range of the ``minimal`` array, kind 1 a
posting-list iterator), emits its docid unless it repeats the previous
one, splits a popped range with two RMQs, and instantiates or advances
posting-list iterators from ``offsets``/``postings``.

``torch.argmin`` returns the first minimum, as ``jnp.argmin`` does: equal
docids sit in range and iterator slots at once, so the lowest slot index
decides emission order and ``done``. JAX drops the emit past column k
(``mode="drop"``); here it sinks into an explicit spare column k that is
cut off at the end. Every gather index is clamped explicitly.

Term ranges [term_lo, term_hi) per lane -> (out int32[B, k] ascending,
INF-padded, done bool[B]): ``done`` is True iff k docids were emitted or
the heap is exhausted (the caller ORs in its bad-range and full-budget
conditions). ``rmq_fn(p, q) -> (pos, val)`` overrides the split-subrange
RMQ (``RangeMin.query_batch`` contract), which is how the per-pop route
sends each pop's RMQ through the CUDA RMQ kernel. ``packed`` (a
``PackedPostings``) swaps the raw postings reads for ``packed_lookup``
decodes, the plain version of the packed kernel; answers are the same
because ``packed_lookup(ptr) == postings[min(ptr, n_post-1)]``.
``count_trips=True`` adds a third result, int32[B]: the trips each lane
ran before its answer was settled (a pop while fewer than k docids were
out and the heap was not exhausted), which the kernel's loop runs too.
"""
from __future__ import annotations

import torch

from ..rmq.ref import rmq_window_batch

INF = 2**31 - 1


def heap_topk_ref(values, st_pos, ib, offsets, postings, term_lo, term_hi, *,
                  k: int, trips: int, n: int, n_terms: int, rmq_fn=None,
                  packed=None, count_trips: bool = False):
    if rmq_fn is None:
        rmq_fn = lambda p, q: rmq_window_batch(values, ib, st_pos, p, q, n=n)
    dev = term_lo.device
    if packed is not None:
        lookup = packed.lookup
    else:
        n_post = postings.shape[0]
        lookup = lambda ptrs: postings[ptrs.clamp(0, n_post - 1)]
    i32 = dict(dtype=torch.int32, device=dev)
    term_lo = term_lo.to(torch.int32)
    B = term_lo.shape[0]
    rows = torch.arange(B, device=dev)
    cap = 2 * trips + 1
    hi_incl = term_hi.to(torch.int32) - 1
    pos0, val0 = rmq_fn(term_lo, hi_incl)
    kind = torch.zeros((B, cap), **i32)
    lo_a = torch.zeros((B, cap), **i32)
    hi_a = torch.full((B, cap), -1, **i32)
    pos_a = torch.zeros((B, cap), **i32)
    val_a = torch.full((B, cap), INF, **i32)
    lo_a[:, 0] = term_lo
    hi_a[:, 0] = hi_incl
    pos_a[:, 0] = pos0
    val_a[:, 0] = torch.where(term_lo <= hi_incl, val0, INF)
    out = torch.full((B, k + 1), INF, **i32)      # column k: the drop sink
    n_out = torch.zeros(B, **i32)
    prev = torch.full((B,), -1, **i32)
    ran = torch.zeros(B, **i32)
    for i in range(trips):
        nf = 1 + 2 * i
        best = torch.argmin(val_a, dim=1)
        bval = val_a[rows, best]
        found = bval < INF
        is_range = kind[rows, best] == 0
        emit = found & (bval != prev)
        ran += (found & (n_out < k)).to(torch.int32)
        out[rows, torch.where(emit & (n_out < k), n_out, k)] = bval
        n_out = n_out + emit.to(torch.int32)
        prev = torch.where(found, bval, prev)
        tstar = pos_a[rows, best]
        lo = lo_a[rows, best]
        hi = hi_a[rows, best]
        pos2, val2 = rmq_fn(torch.cat([lo, tstar + 1]), torch.cat([tstar - 1, hi]))
        lpos, rpos = pos2[:B], pos2[B:]
        lval = torch.where((lo <= tstar - 1) & found & is_range, val2[:B], INF)
        rval = torch.where((tstar + 1 <= hi) & found & is_range, val2[B:], INF)
        ct = tstar.clamp(0, n_terms)
        cl = lo.clamp(0, n_terms)
        it_start, it_end, adv_end = offsets[ct], offsets[ct + 1], offsets[cl + 1]
        it_ptr = it_start + 1                     # minimal was postings[start]
        adv_ptr = tstar + 1                       # iterator pop: ptr + 1
        pv = lookup(torch.cat([it_ptr, adv_ptr]))
        it_val = torch.where((it_ptr < it_end) & found & is_range, pv[:B], INF)
        adv_val = torch.where((adv_ptr < adv_end) & found & ~is_range, pv[B:], INF)
        # popped slot: a range keeps its left part, an iterator advances
        kind[rows, best] = torch.where(is_range, 0, 1).to(torch.int32)
        hi_a[rows, best] = torch.where(is_range, tstar - 1, hi)
        pos_a[rows, best] = torch.where(is_range, lpos, adv_ptr)
        val_a[rows, best] = torch.where(is_range, lval, adv_val)
        # two fresh slots, live only after a range pop
        live = found & is_range
        kind[:, nf] = 0
        lo_a[:, nf] = tstar + 1
        hi_a[:, nf] = hi
        pos_a[:, nf] = rpos
        val_a[:, nf] = torch.where(live, rval, INF)
        kind[:, nf + 1] = 1
        lo_a[:, nf + 1] = tstar                   # iterator: term id here
        hi_a[:, nf + 1] = -1
        pos_a[:, nf + 1] = it_ptr
        val_a[:, nf + 1] = torch.where(live, it_val, INF)
    done = (n_out >= k) | (val_a.min(dim=1).values >= INF)
    if count_trips:
        return out[:, :k].contiguous(), done, ran
    return out[:, :k].contiguous(), done
