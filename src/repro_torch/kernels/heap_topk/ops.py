"""``heap_topk``: the whole bounded-trip single-term engine in one launch.

Two wrappers: ``heap_topk`` reads raw postings, ``heap_topk_packed``
decodes a ``PackedPostings`` (the kernel instantiated for its codec). On
CUDA tensors each launches ``csrc/heap_topk.cu``; on CPU tensors each runs
the plain version ``ref.heap_topk_ref``. Same contract either way:
(out int32[B, k], done bool[B]). ``launches`` and ``packed_launches``
count kernel launches only. ``plan_heap_launch`` is the launch's shape: one
warp per query lane, its slots in the warp's share of shared memory.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ... import backend
from .ref import heap_topk_ref

launches = 0
packed_launches = 0

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 \
    + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_PACKED_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

SMEM_PER_BLOCK = 232_448    # the shared bytes an H100 block may use
MAX_WARPS = 4               # query lanes (warps) a block: B=256 fills 64 blocks
SLOT_FIELDS = 5             # kind, lo, hi, pos, val: int32 each


class HeapPlan(NamedTuple):
    blocks: int
    warps: int              # query lanes a block, one warp each
    smem: int               # dynamic shared bytes a block


def plan_heap_launch(k: int, trips: int, B: int = 1) -> HeapPlan:
    """The heap_topk launch for B lanes: lane b is warp ``b % warps`` of
    block ``b // warps``, with its ``cap = 2*trips + 1`` slots in that warp's
    share of the block's shared memory (``k`` sizes nothing on chip: the
    emitted docids go straight to ``out``). Up to MAX_WARPS lanes a block,
    fewer when their slots would pass SMEM_PER_BLOCK, and never fewer than
    one: a budget one lane's slots cannot fit in is left to the card to
    refuse, and the wrapper raises its error."""
    if k < 1 or trips < 0 or B < 0:
        raise ValueError(f"heap_topk: needs k >= 1, trips >= 0 and B >= 0, got "
                         f"{k}, {trips}, {B}")
    lane_bytes = SLOT_FIELDS * 4 * (2 * trips + 1)
    warps = max(1, min(MAX_WARPS, SMEM_PER_BLOCK // lane_bytes))
    return HeapPlan(-(-B // warps), warps, warps * lane_bytes)


def _check(values, st_pos, ib, offsets, term_lo, term_hi, k, trips, **more):
    """Validate what the kernel takes; returns int32 contiguous term ranges."""
    term_lo = term_lo.to(torch.int32).contiguous()
    term_hi = term_hi.to(torch.int32).contiguous()
    backend.require_cuda_int32("heap_topk", values=values, st_pos=st_pos,
                               offsets=offsets, term_lo=term_lo,
                               term_hi=term_hi, **more)
    if ib.dtype != torch.int8 or not ib.is_contiguous() or ib.device != values.device:
        raise ValueError("heap_topk: ib must be a contiguous int8 tensor on the card")
    return term_lo, term_hi


def heap_topk(values, st_pos, ib, offsets, postings, term_lo, term_hi, *,
              k: int, trips: int, n: int, n_terms: int):
    """values/st_pos/ib: the ``RangeMin`` over the ``minimal`` array (``n``
    its true length); offsets/postings: the inverted index; term ranges
    [term_lo, term_hi) per lane. See ``ref.heap_topk_ref``."""
    global launches
    if not values.is_cuda:
        return heap_topk_ref(values, st_pos, ib, offsets, postings, term_lo,
                             term_hi, k=k, trips=trips, n=n, n_terms=n_terms)
    term_lo, term_hi = _check(values, st_pos, ib, offsets, term_lo, term_hi,
                              k, trips, postings=postings)
    levels, n_blocks = st_pos.shape
    B = term_lo.shape[0]
    plan = plan_heap_launch(k, trips, B)
    out = torch.empty((B, k), dtype=torch.int32, device=values.device)
    done = torch.empty(B, dtype=torch.bool, device=values.device)
    if B == 0:
        return out, done
    fn = backend.load("heap_topk", "heap_topk_launch", _ARGS)
    err = fn(backend.ptr(values), backend.ptr(ib), backend.ptr(st_pos),
             n, values.shape[0], levels, n_blocks,
             backend.ptr(offsets), backend.ptr(postings), postings.shape[0],
             n_terms, backend.ptr(term_lo), backend.ptr(term_hi),
             backend.ptr(out), backend.ptr(done), B, k, trips, *plan,
             backend.stream(values.device))
    backend.check("heap_topk", err)
    launches += 1
    return out, done


def heap_topk_packed(values, st_pos, ib, offsets, packed, term_lo, term_hi, *,
                     k: int, trips: int, n: int, n_terms: int):
    """``heap_topk`` over compressed postings: ``packed`` is the index's
    ``PackedPostings``; "ef" and "bitpack" each run their instantiation
    of the kernel. See ``ref.heap_topk_ref``."""
    global packed_launches
    if not values.is_cuda:
        return heap_topk_ref(values, st_pos, ib, offsets, None, term_lo,
                             term_hi, k=k, trips=trips, n=n, n_terms=n_terms,
                             packed=packed)
    term_lo, term_hi = _check(values, st_pos, ib, offsets, term_lo, term_hi,
                              k, trips, words=packed.words, base=packed.base,
                              meta=packed.meta, wordoff=packed.wordoff)
    levels, n_blocks = st_pos.shape
    B = term_lo.shape[0]
    plan = plan_heap_launch(k, trips, B)
    out = torch.empty((B, k), dtype=torch.int32, device=values.device)
    done = torch.empty(B, dtype=torch.bool, device=values.device)
    if B == 0:
        return out, done
    fn = backend.load("heap_topk", "heap_topk_packed_launch", _PACKED_ARGS)
    err = fn(backend.ptr(values), backend.ptr(ib), backend.ptr(st_pos),
             n, values.shape[0], levels, n_blocks, backend.ptr(offsets),
             backend.ptr(packed.words), backend.ptr(packed.base),
             backend.ptr(packed.meta), backend.ptr(packed.wordoff),
             packed.words.shape[0], packed.n_post, int(packed.has_ef), n_terms,
             backend.ptr(term_lo), backend.ptr(term_hi), backend.ptr(out),
             backend.ptr(done), B, k, trips, *plan,
             backend.stream(values.device))
    backend.check("heap_topk", err)
    packed_launches += 1
    return out, done
