"""QAC search engines (paper §3.1, §3.3), batch-native.

  * ``single_term_topk_bounded_batch`` — paper §3.3 "Single-Term Queries":
    RMQ over the ``minimal`` array with lazily instantiated posting-list
    iterators, as a dense-slot loop with a caller-chosen trip budget.
  * ``conjunctive_multi_batch`` — Fig 5 (Fwd): intersection of the prefix
    posting lists iterated in docid (= score) order, forward-index range
    check, first-k compaction.

Kernel routing on the card (``use_kernel=True``, the default there): the
single-term engine runs the whole trip loop in the ``heap_topk`` kernel;
the multi-term engine runs its whole candidate loop in one launch of the
``intersect`` top-k kernel. That is the route rule, measured on an H100:
``heap_topk`` beat the per-pop route (the same loop one pop at a time, each
pop's RMQ in the ``rmq`` kernel) by ~80x in device time at B = 1, 8, 64
and 256, so ``heap_kernel=False``, which takes the per-pop route, stays
only as the tests' way to reach it. ``use_kernel=False`` runs the plain
PyTorch versions on whatever device the index is on. Routing never changes
answers. The index lives in device memory, so no route is gated on its
size.

``postings_codec`` picks the postings both engines read: None, "auto" and
"raw" read raw CSR, the serving default (packed postings were no faster
single-term and slower multi-term on an H100); "ef" and "bitpack" pin the
index's compressed postings
(``index.packed``, which must exist with that codec), decoded per read by
the packed kernels or their plain versions. The per-pop RMQ route and the
multi-term candidates (the shortest prefix list) read raw CSR on every
codec, as in the JAX package. The JAX package's "auto" also falls back to
the compressed layout when only it fits the TPU's VMEM
(``heap_kernel_max_bytes``, ``_heap_kernel_fits``); on the card the index
sits in device memory, so that gate is not ported and "auto" means raw.

Results are docids, ascending == best-score-first; INF_DOCID pads.
"""
from __future__ import annotations

import torch

from .types import INF_DOCID
from .inverted_index import InvertedIndex
from .rmq import RangeMin

INT32_MAX = 2**31 - 1


def _resolve_packed(index: InvertedIndex, postings_codec: str | None):
    """The ``PackedPostings`` an explicit codec asks for, else None."""
    if postings_codec in (None, "auto", "raw"):
        return None
    packed = index.packed
    if packed is None:
        raise ValueError(
            f"postings_codec={postings_codec!r} but the index has no packed "
            f"postings (build it with postings_codec={postings_codec!r})")
    if packed.codec != postings_codec:
        raise ValueError(
            f"postings_codec={postings_codec!r} but the index was packed as "
            f"{packed.codec!r}")
    return packed


def describe_single_route(*, use_kernel: bool,
                          heap_kernel: bool | None = None,
                          postings_codec: str | None = None) -> str:
    """The route ``single_term_topk_bounded_batch`` takes for these knobs:
    ``"heap_topk[raw]"``, ``"heap_topk[ef]"``, ``"heap_topk[bitpack]"``,
    ``"per_pop_rmq[kernel]"`` or ``"torch_ref"``."""
    if not use_kernel:
        return "torch_ref"
    if heap_kernel is False:
        return "per_pop_rmq[kernel]"
    explicit = postings_codec not in (None, "auto", "raw")
    return f"heap_topk[{postings_codec if explicit else 'raw'}]"


def single_term_topk_bounded_batch(index: InvertedIndex, rmq_minimal: RangeMin,
                                   term_lo, term_hi, k: int, trips: int, *,
                                   use_kernel: bool = False,
                                   heap_kernel: bool | None = None,
                                   postings_codec: str | None = None):
    """Single-term top-k over term ranges [term_lo, term_hi) int32[B].

    Returns (out int32[B, k], done bool[B]). ``done`` is True iff the result
    equals the full 2k-trip engine's; a full 2k budget is the exact engine
    and never signals a fallback.
    """
    from ..kernels.heap_topk.ops import heap_topk, heap_topk_packed
    from ..kernels.heap_topk.ref import heap_topk_ref

    packed = _resolve_packed(index, postings_codec)
    trips = min(trips, 2 * k)
    bad = term_lo >= term_hi
    rm = (rmq_minimal.values, rmq_minimal.st_pos, rmq_minimal.ib, index.offsets)
    args = (*rm, index.postings, term_lo, term_hi)
    kw = dict(k=k, trips=trips, n=rmq_minimal.n, n_terms=index.n_terms)
    route = describe_single_route(use_kernel=use_kernel, heap_kernel=heap_kernel,
                                  postings_codec=postings_codec)
    if route == "heap_topk[raw]":
        out, done = heap_topk(*args, **kw)
    elif route.startswith("heap_topk["):
        out, done = heap_topk_packed(*rm, packed, term_lo, term_hi, **kw)
    elif route == "per_pop_rmq[kernel]":
        out, done = heap_topk_ref(*args, **kw, rmq_fn=lambda p, q:
                                  rmq_minimal.query_batch(p, q, use_kernel=True))
    else:
        out, done = heap_topk_ref(*args, **kw, packed=packed)
    done = bad | done | (trips >= 2 * k)
    return torch.where(bad[:, None], INF_DOCID, out), done


def single_term_topk_batch(index: InvertedIndex, rmq_minimal: RangeMin,
                           term_lo, term_hi, k: int, *,
                           use_kernel: bool = False,
                           heap_kernel: bool | None = None,
                           postings_codec: str | None = None):
    """Full 2k-trip budget, always exact -> out int32[B, k]."""
    out, _ = single_term_topk_bounded_batch(
        index, rmq_minimal, term_lo, term_hi, k, 2 * k, use_kernel=use_kernel,
        heap_kernel=heap_kernel, postings_codec=postings_codec)
    return out


def conjunctive_lanes(index: InvertedIndex, prefix_ids, prefix_len, term_lo,
                      term_hi):
    """The multi-term engine's lanes: (d_start, d_end, starts, ends, dead).

    The shortest prefix list of each lane drives (the first minimum): its
    span ``[d_start, d_end)`` of the postings gives the candidates.
    ``starts``/``ends`` [B, PMAX] are the other prefix lists' spans, 0/0 on a
    slot the lane does not need. ``dead`` marks a lane that answers all INF:
    an empty list it needs, an empty suffix range, no prefix, or a prefix id
    0 (unknown term).
    """
    dev = prefix_ids.device
    B, PMAX = prefix_ids.shape
    rows = torch.arange(B, device=dev)
    slots = torch.arange(PMAX, device=dev)
    valid_t = slots[None, :] < prefix_len[:, None]                  # [B, PMAX]
    starts, ends = index.list_bounds(prefix_ids)                   # [B, PMAX]
    lens = torch.where(valid_t, ends - starts, INT32_MAX)
    driver = torch.argmin(lens, dim=1)                             # first minimum
    need = valid_t & (slots[None, :] != driver[:, None])           # [B, PMAX]
    lane_dead = (need & (ends == starts)).any(dim=1)               # [B]
    bad = ((term_lo >= term_hi) | (prefix_len <= 0)
           | (valid_t & (prefix_ids == 0)).any(dim=1))
    return (starts[rows, driver], ends[rows, driver],
            torch.where(need, starts, 0).to(torch.int32),
            torch.where(need, ends, 0).to(torch.int32), lane_dead | bad)


def conjunctive_multi_batch(index: InvertedIndex, completions, prefix_ids,
                            prefix_len, term_lo, term_hi, k: int, *,
                            tile: int = 128, max_tiles: int = 4096,
                            use_kernel: bool = False, probe_iters: int = 0,
                            postings_codec: str | None = None):
    """Conjunctive top-k: prefix_ids int32[B, PMAX], the rest int32[B].

    The shortest prefix list drives (``conjunctive_lanes``): each lane's
    answer is its first k candidates, in driver-list order, that lie in
    every other prefix list's ``[start, end)`` span of ``postings`` and
    whose forward row holds a suffix term, among the first
    ``max_tiles * tile`` candidates of its driver list. With ``use_kernel``
    the whole candidate loop is one launch of ``conjunctive_topk`` (or
    ``conjunctive_topk_packed`` over ``index.packed`` under an explicit
    ``postings_codec``; the candidates still come from the raw postings),
    with no host sync. Else the plain versions run the JAX package's tile
    loop: one ``tile``-wide chunk of every lane a step, probed with
    ``conjunctive_scan_ref`` (or its packed form), per-lane progress masked,
    a host sync a step. Both give the same answers. An empty list that a
    lane needs kills the lane. ``probe_iters`` caps the binary-search depth
    (callers that know the longest probed list pass its bound); 0 uses
    ``log2(n_postings) + 1``.
    """
    from ..kernels.intersect import ops, ref

    packed = _resolve_packed(index, postings_codec)
    n_post = index.postings.shape[0]
    iters = probe_iters or min(31, max(1, n_post.bit_length()))
    lanes = conjunctive_lanes(index, prefix_ids, prefix_len, term_lo, term_hi)
    kw = dict(k=k, tile=tile, max_tiles=max_tiles, iters=iters)
    if packed is None:
        topk = ops.conjunctive_topk if use_kernel else ref.conjunctive_topk_ref
        return topk(index.postings, *lanes, completions.fwd_terms, term_lo,
                    term_hi, **kw)
    topk = (ops.conjunctive_topk_packed if use_kernel
            else ref.conjunctive_topk_packed_ref)
    return topk(index.postings, packed, *lanes, completions.fwd_terms, term_lo,
                term_hi, **kw)
