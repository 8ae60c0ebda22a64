"""QAC search engines (paper §3.1, §3.3).

  * ``single_term_topk_bounded_batch`` — paper §3.3 "Single-Term Queries":
    RMQ over the ``minimal`` array with lazily instantiated posting-list
    iterators, as a dense-slot loop with a caller-chosen trip budget.
  * ``conjunctive_multi_batch`` — Fig 5 (Fwd): intersection of the prefix
    posting lists iterated in docid (= score) order, forward-index range
    check, first-k compaction.
  * ``complete_conjunctive_batch`` — both engines over one mixed batch,
    each run only when its class is present, selected per lane.

The per-query forms of the JAX package (``prefix_search_topk``,
``conjunctive_multi``, ``single_term_topk(_bounded)``,
``complete_conjunctive``) are plain loops over one query: the references
the batched engines are held to, and the ``*_vmap`` serve forms.

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
from .rmq import RangeMin, topk_in_range
from .searching import ranged_searchsorted

INT32_MAX = 2**31 - 1


# --------------------------------------------------------------------------
# per-query references
# --------------------------------------------------------------------------
def _i32(xs, device) -> torch.Tensor:
    return torch.tensor(xs, dtype=torch.int32, device=device)


def prefix_search_topk(completions, rmq_docids: RangeMin, prefix_ids,
                       prefix_len, term_lo, term_hi, k: int):
    """Fig 1a, one query: top-k docids of completions prefixed by the
    prefix terms and a term in [term_lo, term_hi) -> int32[k]."""
    p, q = completions.locate_prefix(prefix_ids, prefix_len, term_lo, term_hi)
    vals, _ = topk_in_range(rmq_docids, p, q, k)
    return torch.full_like(vals, INF_DOCID) if int(term_lo) >= int(term_hi) else vals


def conjunctive_multi(index: InvertedIndex, completions, prefix_ids,
                      prefix_len, term_lo, term_hi, k: int, *,
                      tile: int = 128, max_tiles: int = 4096):
    """Conjunctive top-k of one query with >= 1 prefix terms -> int32[k].

    prefix_ids int32[PMAX] 1-based (0 pad). Walks the shortest prefix list
    (the first minimum) in ``tile``-wide chunks, at most ``max_tiles`` of
    them; a candidate counts when it lies in every other prefix list
    (binary-search probes) and its forward row holds a term in
    [term_lo, term_hi); the first k in docid order are the answer.
    """
    dev = index.postings.device
    prefix_ids = torch.as_tensor(prefix_ids, device=dev)
    plen, tlo, thi = int(prefix_len), int(term_lo), int(term_hi)
    PMAX = prefix_ids.shape[0]
    valid_t = torch.arange(PMAX, device=dev) < plen
    starts, ends = index.list_bounds(prefix_ids)
    lens = torch.where(valid_t, ends - starts, INT32_MAX)
    driver = int(torch.argmin(lens))                       # first minimum
    d_start, d_end = int(starts[driver]), int(ends[driver])
    n_post = index.postings.shape[0]
    lane = torch.arange(tile, dtype=torch.int32, device=dev)
    res = [INF_DOCID] * k
    found, t = 0, 0
    while t * tile < d_end - d_start and found < k and t < max_tiles:
        at = d_start + t * tile + lane
        cand = index.postings[at.clamp(max=n_post - 1)]
        hits = at < d_end
        for j in range(PMAX):
            if j < plen and j != driver:
                pos = ranged_searchsorted(index.postings, cand, starts[j],
                                          ends[j], side="left")
                hits &= (pos < ends[j]) & (index.postings[pos.clamp(max=n_post - 1)] == cand)
        rows, _ = completions.extract(cand)
        hits &= ((rows >= tlo) & (rows < thi)).any(dim=1)
        for d in cand[hits].tolist()[: k - found]:          # first k, docid order
            res[found] = d
            found += 1
        t += 1
    bad = tlo >= thi or plen <= 0 or bool((valid_t & (prefix_ids == 0)).any())
    return _i32([INF_DOCID] * k if bad else res, dev)


def _single_term_loop(index: InvertedIndex, rmq_minimal: RangeMin, term_lo,
                      term_hi, k: int, trips: int):
    """The dense-slot lazy-iterator heap of paper §3.3 for one query, run
    ``trips`` pops: a slot is a ``minimal`` range (kind 0) or a posting-list
    iterator (kind 1), an iterator made only when its list's minimum pops;
    consecutive duplicate docids are emitted once. Every slot write of the
    JAX package's branchless body is kept, so the final slot values match
    its. -> (out list[k], n_out, the slot values)."""
    post = index.postings
    n_post = post.shape[0]
    query = lambda a, b: tuple(int(x) for x in rmq_minimal.query(a, b))
    bounds = lambda t: tuple(int(x) for x in index.list_bounds(torch.tensor(t)))
    cap = 2 * trips + 1
    lo0, hi_incl = int(term_lo), int(term_hi) - 1
    pos0, val0 = query(lo0, hi_incl)
    kind = [0] * cap
    lo_a, hi_a = [lo0] + [0] * (cap - 1), [hi_incl] + [-1] * (cap - 1)
    pos_a = [pos0] + [0] * (cap - 1)
    val_a = [val0 if lo0 <= hi_incl else INF_DOCID] + [INF_DOCID] * (cap - 1)
    out, n_out, nf, prev = [INF_DOCID] * k, 0, 1, -1
    for _ in range(trips):
        best = min(range(cap), key=val_a.__getitem__)      # first minimum
        bval = val_a[best]
        found = bval < INF_DOCID
        is_range = kind[best] == 0
        if found and bval != prev:                          # emit
            if n_out < k:
                out[n_out] = bval
            n_out += 1
        prev = bval if found else prev
        # range pop: split around the list t* holding the minimum, and
        # instantiate t*'s iterator at its second posting
        tstar, lo, hi = pos_a[best], lo_a[best], hi_a[best]
        lpos, lval = query(lo, tstar - 1)
        lval = lval if (lo <= tstar - 1 and found and is_range) else INF_DOCID
        rpos, rval = query(tstar + 1, hi)
        rval = rval if (tstar + 1 <= hi and found and is_range) else INF_DOCID
        it_start, it_end = bounds(tstar)
        it_ptr = it_start + 1
        it_val = (int(post[min(it_ptr, n_post - 1)])
                  if (it_ptr < it_end and found and is_range) else INF_DOCID)
        # iterator pop: advance (an iterator keeps its term in lo_a)
        adv_ptr = pos_a[best] + 1
        adv_end = bounds(lo_a[best])[1]
        adv_val = (int(post[min(adv_ptr, n_post - 1)])
                   if (adv_ptr < adv_end and found and not is_range) else INF_DOCID)
        kind[best] = 0 if is_range else 1
        if is_range:
            hi_a[best], pos_a[best], val_a[best] = tstar - 1, lpos, lval
        else:
            pos_a[best], val_a[best] = adv_ptr, adv_val
        live = found and is_range
        kind[nf], lo_a[nf], hi_a[nf], pos_a[nf] = 0, tstar + 1, hi, rpos
        val_a[nf] = rval if live else INF_DOCID
        kind[nf + 1], lo_a[nf + 1], hi_a[nf + 1], pos_a[nf + 1] = 1, tstar, -1, it_ptr
        val_a[nf + 1] = it_val if live else INF_DOCID
        nf += 2
    return out, n_out, val_a


def single_term_topk(index: InvertedIndex, rmq_minimal: RangeMin, term_lo,
                     term_hi, k: int):
    """Top-k docids in the union of the lists of terms in [term_lo,
    term_hi), one query, the full 2k pops -> int32[k]."""
    out, _, _ = _single_term_loop(index, rmq_minimal, term_lo, term_hi, k, 2 * k)
    bad = int(term_lo) >= int(term_hi)
    return _i32([INF_DOCID] * k if bad else out, index.postings.device)


def single_term_topk_bounded(index: InvertedIndex, rmq_minimal: RangeMin,
                             term_lo, term_hi, k: int, trips: int):
    """The single-term engine with a caller-chosen pop budget, one query ->
    (out int32[k], done bool): ``done`` iff the result equals the full
    2k-pop engine's (k emitted, every slot exhausted, or a 2k budget)."""
    trips = min(trips, 2 * k)
    out, n_out, val_a = _single_term_loop(index, rmq_minimal, term_lo,
                                          term_hi, k, trips)
    bad = int(term_lo) >= int(term_hi)
    done = bad or n_out >= k or min(val_a) >= INF_DOCID or trips >= 2 * k
    dev = index.postings.device
    return (_i32([INF_DOCID] * k if bad else out, dev),
            torch.tensor(done, device=dev))


def complete_conjunctive(index, completions, rmq_minimal, prefix_ids,
                         prefix_len, term_lo, term_hi, k: int, **kw):
    """Complete() of one parsed query (Fig 1b): the conjunctive engine when
    it has prefix terms, else the single-term engine -> int32[k]."""
    if int(prefix_len) > 0:
        return conjunctive_multi(index, completions, prefix_ids, prefix_len,
                                 term_lo, term_hi, k, **kw)
    return single_term_topk(index, rmq_minimal, term_lo, term_hi, k)


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
    ``log2(n_postings) + 1``. ``completions`` is the index's
    ``Completions`` or a docid stripe's ``LocalFwd``: its ``fwd_stride`` (1,
    or the stripe count) says which forward row holds a docid.
    """
    from ..kernels.intersect import ops, ref

    packed = _resolve_packed(index, postings_codec)
    n_post = index.postings.shape[0]
    iters = probe_iters or min(31, max(1, n_post.bit_length()))
    lanes = conjunctive_lanes(index, prefix_ids, prefix_len, term_lo, term_hi)
    kw = dict(k=k, tile=tile, max_tiles=max_tiles, iters=iters,
              fwd_stride=completions.fwd_stride)
    if packed is None:
        topk = ops.conjunctive_topk if use_kernel else ref.conjunctive_topk_ref
        return topk(index.postings, *lanes, completions.fwd_terms, term_lo,
                    term_hi, **kw)
    topk = (ops.conjunctive_topk_packed if use_kernel
            else ref.conjunctive_topk_packed_ref)
    return topk(index.postings, packed, *lanes, completions.fwd_terms, term_lo,
                term_hi, **kw)


def complete_conjunctive_batch(index, completions, rmq_minimal, prefix_ids,
                               prefix_len, term_lo, term_hi, k: int, *,
                               use_kernel: bool = False,
                               heap_kernel: bool | None = None,
                               postings_codec: str | None = None, **kw):
    """Complete() of a mixed batch: each engine runs over the whole batch
    only when its class is present, and each lane takes its own class's
    row -> int32[B, k]. ``kw`` (``tile``, ``max_tiles``, ``probe_iters``)
    goes to the multi-term engine.

    With ``use_kernel`` both classes take their kernels: ``heap_topk`` for
    the single-term lanes and one ``conjunctive_topk`` launch for the
    multi-term lanes. The JAX package keeps its multi-term class off the
    intersect kernel here, because its Pallas kernel holds the probe lists
    in a static ``list_pad`` that a jit-only call site cannot check; the
    port's kernel takes its probe depth from the postings' length and
    needs no such bound, and the answers are the same.
    """
    is_multi = prefix_len > 0
    absent = torch.full((prefix_len.shape[0], k), INF_DOCID, dtype=torch.int32,
                        device=prefix_len.device)
    multi = absent
    if bool(is_multi.any()):
        multi = conjunctive_multi_batch(index, completions, prefix_ids,
                                        prefix_len, term_lo, term_hi, k,
                                        use_kernel=use_kernel,
                                        postings_codec=postings_codec, **kw)
    single = absent
    if bool((~is_multi).any()):
        single = single_term_topk_batch(index, rmq_minimal, term_lo, term_hi, k,
                                        use_kernel=use_kernel,
                                        heap_kernel=heap_kernel,
                                        postings_codec=postings_codec)
    return torch.where(is_multi[:, None], multi, single)
