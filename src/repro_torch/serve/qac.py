"""QAC serving entry points: the class-pure batches serve/frontend.py
dispatches, the fused mixed-batch step, the docid-striped step, and the
per-query ``*_vmap`` references.

Each runs on the device of the index it is given. ``use_kernel=None``
resolves to the CUDA kernels on the card and the plain PyTorch versions on
the CPU (``backend.default_use_kernel``). ``postings_codec`` ("ef" or
"bitpack") sends the engines through the index's compressed postings
(``core.search``); None reads raw CSR. The ``*_vmap`` forms loop the
per-query engines over the batch's rows (JAX's ``vmap`` of them; a
data-dependent loop does not map in torch): references for the tests, on
no serving path.

``qac_serve_striped`` serves a ``StripedQACIndex``: each stripe answers
every query with the fused step's engines, then the k-wide rows merge by a
min-k over docids. Without a process group it loops over the stripes on
one device (the JAX package's reference path, the one a single card
runs); with a ``torch.distributed`` group of S ranks each rank serves its
own stripe and the merge is one ``all_gather`` ("gather") or log2(S)
pairwise exchanges ("butterfly"), the JAX package's ``shard_map`` over its
``model`` axis. Its data-parallel batch axes wait for the port's
distribution work.
"""
from __future__ import annotations

from ..backend import default_use_kernel
from ..core.builder import QACIndex
from ..core.striped import StripedQACIndex, local_index
import torch

from ..core.search import (complete_conjunctive, complete_conjunctive_batch,
                           conjunctive_multi, conjunctive_multi_batch,
                           single_term_topk_batch, single_term_topk_bounded,
                           single_term_topk_bounded_batch)


def _use_kernel(qidx: QACIndex, use_kernel: bool | None) -> bool:
    return default_use_kernel(qidx.device) if use_kernel is None else use_kernel


def qac_serve_step(qidx: QACIndex, prefix_ids, prefix_len, suffix_chars,
                   suffix_len, *, k: int = 10, tile: int = 128,
                   max_tiles: int = 4096, use_kernel: bool | None = None,
                   heap_kernel: bool | None = None,
                   postings_codec: str | None = None):
    """Fused batched serve of a mixed batch -> docids int32[B, k] (INF
    padded): ``complete_conjunctive_batch``, each class's engine over the
    whole batch when the class is present. The reference the routed
    ``QACFrontend`` equals element for element."""
    term_lo, term_hi = qidx.dictionary.locate_prefix(suffix_chars, suffix_len)
    return complete_conjunctive_batch(
        qidx.index, qidx.completions, qidx.rmq_minimal, prefix_ids,
        prefix_len, term_lo, term_hi, k, tile=tile, max_tiles=max_tiles,
        use_kernel=_use_kernel(qidx, use_kernel), heap_kernel=heap_kernel,
        postings_codec=postings_codec)


def qac_serve_step_vmap(qidx: QACIndex, prefix_ids, prefix_len, suffix_chars,
                        suffix_len, *, k: int = 10, tile: int = 128,
                        max_tiles: int = 4096):
    """The per-query fused serve looped over the batch: the reference."""
    tl, th = qidx.dictionary.locate_prefix(suffix_chars, suffix_len)
    return torch.stack([complete_conjunctive(
        qidx.index, qidx.completions, qidx.rmq_minimal, prefix_ids[b],
        prefix_len[b], tl[b], th[b], k, tile=tile, max_tiles=max_tiles)
        for b in range(tl.shape[0])])


def serve_single_term_vmap(qidx: QACIndex, suffix_chars, suffix_len, *,
                           k: int = 10, trips: int | None = None):
    """The per-query single-term engine looped over the batch -> (docids
    int32[B, k], done bool[B]): the reference."""
    trips = (k + 2) if trips is None else trips
    tl, th = qidx.dictionary.locate_prefix(suffix_chars, suffix_len)
    rows = [single_term_topk_bounded(qidx.index, qidx.rmq_minimal, tl[b],
                                     th[b], k, trips) for b in range(tl.shape[0])]
    return (torch.stack([o for o, _ in rows]), torch.stack([d for _, d in rows]))


def serve_multi_term_vmap(qidx: QACIndex, prefix_ids, prefix_len,
                          suffix_chars, suffix_len, *, k: int = 10,
                          tile: int = 128, max_tiles: int = 4096):
    """The per-query conjunctive engine looped over the batch: the
    reference."""
    tl, th = qidx.dictionary.locate_prefix(suffix_chars, suffix_len)
    return torch.stack([conjunctive_multi(
        qidx.index, qidx.completions, prefix_ids[b], prefix_len[b], tl[b],
        th[b], k, tile=tile, max_tiles=max_tiles) for b in range(tl.shape[0])])


def serve_single_term(qidx: QACIndex, suffix_chars, suffix_len, *, k: int = 10,
                      trips: int | None = None, use_kernel: bool | None = None,
                      heap_kernel: bool | None = None,
                      postings_codec: str | None = None):
    """Batched single-term serve (paper §3.3) -> (docids int32[B, k], done).

    ``trips`` bounds the heap pops per lane (default k + 2); ``done[b]`` is
    False where the budget was too small and the caller must fall back to
    the full 2k-trip engine for exact results.
    """
    trips = (k + 2) if trips is None else trips
    term_lo, term_hi = qidx.dictionary.locate_prefix(suffix_chars, suffix_len)
    return single_term_topk_bounded_batch(
        qidx.index, qidx.rmq_minimal, term_lo, term_hi, k, trips,
        use_kernel=_use_kernel(qidx, use_kernel), heap_kernel=heap_kernel,
        postings_codec=postings_codec)


def serve_single_term_full(qidx: QACIndex, suffix_chars, suffix_len, *,
                           k: int = 10, use_kernel: bool | None = None,
                           heap_kernel: bool | None = None,
                           postings_codec: str | None = None):
    """Batched single-term serve, full 2k-trip budget (always exact)."""
    term_lo, term_hi = qidx.dictionary.locate_prefix(suffix_chars, suffix_len)
    return single_term_topk_batch(
        qidx.index, qidx.rmq_minimal, term_lo, term_hi, k,
        use_kernel=_use_kernel(qidx, use_kernel), heap_kernel=heap_kernel,
        postings_codec=postings_codec)


def serve_multi_term(qidx: QACIndex, prefix_ids, prefix_len, suffix_chars,
                     suffix_len, *, k: int = 10, tile: int = 128,
                     max_tiles: int = 4096, use_kernel: bool | None = None,
                     probe_iters: int = 0, postings_codec: str | None = None):
    """Batched conjunctive serve (Fig 5 Fwd) for a 100%-multi-term batch."""
    term_lo, term_hi = qidx.dictionary.locate_prefix(suffix_chars, suffix_len)
    return conjunctive_multi_batch(
        qidx.index, qidx.completions, prefix_ids, prefix_len, term_lo, term_hi,
        k, tile=tile, max_tiles=max_tiles,
        use_kernel=_use_kernel(qidx, use_kernel), probe_iters=probe_iters,
        postings_codec=postings_codec)


def _local_serve(striped: StripedQACIndex, s: int, prefix_ids, prefix_len,
                 term_lo, term_hi, k: int, tile: int, max_tiles: int,
                 use_kernel: bool, heap_kernel: bool | None,
                 postings_codec: str | None):
    """Stripe ``s``'s [B, k] first-k docids: the fused step's engines over
    its local views, both classes on their kernels under ``use_kernel``."""
    idx, fwd, rmq_min = local_index(striped, s)
    return complete_conjunctive_batch(
        idx, fwd, rmq_min, prefix_ids, prefix_len, term_lo, term_hi, k,
        tile=tile, max_tiles=max_tiles, use_kernel=use_kernel,
        heap_kernel=heap_kernel, postings_codec=postings_codec)


def _min_k(rows: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest docids of each row, ascending (JAX's ``-top_k(-x)``)."""
    return torch.sort(rows, dim=1).values[:, :k].contiguous()


def qac_serve_striped(striped: StripedQACIndex, dictionary, prefix_ids,
                      prefix_len, suffix_chars, suffix_len, *, k: int = 10,
                      tile: int = 128, max_tiles: int = 4096, group=None,
                      merge: str = "gather", use_kernel: bool | None = None,
                      heap_kernel: bool | None = None,
                      postings_codec: str | None = None):
    """Serve a mixed batch from a docid-striped index -> the global top-k
    docids int32[B, k] (INF padded), equal to ``qac_serve_step`` on the
    unstriped index.

    ``group`` None: loop over the S stripes on the index's device, then
    concatenate to [B, S*k] and keep the k smallest. A ``torch.distributed``
    process group of S ranks: rank r serves stripe r of its own copy of the
    index and every rank returns the merged answer. ``merge`` "gather" is
    one ``all_gather`` of the k-wide rows and a min-k; "butterfly" is
    log2(S) exchanges with rank ^ 2**i, each keeping the min-k of both
    rows (k log2(S) docids on the wire a query in place of k S), and
    needs S a power of two.
    """
    if merge not in ("gather", "butterfly"):
        raise ValueError(f"merge must be 'gather' or 'butterfly', got {merge!r}")
    use_kernel = (default_use_kernel(striped.device) if use_kernel is None
                  else use_kernel)
    term_lo, term_hi = dictionary.locate_prefix(suffix_chars, suffix_len)
    S = striped.n_stripes
    args = (prefix_ids, prefix_len, term_lo, term_hi, k, tile, max_tiles,
            use_kernel, heap_kernel, postings_codec)
    if group is None:
        parts = [_local_serve(striped, s, *args) for s in range(S)]
        return _min_k(torch.cat(parts, dim=1), k)

    import torch.distributed as dist

    n, rank = dist.get_world_size(group), dist.get_rank(group)
    if n != S:
        raise ValueError(f"a group of {n} ranks serves a {S}-stripe index")
    if merge == "butterfly" and S & (S - 1):
        raise ValueError(f"the butterfly merge needs a power-of-two stripe count, got {S}")
    cur = _local_serve(striped, rank, *args).contiguous()
    if merge == "gather":
        parts = [torch.empty_like(cur) for _ in range(S)]
        dist.all_gather(parts, cur, group=group)
        return _min_k(torch.cat(parts, dim=1), k)
    for bit in range(S.bit_length() - 1):
        peer = dist.get_global_rank(group, rank ^ (1 << bit))
        other = torch.empty_like(cur)
        sent = dist.isend(cur, peer, group=group)
        dist.recv(other, peer, group=group)
        sent.wait()
        cur = _min_k(torch.cat([cur, other], dim=1), k)
    return cur
