"""The inverted index (paper §3.2) in CSR form + the ``minimal`` array.

Lists are docid-ascending == score-descending, so "first k" == "top-k". The
``minimal`` array (first docid of every list) feeds the single-term RMQ
engine (paper §3.3). ``packed`` optionally carries the same postings in the
compressed device layout (``core/codecs.py``); ``build`` asserts the
round trip ``unpack_postings(packed) == postings``. The raw postings stay on
the device beside it: the multi-term engine reads its candidates (the
shortest prefix list) from them on every route.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .codecs import PackedPostings, pack_postings, unpack_postings
from .types import INF_DOCID
from .rmq import RangeMin


@dataclasses.dataclass(frozen=True)
class InvertedIndex:
    postings: torch.Tensor   # int32[P] concatenated docid lists (ascending)
    offsets: torch.Tensor    # int32[V+2] list boundaries, indexed by 1-based term id
    minimal: torch.Tensor    # int32[V+2] first docid per list (INF if empty)
    n_terms: int
    n_postings: int
    packed: PackedPostings | None = None   # compressed device layout

    @staticmethod
    def build(term_rows: np.ndarray, docid_of_row: np.ndarray, n_terms: int,
              postings_codec: str | None = "ef", *,
              device: torch.device,
              timings: dict | None = None) -> "InvertedIndex":
        """term_rows int32[N, M] (1-based ids, 0 pad); docid_of_row int32[N].

        ``postings_codec``: "ef" (default) or "bitpack" also packs the
        lists into ``.packed``; None skips it. ``timings``, when given,
        receives ``pack_us``: the packing and its round-trip check.
        """
        term_rows = np.asarray(term_rows, dtype=np.int64)
        n, m = term_rows.shape
        docs = np.broadcast_to(np.asarray(docid_of_row, dtype=np.int64)[:, None], (n, m))
        mask = term_rows != 0
        t = term_rows[mask]
        d = docs[mask]
        # dedup (term, doc) pairs — a term may repeat inside one completion
        # (np.unique would hash the keys before sorting them on numpy >= 2.3)
        key = np.sort(t * (np.int64(docid_of_row.max()) + 1) + d)
        first = np.ones(len(key), dtype=bool)
        first[1:] = key[1:] != key[:-1]
        uniq = key[first]          # sorted: by term, then docid within a term
        t = (uniq // (np.int64(docid_of_row.max()) + 1)).astype(np.int64)
        d = (uniq % (np.int64(docid_of_row.max()) + 1)).astype(np.int64)
        cnt = np.bincount(t, minlength=n_terms + 1)  # indexed by 1-based term id
        offsets = np.zeros(n_terms + 2, dtype=np.int32)
        offsets[1 : len(cnt) + 1] = np.cumsum(cnt)
        offsets[len(cnt) + 1 :] = len(d)
        minimal = np.full(n_terms + 2, INF_DOCID, dtype=np.int32)
        starts = offsets[:-1]
        ends = offsets[1:]
        nonempty = ends > starts
        minimal[:-1][nonempty] = d[starts[nonempty]]
        packed = None
        if postings_codec is not None:
            t0 = time.perf_counter()
            packed = pack_postings(d.astype(np.int32), postings_codec,
                                   device=device)
            got = unpack_postings(packed)
            assert (got == d).all(), "packed postings round-trip broke"
            if timings is not None:
                timings["pack_us"] = (time.perf_counter() - t0) * 1e6
        to = lambda a: torch.from_numpy(a).to(device)
        return InvertedIndex(postings=to(d.astype(np.int32)), offsets=to(offsets),
                             minimal=to(minimal), n_terms=n_terms,
                             n_postings=len(d), packed=packed)

    def list_bounds(self, term_id: torch.Tensor):
        t = term_id.clamp(0, self.n_terms)
        return self.offsets[t], self.offsets[t + 1]

    def list_len(self, term_id: torch.Tensor) -> torch.Tensor:
        s, e = self.list_bounds(term_id)
        return e - s

    def build_minimal_rmq(self) -> RangeMin:
        """RMQ over the minimal array for single-term queries (paper §3.3)."""
        return RangeMin.build(self.minimal.cpu().numpy(),
                              device=self.minimal.device)
