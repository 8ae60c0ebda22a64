"""Completions as integer (multi-)sets + the docids map (paper §3.2).

The integer trie is a columnar sorted term matrix; the forward index
(docid -> term set) is the same matrix indexed by docid, used by the
conjunctive forward search.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .searching import ranged_searchsorted


@dataclasses.dataclass(frozen=True)
class Completions:
    cols: torch.Tensor        # int32[M, N]: column j = j-th term of each lex-sorted completion
    docids: torch.Tensor      # int32[N]: lex position -> docid (score rank, 0 = best)
    fwd_terms: torch.Tensor   # int32[N, M]: docid -> term ids (the forward index)
    n_terms_per: torch.Tensor  # int32[N]: docid -> number of terms
    n: int
    max_terms: int

    @staticmethod
    def build(term_rows: np.ndarray, docid_of_row: np.ndarray, lex: np.ndarray,
              *, device: torch.device) -> "Completions":
        """term_rows: int32[N, M] 1-based term ids (0 pad), one row per
        completion; ``rank_rows(term_rows, scores)`` gives (docid_of_row,
        lex): docid = rank under (-score, lexicographic row)."""
        n, m = term_rows.shape
        cols = term_rows[lex].T.copy()                      # [M, N]
        docids = docid_of_row[lex].copy()                   # [N]
        fwd = np.zeros_like(term_rows)
        fwd[docid_of_row] = term_rows                       # docid -> terms
        nt = (term_rows != 0).sum(axis=1).astype(np.int32)
        nterms = np.zeros(n, dtype=np.int32)
        nterms[docid_of_row] = nt
        t = lambda a: torch.from_numpy(a).to(device)
        return Completions(cols=t(cols), docids=t(docids), fwd_terms=t(fwd),
                           n_terms_per=t(nterms), n=n, max_terms=m)

    def locate_prefix(self, prefix_ids, prefix_len, term_lo, term_hi):
        """Lexicographic range [p, q) of completions prefixed by
        prefix_ids[:prefix_len] followed by any term id in [term_lo,
        term_hi): one query, one range-restricted binary search per trie
        level. Returns int32 scalars; empty -> p == q; a prefix as long as
        a row -> (0, 0)."""
        dev = self.cols.device
        as32 = lambda x: torch.as_tensor(x, device=dev).to(torch.int32)
        plen = int(prefix_len)
        lo, hi = as32(0), as32(self.n)
        for j in range(min(plen, self.max_terms)):        # trie descent
            t = as32(prefix_ids[j])
            lo, hi = (ranged_searchsorted(self.cols[j], t, lo, hi, side="left"),
                      ranged_searchsorted(self.cols[j], t, lo, hi, side="right"))
        # final level: any term in [term_lo, term_hi)
        col = self.cols[min(plen, self.max_terms - 1)]
        p = ranged_searchsorted(col, as32(term_lo), lo, hi, side="left")
        q = ranged_searchsorted(col, as32(term_hi), lo, hi, side="left")
        if plen >= self.max_terms:
            return as32(0), as32(0)
        return p, q

    @property
    def fwd_stride(self) -> int:
        """Docid d's forward row is row d // fwd_stride: 1 here, the stripe
        count in a docid stripe's ``LocalFwd`` (``core/striped.py``)."""
        return 1

    def extract(self, docid: torch.Tensor):
        """docid[...] -> (term_ids int32[..., M], n_terms[...]).
        INF or otherwise invalid docids give zeros."""
        valid = (docid >= 0) & (docid < self.n)
        idx = docid.clamp(0, self.n - 1)
        row = torch.where(valid[..., None], self.fwd_terms[idx], 0)
        return row, torch.where(valid, self.n_terms_per[idx], 0)


def rank_rows(term_rows: np.ndarray, scores: np.ndarray):
    """(docid_of_row int32[N], lex int64[N]): each row's docid, its rank
    under (-score, lexicographic row), and the rows' lexicographic order.
    The docid order is the lexicographic one stably sorted by -score, which
    is the same permutation as a lexsort on (-score, row)."""
    m = term_rows.shape[1]
    lex = np.lexsort(tuple(term_rows[:, j] for j in range(m - 1, -1, -1)))
    order = lex[np.argsort(-np.asarray(scores)[lex], kind="stable")]
    docid_of_row = np.empty(len(term_rows), dtype=np.int32)
    docid_of_row[order] = np.arange(len(term_rows), dtype=np.int32)
    return docid_of_row, lex
