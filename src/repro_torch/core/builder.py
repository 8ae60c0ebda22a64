"""Scored query log -> QACIndex: ties every structure of paper §3.2 together.

The host build is numpy (as in the JAX package) and the finished arrays move
to the index's device once.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..backend import resolve_device
from .codecs import CODECS
from .types import MAX_TERMS, MAX_TERM_CHARS
from .dictionary import TermDictionary
from .completions import Completions, rank_rows
from .inverted_index import InvertedIndex
from .rmq import RangeMin
from .strings import encode_strings


@dataclasses.dataclass(frozen=True)
class QACIndex:
    dictionary: TermDictionary
    completions: Completions
    index: InvertedIndex
    rmq_docids: RangeMin        # over completions.docids (prefix-search top-k)
    rmq_minimal: RangeMin       # over index.minimal (single-term queries)
    k_default: int

    @property
    def device(self) -> torch.device:
        return self.index.postings.device


@dataclasses.dataclass
class CorpusStats:
    n_queries: int
    n_unique_terms: int
    avg_chars_per_term: float
    avg_queries_per_term: float
    avg_terms_per_query: float
    uncompressed_bytes: int


def tokenize(s: str) -> list[str]:
    return s.split()      # splits on any whitespace run, drops empty tokens


def _token_counts(keys: list[str]) -> np.ndarray:
    """Tokens per key (int64[N]) of keys whose tokens are joined by single
    spaces, from their UTF-8 bytes joined by newlines (no key holds one)."""
    if not keys:
        return np.zeros(0, np.int64)
    b = np.frombuffer("\n".join(keys).encode("utf-8"), dtype=np.uint8)
    ends = np.append(np.flatnonzero(b == 10), b.size)
    spaces = np.diff(np.searchsorted(np.flatnonzero(b == 32), ends), prepend=0)
    empty = np.diff(ends, prepend=-1) == 1
    return np.where(empty, 0, spaces + 1)


def _normalized(queries: Sequence[str]) -> bool:
    """Whether every query already is its key, ``" ".join(q.split())``: a
    ``str``, ASCII, holding no newline and none of ``str.split``'s other
    whitespace (9-13, 28-31) but single spaces between tokens. Read from
    the bytes of the queries joined by newlines."""
    if not queries:
        return True
    if set(map(type, queries)) != {str}:
        return False
    b = np.frombuffer("\n".join(queries).encode("utf-8"), dtype=np.uint8)
    n_nl = np.count_nonzero(b == 10)
    if (n_nl != len(queries) - 1 or (b >= 128).any() or n_nl != np.count_nonzero(
            (b >= 9) & (b <= 13)) or ((b >= 28) & (b <= 31)).any()):
        return False
    nl = np.array([10], dtype=np.uint8)
    framed = np.concatenate((nl, b, nl))
    sp = np.flatnonzero(framed == 32)
    side = np.concatenate((framed[sp - 1], framed[sp + 1]))
    return not ((side == 10) | (side == 32)).any()


def build_corpus(queries: Sequence[str], scores: Sequence[float],
                 max_terms: int = MAX_TERMS,
                 max_term_chars: int = MAX_TERM_CHARS, *,
                 device: torch.device):
    """Dedup + tokenize a scored query log (host side).

    Returns (dictionary, term_rows int32[N,M], scores float64[N], kept_strings).
    Each log query is tokenized once, into its key (its tokens joined by
    single spaces), unless the log is already normalized (``_normalized``,
    as a rebuild's ``kept`` is). A key's score is the max over its log
    entries, NaN entries ignored (-inf when all are NaN). No token holds
    whitespace, so one split of all kept keys joined gives their tokens in
    order, and numpy scatters their 1-based lexicographic ids (ranks in
    ``sorted``, i.e. by code point) into the rows.
    """
    keys = (list(queries) if _normalized(queries)
            else [" ".join(q.split()) for q in queries])   # the one tokenization
    sc = np.asarray(scores, dtype=np.float64).reshape(-1)
    sc = np.where(np.isnan(sc), -np.inf, sc)
    # each entry's key rank, from a stable sort by key (linear when the log
    # is already in key order, as a rebuild's is)
    keys_arr = np.array(keys, dtype=object)
    by_str = np.asarray(sorted(range(len(keys)), key=keys.__getitem__), dtype=np.int64)
    s_keys = keys_arr[by_str]
    new = np.ones(len(keys), dtype=bool)
    new[1:] = s_keys[1:] != s_keys[:-1]
    rank = np.empty(len(keys), dtype=np.int64)
    rank[by_str] = np.cumsum(new) - 1
    # entries by key, each key's by descending score, ties in log order (a
    # stable lexsort), so each key's first entry holds its score: the first
    # of its equal maxima in log order
    order = np.lexsort((-sc, rank))
    first = np.ones(len(keys), dtype=bool)
    first[1:] = rank[order[1:]] != rank[order[:-1]]
    kept, sc = keys_arr[order[first]], sc[order[first]]
    n_tok = _token_counts(kept.tolist())
    ok = (n_tok > 0) & (n_tok <= max_terms)   # no empty key, none too long
    kept, sc, n_tok = kept[ok].tolist(), sc[ok], n_tok[ok]
    flat = "\n".join(kept).split()
    vocab = sorted(set(flat))
    dictionary = TermDictionary.build(vocab, max_term_chars, device=device)
    tid = dict(zip(vocab, range(1, len(vocab) + 1)))  # 1-based lexicographic ids
    ids = np.fromiter(map(tid.__getitem__, flat), np.int32, len(flat))
    row = np.repeat(np.arange(len(kept)), n_tok)
    col = np.arange(len(flat)) - np.repeat(np.cumsum(n_tok) - n_tok, n_tok)
    rows = np.zeros((len(kept), max_terms), dtype=np.int32)
    rows[row, col] = ids
    return dictionary, rows, sc, kept


def build_qac_index(queries: Sequence[str], scores: Sequence[float],
                    k_default: int = 10,
                    max_terms: int = MAX_TERMS,
                    max_term_chars: int = MAX_TERM_CHARS,
                    postings_codec: str | None = "ef",
                    device=None, timings: dict | None = None):
    """Full pipeline: scored log -> (QACIndex, kept strings, scores).

    ``device`` defaults to the card (see ``backend.resolve_device``).
    ``postings_codec`` ("ef" default, "bitpack", or None) also emits the
    compressed postings layout beside raw CSR (``InvertedIndex.build``);
    the engines decode it only when the caller names a codec
    (``core.search``). ``timings``, when given, receives ``pack_us``, the
    part of the build that packs the postings (``InvertedIndex.build``).
    """
    if postings_codec is not None and postings_codec not in CODECS:
        raise ValueError(f"unknown postings_codec {postings_codec!r}")
    device = resolve_device(device)
    dictionary, rows, sc, kept = build_corpus(
        queries, scores, max_terms, max_term_chars, device=device)
    d_of_row, lex = rank_rows(rows, sc)
    comps = Completions.build(rows, d_of_row, lex, device=device)
    inv = InvertedIndex.build(rows, d_of_row, dictionary.n_terms,
                              postings_codec, device=device, timings=timings)
    qidx = QACIndex(
        dictionary=dictionary,
        completions=comps,
        index=inv,
        rmq_docids=RangeMin.build(comps.docids.cpu().numpy(), device=device),
        rmq_minimal=inv.build_minimal_rmq(),
        k_default=k_default,
    )
    return qidx, kept, sc


def corpus_stats(kept: Sequence[str]) -> CorpusStats:
    """The paper's Table 2 columns of a deduplicated corpus."""
    terms = [t for q in kept for t in tokenize(q)]
    uniq = set(terms)
    return CorpusStats(
        n_queries=len(kept),
        n_unique_terms=len(uniq),
        avg_chars_per_term=float(np.mean([len(t) for t in uniq])) if uniq else 0.0,
        avg_queries_per_term=len(terms) / max(len(uniq), 1),
        avg_terms_per_query=len(terms) / max(len(kept), 1),
        uncompressed_bytes=sum(len(q) + 1 for q in kept),
    )


def parse_queries(dictionary: TermDictionary, raw_queries: Sequence[str],
                  max_terms: int = MAX_TERMS,
                  max_term_chars: int = MAX_TERM_CHARS):
    """Paper §3.1 "Parsing": split each raw query into prefix term-ids and a
    (possibly incomplete) suffix. Host-side; prefix terms are located on the
    dictionary's device.

    A trailing space means the last term is complete -> it joins the prefix
    and the suffix is empty (matches any term). Returns (prefix_ids
    int32[B, M], prefix_len int32[B], prefix_ok bool[B] numpy, suffix
    uint8[B, T], suffix_len int32[B]), tensors on the dictionary's device.
    """
    B = len(raw_queries)
    prefix_ids = np.zeros((B, max_terms), dtype=np.int32)
    prefix_len = np.zeros(B, dtype=np.int32)
    prefix_ok = np.ones(B, dtype=bool)
    suffix = np.zeros((B, max_term_chars), dtype=np.uint8)
    suffix_len = np.zeros(B, dtype=np.int32)
    all_terms = []
    for q in raw_queries:
        toks = tokenize(q)
        ends_complete = q.endswith(" ") or q.endswith("\t")
        pre = toks if ends_complete else toks[:-1]
        all_terms.append((pre, "" if ends_complete or not toks else toks[-1]))
    flat = [t for pre, _ in all_terms for t in pre]
    device = dictionary.chars.device
    ids = {}
    if flat:
        uniq = sorted(set(flat))
        chars = torch.from_numpy(encode_strings(uniq, max_term_chars)).to(device)
        ids = dict(zip(uniq, dictionary.locate(chars).cpu().tolist()))
    for i, (pre, suf) in enumerate(all_terms):
        pre = pre[: max_terms - 1]
        for j, t in enumerate(pre):
            tid = ids.get(t, 0)
            prefix_ids[i, j] = tid
            if tid == 0:
                prefix_ok[i] = False
        prefix_len[i] = len(pre)
        b = suf.encode("utf-8")[:max_term_chars]
        suffix[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        suffix_len[i] = len(b)
    to = lambda a: torch.from_numpy(a).to(device)
    return to(prefix_ids), to(prefix_len), prefix_ok, to(suffix), to(suffix_len)
