"""The freshness delta tier: a small uncompressed host-resident index
absorbing newly observed completions between rebuilds, as in the JAX
package's ``core/delta.py``.

  * ``DeltaIndex``: a tiny, uncompressed tier on the host. Inserts are
    O(row) appends: term ids come from the CURRENT generation's
    ``TermDictionary`` (an id here means exactly what it means in the
    immutable tier, so one parse serves both), and postings are
    APPEND-ONLY per-term entry-id lists (a later trend bump may rewrite a
    score in place; the list structure only ever grows).
  * ``MainCorpusView``: the host mirror of the immutable generation the
    delta shadows: completion-string <-> docid <-> score maps built from
    the index arrays themselves (no ordering assumptions on the corpus),
    used for shadow detection at insert and by the merge and oracle layers
    of ``serve.freshness``.

Exactness contract: the visible state after any prefix of inserts answers
bit-identically to a from-scratch ``build_qac_index`` over (base corpus +
those inserts). ``build_corpus`` dedups completions with MAX score, so the
delta mirrors that algebra at insert time: a completion the main tier
already holds at a score at least as high is a **noop**; a higher score
makes a **shadow** entry that remembers the main docid it outranks (the
merge suppresses the main copy); a completion already in the delta keeps
the max of both scores (**update**, in place); an out-of-vocabulary term
is **deferred** to the next rebuild; what the builder would drop (empty,
too many terms) is **dropped**.

Lookup (``topk``) mirrors the engines' match rule (every prefix term
present, >= 1 term in the suffix's ``[lo, hi)`` range) and returns entries
in (score desc, token tuple asc) order, which is the (-score, lexicographic
row) docid order a from-scratch build would assign. ``upto`` replays any
historical prefix of the insert log.

The port differs in how ``MainCorpusView`` is built, not in what it holds:
the JAX package joins each docid's tokens in a Python loop (~3.4 s per
million rows) and fills two dicts over every completion; here one numpy
gather over the forward index writes every docid's UTF-8 bytes into one
buffer, decoded and split once, ``tokens_of_docid`` is made per docid when
read, and over the builder's output the scores and the string -> docid map
come from the completions' lexicographic positions.
"""
from __future__ import annotations

import bisect
import dataclasses
import operator
from collections.abc import Mapping
from itertools import islice

import numpy as np

from .builder import QACIndex, tokenize
from .types import MAX_TERMS

_ROW_END = 0xFF          # never a byte of valid UTF-8: ends each row's string
_CHUNK_ROWS = 1 << 20    # forward rows gathered at once


class _TokensOfDocid:
    """``tokens_of_docid[d]``: docid d's tokens as a tuple, made when read
    (the JAX package holds a list of them, one tuple per docid)."""

    def __init__(self, fwd: np.ndarray, term_str: list[str]):
        self._fwd, self._term_str = fwd, term_str

    def __len__(self) -> int:
        return len(self._fwd)

    def __getitem__(self, d) -> tuple:
        return tuple(self._term_str[t] for t in self._fwd[d].tolist() if t)

    def __iter__(self):
        return (self[d] for d in range(len(self)))


class _SortedDocids(Mapping):
    """``docid_of_string`` over strings that ascend strictly in lexicographic
    position: a binary search for the position, then its docid. Equal, as
    a mapping, to the JAX package's dict of every docid's string."""

    def __init__(self, lex_strings: list[str], docids: np.ndarray):
        self._lex, self._docids = lex_strings, docids

    def __getitem__(self, s: str) -> int:
        p = bisect.bisect_left(self._lex, s)
        if p == len(self._lex) or self._lex[p] != s:
            raise KeyError(s)
        return int(self._docids[p])

    def __len__(self) -> int:
        return len(self._lex)

    def __iter__(self):       # docid order, as the JAX dict was filled
        order = np.argsort(self._docids, kind="stable")
        return (self._lex[p] for p in order.tolist())


def _joined_rows(fwd: np.ndarray, term_str: list[str]) -> list[str]:
    """``" ".join(term_str[t] for t in row if t)`` for every row of ``fwd``:
    each row's term bytes gathered with numpy into one buffer, one byte that
    is never valid UTF-8 after each row, one decode and one split. Each term
    is re-encoded from its decoded string, so the buffer is valid UTF-8 but
    for those bytes whatever the dictionary's bytes were (a replaced byte
    decodes to U+FFFD once, and is U+FFFD here); ``surrogateescape`` turns
    each end byte into a lone surrogate, which no term holds."""
    enc = [s.encode("utf-8") for s in term_str]
    n_ids = len(enc)
    lens = np.fromiter(map(len, enc), np.int64, n_ids)
    width = int(lens.max(initial=0)) + 1                  # bytes + separator
    # rows [0, n_ids): a term and a space; rows [n_ids, 2 n_ids): a term
    # and the end of its row. ``used`` marks each row's bytes.
    table = np.zeros((2 * n_ids, width), np.uint8)
    flat = np.frombuffer(b"".join(enc), np.uint8)
    row = np.repeat(np.arange(n_ids), lens)
    col = np.arange(flat.size) - np.repeat(np.cumsum(lens) - lens, lens)
    table[row, col] = table[row + n_ids, col] = flat
    table[np.arange(n_ids), lens] = ord(" ")
    table[np.arange(n_ids) + n_ids, lens] = _ROW_END
    used = np.arange(width)[None, :] <= np.concatenate([lens, lens])[:, None]
    end = chr(0xDC00 + _ROW_END)
    out: list[str] = []
    for s in range(0, len(fwd), _CHUNK_ROWS):
        ids = fwd[s:s + _CHUNK_ROWS]
        # one entry per term of a row, in slot order; a row with no term
        # keeps its slot 0 (id 0: no bytes), so every row has a last entry
        take = ids != 0
        take[:, 0] |= ~take.any(axis=1)
        t = ids[take].astype(np.int64)
        t[np.cumsum(take.sum(axis=1)) - 1] += n_ids
        text = np.take(table, t, axis=0)[np.take(used, t, axis=0)].tobytes()
        out.extend(text.decode("utf-8", "surrogateescape").split(end)[:-1])
    return out


class MainCorpusView:
    """Host mirror of one immutable generation: string/docid/score maps.

    Built from the index arrays themselves (``fwd_terms`` + the dictionary's
    char rows), each copied to the host once, not from any assumed alignment
    between the builder's ``kept`` list and docid order, so it stays correct
    for any corpus. ``fwd`` may pass the host forward index when the caller
    already holds it (``QACFrontend.host_fwd_terms``).

    The maps equal the JAX package's. Where ``kept`` is the completions'
    strings in lexicographic position, ascending strictly (what the builder
    returns), the scores scatter by position and ``docid_of_string`` is a
    binary search over ``kept``; otherwise both are dicts, as in JAX. At
    9.9M rows, on the host of an H100 machine, the first way builds in
    14.2 s and the dicts in 40.5 s; a lookup costs 19.6 and 1.7 us
    (``chip_smoke.py --probe``).
    """

    def __init__(self, qidx: QACIndex, kept, scores, *, fwd: np.ndarray | None = None):
        self.qidx = qidx
        self.kept = list(kept)
        self.scores = np.asarray(scores, dtype=np.float64)
        if len(self.kept) != len(self.scores):
            raise ValueError(f"{len(self.kept)} kept strings vs "
                             f"{len(self.scores)} scores")
        # decode each unique term once (V decodes); an S-view of the char
        # rows drops trailing NULs as ``bytes(r).rstrip(b"\x00")`` does
        chars = np.ascontiguousarray(qidx.dictionary.chars.cpu().numpy())
        term_str = [""] + [b.decode("utf-8", errors="replace") for b in
                           chars.view(f"S{chars.shape[1]}").ravel().tolist()]
        # host-side term -> 1-based id (a dictionary search on the device per
        # call would cost the insert path a device round trip)
        self.term_id = dict(zip(term_str[1:], range(1, len(term_str))))
        if fwd is None:
            fwd = qidx.completions.fwd_terms.cpu().numpy()
        self.string_of_docid: list[str] = _joined_rows(fwd, term_str)
        self.tokens_of_docid = _TokensOfDocid(fwd, term_str)
        docids = qidx.completions.docids.cpu().numpy()
        lex = np.asarray(self.string_of_docid, dtype=object)[docids].tolist()
        if lex == self.kept and all(map(operator.lt, lex, islice(lex, 1, None))):
            self.score_of_docid = np.empty(len(lex), np.float64)
            self.score_of_docid[docids] = self.scores
            self.docid_of_string = _SortedDocids(self.kept, docids)
        else:
            score_by_string = dict(zip(self.kept, self.scores.tolist()))
            self.score_of_docid = np.fromiter(
                map(score_by_string.__getitem__, self.string_of_docid),
                np.float64, len(self.string_of_docid))
            self.docid_of_string = dict(zip(self.string_of_docid,
                                            range(len(self.string_of_docid))))

    def lookup(self, canonical: str):
        """canonical completion string -> (docid, score) or None."""
        d = self.docid_of_string.get(canonical)
        if d is None:
            return None
        return d, float(self.score_of_docid[d])


@dataclasses.dataclass
class DeltaEntry:
    """One applied insert: the completion under the current generation's
    term ids, its score history, and the main docid it shadows (-1 =
    a genuinely new completion).

    ``born`` is the delta sequence number at which this entry became
    visible; ``hist`` is its (seq, score) history — a later trend bump
    rewrites the score IN PLACE structurally but appends to the history,
    so any historical sequence number replays the exact score it saw.
    """

    query: str               # canonical " ".join(tokens)
    tokens: tuple            # token tuple — the cross-dictionary tie-break
    row: np.ndarray          # int32[max_terms] 1-based ids, 0 pad
    born: int                # seq at which the entry became visible
    hist: list               # [(seq, score)] ascending, never empty
    shadow_docid: int        # main docid outranked by this entry, or -1

    @property
    def score(self) -> float:
        return self.hist[-1][1]

    def score_at(self, seq: int) -> float:
        for s, sc in reversed(self.hist):
            if s <= seq:
                return sc
        raise ValueError(f"entry born at seq {self.born} queried at {seq}")


class DeltaIndex:
    """Append-only in-memory delta tier over one ``MainCorpusView``.

    ``seq`` counts VISIBLE state changes: it bumps on every applied entry
    and on every in-place score raise of an existing entry (the two insert
    outcomes the from-scratch oracle can observe), and ``oplog`` records
    the (query, score) of each bump. Visible state ``(generation, seq)``
    therefore means "the generation's base corpus with ``oplog[:seq]``
    replayed under the builder's max-score dedup", and every read API
    takes ``upto=seq`` to reproduce that state exactly — entries born
    later are filtered out, earlier entries report ``score_at(seq)``.
    """

    def __init__(self, view: MainCorpusView, *, capacity: int = 4096,
                 max_terms: int = MAX_TERMS):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.view = view
        self.capacity = capacity
        self.max_terms = max_terms
        self.entries: list[DeltaEntry] = []
        self.rows = np.zeros((capacity, max_terms), dtype=np.int32)
        self.scores = np.zeros(capacity, dtype=np.float64)
        # append-only postings: term id -> entry ids, in insertion order
        # (ascending by construction — the "docid order" of the delta tier
        # is (score, tokens), recomputed at read time over the tiny tier,
        # but the postings themselves never reorder)
        self.postings: dict[int, list[int]] = {}
        self.by_query: dict[str, int] = {}
        self.shadow_docids: list[int] = []   # grows with shadow entries
        self.deferred: list[tuple[str, float]] = []   # OOV: next rebuild
        self.seq = 0                          # visible-state version counter
        self.oplog: list[tuple[str, float]] = []      # one row per seq bump
        self._born: list[int] = []            # born seq per entry (ascending)
        self._stats = {"applied": 0, "updated": 0, "noop": 0,
                       "deferred": 0, "dropped": 0}

    @property
    def n(self) -> int:
        return len(self.entries)

    def _n_visible(self, seq: int) -> int:
        """Entries born at or before ``seq`` — a PREFIX of the entry list,
        because born values are assigned in append order."""
        return bisect.bisect_right(self._born, seq)

    # -- writes ---------------------------------------------------------------
    def insert(self, query: str, score: float) -> str:
        """Absorb one observed completion; returns the outcome kind:
        ``"applied"`` (new visible entry), ``"updated"`` (an existing delta
        entry's score rose in place), ``"noop"`` (main tier already
        outranks it), ``"deferred"`` (OOV term, buffered for the next
        rebuild), or ``"dropped"`` (the builder itself would discard it).
        Raises ``OverflowError`` when the delta is full — the caller
        (``GenerationalQAC``) rebuilds and swaps before that can happen.
        """
        score = float(score)
        toks = tokenize(query)
        if not toks or len(toks) > self.max_terms:
            self._stats["dropped"] += 1
            return "dropped"
        canonical = " ".join(toks)
        prev = self.by_query.get(canonical)
        if prev is not None:
            if score > self.entries[prev].score:
                # in-place score raise: max-dedup, never a second entry —
                # but a VISIBLE change, so it gets its own seq + oplog row
                self.seq += 1
                self.oplog.append((canonical, score))
                self.entries[prev].hist.append((self.seq, score))
                self.scores[prev] = score
                self._stats["updated"] += 1
                return "updated"
            self._stats["noop"] += 1
            return "noop"
        main = self.view.lookup(canonical)
        if main is not None and score <= main[1]:
            self._stats["noop"] += 1
            return "noop"
        ids = [self.view.term_id.get(t, 0) for t in toks]
        if any(i == 0 for i in ids):
            # out-of-vocabulary term: the current dictionary cannot name
            # it, so it waits for the rebuild (which re-runs the builder
            # over base + delta + deferred and mints the new term ids)
            self.deferred.append((canonical, score))
            self._stats["deferred"] += 1
            return "deferred"
        if self.n >= self.capacity:
            raise OverflowError(
                f"delta full ({self.capacity} entries); rebuild and swap")
        eid = self.n
        row = np.zeros(self.max_terms, dtype=np.int32)
        row[: len(ids)] = ids
        shadow = main[0] if main is not None else -1
        self.seq += 1
        self.oplog.append((canonical, score))
        self.entries.append(DeltaEntry(query=canonical, tokens=tuple(toks),
                                       row=row, born=self.seq,
                                       hist=[(self.seq, score)],
                                       shadow_docid=shadow))
        self._born.append(self.seq)
        self.rows[eid] = row
        self.scores[eid] = score
        for t in sorted(set(ids)):
            self.postings.setdefault(t, []).append(eid)
        if shadow >= 0:
            self.shadow_docids.append(shadow)
        self.by_query[canonical] = eid
        self._stats["applied"] += 1
        return "applied"

    # -- reads ----------------------------------------------------------------
    def shadowed(self, upto: int | None = None) -> set[int]:
        """Main docids outranked by the state at sequence ``upto``."""
        nv = self._n_visible(self.seq if upto is None else upto)
        return {e.shadow_docid for e in self.entries[:nv]
                if e.shadow_docid >= 0}

    def _candidates(self, pids, plen: int, n_vis: int) -> np.ndarray:
        """Entry ids that can possibly match: the append-only postings of
        the rarest prefix term when there is one, else everything live."""
        if plen <= 0:
            return np.arange(n_vis, dtype=np.int64)
        lists = [np.asarray(self.postings.get(int(t), ()), dtype=np.int64)
                 for t in set(int(x) for x in pids[:plen])]
        cand = min(lists, key=len)
        return cand[cand < n_vis]

    def matches(self, pids, plen: int, lo: int, hi: int,
                upto: int | None = None) -> list[int]:
        """Entry ids matching the engines' rule — every prefix term present
        AND >= 1 term in [lo, hi) — in (score desc, tokens asc) order at
        sequence ``upto``, i.e. exactly the (-score, lexicographic row)
        docid order a from-scratch build of that state would assign."""
        seq = self.seq if upto is None else upto
        n_vis = self._n_visible(seq)
        if n_vis <= 0 or hi <= lo:
            return []
        pids = np.asarray(pids, dtype=np.int64)
        if plen > 0 and bool((pids[:plen] == 0).any()):
            return []                       # engines reject unknown prefix terms
        cand = self._candidates(pids, plen, n_vis)
        if cand.size == 0:
            return []
        rows = self.rows[cand]                                    # [C, M]
        keep = ((rows >= lo) & (rows < hi)).any(axis=1)
        for t in set(int(x) for x in pids[:plen]):
            keep &= (rows == t).any(axis=1)
        hit = cand[keep]
        return sorted((int(i) for i in hit),
                      key=lambda i: (-self.entries[i].score_at(seq),
                                     self.entries[i].tokens))

    def topk(self, pids, plen: int, lo: int, hi: int, k: int,
             upto: int | None = None) -> list[int]:
        return self.matches(pids, plen, lo, hi, upto)[:k]

    # -- rebuild handoff ------------------------------------------------------
    def fold_corpus(self) -> tuple[list[str], list[float]]:
        """(queries, scores) to append to the base corpus at rebuild:
        every applied entry plus the deferred OOV buffer. ``build_corpus``'s
        max-dedup makes re-stating a shadow harmless by construction."""
        qs = [e.query for e in self.entries] + [q for q, _ in self.deferred]
        sc = [e.score for e in self.entries] + [s for _, s in self.deferred]
        return qs, sc

    def stats(self) -> dict:
        return dict(self._stats, n=self.n, seq=self.seq,
                    deferred_pending=len(self.deferred),
                    shadows=len(self.shadow_docids))
