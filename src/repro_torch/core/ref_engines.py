"""Host (numpy/python) reference engines: the paper's exact algorithms, a
copy of the JAX package's ``core/ref_engines.py``.

These serve two purposes:
  1. oracles for the engines' tests (results must match exactly);
  2. the CPU baselines of the paper's Table 5 comparison (Heap vs Fwd vs FC),
     implemented faithfully: Heap == Fig 3, Fwd == Fig 5, FC == Fig 5 with
     front-coded extraction, single-term == §3.3 RMQ-on-minimal.
"""
from __future__ import annotations

import heapq
from bisect import bisect_left
from typing import Sequence

import numpy as np


class HostIndex:
    """Plain-python mirror of the built structures, for oracles/baselines."""

    def __init__(self, rows: np.ndarray, docid_of_row: np.ndarray, n_terms: int):
        self.rows = np.asarray(rows)
        self.doc_of_row = np.asarray(docid_of_row)
        n = len(rows)
        self.fwd = np.zeros_like(self.rows)
        self.fwd[self.doc_of_row] = self.rows
        self.lists: dict[int, list[int]] = {}
        for r, d in zip(self.rows, self.doc_of_row):
            for t in r:
                if t:
                    self.lists.setdefault(int(t), set()).add(int(d))  # type: ignore
        self.lists = {t: sorted(s) for t, s in self.lists.items()}
        self.n_terms = n_terms
        self.n = n
        lex = np.lexsort(tuple(self.rows[:, j] for j in range(self.rows.shape[1] - 1, -1, -1)))
        self.lex_rows = self.rows[lex]
        self.docids = self.doc_of_row[lex]

    def plist(self, t: int) -> list[int]:
        return self.lists.get(int(t), [])

    # -- oracles --------------------------------------------------------------
    def brute_conjunctive(self, prefix: Sequence[int], lo: int, hi: int, k: int):
        """All docids containing every prefix term and >=1 term in [lo,hi)."""
        out = []
        for d in range(self.n):
            terms = set(int(t) for t in self.fwd[d] if t)
            if all(int(t) in terms for t in prefix) and any(
                lo <= t < hi for t in terms
            ):
                out.append(d)
                if len(out) == k:
                    break
        return out

    def brute_prefix_search(self, prefix: Sequence[int], lo: int, hi: int, k: int):
        """Docids of completions prefixed by prefix + one term in [lo,hi)."""
        p = list(prefix)
        out = []
        for row, d in zip(self.fwd, range(self.n)):
            terms = [int(t) for t in row if t]
            if len(terms) < len(p) + 1:
                continue
            if terms[: len(p)] == p and lo <= terms[len(p)] < hi:
                out.append(d)
        return sorted(out)[:k]

    # -- paper Fig 3: heap-based conjunctive ----------------------------------
    def heap_conjunctive(self, prefix: Sequence[int], lo: int, hi: int, k: int):
        prefix = [int(t) for t in prefix]
        if not prefix:
            return self.single_term_classic(lo, hi, k)
        plists = [self.plist(t) for t in prefix]
        if any(not l for l in plists):
            return []
        # intersection iterator over the prefix lists
        def intersection():
            short = min(plists, key=len)
            others = [l for l in plists if l is not short]
            for x in short:
                ok = True
                for l in others:
                    i = bisect_left(l, x)
                    if i >= len(l) or l[i] != x:
                        ok = False
                        break
                if ok:
                    yield x

        iters = []
        for t in range(lo, hi):
            l = self.plist(t)
            if l:
                iters.append([l[0], t, 0])  # [current docid, term, ptr]
        heapq.heapify(iters)
        results = []
        for x in intersection():
            while iters:
                top = iters[0]
                if top[0] > x:
                    break
                if top[0] < x:
                    l = self.plist(top[1])
                    i = bisect_left(l, x, top[2])
                    if i < len(l):
                        heapq.heapreplace(iters, [l[i], top[1], i])
                    else:
                        heapq.heappop(iters)
                else:
                    results.append(x)
                    break
            if len(results) == k or not iters:
                break
        return results

    # -- paper Fig 5: forward search ------------------------------------------
    def fwd_conjunctive(self, prefix: Sequence[int], lo: int, hi: int, k: int,
                        extract=None):
        prefix = [int(t) for t in prefix]
        if not prefix:
            return self.single_term_rmq(lo, hi, k)
        plists = [self.plist(t) for t in prefix]
        if any(not l for l in plists):
            return []
        short = min(plists, key=len)
        others = [l for l in plists if l is not short]
        results = []
        for x in short:
            ok = True
            for l in others:
                i = bisect_left(l, x)
                if i >= len(l) or l[i] != x:
                    ok = False
                    break
            if not ok:
                continue
            terms = extract(x) if extract else [int(t) for t in self.fwd[x] if t]
            if any(lo <= t < hi for t in terms):
                results.append(x)
                if len(results) == k:
                    break
        return results

    # -- single-term engines ---------------------------------------------------
    def single_term_classic(self, lo: int, hi: int, k: int):
        """Classic k-way merge over all lists in range (the slow baseline)."""
        iters = []
        for t in range(lo, hi):
            l = self.plist(t)
            if l:
                iters.append((l[0], t, 0))
        heapq.heapify(iters)
        out = []
        while iters and len(out) < k:
            d, t, i = heapq.heappop(iters)
            if not out or out[-1] != d:
                out.append(d)
            l = self.plist(t)
            if i + 1 < len(l):
                heapq.heappush(iters, (l[i + 1], t, i + 1))
        return out

    def single_term_rmq(self, lo: int, hi: int, k: int):
        """Paper §3.3: RMQ over `minimal` with lazy iterator instantiation."""
        INF = 2**31 - 1
        minimal = np.full(self.n_terms + 2, INF, dtype=np.int64)
        for t, l in self.lists.items():
            minimal[t] = l[0]

        # (value, kind, payload): kind 0 = range (lo, hi) over minimal,
        # kind 1 = iterator (term, ptr)
        def rng(a, b):
            if a > b:
                return None
            seg = minimal[a : b + 1]
            i = int(np.argmin(seg))
            v = int(seg[i])
            if v == INF:
                return None
            return (v, 0, (a, b, a + i))

        heap = []
        r0 = rng(lo, hi - 1)
        if r0:
            heap.append(r0)
        heapq.heapify(heap)
        out = []
        while heap and len(out) < k:
            v, kind, payload = heapq.heappop(heap)
            if not out or out[-1] != v:
                out.append(v)
            if kind == 0:
                a, b, tstar = payload
                for r in (rng(a, tstar - 1), rng(tstar + 1, b)):
                    if r:
                        heapq.heappush(heap, r)
                l = self.plist(tstar)
                if len(l) > 1:
                    heapq.heappush(heap, (l[1], 1, (tstar, 1)))
            else:
                t, i = payload
                l = self.plist(t)
                if i + 1 < len(l):
                    heapq.heappush(heap, (l[i + 1], 1, (t, i + 1)))
        return out


class HybIndex:
    """Bast-Weber HYB baseline (SIGIR'06): inverted lists merged into blocks
    of consecutive term ids; each block stores (docid, termid) pairs sorted
    by docid. A conjunctive query intersects the prefix lists (as usual) and
    checks candidates against the blocks overlapping the suffix range —
    cheap when the range ~ covers blocks, at the price of storing termids.

    Block sizing follows the paper's c-parameter: blocks close when they
    hold >= c * total_postings postings.
    """

    def __init__(self, host: HostIndex, c: float = 1e-2):
        total = sum(len(l) for l in host.lists.values())
        cap = max(1, int(c * total))
        self.host = host
        self.blocks = []          # list of (t_lo, t_hi_incl, docids[], termids[])
        cur_d, cur_t = [], []
        t_lo = 1
        for t in range(1, host.n_terms + 1):
            for d in host.plist(t):
                cur_d.append(d)
                cur_t.append(t)
            if len(cur_d) >= cap and t >= t_lo:
                order = np.argsort(np.asarray(cur_d), kind="stable")
                self.blocks.append((t_lo, t,
                                    np.asarray(cur_d)[order],
                                    np.asarray(cur_t)[order]))
                cur_d, cur_t = [], []
                t_lo = t + 1
        if cur_d:
            order = np.argsort(np.asarray(cur_d), kind="stable")
            self.blocks.append((t_lo, host.n_terms,
                                np.asarray(cur_d)[order],
                                np.asarray(cur_t)[order]))

    def space_bytes(self) -> int:
        return sum(len(d) * 8 for _, _, d, _ in self.blocks)

    def _range_blocks(self, lo: int, hi: int):
        return [b for b in self.blocks if b[0] < hi and b[1] >= lo]

    def conjunctive(self, prefix, lo: int, hi: int, k: int):
        """Candidates from the prefix intersection, suffix check via blocks."""
        from bisect import bisect_left
        prefix = [int(t) for t in prefix]
        blocks = self._range_blocks(lo, hi)
        if not prefix:
            # single-term: k smallest docids in the union of range lists,
            # scanned from the blocks (docid-sorted)
            out = []
            ptrs = [0] * len(blocks)
            import heapq
            heap = []
            for i, (_, _, dd, tt) in enumerate(blocks):
                for j in range(len(dd)):
                    if lo <= tt[j] < hi:
                        heap.append((int(dd[j]), i, j))
                        break
            heapq.heapify(heap)
            while heap and len(out) < k:
                d, i, j = heapq.heappop(heap)
                if not out or out[-1] != d:
                    out.append(d)
                _, _, dd, tt = blocks[i]
                j += 1
                while j < len(dd):
                    if lo <= tt[j] < hi:
                        heapq.heappush(heap, (int(dd[j]), i, j))
                        break
                    j += 1
            return out
        plists = [self.host.plist(t) for t in prefix]
        if any(not l for l in plists):
            return []
        short = min(plists, key=len)
        others = [l for l in plists if l is not short]
        results = []
        for x in short:
            ok = True
            for l in others:
                i = bisect_left(l, x)
                if i >= len(l) or l[i] != x:
                    ok = False
                    break
            if not ok:
                continue
            hit = False
            for _, _, dd, tt in blocks:
                i = np.searchsorted(dd, x, side="left")
                while i < len(dd) and dd[i] == x:
                    if lo <= tt[i] < hi:
                        hit = True
                        break
                    i += 1
                if hit:
                    break
            if hit:
                results.append(x)
                if len(results) == k:
                    break
        return results
