"""Generational QAC serving: delta tier + exact k-way merge + atomic swap,
as in the JAX package's ``serve/freshness.py``.

``GenerationalQAC`` is the freshness layer over the whole serving stack:
it owns a chain of immutable index *generations* (each a full
``build_qac_index`` artifact on the card with its warmed ``QACFrontend``),
the current generation's ``core.delta.DeltaIndex`` absorbing live inserts,
and ONE ``QACOnlineRuntime`` whose caches carry the generation tag. Three
moving parts:

  * **k-way merge serving**: every answered request is merged on the host
    from two sorted streams: the main tier's engine row (k smallest
    matching docids, which IS (-score, lexicographic-row) order) and the
    delta tier's matches at the request's visible sequence number. Merge
    key: ``(-score, token tuple)``: term ids are lexicographic ranks, so
    comparing token tuples compares term rows, and the key survives
    dictionary regeneration across generations. Shadowed main docids
    (delta raised their score) are suppressed; the same completion
    re-enters from the delta stream. Fewer than k visible matches pad the
    answer.

    The merge is exact per answer: the engine row's fetch horizon is its
    deepest examined docid, and every unfetched main match sorts strictly
    after it. If the merged k-th item does not sort at or before the
    horizon, the layer ESCALATES: it re-fetches the main tier at the next
    pow2 k (one ``frontend.complete`` dispatch at B=1 each) until the bound
    holds or the tier is exhausted. A multi-term request whose conjunctive
    driver scan would truncate (``tile * max_tiles`` candidates) skips the
    engine row and takes an exact scan of the generation's forward index
    instead, so merged answers are true top-k where the engine's budget is
    not. The JAX package scans on the host with numpy; the port filters the
    index's own forward rows on its device with torch ops (the docids are
    the same) and keeps the first k + |shadowed| matches, the only ones
    that can reach the answer. ``truncated_scans`` counts the branch and
    ``truncated_scan_us`` sums its wall.

  * **generation-tagged caches (cache-below-merge)**: the runtime's LRU and
    session tiers sit BELOW the merge and hold main-tier rows only. A main
    row is valid for the entire generation, so inserts never invalidate
    anything; the delta is merged on top at answer time. A generation swap
    invalidates both tiers exactly once
    (``QACOnlineRuntime.install_generation``).

  * **rebuild-and-swap**: when the delta reaches ``swap_threshold`` visible
    changes, the delta folds into a fresh immutable build (the same
    builder over base + applied entries + deferred OOV, so the new
    generation is bit-identical to a from-scratch build by construction),
    the new frontend runs a warm-up sweep, and the swap itself is only:
    drain the runtime (queued requests were admitted against the old
    generation and must be answered by it), absorb their answers at the old
    version, make the new generation's host view, install the new frontend
    under the next monotone generation id. ``swap_log`` records the rebuild
    wall (build, of it the postings packing, frontend, warm-up) and the swap
    stall (drain, absorb, view, install) separately.

Visible version = ``(generation, seq)``: a request's answer reflects the
generation installed when it was answered plus the first ``seq`` visible
delta changes. The time-indexed oracle (``oracle_answer`` /
``check_parity``) rebuilds that exact corpus from scratch per distinct
version and asserts every answer matches it. ``witness_answers`` is a
cheaper check for indexes too large to rebuild per version: it filters the
generation's forward rows and the delta's op log on the device and orders
the matches by (-score, tokens). Event ordering makes the version
well-defined: a mutation first ticks the runtime clock (deadline dispatches
for earlier arrivals fire first, at the pre-mutation state), then pending
answers are absorbed, then the mutation applies.

Answers are completion STRINGS (k-tuples, None-padded), not docids: docids
are generation-local names and do not survive a swap.

Everything builds on the device that ``device`` names (None: the card);
``device="cpu"`` runs the plain PyTorch versions for the tests.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter, deque

import numpy as np
import torch

from ..backend import resolve_device
from ..core.builder import build_qac_index, parse_queries
from ..core.delta import DeltaIndex, MainCorpusView
from ..core.types import INF_DOCID
from ..obs.metrics import percentiles
from .frontend import QACFrontend
from .runtime import (QACOnlineRuntime, QACRequest, RuntimeConfig,
                      prepare_requests)


@dataclasses.dataclass
class FreshnessConfig:
    """Delta-tier + swap knobs, validated at construction like
    ``RuntimeConfig``/``ClusterConfig``. ``swap_threshold`` counts VISIBLE
    delta changes (applied inserts + in-place score raises); it must fit
    inside ``delta_capacity`` so the delta can never overflow between
    swaps, and the capacity must hold at least one full answer."""

    k: int = 10
    delta_capacity: int = 4096
    swap_threshold: int = 1024

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.delta_capacity < self.k:
            raise ValueError(
                f"delta_capacity ({self.delta_capacity}) must be >= k "
                f"({self.k}) — the delta alone may have to fill an answer")
        if not 1 <= self.swap_threshold <= self.delta_capacity:
            raise ValueError(
                f"swap_threshold ({self.swap_threshold}) must be in "
                f"[1, delta_capacity={self.delta_capacity}]")


@dataclasses.dataclass
class _Generation:
    """One immutable tier: its build artifacts, host view, warmed frontend,
    and the delta absorbing inserts while it is current. The forward index
    the exact scans read is the index's own, on its device."""

    gen: int
    qidx: object
    kept: list
    scores: np.ndarray
    view: MainCorpusView
    frontend: QACFrontend
    delta: DeltaIndex
    view_us: float           # the host view's build time


@dataclasses.dataclass
class FreshResult:
    """One merged answer. ``strings``/``scores`` are k-tuples (None/0.0
    padded); ``gen``/``seq`` is the visible version the answer reflects
    (what the oracle rebuilds); ``n_delta`` counts items served from the
    delta tier; ``path`` is the runtime cache path of the main-tier row."""

    idx: int
    query: str
    k: int
    gen: int
    seq: int
    strings: tuple
    scores: tuple
    path: str
    n_delta: int
    escalations: int
    lat_us: float


def _scan(fwd: torch.Tensor, lo: int, hi: int, prefix, limit: int) -> list[int]:
    """The first ``limit`` docids, ascending, whose forward row holds every
    term of ``prefix`` and a term in ``[lo, hi)``: the engines' match rule
    over the whole forward index, on its device."""
    keep = ((fwd >= lo) & (fwd < hi)).any(dim=1)
    for t in set(int(x) for x in prefix):
        keep &= (fwd == t).any(dim=1)
    return torch.nonzero(keep).flatten()[:limit].tolist()


class GenerationalQAC:
    """The freshness subsystem (module docstring): generations + delta +
    merge over one generation-tagged ``QACOnlineRuntime``."""

    def __init__(self, queries, scores, *, cfg: FreshnessConfig | None = None,
                 rt_cfg: RuntimeConfig | None = None,
                 frontend_kwargs: dict | None = None,
                 postings_codec: str | None = "ef", device=None,
                 tracer=None, registry=None, built=None):
        """Generation 0 is ``build_qac_index`` over ``queries``/``scores``,
        or ``built``: the ``(qidx, kept, scores)`` that ``build_qac_index``
        already returned for that log (its index on ``device``), which is
        served as it is and not built again. Later generations rebuild from
        ``kept`` and ``scores`` with ``postings_codec`` either way."""
        self.cfg = cfg if cfg is not None else FreshnessConfig()
        self.rt_cfg = rt_cfg if rt_cfg is not None else RuntimeConfig()
        self.device = resolve_device(device)
        # observability: shared with the runtime (reset threads it
        # through); merge/rebuild/swap emit their own spans here.
        self.tracer = tracer
        if registry is not None:
            registry.register_collector("freshness",
                                        lambda: self.snapshot())
        self._postings_codec = postings_codec
        self._fe_kwargs = dict(specialize_list_pad=False)
        self._fe_kwargs.update(frontend_kwargs or {})
        self._dispatch_logging = False
        if built is None:
            built = build_qac_index(
                list(queries), list(scores), k_default=self.cfg.k,
                postings_codec=postings_codec, device=self.device)
        qidx, kept, sc = built
        if qidx.device.type != self.device.type:
            raise ValueError(f"the built index is on {qidx.device}, "
                             f"the live index serves on {self.device}")
        self._g0 = self._make_generation(0, qidx, kept, sc,
                                         QACFrontend(qidx, **self._fe_kwargs))
        self.reset()

    def _make_generation(self, gen, qidx, kept, sc, fe) -> _Generation:
        t0 = time.perf_counter()
        view = MainCorpusView(qidx, kept, sc, fwd=fe.host_fwd_terms())
        view_us = (time.perf_counter() - t0) * 1e6
        return _Generation(
            gen=gen, qidx=qidx, kept=list(kept),
            scores=np.asarray(sc, np.float64), view=view, frontend=fe,
            delta=DeltaIndex(view, capacity=self.cfg.delta_capacity),
            view_us=view_us)

    def reset(self):
        """Fresh serving state back at generation 0 (measured-replay
        protocol). Generation 0's index, frontend and host view survive:
        the view is a pure function of its index, so only the delta is
        made anew (the JAX package rebuilds the view here too)."""
        g0 = self._g0
        self.history: dict[int, _Generation] = {0: dataclasses.replace(
            g0, delta=DeltaIndex(g0.view, capacity=self.cfg.delta_capacity))}
        self.rt = QACOnlineRuntime(g0.frontend, self.rt_cfg,
                                   tracer=self.tracer)
        self.answers: dict[int, FreshResult] = {}
        self._req_by_idx: dict[int, QACRequest] = {}
        self._recent: deque = deque(maxlen=64)   # warm fodder for swaps
        self.apply_log: list[dict] = []
        self.swap_log: list[dict] = []
        self.truncated_scans = 0
        self.truncated_scan_us = 0.0      # their wall, the scans' device work in it
        self._oracle_cache: dict[tuple[int, int], tuple] = {}

    def _cur(self) -> _Generation:
        return self.history[self.rt.generation]

    # -- dispatch log across generations --------------------------------------
    def begin_dispatch_log(self):
        """Record every engine dispatch from now on, on the serving frontend
        and on each frontend a later rebuild makes (``QACFrontend``'s
        dispatch log: (cache key, route) per dispatch)."""
        self._dispatch_logging = True
        for g in self.history.values():
            g.frontend.begin_dispatch_log()

    def end_dispatch_log(self) -> list:
        """Every generation's dispatches since ``begin_dispatch_log``."""
        self._dispatch_logging = False
        log, seen = [], set()
        for g in self.history.values():
            if id(g.frontend) not in seen:
                seen.add(id(g.frontend))
                log += g.frontend.end_dispatch_log()
        return log

    # -- merge ----------------------------------------------------------------
    @staticmethod
    def _scan_exact_gen(g: _Generation, r: QACRequest) -> bool:
        """Mirror of ``QACOnlineRuntime._scan_exact`` against generation
        g's own posting lists (the request was parsed under g, so its term
        ids index g's lists, not whatever is installed now)."""
        if r.plen == 0:
            return True
        ll = g.frontend._list_lens
        terms = np.clip(r.pids[: r.plen], 0, len(ll) - 1)
        return int(ll[terms].min()) <= g.frontend.tile * g.frontend.max_tiles

    def _main_key(self, g: _Generation, d: int) -> tuple:
        return (-float(g.view.score_of_docid[d]), g.view.tokens_of_docid[d])

    def _merge(self, g: _Generation, r: QACRequest, row: np.ndarray,
               seq: int):
        """Merge the main-tier row with the delta at sequence ``seq`` into
        the exact top-k (strings, scores, n_delta, escalations)."""
        delta = g.delta
        d_ids = delta.matches(r.pids, r.plen, r.lo, r.hi, upto=seq)
        d_items = [(-delta.entries[i].score_at(seq), delta.entries[i].tokens,
                    delta.entries[i].query) for i in d_ids]
        shadowed = delta.shadowed(seq)
        escalations = 0
        if not self._scan_exact_gen(g, r):
            # the engine's conjunctive driver scan would truncate on this
            # request: take the exact scan of g's forward index so the
            # merged answer is true top-k regardless of the engine budget.
            # Main items sort in docid order, so past the first k that are
            # not shadowed none can reach the answer.
            t0 = time.perf_counter()
            fetched = _scan(g.qidx.completions.fwd_terms, r.lo, r.hi,
                            r.pids[: r.plen], r.k + len(shadowed))
            self.truncated_scans += 1
            self.truncated_scan_us += (time.perf_counter() - t0) * 1e6
            exhausted = True
            escalations = -1            # sentinel: exact-scan path taken
        else:
            fetched = [int(d) for d in row if d != INF_DOCID]
            exhausted = len(fetched) < len(row)
        kprime = max(r.k, 1)
        n_main = int(g.view.score_of_docid.shape[0])
        while True:
            m_items = [self._main_key(g, d) + (g.view.string_of_docid[d],)
                       for d in fetched if d not in shadowed]
            merged = sorted(d_items + m_items)
            if exhausted:
                break
            horizon = self._main_key(g, fetched[-1]) if fetched else None
            if (len(merged) >= r.k
                    and (horizon is None
                         or merged[r.k - 1][:2] <= horizon)):
                break
            # escalate: deeper main fetch at the next pow2 k
            escalations += 1
            kprime = max(kprime * 2, 2)
            kprime = 1 << (kprime - 1).bit_length()
            if self.tracer is not None and self.tracer.want(r.idx):
                self.tracer.instant("merge.escalate", r.t_us,
                                    cat="freshness", req=r.idx,
                                    kprime=kprime, gen=g.gen)
            out = g.frontend.complete(
                r.pids[None], np.asarray([r.plen], np.int32), r.suf[None],
                np.asarray([r.slen], np.int32), k=min(kprime, n_main))[0]
            fetched = [int(d) for d in out if d != INF_DOCID]
            exhausted = len(fetched) < out.shape[0] or kprime >= n_main
        top = merged[: r.k]
        strings = tuple(t[2] for t in top) + (None,) * (r.k - len(top))
        scs = tuple(-t[0] for t in top) + (0.0,) * (r.k - len(top))
        n_delta = sum(1 for t in top if t[:2] in
                      {(s, tk) for s, tk, _ in d_items})
        return strings, scs, n_delta, max(escalations, 0)

    def _absorb(self):
        """Move finished runtime rows into merged answers at the CURRENT
        visible version (absorb always runs before a mutation applies or a
        swap installs, so "current" is exactly what those rows saw)."""
        rt = self.rt
        if not rt._results:
            return
        tr = self.tracer
        for idx, row in rt._results.items():
            r = self._req_by_idx.pop(idx)
            g = self.history[rt.done_gen[idx]]
            seq = g.delta.seq
            traced = tr is not None and tr.want(idx)
            t0 = time.perf_counter() if traced else 0.0
            strings, scs, n_delta, esc = self._merge(g, r, row, seq)
            if traced:
                tr.span("merge.kway", rt.done_t_us[idx],
                        (time.perf_counter() - t0) * 1e6, cat="freshness",
                        req=idx, n_delta=n_delta, escalations=esc,
                        seq=seq, gen=g.gen)
            self.answers[idx] = FreshResult(
                idx=idx, query=r.query, k=r.k, gen=g.gen, seq=seq,
                strings=strings, scores=scs, path=rt.done_path[idx],
                n_delta=n_delta, escalations=esc,
                lat_us=rt.done_t_us[idx] - r.t_us)
        rt._results.clear()
        rt.done_t_us.clear()
        rt.done_path.clear()
        rt.done_gen.clear()

    # -- mutations ------------------------------------------------------------
    def insert(self, query: str, score: float, t_us: float = 0.0) -> str:
        """Apply one live mutation at virtual time ``t_us``: tick the
        runtime (deadline dispatches for earlier arrivals fire at the
        pre-mutation state), absorb their answers, apply the insert, and
        rebuild-and-swap if the delta crossed the threshold. Returns the
        ``DeltaIndex.insert`` outcome kind."""
        self.rt.tick(t_us)
        self._absorb()
        g = self._cur()
        t0 = time.perf_counter()
        out = g.delta.insert(query, score)
        self.apply_log.append(dict(
            t_us=float(t_us), outcome=out, gen=g.gen,
            wall_us=(time.perf_counter() - t0) * 1e6))
        if self.tracer is not None:
            self.tracer.instant("delta.apply", float(t_us), cat="freshness",
                                outcome=out, gen=g.gen, seq=g.delta.seq)
        if g.delta.seq >= self.cfg.swap_threshold:
            self._rebuild_and_swap(t_us)
        return out

    def _warm_frontend(self, fe: QACFrontend):
        """Run the new generation's dispatch shapes once from recent
        traffic (pow2 sweep, both engine classes), which loads the kernels
        and fills PyTorch's allocator: part of the BACKGROUND rebuild cost,
        never the swap stall."""
        good = [r for r in self._recent if not QACOnlineRuntime._is_bad(r)]
        for rs in ([r for r in good if r.plen == 0],
                   [r for r in good if r.plen > 0]):
            if not rs:
                continue
            b = 1
            while b <= max(self.rt_cfg.max_batch, 1):
                take = [rs[i % len(rs)] for i in range(b)]
                fe.complete(
                    np.stack([r.pids for r in take]),
                    np.asarray([r.plen for r in take], np.int32),
                    np.stack([r.suf for r in take]),
                    np.asarray([r.slen for r in take], np.int32),
                    k=np.asarray([r.k for r in take], np.int32))
                if b == self.rt_cfg.max_batch:
                    break
                b = min(b * 2, self.rt_cfg.max_batch)

    def _rebuild_and_swap(self, t_us: float):
        """Fold the delta into a fresh immutable build, then atomically
        install it. The rebuild + new-frontend warm-up happen "in
        background" (their wall time is ``rebuild_wall_us``); the swap stall
        is only drain + absorb + view + install."""
        g = self._cur()
        t0 = time.perf_counter()
        dq, ds = g.delta.fold_corpus()
        timings = {}
        qidx, kept, sc = build_qac_index(
            g.kept + dq, list(g.scores) + ds, k_default=self.cfg.k,
            postings_codec=self._postings_codec, device=self.device,
            timings=timings)
        t_built = time.perf_counter()
        fe = QACFrontend(qidx, **self._fe_kwargs)
        if self._dispatch_logging:
            fe.begin_dispatch_log()
        t_fe = time.perf_counter()
        self._warm_frontend(fe)
        t_warm = time.perf_counter()
        rebuild_us = (t_warm - t0) * 1e6
        self.rt.drain()
        t_drain = time.perf_counter()
        self._absorb()                      # old-version answers, pre-swap
        t_absorb = time.perf_counter()
        new_gen = g.gen + 1
        self.history[new_gen] = self._make_generation(
            new_gen, qidx, kept, sc, fe)
        t_view = time.perf_counter()
        self.rt.install_generation(new_gen, fe)
        t_end = time.perf_counter()
        stall_us = (t_end - t_warm) * 1e6
        self.swap_log.append(dict(
            t_us=float(t_us), gen=new_gen, rebuild_wall_us=rebuild_us,
            swap_stall_us=stall_us, folded=g.delta.n,
            folded_seq=g.delta.seq, deferred=len(g.delta.deferred),
            build_us=(t_built - t0) * 1e6, pack_us=timings.get("pack_us", 0.0),
            frontend_us=(t_fe - t_built) * 1e6, warm_us=(t_warm - t_fe) * 1e6,
            drain_us=(t_drain - t_warm) * 1e6,
            absorb_us=(t_absorb - t_drain) * 1e6,
            view_us=(t_view - t_absorb) * 1e6,
            install_us=(t_end - t_view) * 1e6))
        if self.tracer is not None:
            self.tracer.span("generation.rebuild", float(t_us), rebuild_us,
                             cat="freshness", gen=new_gen, folded=g.delta.n)
            self.tracer.span("generation.swap_stall", float(t_us), stall_us,
                             cat="freshness", gen=new_gen)
            self.tracer.instant("generation.swap", float(t_us),
                                cat="freshness", generation=new_gen)

    # -- serving --------------------------------------------------------------
    def _flush_requests(self, buf: list, k: int):
        """Parse a run of buffered request events against the CURRENT
        generation's dictionary and submit them in arrival order. Safe to
        batch: between two mutations the runtime is driven purely by
        ``submit`` at each request's own timestamp."""
        if not buf:
            return
        g = self._cur()
        reqs = parse_and_prepare(g.qidx, [(t, s, q) for _, t, s, q in buf],
                                 k=k)
        for (gidx, _, _, _), r in zip(buf, reqs):
            r.idx = gidx
            self._req_by_idx[gidx] = r
            self._recent.append(r)
            self.rt.submit(r)

    def run_mutation_trace(self, events, *, k: int | None = None):
        """Replay a mutation trace (``text.generate_mutation_trace`` events
        or (t_us, kind, session, query, score) tuples) -> list of
        ``FreshResult`` in request order."""
        k = self.cfg.k if k is None else k
        buf, req_order = [], []
        last = -np.inf
        for gidx, ev in enumerate(events):
            t, kind, sess, q, sc = _norm_event(ev)
            if t < last:
                raise ValueError("trace must be sorted by event time")
            last = t
            if kind == "request":
                buf.append((gidx, t, sess, q))
                req_order.append(gidx)
            elif kind in ("insert", "trend"):
                self._flush_requests(buf, k)
                buf = []
                self.insert(q, sc, t)
            else:
                raise ValueError(f"unknown event kind {kind!r}")
        self._flush_requests(buf, k)
        self.rt.drain()
        self._absorb()
        missing = [i for i in req_order if i not in self.answers]
        if missing:
            raise RuntimeError(
                f"requests lost by freshness layer: {missing[:5]}")
        return [self.answers[i] for i in req_order]

    def replay(self, events, *, k: int | None = None, warm: bool = True):
        """Measured-replay protocol (runtime/cluster shape): one full warm
        pass runs generation 0's dispatch shapes and every swap the trace
        will perform, then reset + measured pass."""
        if warm:
            self.run_mutation_trace(events, k=k)
            self.reset()
        return self.run_mutation_trace(events, k=k)

    def complete_batch(self, raw_queries, *, k: int | None = None):
        """Batched merged path, no runtime/caches: parse + main-tier
        ``frontend.complete`` + per-row delta merge at the current version.
        Returns list[tuple[str | None, ...]] of length k each."""
        k = self.cfg.k if k is None else k
        g = self._cur()
        reqs = parse_and_prepare(
            g.qidx, [(0.0, 0, q) for q in raw_queries], k=k)
        out = g.frontend.complete(
            np.stack([r.pids for r in reqs]),
            np.asarray([r.plen for r in reqs], np.int32),
            np.stack([r.suf for r in reqs]),
            np.asarray([r.slen for r in reqs], np.int32), k=k)
        seq = g.delta.seq
        return [self._merge(g, r, out[i, : k], seq)[0]
                for i, r in enumerate(reqs)]

    # -- the time-indexed oracle ----------------------------------------------
    def oracle_index(self, gen: int, seq: int):
        """From-scratch build of visible version (gen, seq): the
        generation's base corpus + its delta oplog replayed to ``seq``,
        through the ONE production builder, on this instance's device.
        Cached per distinct version."""
        key = (gen, seq)
        hit = self._oracle_cache.get(key)
        if hit is not None:
            return hit
        g = self.history[gen]
        ops = g.delta.oplog[:seq]
        qidx, kept, sc = build_qac_index(
            g.kept + [q for q, _ in ops],
            list(g.scores) + [s for _, s in ops],
            k_default=self.cfg.k, postings_codec=self._postings_codec,
            device=self.device)
        self._oracle_cache[key] = (qidx, MainCorpusView(qidx, kept, sc))
        return self._oracle_cache[key]

    def oracle_answer(self, raw_query: str, gen: int, seq: int,
                      k: int) -> tuple:
        """The ground truth for one answer: parse ``raw_query`` against the
        from-scratch index of version (gen, seq) and take its exact top-k
        (smallest matching docids == (-score, lexicographic row) order),
        decoded to strings. This is what every served ``FreshResult`` must
        equal, bit for bit."""
        qidx, view = self.oracle_index(gen, seq)
        pids, plen, _, suf, slen = parse_queries(qidx.dictionary, [raw_query])
        lo, hi = (int(a[0]) for a in qidx.dictionary.locate_prefix(suf, slen))
        pl = int(plen[0])
        prefix = pids[0, :pl].cpu().numpy()
        if hi <= lo or (pl > 0 and bool((prefix == 0).any())):
            return (None,) * k
        docids = _scan(qidx.completions.fwd_terms, lo, hi, prefix, k)
        strings = tuple(view.string_of_docid[d] for d in docids)
        return strings + (None,) * (k - len(strings))

    def check_parity(self, results, *, sample_every: int = 1) -> int:
        """Assert the time-indexed parity gate over served results: every
        (sampled) answer's strings equal the from-scratch oracle at its own
        visible version. Returns the number of answers checked."""
        checked = 0
        for res in results[::max(sample_every, 1)]:
            want = self.oracle_answer(res.query, res.gen, res.seq, res.k)
            if res.strings != want:
                raise AssertionError(
                    f"freshness parity break at request {res.idx} "
                    f"({res.query!r}, gen={res.gen}, seq={res.seq}): "
                    f"served {res.strings[:3]}... vs oracle {want[:3]}...")
            checked += 1
        return checked

    # -- reporting ------------------------------------------------------------
    def snapshot(self) -> dict:
        """Freshness counters + the runtime telemetry snapshot."""
        served = list(self.answers.values())
        # the shared percentile helper; the `or [0.0]` fallback keeps a
        # zero-mutation replay reporting floats (this snapshot's contract,
        # unlike the runtime/cluster latency keys)
        ap = percentiles([a["wall_us"] for a in self.apply_log] or [0.0],
                         (50, 99))
        st = percentiles([s["swap_stall_us"] for s in self.swap_log]
                         or [0.0], (99,))
        return {
            "generation": self.rt.generation,
            "n_swaps": len(self.swap_log),
            "n_mutations": len(self.apply_log),
            "mutation_outcomes": dict(
                Counter(a["outcome"] for a in self.apply_log)),
            "delta_stats": self._cur().delta.stats(),
            "delta_hit_answers": sum(1 for r in served if r.n_delta > 0),
            "escalations": sum(r.escalations for r in served),
            "truncated_scans": self.truncated_scans,
            "truncated_scan_us": self.truncated_scan_us,
            "apply_p50_us": ap["p50_us"],
            "apply_p99_us": ap["p99_us"],
            "swap_stall_p99_us": st["p99_us"],
            "rebuild_wall_us": [s["rebuild_wall_us"] for s in self.swap_log],
            "runtime": self.rt.telemetry.snapshot(),
        }


def witness_answers(gq: GenerationalQAC, results) -> list[tuple]:
    """Each answer's strings as the from-scratch semantics give them, with
    no build: the answer's generation's base corpus plus its delta op log
    replayed to ``seq`` (max score per completion), filtered by the
    engines' match rule and ordered by (-score, tokens), the order a
    from-scratch build assigns its docids. The main tier is scanned on its
    device (its first k + |outranked| matches); the op log's rows are
    filtered there too. Reads the generation's index, host view, term ids
    and op log, not the merge or the delta's own reads."""
    out: dict[int, tuple] = {}
    by_gen: dict[int, list] = {}
    for i, res in enumerate(results):
        by_gen.setdefault(res.gen, []).append(i)
    for gen, idxs in by_gen.items():
        g = gq.history[gen]
        view, fwd = g.view, g.qidx.completions.fwd_terms
        reqs = prepare_requests(g.qidx, [(0.0, 0, results[i].query) for i in idxs])
        oplog = g.delta.oplog
        tokens = [tuple(q.split()) for q, _ in oplog]
        rows = np.zeros((len(oplog), fwd.shape[1]), np.int32)
        for j, tk in enumerate(tokens):
            rows[j, :len(tk)] = [view.term_id[t] for t in tk]
        rows_dev = torch.from_numpy(rows).to(fwd.device)
        for i, r in zip(idxs, reqs):
            res = results[i]
            if QACOnlineRuntime._is_bad(r):
                out[i] = (None,) * res.k
                continue
            best: dict[str, float] = {}          # the visible delta state
            for (q, s) in oplog[: res.seq]:
                best[q] = max(best.get(q, -np.inf), s)
            hit = ((rows_dev >= r.lo) & (rows_dev < r.hi)).any(dim=1)
            for t in set(int(x) for x in r.pids[: r.plen]):
                hit &= (rows_dev == t).any(dim=1)
            first = {}
            for j in torch.nonzero(hit[: res.seq]).flatten().tolist():
                first.setdefault(oplog[j][0], j)
            items = [(-best[q], tokens[j], q) for q, j in first.items()]
            outranked = {view.docid_of_string[q] for q in best
                         if q in view.docid_of_string}
            for d in _scan(fwd, r.lo, r.hi, r.pids[: r.plen],
                           res.k + len(outranked)):
                if d not in outranked:
                    items.append((-float(view.score_of_docid[d]),
                                  view.tokens_of_docid[d],
                                  view.string_of_docid[d]))
            top = [q for _, _, q in sorted(items)[: res.k]]
            out[i] = tuple(top) + (None,) * (res.k - len(top))
    return [out[i] for i in range(len(results))]


def _norm_event(ev):
    """(t_us, kind, session, query, score) from a MutationEvent-like
    object or a plain tuple."""
    if hasattr(ev, "kind"):
        return (float(ev.t_us), ev.kind, int(ev.session), ev.query,
                float(ev.score))
    t, kind, sess, q, sc = ev
    return float(t), kind, int(sess), q, float(sc)


def parse_and_prepare(qidx, trace, *, k: int = 10):
    """``runtime.prepare_requests`` under its freshness-layer name: one
    batched parse of (t_us, session, query) events against a SPECIFIC
    generation's dictionary: requests are generation-local, so the
    freshness layer re-parses per generation rather than once per trace."""
    return prepare_requests(qidx, trace, k=k)
