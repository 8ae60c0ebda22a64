"""Online QAC serving runtime: one replica, as in the JAX package's
``serve/runtime.py``.

Everything below ``QACFrontend`` is batch-in/batch-out; QAC traffic is
neither: requests arrive one at a time, keystroke by keystroke per session.
This module is the layer in between:

  * **micro-batch scheduler**: individually arriving timestamped requests
    join a FIFO queue; a batch dispatches when ``max_batch`` requests are
    waiting (the bucket is full) or the oldest request's slack expires
    (``deadline = arrival + slack_us``). Batches go straight into
    ``QACFrontend.complete``, whose pow2 batch and k buckets and
    per-(engine, bucket, k, list_pad) callable cache keep the set of
    launch shapes closed in steady state.
  * **prefix-result cache + session store**: sessions retype popular
    prefixes (exact-hit LRU, keyed by the *parsed* query so whitespace
    variants share entries), and each keystroke extends the session's
    previous prefix by one character. When the previous answer was
    *complete* (fewer than k matches: an INF_DOCID-padded row is the whole
    match set) and the extension provably shrinks the match set, the new
    answer is computed by filtering the cached set on the host, with no
    engine dispatch at all. Results are bit-identical to an uncached
    ``QACFrontend`` call by construction.
  * **telemetry**: per-request latency percentiles, queue depth (max-depth
    gauge), deadline violations, batch sizes, dispatch triggers, cache hit
    rate.

One instance is one serving replica and never sheds load: the queue is
unbounded. Overload policy belongs to ``serve/cluster.py``, whose hooks
into this runtime are ``on_dispatch`` (per-dispatch service telemetry for
the queue-pressure estimator) and ``done_t_us`` (virtual completion times,
so re-routed requests are measured from their original arrival).

Time model: an explicit clock in microseconds. Trace replay (``run_trace``)
uses the trace's virtual arrival times for queueing decisions and
*measured wall time* for engine service, the queueing-simulation hybrid, so
reported latency includes real queueing behind a busy server. On the card
that wall time covers the dispatch's device work: ``QACFrontend.complete``
returns host arrays, and the copy to the host waits for the kernels. A
dispatched batch's results are visible to the cache immediately rather
than at completion time; at keystroke cadence (~100 ms) against batch
service (~ms) the difference is noise, and it cannot affect parity.

The index lives on the device; the runtime reads two host mirrors of it,
each made once per frontend: the forward index (docid -> term row) for the
session filter, and the posting-list lengths for the completeness proof.
``prepare_requests`` parses a whole trace on the device and brings its
fields to the host in one copy each; no request reads the device on its own.

The exactness argument for the session filter path. A request parses to
prefix term-ids ``P`` and a suffix term range ``[lo, hi)``; the engine
returns the k smallest docids d with ``P ⊆ T(d)`` and ``T(d) ∩ [lo, hi) ≠
∅`` (T(d) = the completion's term set, docid order == score order). For a
previous request (P0, [lo0, hi0)) and a new one (P, [lo, hi)), the new
match set is a subset of the old when

  ``P0 ⊆ P``  AND  ( ``[lo, hi) ⊆ [lo0, hi0)``                — suffix grew
                 OR  ``∃ t ∈ P \\ P0 with lo0 <= t < hi0`` )   — term completed

(the second disjunct is the just-promoted term witnessing the old suffix
condition). Both keystroke moves, appending a character or completing a
term with a space, satisfy one of these. Backtracking grows the match set,
so it never reuses the session entry; it hits the exact LRU instead.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter, OrderedDict, deque

import numpy as np

from ..core.builder import QACIndex, parse_queries
from ..core.types import INF_DOCID
from ..obs.metrics import percentiles
from .frontend import QACFrontend


@dataclasses.dataclass
class RuntimeConfig:
    """Scheduler + cache knobs. These defaults suit a small demo;
    ``QACArch.online_*`` / ``runtime_config()`` is the production-scale
    preset (bigger batches and caches)."""

    max_batch: int = 64          # dispatch as soon as this many misses queue
    slack_us: float = 20_000.0   # batching deadline per request (NOT the SLA)
    cache_entries: int = 1 << 16   # exact prefix-result LRU capacity; 0 = off
    session_entries: int = 1 << 16  # session store capacity; 0 = off

    def __post_init__(self):
        # fail at construction with a nameable field, not deep inside a
        # dispatch. slack_us == 0 is legal (dispatch immediately); a
        # negative deadline is not.
        if self.max_batch <= 0:
            raise ValueError(f"max_batch must be positive, "
                             f"got {self.max_batch}")
        if self.slack_us < 0:
            raise ValueError(f"slack_us must be >= 0, got {self.slack_us}")
        if self.cache_entries < 0:
            raise ValueError(f"cache_entries must be >= 0, "
                             f"got {self.cache_entries}")
        if self.session_entries < 0:
            raise ValueError(f"session_entries must be >= 0, "
                             f"got {self.session_entries}")


@dataclasses.dataclass
class QACRequest:
    """One timestamped keystroke request, pre-parsed for the engines.

    ``key`` is the parsed identity (prefix ids + suffix bytes): the cache
    key, so queries that parse identically share results. ``lo``/``hi`` is
    the suffix's term range from ``dictionary.locate_prefix``; the session
    fast path needs it on the host, and it is bit-for-bit what the engine
    recomputes on the device (same structure, same search).
    """

    idx: int
    t_us: float
    session: int
    query: str
    k: int
    pids: np.ndarray      # int32[MAX_TERMS]
    plen: int
    ok: bool              # parse's prefix_ok (every prefix term known)
    suf: np.ndarray       # uint8[MAX_TERM_CHARS]
    slen: int
    lo: int
    hi: int
    key: tuple
    deadline: float = 0.0


def prepare_requests(qidx: QACIndex, trace, *, k: int | np.ndarray = 10):
    """(t_us, session, query) events -> list[QACRequest], one batched parse.

    ``trace`` is what ``text.synth.generate_keystroke_trace`` emits (any
    iterable of timestamped (t_us, session_id, raw_query) works). ``k`` may
    be a scalar or a per-request array (the frontend's per-request-k path
    serves mixed-k batches exactly). The parse and ``locate_prefix`` run on
    the index's device, once for the whole trace.
    """
    trace = list(trace)
    raw = [q for _, _, q in trace]
    pids, plen, pok, suf, slen = parse_queries(qidx.dictionary, raw)
    lo, hi = qidx.dictionary.locate_prefix(suf, slen)
    # the whole trace's fields to the host, one copy each
    pids, plen, suf, slen, lo, hi = (
        a.cpu().numpy() for a in (pids, plen, suf, slen, lo, hi))
    karr = np.broadcast_to(np.asarray(k, np.int32), (len(raw),))
    reqs = []
    for i, (t, sess, q) in enumerate(trace):
        pl, sl = int(plen[i]), int(slen[i])
        key = (pl, pids[i, :pl].tobytes(), sl, suf[i, :sl].tobytes())
        reqs.append(QACRequest(
            idx=i, t_us=float(t), session=int(sess), query=q,
            k=int(karr[i]), pids=pids[i], plen=pl, ok=bool(pok[i]),
            suf=suf[i], slen=sl, lo=int(lo[i]), hi=int(hi[i]), key=key))
    return reqs


@dataclasses.dataclass
class _SessionEntry:
    """Last answered request of a session: its parse + (when complete) the
    FULL ascending match set. ``full is None`` == truncated, no reuse.
    ``gen`` is the index generation that produced the match set — docids
    from another generation name different completions, so reuse requires
    ``gen == runtime.generation`` (enforced in ``_reusable``)."""

    pid_set: frozenset
    lo: int
    hi: int
    full: np.ndarray | None
    gen: int = 0


class RuntimeTelemetry:
    """Latency/cache/batch counters; ``snapshot()`` -> flat dict."""

    def __init__(self):
        self.lat_us: list[float] = []
        self.paths: Counter = Counter()
        self.batch_sizes: list[int] = []
        self.triggers: Counter = Counter()
        self.queue_peak = 0
        self.engine_wall_us = 0.0
        # a deadline violation = a dispatch that STARTED after the oldest
        # batched request's (arrival + slack) deadline: the server was so
        # backed up the batching budget was already blown before service
        # began. Both it and queue_peak are first-class snapshot() fields.
        self.deadline_violations = 0
        # freshness: per-generation path counters + the swap
        # invalidation ledger. paths_by_gen[g] counts hits/misses answered
        # while generation g was installed; invalidations[(old, new)]
        # records each swap's flush exactly once (count, entries dropped
        # per tier) — tests assert count == 1 per transition.
        self.paths_by_gen: dict[int, Counter] = {}
        self.invalidations: dict[tuple[int, int], dict] = {}

    def record(self, path: str, lat_us: float, gen: int | None = None):
        self.paths[path] += 1
        self.lat_us.append(lat_us)
        if gen is not None:
            self.paths_by_gen.setdefault(gen, Counter())[path] += 1

    def record_invalidation(self, old_gen: int, new_gen: int,
                            n_lru: int, n_sessions: int):
        key = (old_gen, new_gen)
        entry = self.invalidations.setdefault(
            key, {"count": 0, "lru_entries": 0, "session_entries": 0})
        entry["count"] += 1
        entry["lru_entries"] += n_lru
        entry["session_entries"] += n_sessions

    def snapshot(self) -> dict:
        n = len(self.lat_us)
        hits = self.paths["hit_exact"] + self.paths["hit_session"]
        hist = {}
        if self.batch_sizes:
            bs = np.asarray(self.batch_sizes)
            sizes, counts = np.unique(bs, return_counts=True)
            hist = {int(s): int(c) for s, c in zip(sizes, counts)}
        snap = {"n_requests": n}
        # the one percentile implementation (obs.metrics): a window that
        # served nothing reports explicit None, never a fake 0us
        snap.update(percentiles(self.lat_us, mean=True, vmax=True))
        snap.update({
            "cache_hit_rate": hits / max(n, 1),
            "paths": dict(self.paths),
            "n_batches": len(self.batch_sizes),
            "mean_batch_size": (float(np.mean(self.batch_sizes))
                                if self.batch_sizes else None),
            "batch_hist": hist,
            "triggers": dict(self.triggers),
            "queue_peak": self.queue_peak,
            "max_queue_depth": self.queue_peak,
            "deadline_violations": self.deadline_violations,
            "engine_wall_us": float(self.engine_wall_us),
            "per_generation": {g: dict(c)
                               for g, c in sorted(self.paths_by_gen.items())},
            "invalidations": {f"{o}->{n}": dict(v) for (o, n), v in
                              sorted(self.invalidations.items())},
        })
        return snap


class QACOnlineRuntime:
    """Deadline-aware micro-batching + keystroke-locality caches over a
    ``QACFrontend``. One instance per serving replica; ``reset()`` clears
    queue/caches/telemetry but keeps the frontend's warm callable cache.
    It runs on the device of the frontend's index."""

    def __init__(self, frontend: QACFrontend, cfg: RuntimeConfig | None = None,
                 *, tracer=None, registry=None):
        self.fe = frontend
        self.cfg = cfg if cfg is not None else RuntimeConfig()
        # observability: every instrumentation site below is behind
        # `if self.tracer is not None` (+ per-request sampling), so
        # tracer=None costs one attribute check per request. The registry
        # collector closes over self, so reset()'s fresh telemetry is
        # picked up without re-registering.
        self.tracer = tracer
        if registry is not None:
            registry.register_collector("runtime",
                                        lambda: self.telemetry.snapshot())
        # host forward index for the session filter path: docid -> term row,
        # one host copy per frontend (frontend.host_fwd_terms)
        self.fwd = frontend.host_fwd_terms()
        # posting-list lengths (host), for the completeness proof below
        self._list_lens = frontend._list_lens
        # cluster hook (serve/cluster.py): called as
        # on_dispatch(batch_size, wall_us, t_start) after every engine
        # dispatch, feeding the dispatcher's per-replica EWMA service-time
        # estimate. None = standalone runtime, no observer.
        self.on_dispatch = None
        # freshness: the installed index generation. Cache keys
        # and session entries carry this tag, and ``install_generation``
        # is the ONLY way to advance it — reset() deliberately leaves it
        # alone (it is index identity, not cache state).
        self.generation = 0
        self.reset()

    def reset(self):
        self.cache: OrderedDict = OrderedDict()     # (key, k) -> row int32[k]
        self.sessions: OrderedDict = OrderedDict()  # session -> _SessionEntry
        self.queue: deque = deque()
        self._server_free = 0.0
        self._results: dict[int, np.ndarray] = {}
        # virtual completion time per request idx (t_us + its latency) —
        # the cluster measures re-routed requests from their ORIGINAL
        # arrival, which only it knows, so it reads completion times here
        self.done_t_us: dict[int, float] = {}
        # freshness bookkeeping per answered request: which cache path
        # served it and which generation was installed when it finished —
        # the freshness layer keys its per-answer delta merge and the
        # time-indexed oracle on these.
        self.done_path: dict[int, str] = {}
        self.done_gen: dict[int, int] = {}
        self.telemetry = RuntimeTelemetry()

    def install_generation(self, generation: int, frontend: QACFrontend):
        """Atomically swap in a rebuilt index: flush both cache tiers
        EXACTLY ONCE (recorded in telemetry), rebind the frontend and its
        host mirrors, and advance the generation id. Idempotent on the
        same generation (a re-delivered swap must not double-flush);
        refuses to move backwards; refuses to swap under queued requests
        (the caller drains first — queued requests were admitted against
        the old generation and must be answered by it)."""
        if generation == self.generation:
            return
        if generation < self.generation:
            raise ValueError(f"generation must be monotone: "
                             f"{self.generation} -> {generation}")
        if self.queue:
            raise RuntimeError(
                f"cannot swap generation with {len(self.queue)} queued "
                f"requests; drain() first")
        self.telemetry.record_invalidation(
            self.generation, generation, len(self.cache), len(self.sessions))
        self.cache.clear()
        self.sessions.clear()
        self.fe = frontend
        self.fwd = frontend.host_fwd_terms()
        self._list_lens = frontend._list_lens
        self.generation = generation

    # -- host mirrors of the engine's semantics -------------------------------
    @staticmethod
    def _is_bad(r: QACRequest) -> bool:
        """The engines' reject rule, verbatim: empty suffix range always; an
        unknown (id 0) prefix term for the multi-term class. Rejected lanes
        are all-INF on device, so answering INF here is bit-identical."""
        if r.hi <= r.lo:
            return True
        return r.plen > 0 and bool((r.pids[: r.plen] == 0).any())

    def _match_rows(self, docids: np.ndarray, r: QACRequest) -> np.ndarray:
        """bool[n]: which candidate docids match r, by the engine's rule —
        every prefix term present and >= 1 term in [lo, hi)."""
        rows = self.fwd[docids]                                   # [n, M]
        keep = ((rows >= r.lo) & (rows < r.hi)).any(axis=1)
        if r.plen:
            pids = r.pids[: r.plen]
            has = (rows[:, None, :] == pids[None, :, None]).any(axis=2)
            keep &= has.all(axis=1)
        return keep

    def _scan_exact(self, r: QACRequest) -> bool:
        """Can an INF-padded engine row for r be trusted as the COMPLETE
        match set? The single-term engine is always exact (the frontend's
        full-budget fallback guarantees it), but ``conjunctive_multi``
        stops scanning its driver list after ``tile * max_tiles`` docids —
        an INF-padded row from a longer scan may be a truncation, not
        exhaustion. The driver is the SHORTEST prefix posting list, whose
        length the host knows, so exactness is provable per request."""
        if r.plen == 0:
            return True
        terms = np.clip(r.pids[: r.plen], 0, len(self._list_lens) - 1)
        return int(self._list_lens[terms].min()) <= self.fe.tile * self.fe.max_tiles

    def _reusable(self, sess: _SessionEntry | None, r: QACRequest) -> bool:
        """Is r's match set provably a subset of the session's stored one —
        AND would r's own engine dispatch have been exact? (See the module
        docstring for the subset argument.) The second condition matters
        because the contract is bit-identity with the engine INCLUDING its
        ``tile * max_tiles`` driver-scan truncation: on a request whose own
        scan would truncate, the host filter would return matches the
        engine misses, so it must fall through to the engine instead."""
        if sess is None or sess.full is None:
            return False
        if sess.gen != self.generation:
            return False   # docids from another generation are meaningless
        if not self._scan_exact(r):
            return False
        new_pids = frozenset(int(t) for t in r.pids[: r.plen])
        if not sess.pid_set <= new_pids:
            return False
        if sess.lo <= r.lo and r.hi <= sess.hi:
            return True
        return any(sess.lo <= t < sess.hi for t in new_pids - sess.pid_set)

    # -- cache/session bookkeeping --------------------------------------------
    def _remember(self, r: QACRequest, row: np.ndarray,
                  full: np.ndarray | None):
        """Insert an answered request into the LRU and the session store.

        ``full`` is the complete ascending match set when the caller knows
        it (filter path / trivial reject); otherwise it is recovered from
        the row iff the row is INF-padded (fewer than k matches == the row
        IS the whole set)."""
        if self.cfg.cache_entries > 0:
            # the generation tag in the key makes stale hits structurally
            # impossible even if a flush were missed; the swap still
            # flushes so dead-generation entries don't occupy LRU slots
            ck = (self.generation, r.key, r.k)
            # private copy: returned rows are caller-owned, so an in-place
            # consumer edit must never reach the cached entry
            self.cache[ck] = row.copy()
            self.cache.move_to_end(ck)
            while len(self.cache) > self.cfg.cache_entries:
                self.cache.popitem(last=False)
        if self.cfg.session_entries > 0:
            if (full is None and bool((row == INF_DOCID).any())
                    and self._scan_exact(r)):
                full = row[row != INF_DOCID]
            self.sessions[r.session] = _SessionEntry(
                pid_set=frozenset(int(t) for t in r.pids[: r.plen]),
                lo=r.lo, hi=r.hi, full=full, gen=self.generation)
            self.sessions.move_to_end(r.session)
            while len(self.sessions) > self.cfg.session_entries:
                self.sessions.popitem(last=False)

    def _finish(self, r: QACRequest, row: np.ndarray, path: str,
                lat_us: float):
        self._results[r.idx] = row
        self.done_t_us[r.idx] = r.t_us + lat_us
        self.done_path[r.idx] = path
        self.done_gen[r.idx] = self.generation
        self.telemetry.record(path, lat_us, gen=self.generation)

    # -- tracing helpers ------------------------------------------------------
    def _trace_hit(self, r: QACRequest, path: str, lat_us: float, **attrs):
        """Root request span + cache-tier child for a request answered at
        arrival (trivial / hit_exact / hit_session). No-op unless the
        request is sampled."""
        tr = self.tracer
        if tr is None or not tr.want(r.idx):
            return
        root = tr.span("request", r.t_us, lat_us, req=r.idx, path=path,
                       session=r.session, k=r.k, gen=self.generation,
                       query=r.query)
        tr.span(f"cache.{path}", r.t_us, lat_us, cat="cache", req=r.idx,
                parent=root, **attrs)

    def _miss_reason(self, r: QACRequest, sess) -> str:
        """Why the session fast path could not serve r (the exact LRU was
        already probed and absent). Computed only for sampled requests."""
        if self.cfg.session_entries <= 0:
            return "session_disabled"
        if sess is None:
            return "no_session_entry"
        if sess.full is None:
            return "truncated_set"
        if sess.gen != self.generation:
            return "stale_generation"
        if not self._scan_exact(r):
            return "scan_inexact"
        new_pids = frozenset(int(t) for t in r.pids[: r.plen])
        if not sess.pid_set <= new_pids:
            return "not_subset"
        return "suffix_widened"

    # -- scheduler ------------------------------------------------------------
    def submit(self, r: QACRequest):
        """One arriving request: serve it from the caches at arrival, or
        queue it for the next micro-batch. Call in arrival-time order."""
        now = r.t_us
        self._advance(now)
        t0 = time.perf_counter()
        if self._is_bad(r):
            row = np.full(r.k, INF_DOCID, np.int32)
            self._remember(r, row, row[:0])
            lat = (time.perf_counter() - t0) * 1e6
            self._finish(r, row, "trivial", lat)
            self._trace_hit(r, "trivial", lat, reason="engine_reject")
            return
        if self.cfg.cache_entries > 0:
            ck = (self.generation, r.key, r.k)
            hit = self.cache.get(ck)
            if hit is not None:
                self.cache.move_to_end(ck)
                self._remember(r, hit, None)
                lat = (time.perf_counter() - t0) * 1e6
                self._finish(r, hit.copy(), "hit_exact", lat)
                self._trace_hit(r, "hit_exact", lat, reason="lru_exact")
                return
        sess = (self.sessions.get(r.session)
                if self.cfg.session_entries > 0 else None)
        if self._reusable(sess, r):
            cand = sess.full
            keep = cand[self._match_rows(cand, r)] if cand.size else cand
            row = np.full(r.k, INF_DOCID, np.int32)
            row[: min(r.k, keep.size)] = keep[: r.k]
            self._remember(r, row, keep)
            lat = (time.perf_counter() - t0) * 1e6
            self._finish(r, row, "hit_session", lat)
            self._trace_hit(r, "hit_session", lat, reason="subset_filter",
                            n_candidates=int(cand.size))
            return
        if self.tracer is not None and self.tracer.want(r.idx):
            self.tracer.instant("cache.miss", now, cat="cache", req=r.idx,
                                reason=self._miss_reason(r, sess))
        r.deadline = now + self.cfg.slack_us
        self.queue.append(r)
        self.telemetry.queue_peak = max(self.telemetry.queue_peak,
                                        len(self.queue))
        while len(self.queue) >= self.cfg.max_batch:
            self._dispatch(max(now, self._server_free), "full")

    def _advance(self, now: float):
        """Fire every deadline-triggered dispatch that happens before
        ``now`` (multiple can queue up behind a busy server)."""
        while self.queue:
            t_ready = max(self.queue[0].deadline, self._server_free)
            if t_ready >= now:
                break
            self._dispatch(t_ready, "deadline")

    def _dispatch(self, t_start: float, trigger: str):
        """Form one micro-batch (oldest-first, only requests that have
        arrived by t_start) and run it through the frontend; the measured
        wall time advances the virtual server clock."""
        batch = []
        while (self.queue and len(batch) < self.cfg.max_batch
               and self.queue[0].t_us <= t_start):
            batch.append(self.queue.popleft())
        # every call site guarantees t_start >= the head's arrival time
        # (deadline = arrival + slack, full-trigger uses now) — a violation
        # would mean serving a request before it arrived
        assert batch, "dispatch scheduled before the queue head's arrival"
        tr = self.tracer
        traced = tr is not None and any(tr.want(r.idx) for r in batch)
        if traced:
            self.fe.begin_dispatch_log()
        t0 = time.perf_counter()
        pids = np.stack([r.pids for r in batch])
        plen = np.asarray([r.plen for r in batch], np.int32)
        suf = np.stack([r.suf for r in batch])
        slen = np.asarray([r.slen for r in batch], np.int32)
        # the frontend's array-k path owns the scalar-vs-bucketed routing
        # (only the default k collapses to a raw scalar dispatch)
        ks = np.asarray([r.k for r in batch], np.int32)
        # complete() returns host arrays: their copy from the card waits for
        # the dispatch's kernels, so dt_us holds its device work
        out = self.fe.complete(pids, plen, suf, slen, k=ks)
        dt_us = (time.perf_counter() - t0) * 1e6
        self._server_free = t_start + dt_us
        if traced:
            dlog = self.fe.end_dispatch_log()
            tr.span("batch.dispatch", t_start, dt_us, cat="batch",
                    size=len(batch), trigger=trigger,
                    keys=[list(key) for key, _ in dlog],
                    routes=sorted({route for _, route in dlog}))
        tel = self.telemetry
        tel.batch_sizes.append(len(batch))
        tel.triggers[trigger] += 1
        tel.engine_wall_us += dt_us
        tel.deadline_violations += sum(t_start > r.deadline for r in batch)
        if self.on_dispatch is not None:
            self.on_dispatch(len(batch), dt_us, t_start)
        for i, r in enumerate(batch):
            row = out[i, : r.k].copy()
            self._remember(r, row, None)
            lat = self._server_free - r.t_us
            self._finish(r, row, "miss", lat)
            if traced and tr.want(r.idx):
                # queue.wait + engine.service == lat exactly (same clock
                # arithmetic), so spans alone rebuild the percentiles
                root = tr.span("request", r.t_us, lat, req=r.idx,
                               path="miss", session=r.session, k=r.k,
                               gen=self.generation, query=r.query)
                tr.span("queue.wait", r.t_us, t_start - r.t_us,
                        cat="queue", req=r.idx, parent=root,
                        trigger=trigger)
                tr.span("engine.service", t_start, dt_us, cat="engine",
                        req=r.idx, parent=root, batch_size=len(batch))

    def tick(self, now: float):
        """Fire any deadline-expired dispatches up to ``now``. Trace replay
        never needs this (``submit`` advances the clock and ``drain`` ends
        the trace), but a LIVE deployment must call it periodically — a
        traffic lull after fewer than ``max_batch`` arrivals would
        otherwise leave queued requests past their deadlines with nothing
        to trigger the dispatch."""
        self._advance(now)

    def drain(self):
        """Dispatch everything still queued (end of trace / shutdown)."""
        while self.queue:
            self._dispatch(max(self.queue[0].deadline, self._server_free),
                           "drain")

    # -- drivers --------------------------------------------------------------
    def run_trace(self, reqs: list[QACRequest]):
        """Replay a timestamped request list -> result rows in trace order
        (row i is int32[reqs[i].k], INF-padded)."""
        last = -np.inf
        for r in reqs:
            if r.t_us < last:
                raise ValueError("trace must be sorted by arrival time")
            last = r.t_us
            self.submit(r)
        self.drain()
        return [self._results[r.idx] for r in reqs]

    def replay(self, reqs: list[QACRequest], *, warm: bool = True):
        """The measured-replay protocol: mint the trace's dispatch callables
        (``warmup`` sweep + one full warm pass, which also forms the batch
        shapes the schedule itself makes), reset runtime state, then replay
        measured. Telemetry afterwards reflects only the measured pass."""
        if warm:
            self.warmup(reqs)
            self.run_trace(reqs)
            self.reset()
        return self.run_trace(reqs)

    def warmup(self, reqs: list[QACRequest]):
        """Mint the (engine, bucket, k) dispatch callables the trace can
        form: class-pure sweeps at every pow2 batch size up to max_batch,
        drawn cyclically from the trace's own requests so the multi-term
        per-bucket list_pad specialization sees realistic term ids. Leaves
        the runtime's own caches untouched."""
        good = [r for r in reqs if not self._is_bad(r)]
        for rs in ([r for r in good if r.plen == 0],
                   [r for r in good if r.plen > 0]):
            if not rs:
                continue
            b = 1
            while b <= max(self.cfg.max_batch, 1):
                take = [rs[i % len(rs)] for i in range(b)]
                self.fe.complete(
                    np.stack([r.pids for r in take]),
                    np.asarray([r.plen for r in take], np.int32),
                    np.stack([r.suf for r in take]),
                    np.asarray([r.slen for r in take], np.int32),
                    k=np.asarray([r.k for r in take], np.int32))
                if b == self.cfg.max_batch:
                    break
                b = min(b * 2, self.cfg.max_batch)


def run_naive_trace(frontend: QACFrontend, reqs: list[QACRequest],
                    *, warm: bool = True):
    """One-request-per-dispatch baseline: every request runs individually
    through ``frontend.complete`` in arrival order under the same
    virtual-clock queueing model, with no micro-batching and no caches. It
    is uncached per-request QACFrontend serving, so its rows double as the
    parity reference for the runtime. Returns (rows, stats dict).

    ``warm`` first runs one dispatch per distinct (class, k, list_pad) the
    trace touches, so reported latencies measure serving, not first
    calls."""
    if warm:
        seen = set()
        for r in reqs:
            lp = (frontend._multi_list_pad(r.pids[None], np.asarray([r.plen]))
                  if r.plen > 0 else 0)
            sig = (r.plen > 0, r.k, lp)
            if sig in seen:
                continue
            seen.add(sig)
            frontend.complete(r.pids[None], np.asarray([r.plen], np.int32),
                              r.suf[None], np.asarray([r.slen], np.int32),
                              k=r.k)
    server_free = 0.0
    rows, lats = [], []
    for r in reqs:
        t0 = time.perf_counter()
        out = frontend.complete(
            r.pids[None], np.asarray([r.plen], np.int32), r.suf[None],
            np.asarray([r.slen], np.int32), k=r.k)
        dt_us = (time.perf_counter() - t0) * 1e6
        start = max(r.t_us, server_free)
        server_free = start + dt_us
        lats.append(server_free - r.t_us)
        rows.append(out[0, : r.k].copy())
    stats = {"n_requests": len(lats)}
    stats.update(percentiles(lats, (50, 99), mean=True))
    return rows, stats
