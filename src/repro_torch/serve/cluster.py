"""Multi-replica QAC serving cluster, as in the JAX package's
``serve/cluster.py``: the topology over ``serve/runtime.py``'s one replica.

  * **N replicas**: each a ``QACOnlineRuntime`` wrapping a ``QACFrontend``
    (full-index copies). Every replica owns a bounded queue feeding its
    micro-batch executor, the bound enforced at admission instead of
    blocking the producer.
  * **session-affinity dispatch**: rendezvous (highest-random-weight)
    hashing on the session id over the replicas the dispatcher believes
    alive. The session-cache tier pays off only if a session sticks to one
    replica; rendezvous hashing gives stickiness and minimal re-shuffling
    when the alive set changes (only the dead replica's sessions move).
  * **admission control**: per-request SLA classes and a queue-pressure
    estimator; the state machine is below.
  * **replica fault handling**: ``HeartbeatRegistry`` liveness + a
    ``FaultInjector``-driven drill mode (kill/stall windows on the virtual
    clock). The dispatcher detects the missed heartbeat, re-routes the dead
    replica's buffered and queued requests to the survivors (their session
    caches are lost; answers stay bit-identical to the uncached frontend,
    since caches are exact: where a request is served never changes what
    it answers), and re-admits the replica when it heartbeats again (a
    killed replica returns with cold caches; a stalled one keeps its
    state).

SLA classes and the degradation/shed state machine
--------------------------------------------------

Every request carries an SLA class: ``"interactive"`` (a human is typing;
the SLA applies) or ``"bulk"`` (batch rescoring, prefetchers, crawlers:
latency-tolerant, first to degrade). Admission happens at the dispatcher,
per request, from the target replica's *queue pressure*:

    est_wait_us = backlog + queue_depth * EWMA(per-request service time)

where backlog is how far the replica's virtual server clock is behind the
arrival and the EWMA comes from a ``runtime.fault.StepMonitor`` fed by the
runtime's ``on_dispatch`` hook. The decision ladder, in order:

    queue_depth >= max_queue               -> REJECT ("queue_full", any class)
    est >= shed_pressure_us                -> REJECT ("shed_overload", any)
    est >= shed_bulk_pressure_us and bulk  -> REJECT ("shed_bulk")
    est >= degrade_pressure_us             -> DEGRADE:
        bulk multi-term                    -> REJECT ("degrade_skip_multi")
                                              (the conjunctive engine is the
                                              expensive class; bulk traffic
                                              loses it first)
        otherwise                          -> serve at k' = min(k, degraded_k)
                                              (a smaller top-k bucket; the
                                              engines' prefix-stable top-k
                                              makes the k'-answer exactly the
                                              first k' rows of the full one)
    otherwise                              -> serve at full k

A rejected result is explicit (``ClusterResult.status == "rejected"`` with
the shed reason). Every served row remains bit-identical to
``frontend.complete`` at the k it was served with, so degradation never
trades away correctness, only result count.

Time model: as in ``serve/runtime.py``, a virtual microsecond clock for
arrivals and queueing, measured wall time for engine service. Each replica
has its own virtual server clock, so the latencies are those of N
independent servers; in this process one card serves their dispatches in
turn, each measured alone. Heartbeats piggyback on the event loop (every
arrival observes every replica), so detection latency is the heartbeat
timeout plus the gap to the next arrival. Before the ladder reads a
replica's queue, the replica fires the deadline dispatches due by the
arrival (``tick``), as a live replica would have; the JAX package's
cluster does not, so there a replica shedding with requests queued never
dispatches them and sheds everything until the trace ends.
"""
from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np

from ..obs.metrics import percentiles
from ..runtime.fault import (FaultInjector, HeartbeatRegistry, ReplicaFault,
                             StepMonitor)
from .frontend import QACFrontend
from .runtime import QACOnlineRuntime, QACRequest, RuntimeConfig

SERVED = "ok"
REJECTED = "rejected"

_M64 = (1 << 64) - 1


def _mix(a: int, b: int) -> int:
    """Deterministic 64-bit hash of (a, b), a splitmix64-style finalizer.

    Python's ``hash`` is salted for str/bytes and implementation-defined;
    routing must be stable across processes (a restarted dispatcher must
    route sessions the same way), so the mix is explicit.
    """
    x = ((a + 0x9E3779B97F4A7C15) * 0xBF58476D1CE4E5B9 + b) & _M64
    x ^= x >> 31
    x = (x * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 29)


def rendezvous_route(session: int, replicas) -> int | None:
    """Highest-random-weight hash: argmax over replicas of mix(session, r).

    Stickiness: a session routes to the same replica while the alive set
    is unchanged. Minimal disruption: removing a replica re-routes ONLY
    the sessions whose argmax it was; every other session keeps its
    replica (and therefore its warm session cache).
    """
    best, best_w = None, -1
    for rid in replicas:
        w = _mix(int(session), int(rid))
        if w > best_w:
            best, best_w = rid, w
    return best


def assign_sla(reqs, *, bulk_fraction: float = 0.25, seed: int = 0):
    """Deterministic per-session SLA classes: ``bulk_fraction`` of sessions
    (by hash, so the assignment is stable across runs and every request of
    a session shares its class) are ``"bulk"``, the rest ``"interactive"``.
    """
    if not 0.0 <= bulk_fraction <= 1.0:
        raise ValueError(f"bulk_fraction must be in [0, 1], "
                         f"got {bulk_fraction}")
    cut = int(bulk_fraction * (1 << 32))
    return ["bulk" if _mix(r.session, 0xB01D + seed) % (1 << 32) < cut
            else "interactive" for r in reqs]


@dataclasses.dataclass
class ClusterConfig:
    """Dispatcher + admission-control knobs. The pressure thresholds are
    estimated-wait budgets in microseconds and must be ordered
    ``degrade <= shed_bulk <= shed`` — the ladder in the module docstring.
    ``float("inf")`` thresholds disable that tier (the unbounded
    baseline)."""

    n_replicas: int = 2
    max_queue: int = 256                    # bounded per-replica queue
    degrade_pressure_us: float = 25_000.0   # -> smaller k, bulk loses multi
    shed_bulk_pressure_us: float = 50_000.0  # -> bulk rejected
    shed_pressure_us: float = 100_000.0     # -> everything rejected
    degraded_k: int = 4                     # k bucket served under degrade
    heartbeat_timeout_us: float = 200_000.0  # missed-beat death deadline

    def __post_init__(self):
        if self.n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, "
                             f"got {self.n_replicas}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.degraded_k < 1:
            raise ValueError(f"degraded_k must be >= 1, "
                             f"got {self.degraded_k}")
        if not self.degrade_pressure_us > 0:
            raise ValueError(f"degrade_pressure_us must be positive, "
                             f"got {self.degrade_pressure_us}")
        if not (self.degrade_pressure_us <= self.shed_bulk_pressure_us
                <= self.shed_pressure_us):
            raise ValueError(
                "pressure thresholds must be ordered degrade <= shed_bulk "
                f"<= shed, got {self.degrade_pressure_us} / "
                f"{self.shed_bulk_pressure_us} / {self.shed_pressure_us}")
        if not self.heartbeat_timeout_us > 0:
            raise ValueError(f"heartbeat_timeout_us must be positive, "
                             f"got {self.heartbeat_timeout_us}")


@dataclasses.dataclass
class ClusterResult:
    """One request's outcome. ``status == "ok"``: ``row`` is int32[k_served]
    (INF-padded), bit-identical to an uncached ``frontend.complete`` call at
    ``k_served``; degraded requests have ``k_served < k`` and the row is the
    first ``k_served`` entries of the full answer (prefix-stable top-k).
    ``status == "rejected"``: ``row`` is None and ``reason`` names the shed
    tier."""

    status: str
    row: np.ndarray | None
    k_served: int
    replica: int | None
    sla: str
    degraded: bool
    rerouted: bool
    reason: str = ""
    # the index generation whose frontend answered: the time-indexed parity
    # oracle replays each row against a build of exactly this generation
    gen: int = 0


class ClusterTelemetry:
    """Per-class latency + admission/fault counters; ``snapshot()`` -> dict.

    Latencies are measured from each request's original arrival to its
    virtual completion: a re-routed request pays its detection delay here,
    which is what ``failover_p99_us`` reports.
    """

    def __init__(self):
        self.lat_us: dict[str, list[float]] = {"interactive": [], "bulk": []}
        self.degraded_lat_us: list[float] = []
        self.shed: Counter = Counter()          # (sla, reason) -> count
        self.rerouted = 0
        self.failover_lat_us: list[float] = []
        self.per_replica: Counter = Counter()   # rid -> served count
        self.deaths: list[tuple[float, int]] = []
        self.readmissions: list[tuple[float, int]] = []
        # freshness: one (t_us, generation) entry per cluster-wide swap
        self.swaps: list[tuple[float, int]] = []

    @staticmethod
    def _pct(lat) -> dict:
        # the one percentile implementation (obs.metrics): an SLA class
        # that served nothing reports explicit None, never a fake 0us
        return percentiles(lat, mean=True)

    def snapshot(self) -> dict:
        served = sum(len(v) for v in self.lat_us.values())
        rejected = sum(self.shed.values())
        n = served + rejected
        out = {
            "n_requests": n,
            "served": served,
            "rejected": rejected,
            "shed_rate": rejected / max(n, 1),
            "degrade_rate": len(self.degraded_lat_us) / max(n, 1),
            "rerouted": self.rerouted,
            "shed": {f"{sla}:{reason}": c
                     for (sla, reason), c in sorted(self.shed.items())},
            "per_replica": dict(sorted(self.per_replica.items())),
            "deaths": list(self.deaths),
            "readmissions": list(self.readmissions),
            "swaps": list(self.swaps),
        }
        for cls, lat in self.lat_us.items():
            for key, v in self._pct(lat).items():
                out[f"{cls}_{key}"] = v
            out[f"{cls}_served"] = len(lat)
        for key, v in self._pct(self.failover_lat_us).items():
            out[f"failover_{key}"] = v
        return out


class _Replica:
    """One replica slot: its runtime, its service-time monitor, and the
    limbo buffer of requests sent to it while it was (undetectably) down."""

    def __init__(self, rid: int, runtime: QACOnlineRuntime):
        self.rid = rid
        self.runtime = runtime
        self.limbo: list[tuple[QACRequest, str, float]] = []  # (r, sla, t0)
        self.seen_fault: ReplicaFault | None = None
        self._n_dispatch = 0
        self.fresh_monitor()
        runtime.on_dispatch = self._on_dispatch

    def fresh_monitor(self):
        # responsive EWMA: overload onset must move the estimate within a
        # few dispatches, not a few hundred
        self.monitor = StepMonitor(alpha=0.3, warmup=0)

    def _on_dispatch(self, batch_size: int, wall_us: float, t_start: float):
        self._n_dispatch += 1
        self.monitor.record(self._n_dispatch, wall_us / max(batch_size, 1))

    def est_wait_us(self, now: float) -> float:
        """The admission pressure estimate: how long a request admitted at
        ``now`` would wait before service begins."""
        per_req = self.monitor.mean or 0.0
        backlog = max(0.0, self.runtime._server_free - now)
        return backlog + len(self.runtime.queue) * per_req

    def depth(self) -> int:
        return len(self.runtime.queue) + len(self.limbo)


class QACServingCluster:
    """N ``QACOnlineRuntime`` replicas behind a session-affinity dispatcher
    with SLA-class admission control and heartbeat-driven failover (module
    docstring has the full state machine).

    ``frontends`` may be supplied explicitly: one per replica for the
    production shape, or the same warm instance repeated to share its
    callable cache and host mirrors (``complete`` is a pure function, so
    sharing never changes results). The replicas run on the device of the
    frontends' index.
    ``injector`` carries the drill schedule (``ReplicaFault`` windows);
    the default injector has none, i.e. a healthy cluster.
    """

    def __init__(self, qidx=None, cfg: ClusterConfig | None = None,
                 rt_cfg: RuntimeConfig | None = None, *,
                 frontends: list[QACFrontend] | None = None,
                 injector: FaultInjector | None = None,
                 frontend_kwargs: dict | None = None,
                 tracer=None, registry=None):
        self.cfg = cfg if cfg is not None else ClusterConfig()
        self.rt_cfg = rt_cfg if rt_cfg is not None else RuntimeConfig()
        # observability: the tracer is shared with every replica runtime
        # (reset() threads it through); admission/fault/swap decision
        # points emit instants. None = no overhead.
        self.tracer = tracer
        if registry is not None:
            registry.register_collector("cluster",
                                        lambda: self.telemetry.snapshot())
        self.injector = injector if injector is not None else FaultInjector([])
        if frontends is None:
            if qidx is None:
                raise ValueError("provide qidx or explicit frontends")
            kw = dict(specialize_list_pad=False)   # a closed set of callables
            kw.update(frontend_kwargs or {})
            frontends = [QACFrontend(qidx, **kw)
                         for _ in range(self.cfg.n_replicas)]
        if len(frontends) != self.cfg.n_replicas:
            raise ValueError(f"{len(frontends)} frontends for "
                             f"{self.cfg.n_replicas} replicas")
        self.frontends = frontends
        self.qidx = qidx if qidx is not None else frontends[0].qidx
        # index capacity: a request can never return more than every
        # completion; catch the misconfiguration here with a nameable
        # error instead of deep inside an engine dispatch
        self.capacity = int(self.qidx.completions.n)
        if self.cfg.degraded_k > self.capacity:
            raise ValueError(
                f"degraded_k={self.cfg.degraded_k} exceeds index capacity "
                f"({self.capacity} completions)")
        for f in self.injector.replica_faults:
            if not 0 <= f.replica < self.cfg.n_replicas:
                raise ValueError(f"fault targets replica {f.replica} of "
                                 f"{self.cfg.n_replicas}")
        self.reset()

    def reset(self):
        """Fresh cluster state (queues, caches, liveness, telemetry); the
        frontends' warm callable caches survive."""
        self.replicas = [
            _Replica(i, QACOnlineRuntime(fe, self.rt_cfg,
                                         tracer=self.tracer))
            for i, fe in enumerate(self.frontends)]
        self._now = 0.0
        self.registry = HeartbeatRegistry(
            timeout_s=self.cfg.heartbeat_timeout_us,
            clock=lambda: self._now)
        for rep in self.replicas:
            self.registry.beat(rep.rid)
        self.dead: set[int] = set()
        self.telemetry = ClusterTelemetry()
        self._results: dict[int, ClusterResult] = {}
        # idx -> admission record (replica, sla, degraded, rerouted,
        # orig_t, orig_k); rewritten if the request is re-routed
        self._meta: dict[int, dict] = {}

    # -- liveness -------------------------------------------------------------
    def _observe(self, now: float):
        """One heartbeat/detection pass over every replica at virtual time
        ``now``: beat the live ones, detect deaths past the timeout (and
        fail their orphans over), re-admit recoveries."""
        for rep in self.replicas:
            rid = rep.rid
            fault = self.injector.down(rid, now)
            if fault is not None:
                rep.seen_fault = fault
                if fault.kind == "stall":
                    # a stalled server is busy-equivalent until recovery:
                    # nothing it has queued may dispatch inside the window,
                    # and the pressure estimator sees the backlog
                    rep.runtime._server_free = max(
                        rep.runtime._server_free, fault.t_up_us)
                if rid not in self.dead:
                    last = self.registry.last.get(rid, 0.0)
                    if now - last > self.cfg.heartbeat_timeout_us:
                        self.dead.add(rid)
                        self.telemetry.deaths.append((now, rid))
                        if self.tracer is not None:
                            self.tracer.instant(
                                "replica.death", now, cat="cluster",
                                replica=rid, kind=fault.kind)
                        self._failover(rep, now)
                continue
            self.registry.beat(rid)
            if rep.seen_fault is None:
                continue
            # recovery: the replica heartbeats again
            pending = list(rep.limbo)
            rep.limbo = []
            if rep.seen_fault.kind == "kill":
                # the restarted process lost queue AND caches; whatever it
                # had queued must be retried, served results survive (they
                # were answered before the kill)
                pending += self._drain_queue(rep)
                self._harvest(rep)
                rep.runtime.reset()
                rep.runtime.on_dispatch = rep._on_dispatch
                rep.fresh_monitor()
            rep.seen_fault = None
            if rid in self.dead:
                self.dead.discard(rid)
                self.telemetry.readmissions.append((now, rid))
                if self.tracer is not None:
                    self.tracer.instant("replica.readmit", now,
                                        cat="cluster", replica=rid)
            for (q, sla, orig_t) in pending:
                # re-admitted to the SAME replica (recovered before any
                # re-route happened) — delayed, not rerouted
                self._admit(rep, q, sla, now=now, orig_t=orig_t,
                            rerouted=False)

    def _drain_queue(self, rep: _Replica):
        """Pull every unserved request out of a replica's runtime queue,
        restoring each one's pre-degradation k from the admission record."""
        out = []
        while rep.runtime.queue:
            q = rep.runtime.queue.popleft()
            meta = self._meta[q.idx]
            if q.k != meta["orig_k"]:
                q = dataclasses.replace(q, k=meta["orig_k"])
            out.append((q, meta["sla"], meta["orig_t"]))
        return out

    def _failover(self, rep: _Replica, now: float):
        """A detected death: re-route the dead replica's limbo + queued
        requests to the surviving replicas (fresh rendezvous, which only
        moves the dead replica's sessions)."""
        pending = list(rep.limbo) + self._drain_queue(rep)
        rep.limbo = []
        for (q, sla, orig_t) in pending:
            target = self._route(q.session)
            if target is None:
                self._reject(q, sla, "no_replica", rerouted=True)
                continue
            self._deliver(self.replicas[target], q, sla, now=now,
                          orig_t=orig_t, rerouted=True)

    # -- dispatch -------------------------------------------------------------
    def _route(self, session: int) -> int | None:
        alive = [rep.rid for rep in self.replicas if rep.rid not in self.dead]
        return rendezvous_route(session, alive)

    def submit(self, r: QACRequest, sla: str = "interactive"):
        """One arriving request: heartbeat pass, session-affinity route,
        admission ladder, then either the replica's runtime or an explicit
        REJECTED result. Call in arrival-time order."""
        if sla not in ("interactive", "bulk"):
            raise ValueError(f"unknown SLA class {sla!r}")
        self._now = max(self._now, r.t_us)
        self._observe(self._now)
        rid = self._route(r.session)
        if rid is None:
            self._reject(r, sla, "no_replica", rerouted=False)
            return
        self._deliver(self.replicas[rid], r, sla, now=self._now,
                      orig_t=r.t_us, rerouted=False)

    def _deliver(self, rep: _Replica, r: QACRequest, sla: str, *,
                 now: float, orig_t: float, rerouted: bool):
        """Hand a routed request to its replica. If the replica is inside
        a not-yet-detected fault window the request is delivered into the
        void (kill) or a frozen accept queue (stall) and sits in limbo
        until detection or recovery; the queue bound still applies —
        back-pressure does not need a live heartbeat."""
        if self.injector.down(rep.rid, now) is not None:
            if rep.depth() >= self.cfg.max_queue:
                self._reject(r, sla, "queue_full", rerouted)
            else:
                rep.limbo.append((r, sla, orig_t))
            return
        self._admit(rep, r, sla, now=now, orig_t=orig_t, rerouted=rerouted)

    def _admit(self, rep: _Replica, r: QACRequest, sla: str, *, now: float,
               orig_t: float, rerouted: bool):
        """The admission ladder (module docstring): full service ->
        degraded service -> explicit shed."""
        cfg = self.cfg
        # the replica's clock first: its deadline dispatches due by now fire
        # before the estimate reads its queue, as a live replica's would.
        # The JAX package's cluster skips this: a replica whose estimate
        # passes shed_pressure_us with requests queued then sheds every
        # later request, and its queue waits for the end of the trace.
        rep.runtime.tick(now)
        if rep.depth() >= cfg.max_queue:
            self._reject(r, sla, "queue_full", rerouted)
            return
        est = rep.est_wait_us(now)
        if est >= cfg.shed_pressure_us:
            self._reject(r, sla, "shed_overload", rerouted)
            return
        if sla == "bulk" and est >= cfg.shed_bulk_pressure_us:
            self._reject(r, sla, "shed_bulk", rerouted)
            return
        degraded = bool(est >= cfg.degrade_pressure_us)
        if degraded and sla == "bulk" and r.plen > 0:
            # degrade tier: bulk traffic loses the conjunctive engine
            self._reject(r, sla, "degrade_skip_multi", rerouted)
            return
        k = min(r.k, cfg.degraded_k) if degraded else r.k
        tr = self.tracer
        if tr is not None and tr.want(r.idx):
            tr.instant("admission", now, cat="cluster", req=r.idx,
                       decision="degrade" if degraded else "admit_full",
                       est_wait_us=est, replica=rep.rid, sla=sla,
                       k_served=k, rerouted=rerouted)
        self._meta[r.idx] = dict(replica=rep.rid, sla=sla, degraded=degraded,
                                 rerouted=rerouted, orig_t=orig_t,
                                 orig_k=r.k)
        if k != r.k or now != r.t_us:
            r = dataclasses.replace(r, t_us=now, k=k, deadline=0.0)
        rep.runtime.submit(r)

    def _reject(self, r: QACRequest, sla: str, reason: str, rerouted: bool):
        tr = self.tracer
        if tr is not None and tr.want(r.idx):
            tr.instant("admission", self._now, cat="cluster", req=r.idx,
                       decision="shed", reason=reason, sla=sla,
                       rerouted=rerouted)
        self.telemetry.shed[(sla, reason)] += 1
        if rerouted:
            self.telemetry.rerouted += 1
        self._results[r.idx] = ClusterResult(
            status=REJECTED, row=None, k_served=0, replica=None, sla=sla,
            degraded=False, rerouted=rerouted, reason=reason)

    # -- results --------------------------------------------------------------
    def _harvest(self, rep: _Replica):
        """Move the replica runtime's finished rows into cluster results,
        measuring latency from each request's ORIGINAL arrival."""
        rt = rep.runtime
        for idx, row in rt._results.items():
            meta = self._meta[idx]
            lat = rt.done_t_us[idx] - meta["orig_t"]
            self.telemetry.lat_us[meta["sla"]].append(lat)
            self.telemetry.per_replica[rep.rid] += 1
            if meta["degraded"]:
                self.telemetry.degraded_lat_us.append(lat)
            if meta["rerouted"]:
                self.telemetry.rerouted += 1
                self.telemetry.failover_lat_us.append(lat)
            self._results[idx] = ClusterResult(
                status=SERVED, row=row, k_served=int(row.shape[0]),
                replica=rep.rid, sla=meta["sla"], degraded=meta["degraded"],
                rerouted=meta["rerouted"],
                gen=rt.done_gen.get(idx, rt.generation))
        rt._results.clear()
        rt.done_t_us.clear()
        rt.done_path.clear()
        rt.done_gen.clear()

    def propagate_swap(self, generation: int,
                       frontends: list[QACFrontend], *, t_us: float = 0.0):
        """Cluster-wide generation swap: for every replica, flush its
        runtime queue (queued requests were admitted against the old
        generation and must be answered by it), harvest the finished rows
        with their old-generation tag, then install the new frontend —
        which invalidates both cache tiers exactly once per replica.
        ``frontends`` follows the constructor's contract (one per replica,
        or a shared warm instance repeated)."""
        if len(frontends) != self.cfg.n_replicas:
            raise ValueError(f"{len(frontends)} frontends for "
                             f"{self.cfg.n_replicas} replicas")
        self._now = max(self._now, t_us)
        for rep, fe in zip(self.replicas, frontends):
            if self.injector.down(rep.rid, self._now) is None:
                rep.runtime.drain()
            else:
                # a down replica cannot serve its old-generation queue; park
                # the requests in limbo (recovery/failover re-admits them
                # against whatever generation then serves, with original k)
                rep.limbo.extend(self._drain_queue(rep))
            self._harvest(rep)
            rep.runtime.install_generation(generation, fe)
        # reset() builds replicas from self.frontends — keep it current so
        # a post-swap reset restarts on the NEW generation
        self.frontends = list(frontends)
        self.telemetry.swaps.append((self._now, generation))
        if self.tracer is not None:
            self.tracer.instant("generation.swap", self._now, cat="cluster",
                                generation=generation)

    def drain(self):
        """End of trace: advance past the heartbeat timeout so any
        still-down replica is detected and its orphans re-route, flush
        every live queue, harvest everything."""
        self._now += self.cfg.heartbeat_timeout_us + 1.0
        self._observe(self._now)
        for rep in self.replicas:
            if self.injector.down(rep.rid, self._now) is None:
                rep.runtime.drain()
            self._harvest(rep)

    # -- drivers --------------------------------------------------------------
    def run_trace(self, reqs: list[QACRequest], sla=None):
        """Replay a timestamped request list -> list[ClusterResult] in
        trace order. ``sla`` is None (all interactive), one class name, or
        a per-request sequence."""
        sla = self._sla_list(reqs, sla)
        kmax = max((r.k for r in reqs), default=0)
        if kmax > self.capacity:
            raise ValueError(f"requested k={kmax} exceeds index capacity "
                             f"({self.capacity} completions)")
        last = -np.inf
        for r, s in zip(reqs, sla):
            if r.t_us < last:
                raise ValueError("trace must be sorted by arrival time")
            last = r.t_us
            self.submit(r, s)
        self.drain()
        missing = [r.idx for r in reqs if r.idx not in self._results]
        assert not missing, f"requests lost by the cluster: {missing[:5]}"
        return [self._results[r.idx] for r in reqs]

    def replay(self, reqs: list[QACRequest], sla=None, *, warm: bool = True):
        """The measured-replay protocol (same shape as the runtime's): one
        full warm pass mints every callable the trace + drill can form,
        then a reset and a measured pass."""
        if warm:
            self.run_trace(reqs, sla)
            self.reset()
        return self.run_trace(reqs, sla)

    @staticmethod
    def _sla_list(reqs, sla) -> list[str]:
        if sla is None:
            return ["interactive"] * len(reqs)
        if isinstance(sla, str):
            return [sla] * len(reqs)
        sla = list(sla)
        if len(sla) != len(reqs):
            raise ValueError(f"{len(sla)} SLA classes for "
                             f"{len(reqs)} requests")
        return sla


def check_cluster_parity_timed(frontends_by_gen: dict,
                               reqs: list[QACRequest],
                               results: list[ClusterResult]) -> int:
    """The time-indexed parity oracle: every served result row
    must be bit-identical to the uncached frontend of the generation that
    ANSWERED it (``ClusterResult.gen``), truncated to its served k — the
    first ``k_served`` entries of that generation's full-k answer, by
    prefix-stable top-k. Returns the number of rows checked.

    ``frontends_by_gen`` maps generation id -> a ``QACFrontend`` over a
    from-scratch build of that generation's corpus. A request that crossed
    a swap (admitted under gen g, answered under g+1 — e.g. re-routed out
    of a dead replica) is checked against the generation that actually
    produced its docids; an unknown generation in the results is a hard
    failure, not a skip.
    """
    checked = 0
    for r, res in zip(reqs, results):
        if res.status != SERVED:
            continue
        if res.gen not in frontends_by_gen:
            raise AssertionError(
                f"request {r.idx} answered by unknown generation {res.gen} "
                f"(oracle has {sorted(frontends_by_gen)})")
        fe = frontends_by_gen[res.gen]
        want = fe.complete(
            r.pids[None], np.asarray([r.plen], np.int32), r.suf[None],
            np.asarray([r.slen], np.int32), k=r.k)[0]
        np.testing.assert_array_equal(
            res.row, want[: res.k_served],
            err_msg=(f"cluster parity break at request {r.idx} "
                     f"({r.query!r}, k_served={res.k_served}, "
                     f"replica={res.replica}, rerouted={res.rerouted}, "
                     f"gen={res.gen})"))
        checked += 1
    return checked


def check_cluster_parity(frontend: QACFrontend, reqs: list[QACRequest],
                         results: list[ClusterResult]) -> int:
    """Assert the fault-drill correctness gate: every served (non-REJECTED)
    result row is bit-identical to the uncached frontend oracle at its
    served k. The single-generation view of ``check_cluster_parity_timed``
    (one code path): every generation the results mention maps to the one
    frontend, which is exact whenever the cluster never swapped.

    ``run_naive_trace`` rows work as the oracle too; this helper exists so
    every caller asserts the same contract through one code path.
    """
    gens = {res.gen for res in results if res.status == SERVED}
    return check_cluster_parity_timed({g: frontend for g in gens or {0}},
                                      reqs, results)
