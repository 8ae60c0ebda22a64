"""The port's serving cluster (``serve/cluster.py``) against the JAX package:
routing and SLA assignment over 10,000 sessions, every served row of a
healthy cluster and of kill and stall drills bit-identical to JAX's
uncached ``QACFrontend.complete`` at the row's served k, the admission
ladder's decisions on forced-pressure traces equal to JAX's cluster (on a
trace whose time moves between arrivals, to JAX's cluster with the one
change the port makes: the replica advanced to the arrival first), and
the construction-time validation."""
import dataclasses

import numpy as np
import pytest

import repro.serve.runtime as jax_runtime_mod
import repro_torch.serve.runtime as runtime_mod
from _torch_clock import fix_clocks
from repro.core import build_qac_index as jax_build
from repro.serve import QACFrontend as JaxFrontend
from repro.serve.cluster import (ClusterConfig as JaxClusterConfig,
                                 ClusterTelemetry as JaxClusterTelemetry,
                                 QACServingCluster as JaxCluster,
                                 assign_sla as jax_assign_sla,
                                 rendezvous_route as jax_route)
from repro.serve.runtime import RuntimeConfig as JaxRuntimeConfig
from repro_torch.core import build_qac_index
from repro_torch.runtime.fault import FaultInjector, ReplicaFault
from repro_torch.serve import QACFrontend
from repro_torch.serve.cluster import (ClusterConfig, ClusterTelemetry,
                                       QACServingCluster, assign_sla,
                                       check_cluster_parity, rendezvous_route)
from repro_torch.serve.runtime import QACOnlineRuntime, RuntimeConfig, prepare_requests
from repro_torch.text import (KeystrokeTraceConfig, SynthLogConfig,
                              generate_keystroke_trace, generate_query_log)

from _torch_pairs import RowOracle, as_jax_requests

RT = dict(max_batch=8, slack_us=2000.0)
# the parity and drill tests disable the pressure ladder (wall-clock service
# times are arbitrary); the ladder tests seed the EWMA and never read a clock
RELAXED = dict(degrade_pressure_us=1e12, shed_bulk_pressure_us=1e12, shed_pressure_us=1e12)
LADDER = dict(n_replicas=1, degrade_pressure_us=1_500.0, shed_bulk_pressure_us=2_500.0,
              shed_pressure_us=3_500.0, degraded_k=2)


@pytest.fixture(scope="module")
def built():
    qs, sc = generate_query_log(SynthLogConfig(n_queries=500, vocab_size=140,
                                               mean_term_chars=4.0, seed=7))
    jq, _, _ = jax_build(qs, sc)
    tq, kept, _ = build_qac_index(qs, sc, device="cpu")
    fe = QACFrontend(tq, k=10, specialize_list_pad=False)
    jfe = JaxFrontend(jq, k=10, use_kernel=False, specialize_list_pad=False)
    trace = generate_keystroke_trace(kept, KeystrokeTraceConfig(
        n_sessions=10, mean_keystroke_ms=5.0, session_spread_ms=20.0, seed=11))
    reqs = prepare_requests(tq, trace, k=10)
    return dict(jq=jq, tq=tq, kept=kept, fe=fe, jfe=jfe, trace=trace, reqs=reqs,
                jreqs=as_jax_requests(reqs),
                oracle=RowOracle(jfe, batch=8))


def _served_rows_equal_jax(built, reqs, res):
    """Every served row equals JAX's uncached answer cut to its served k;
    returns how many were checked."""
    want = built["oracle"](reqs)
    n = 0
    for r, got, w in zip(reqs, res, want):
        if got.status != "ok":
            continue
        assert got.row.dtype == np.int32 and got.row.shape == (got.k_served,)
        np.testing.assert_array_equal(got.row, w[: got.k_served], err_msg=r.query)
        n += 1
    return n


def _cluster(built, cfg, injector=None, rt=None):
    return QACServingCluster(built["tq"], cfg, RuntimeConfig(**(rt or RT)),
                             frontends=[built["fe"]] * cfg.n_replicas, injector=injector)


def _jax_cluster(built, cfg, injector=None, rt=None):
    return JaxCluster(built["jq"], cfg, JaxRuntimeConfig(**(rt or RT)),
                      frontends=[built["jfe"]] * cfg.n_replicas, injector=injector)


class _TickingJaxCluster(JaxCluster):
    """JAX's cluster with the port's one change to it: the replica's clock
    advances to the arrival (its due deadline dispatches fire) before the
    admission ladder reads the replica."""

    def _admit(self, rep, r, sla, *, now, orig_t, rerouted):
        rep.runtime.tick(now)
        super()._admit(rep, r, sla, now=now, orig_t=orig_t, rerouted=rerouted)


class _R:
    def __init__(self, session):
        self.session = session


@pytest.mark.parametrize("alive", [[0, 1, 2, 3], [0, 1, 3], [2], [], list(range(9))])
def test_rendezvous_route_equals_jax(alive):
    sessions = np.random.default_rng(0).integers(0, 2**40, 10_000).tolist() + list(range(100))
    got = [rendezvous_route(s, alive) for s in sessions]
    assert got == [jax_route(s, alive) for s in sessions]
    if len(alive) > 1:
        assert set(got) == set(alive)
        gone = alive[1:]                    # only replica alive[0]'s sessions move
        assert all(rendezvous_route(s, gone) == g for s, g in zip(sessions, got)
                   if g != alive[0])


@pytest.mark.parametrize("bulk_fraction,seed", [(0.25, 0), (0.5, 3), (0.0, 0), (1.0, 1)])
def test_assign_sla_equals_jax(bulk_fraction, seed):
    reqs = [_R(s) for s in np.random.default_rng(1).integers(0, 10_000, 10_000).tolist()]
    got = assign_sla(reqs, bulk_fraction=bulk_fraction, seed=seed)
    assert got == jax_assign_sla(reqs, bulk_fraction=bulk_fraction, seed=seed)
    by_sess = {}
    assert all(by_sess.setdefault(r.session, s) == s for r, s in zip(reqs, got))
    with pytest.raises(ValueError):
        assign_sla(reqs, bulk_fraction=1.5)


def test_healthy_cluster_rows_and_affinity(built):
    reqs = built["reqs"]
    cl = _cluster(built, ClusterConfig(n_replicas=2, **RELAXED))
    res = cl.replay(reqs, assign_sla(reqs, bulk_fraction=0.4))
    assert all(r.status == "ok" for r in res)
    assert _served_rows_equal_jax(built, reqs, res) == len(reqs)
    assert check_cluster_parity(built["fe"], reqs[:20], res[:20]) == 20
    by_sess = {}
    assert all(by_sess.setdefault(q.session, r.replica) == r.replica
               for q, r in zip(reqs, res))
    assert len(cl.telemetry.per_replica) == 2


@pytest.mark.parametrize("drill", ["kill", "kill_recover", "stall"])
def test_fault_drill_rows_equal_jax(built, drill):
    reqs = built["reqs"]
    t0 = reqs[len(reqs) // 2].t_us
    fault = {"kill": ReplicaFault(0, t0),
             "kill_recover": ReplicaFault(0, reqs[len(reqs) // 3].t_us,
                                          reqs[len(reqs) // 3].t_us + 60_000.0),
             "stall": ReplicaFault(0, t0, t0 + 100_000.0, kind="stall")}[drill]
    cfg = ClusterConfig(n_replicas=2, heartbeat_timeout_us=50_000.0, **RELAXED)
    cl = _cluster(built, cfg, injector=FaultInjector([], replica_faults=[fault]))
    res = cl.replay(reqs)
    snap = cl.telemetry.snapshot()
    assert len(res) == len(reqs) and all(r.status == "ok" for r in res)
    assert _served_rows_equal_jax(built, reqs, res) == len(reqs)
    if drill.startswith("kill"):
        assert snap["deaths"] and snap["deaths"][0][1] == 0 and snap["rerouted"] > 0
    if drill == "kill":
        assert all(r.replica == 1 for q, r in zip(reqs, res) if q.t_us > t0)
        assert snap["failover_p99_us"] > 0
    if drill == "kill_recover":
        t_re = snap["readmissions"][0][0]
        assert any(r.replica == 0 for q, r in zip(reqs, res) if q.t_us > t_re)


def _ladder_reqs(built, n):
    uniq = sorted({q.split()[0] for q in built["kept"]})
    return prepare_requests(built["tq"], [(0.0, s, uniq[s]) for s in range(n)], k=10)


@pytest.mark.parametrize("case", ["interactive", "bulk", "skip_multi_bulk",
                                  "skip_multi_interactive", "queue_full"])
def test_admission_ladder_equals_jax(built, case):
    """Same-instant arrivals against a seeded EWMA (1 ms a queued request),
    nothing dispatching until the drain: each rung of the ladder, decided
    by the port's cluster and by JAX's on the same requests."""
    held = dict(max_batch=64, slack_us=1e9)
    if case == "queue_full":
        cfgs = [C(n_replicas=1, max_queue=3, **RELAXED) for C in (ClusterConfig, JaxClusterConfig)]
    elif case.startswith("skip_multi"):
        cfgs = [C(n_replicas=1, degrade_pressure_us=500.0, shed_bulk_pressure_us=1e9,
                  shed_pressure_us=1e9, degraded_k=2) for C in (ClusterConfig, JaxClusterConfig)]
    else:
        cfgs = [ClusterConfig(**LADDER), JaxClusterConfig(**LADDER)]
    if case.startswith("skip_multi"):
        words = next(q for q in built["kept"] if len(q.split()) >= 2).split()
        reqs = prepare_requests(built["tq"], [(0.0, 0, built["kept"][0].split()[0]),
                                              (0.0, 1, words[0] + " " + words[1][:1])], k=10)
        sla = ["interactive", case.rsplit("_", 1)[1]]
    else:
        reqs = _ladder_reqs(built, 6)
        sla = "bulk" if case == "bulk" else None
    outs = []
    for make, cfg, reqs_of in ((_cluster, cfgs[0], reqs),
                               (_jax_cluster, cfgs[1], as_jax_requests(reqs))):
        cl = make(built, cfg, rt=held)
        cl.replicas[0].monitor.record(1, 1_000.0)
        outs.append((cl.run_trace(reqs_of, sla), cl.telemetry.snapshot()))
    (res, snap), (jres, jsnap) = outs
    assert [(r.status, r.reason, r.degraded, r.k_served, r.replica, r.sla, r.rerouted)
            for r in res] == [(r.status, r.reason, r.degraded, r.k_served, r.replica,
                               r.sla, r.rerouted) for r in jres]
    for r, j in zip(res, jres):
        if r.status == "ok":
            np.testing.assert_array_equal(r.row, np.asarray(j.row))
    for key in ("n_requests", "served", "rejected", "shed_rate", "degrade_rate", "shed",
                "per_replica", "rerouted"):
        assert snap[key] == jsnap[key], key
    assert {"interactive": [4, 2], "bulk": [3, 3], "skip_multi_bulk": [1, 1],
            "skip_multi_interactive": [2, 0], "queue_full": [3, 3]}[case] == [
        snap["served"], snap["rejected"]]
    _served_rows_equal_jax(built, reqs, res)


@pytest.mark.parametrize("n_replicas", [1, 2])
def test_admission_ladder_over_time_equals_ticking_jax(built, monkeypatch, n_replicas):
    """The keystroke trace (arrivals over ~200 ms) against replicas whose
    every dispatch and cache hit takes 2**-9 s (~1.95 ms): the replicas
    fall behind, dispatch on deadlines between arrivals, and every rung of
    the ladder fires. The port's decisions, served rows and telemetry
    equal those of JAX's cluster once it too advances the replica before
    admission; JAX's cluster as it stands decides otherwise."""
    reqs, step = built["reqs"], 2.0 ** -9
    sla = assign_sla(reqs, bulk_fraction=0.4)
    cfg = dict(LADDER, n_replicas=n_replicas)
    runs = []
    for make, reqs_of in ((lambda: _cluster(built, ClusterConfig(**cfg)), reqs),
                          (lambda: _TickingJaxCluster(
                              built["jq"], JaxClusterConfig(**cfg), JaxRuntimeConfig(**RT),
                              frontends=[built["jfe"]] * n_replicas), built["jreqs"]),
                          (lambda: _jax_cluster(built, JaxClusterConfig(**cfg)),
                           built["jreqs"])):
        fix_clocks(monkeypatch, runtime_mod, jax_runtime_mod, step_s=step)
        cl = make()
        res = cl.run_trace(reqs_of, sla)
        runs.append((res, cl.telemetry.snapshot()))
    (res, snap), (tres, tsnap), (jres, _) = runs
    decide = lambda rs: [(r.status, r.reason, r.degraded, r.k_served, r.replica, r.sla,
                          r.rerouted) for r in rs]
    assert decide(res) == decide(tres)
    assert decide(res) != decide(jres)
    for r, t in zip(res, tres):
        if r.status == "ok":
            np.testing.assert_array_equal(r.row, np.asarray(t.row))
    for key in ("n_requests", "served", "rejected", "shed_rate", "degrade_rate", "shed",
                "per_replica", "interactive_p99_us", "bulk_p99_us"):
        assert snap[key] == tsnap[key], key
    rungs = {r.reason or ("degraded" if r.degraded else "full") for r in res}
    assert rungs == {"full", "degraded", "degrade_skip_multi", "shed_bulk", "shed_overload"}
    assert _served_rows_equal_jax(built, reqs, res) == snap["served"]


def test_cluster_config_validation():
    for kw in (dict(n_replicas=0), dict(max_queue=0), dict(degraded_k=0),
               dict(degrade_pressure_us=0.0),
               dict(degrade_pressure_us=5.0, shed_bulk_pressure_us=4.0),
               dict(shed_bulk_pressure_us=200_000.0, shed_pressure_us=100_000.0),
               dict(heartbeat_timeout_us=0.0)):
        with pytest.raises(ValueError):
            JaxClusterConfig(**kw)
        with pytest.raises(ValueError):
            ClusterConfig(**kw)
    assert dataclasses.asdict(ClusterConfig()) == dataclasses.asdict(JaxClusterConfig())


def test_qac_arch_equals_jax_and_builds_its_frontend(built):
    """``qac-ebay``'s widths, routes and serving knobs equal JAX's;
    ``frontend`` builds the serving frontend on the arch's routes, so a
    codec the arch names and the index lacks is refused."""
    from repro.configs import get_arch as jax_get_arch
    from repro_torch.configs import get_arch
    from repro_torch.obs import JitAuditor

    arch, jarch = get_arch("qac-ebay"), jax_get_arch("qac-ebay")
    for f in dataclasses.fields(arch):
        assert getattr(arch, f.name) == getattr(jarch, f.name), f.name
    assert dataclasses.asdict(arch.runtime_config()) == dataclasses.asdict(
        jarch.runtime_config())
    for n in (None, 2):
        assert dataclasses.asdict(arch.cluster_config(n)) == dataclasses.asdict(
            jarch.cluster_config(n))
    aud = JitAuditor()
    fe = arch.frontend(built["tq"], auditor=aud)
    assert (fe.k, fe.specialize_list_pad, fe.use_kernel, fe.heap_kernel,
            fe.postings_codec, fe.auditor) == (10, False, False, None, "auto", aud)
    reqs = built["reqs"][:40]
    want = built["oracle"](reqs)
    got = QACOnlineRuntime(fe, RuntimeConfig(**RT)).run_trace(reqs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert dataclasses.replace(arch, postings_codec="ef").frontend(built["tq"])._explicit_packed
    with pytest.raises(ValueError):
        dataclasses.replace(arch, postings_codec="bitpack").frontend(built["tq"])


def test_runtime_config_validation():
    for kw in (dict(max_batch=0), dict(slack_us=-1.0), dict(cache_entries=-1),
               dict(session_entries=-1)):
        with pytest.raises(ValueError):
            RuntimeConfig(**kw)
    assert dataclasses.asdict(RuntimeConfig(slack_us=0.0)) == dataclasses.asdict(
        JaxRuntimeConfig(slack_us=0.0))


def test_cluster_capacity_validation(built):
    tq, fe, reqs = built["tq"], built["fe"], built["reqs"]
    cap = int(tq.completions.n)
    with pytest.raises(ValueError):                 # degraded_k beyond the corpus
        QACServingCluster(tq, ClusterConfig(degraded_k=cap + 1), frontends=[fe, fe])
    with pytest.raises(ValueError):                 # a fault aimed at no replica
        QACServingCluster(tq, ClusterConfig(n_replicas=2), frontends=[fe, fe],
                          injector=FaultInjector([], replica_faults=[ReplicaFault(7, 0.0)]))
    with pytest.raises(ValueError):                 # the wrong frontend count
        QACServingCluster(tq, ClusterConfig(n_replicas=3), frontends=[fe, fe])
    with pytest.raises(ValueError):
        QACServingCluster(None, ClusterConfig())
    cl = QACServingCluster(tq, ClusterConfig(n_replicas=2), frontends=[fe, fe])
    with pytest.raises(ValueError):                 # k beyond the index's capacity
        cl.run_trace([dataclasses.replace(r, k=cap + 1) for r in reqs[:3]])
    with pytest.raises(ValueError):
        cl.submit(reqs[0], sla="premium")
    with pytest.raises(ValueError):
        cl.run_trace(reqs[:3], ["interactive"])
    with pytest.raises(ValueError):
        cl.run_trace(reqs[:3][::-1])
    built_fe = QACServingCluster(tq, ClusterConfig(n_replicas=2)).frontends
    assert len(built_fe) == 2 and not any(f.specialize_list_pad for f in built_fe)


def test_cluster_telemetry_equals_jax():
    got, want = ClusterTelemetry(), JaxClusterTelemetry()
    assert got.snapshot() == want.snapshot()        # empty classes: explicit None
    lats = [float(x) for x in [10, 20, 30, 1000, 55, 7, 7, 90, 300, 42]]
    for t in (got, want):
        t.lat_us["interactive"] = list(lats)
        t.lat_us["bulk"] = lats[:3]
        t.degraded_lat_us = lats[:2]
        t.failover_lat_us = lats[5:]
        t.shed[("bulk", "shed_bulk")] += 3
        t.rerouted, t.per_replica[1] = 2, 7
        t.deaths.append((5.0, 1))
    snap = got.snapshot()
    assert snap == want.snapshot()
    assert snap["interactive_p99_us"] == float(np.percentile(lats, 99))


def test_propagate_swap(built):
    """A cluster-wide swap drains each live replica's queue under the old
    generation, tags its rows, and installs the new frontend once per
    replica; a down replica parks its queue in limbo for failover."""
    tq, fe, reqs = built["tq"], built["fe"], built["reqs"]
    half = len(reqs) // 2
    cfg = ClusterConfig(n_replicas=2, **RELAXED)
    cl = QACServingCluster(tq, cfg, RuntimeConfig(max_batch=64, slack_us=1e9),
                           frontends=[fe, fe])
    for r in reqs[:half]:
        cl.submit(r)
    fe1 = QACFrontend(tq, k=10, specialize_list_pad=False)
    cl.propagate_swap(1, [fe1, fe1], t_us=reqs[half].t_us)
    with pytest.raises(ValueError):
        cl.propagate_swap(2, [fe1])
    for r in reqs[half:]:
        cl.submit(r)
    cl.drain()
    res = [cl._results[r.idx] for r in reqs]
    assert [r.gen for r in res] == [0] * half + [1] * (len(reqs) - half)
    assert all(rep.runtime.generation == 1 and rep.runtime.fe is fe1 for rep in cl.replicas)
    assert cl.telemetry.snapshot()["swaps"] == [(reqs[half].t_us, 1)]
    assert _served_rows_equal_jax(built, reqs, res) == len(reqs)


def test_admission_sees_the_replica_advanced_to_now(built):
    """The one departure from the JAX package's cluster: before the ladder
    reads a replica's queue, the replica fires the deadline dispatches due
    by the arrival. Four same-instant arrivals fill the queue (est 0-3 ms
    against a 1 ms EWMA), the fifth is shed; a sixth arriving a second
    later, long after the queue's 1 ms deadline, is admitted here, while
    JAX's cluster, whose replica was never advanced, still sheds it and
    every request after it."""
    held = dict(max_batch=64, slack_us=1_000.0)
    uniq = sorted({q.split()[0] for q in built["kept"]})
    trace = [(0.0, s, uniq[s]) for s in range(5)] + [(1e6 + s, s, uniq[s]) for s in range(5, 8)]
    reqs = prepare_requests(built["tq"], trace, k=10)
    outs = []
    for make, cfg, reqs_of in ((_cluster, ClusterConfig(**LADDER), reqs),
                               (_jax_cluster, JaxClusterConfig(**LADDER),
                                as_jax_requests(reqs))):
        cl = make(built, cfg, rt=held)
        cl.replicas[0].monitor.record(1, 1_000.0)
        outs.append([(r.status, r.reason) for r in cl.run_trace(reqs_of)])
    got, want = outs
    assert got[:5] == want[:5] == [("ok", "")] * 4 + [("rejected", "shed_overload")]
    assert want[5:] == [("rejected", "shed_overload")] * 3
    assert got[5] == ("ok", "")
