"""The port's ``runtime/fault.py`` against the JAX package's on the same
inputs: ``StepMonitor``'s straggler flags and EWMA state, the
``HeartbeatRegistry``'s liveness on a fake clock, and ``FaultInjector``'s
step schedule, ``ReplicaFault`` windows and their validation."""
import numpy as np
import pytest

from repro.runtime import fault as jf
from repro_torch.runtime import fault as tf


def _dts(kind, n=120):
    rng = np.random.default_rng({"noise": 0, "flat": 1, "shift": 2, "spikes": 3}[kind])
    if kind == "flat":
        return [2.0] * n
    if kind == "shift":
        return [1.0] * (n // 2) + [5.0] * (n - n // 2)
    x = rng.normal(1.0, 0.05, n)
    if kind == "spikes":
        x[rng.integers(0, n, 6)] = 10.0
    return x.tolist()


@pytest.mark.parametrize("kind", ["noise", "flat", "shift", "spikes"])
@pytest.mark.parametrize("kw", [dict(), dict(alpha=0.3, warmup=0),
                                dict(alpha=0.5, z_threshold=1.0, warmup=10)])
def test_step_monitor_equals_jax(kind, kw):
    got, want = tf.StepMonitor(**kw), jf.StepMonitor(**kw)
    for i, dt in enumerate(_dts(kind)):
        assert got.record(i, dt) == want.record(i, dt)
        assert (got.mean, got.var, got.n) == (want.mean, want.var, want.n)
    assert got.stragglers == want.stragglers
    if kind == "spikes" and kw.get("warmup", 5) < 10:
        assert got.stragglers


def test_heartbeat_registry_equals_jax_on_a_fake_clock():
    now = [0.0]
    regs = [m.HeartbeatRegistry(timeout_s=10.0, clock=lambda: now[0]) for m in (tf, jf)]
    assert [r.dead_hosts() for r in regs] == [[], []]
    rng = np.random.default_rng(5)
    for step in range(200):
        now[0] += float(rng.exponential(3.0))
        host = int(rng.integers(0, 6))
        if rng.random() < 0.7:
            for r in regs:
                r.beat(host)
        got, want = regs[0], regs[1]
        assert got.dead_hosts() == want.dead_hosts()
        assert got.alive_hosts() == want.alive_hosts()
        assert got.last == want.last
    now[0] = 100.0
    for r in regs:
        r.beat(0)
    now[0] = 110.0                                  # exactly at the timeout: alive
    assert 0 in regs[0].alive_hosts() and 0 in regs[1].alive_hosts()
    now[0] = 110.0 + 1e-9
    assert 0 in regs[0].dead_hosts() and 0 in regs[1].dead_hosts()


def test_fault_injector_step_schedule_equals_jax():
    got, want = tf.FaultInjector([3, 7], kill_hosts=[1]), jf.FaultInjector([3, 7], kill_hosts=[1])
    for step in [0, 3, 3, 5, 7, 7, 9]:
        raised = []
        for inj in (got, want):
            try:
                inj.check(step)
                raised.append(None)
            except RuntimeError as e:
                raised.append(str(e))
        assert raised[0] == raised[1]
    assert got.fired == want.fired == [3, 7]


def test_replica_fault_windows_equal_jax():
    specs = [(0, 100.0, 200.0, "kill"), (1, 150.0, float("inf"), "stall"),
             (0, 500.0, 501.0, "stall"), (3, 0.0, 50.0, "kill")]
    got = tf.FaultInjector([], replica_faults=[tf.ReplicaFault(*s) for s in specs])
    want = jf.FaultInjector([], replica_faults=[jf.ReplicaFault(*s) for s in specs])
    for rep in range(5):
        assert [(f.replica, f.t_down_us, f.t_up_us, f.kind)
                for f in got.faults_for(rep)] == [
            (f.replica, f.t_down_us, f.t_up_us, f.kind) for f in want.faults_for(rep)]
        for t in [-1.0, 0.0, 49.9, 50.0, 99.9, 100.0, 150.0, 199.9, 200.0, 500.0,
                  500.5, 501.0, 1e12]:
            g, w = got.down(rep, t), want.down(rep, t)
            assert (g is None) == (w is None)
            if g is not None:
                assert (g.replica, g.t_down_us, g.t_up_us, g.kind) == (
                    w.replica, w.t_down_us, w.t_up_us, w.kind)
    assert got.down(0, 100.0) is got.replica_faults[0]          # half-open window


@pytest.mark.parametrize("args,kw", [((0, 100.0, 100.0), {}), ((0, 200.0, 100.0), {}),
                                     ((0, 0.0), dict(kind="flake"))])
def test_replica_fault_validation_equals_jax(args, kw):
    with pytest.raises(ValueError):
        jf.ReplicaFault(*args, **kw)
    with pytest.raises(ValueError):
        tf.ReplicaFault(*args, **kw)
    tf.ReplicaFault(0, 0.0, kind="stall")
    tf.ReplicaFault(0, 0.0, kind="kill")
