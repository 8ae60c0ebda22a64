"""Fault handling for training and for the serving cluster, the JAX
package's ``runtime/fault.py``:

  * StepMonitor       per-step wall-time EWMA; flags stragglers by z-score.
  * HeartbeatRegistry host liveness; a missed deadline marks the host dead.
  * ElasticPolicy     given surviving hosts, proposes the largest valid mesh
                      (power-of-two data axis, fixed model axis).
  * ReplicaFault      one scheduled replica fault window (kill or stall).
  * FaultInjector     deterministic fault schedule for tests and drills:
                      step-based (``check``) and time-window replica faults
                      (``down``).
  * TrainDriver       the restart loop: run -> fault -> restore the latest
                      checkpoint -> continue (``launch/train.py --drill``).

``serve/cluster.py`` uses StepMonitor (per-replica EWMA service time for
its queue-pressure estimator), HeartbeatRegistry (replica liveness on the
cluster's virtual microsecond clock) and FaultInjector time windows
(replica kill and stall drills).

TrainDriver restarts on a ``RuntimeError``, as JAX's does. In torch that
also covers a CUDA error raised by a kernel launch or a synchronising call;
after a device-side assert the CUDA context is unusable, so the restart
then fails again until ``max_restarts`` re-raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


class StepMonitor:
    """EWMA step-time tracker with straggler z-score detection."""

    def __init__(self, alpha: float = 0.1, z_threshold: float = 3.0,
                 warmup: int = 5):
        self.alpha = alpha
        self.z = z_threshold
        self.warmup = warmup
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self.n = 0
        self.stragglers: list[tuple[int, float]] = []

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self.n += 1
        if self.mean is None:
            self.mean = dt
            return False
        is_straggler = False
        if self.n > self.warmup and self.var > 0:
            zscore = (dt - self.mean) / (self.var ** 0.5)
            if zscore > self.z:
                is_straggler = True
                self.stragglers.append((step, dt))
        delta = dt - self.mean
        self.mean += self.alpha * delta
        self.var = (1 - self.alpha) * (self.var + self.alpha * delta * delta)
        return is_straggler


class HeartbeatRegistry:
    def __init__(self, timeout_s: float = 60.0, clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        self.last: dict[int, float] = {}

    def beat(self, host: int):
        self.last[host] = self.clock()

    def dead_hosts(self) -> list[int]:
        now = self.clock()
        return [h for h, t in self.last.items() if now - t > self.timeout]

    def alive_hosts(self) -> list[int]:
        dead = set(self.dead_hosts())
        return [h for h in self.last if h not in dead]


@dataclasses.dataclass
class ElasticPolicy:
    """Shrink the data axis to the largest power of two that fits the
    surviving hosts; the model axis is fixed by the sharded state layout."""
    chips_per_host: int
    model_axis: int
    min_data_axis: int = 1

    def propose_mesh(self, n_alive_hosts: int) -> Optional[tuple[int, int]]:
        chips = n_alive_hosts * self.chips_per_host
        data = chips // self.model_axis
        if data < self.min_data_axis:
            return None
        data = 1 << (data.bit_length() - 1)        # floor power of two
        return (data, self.model_axis)


@dataclasses.dataclass(frozen=True)
class ReplicaFault:
    """One scheduled serving fault: ``replica`` is down over
    ``[t_down_us, t_up_us)`` on the cluster's virtual clock.

    ``kind="kill"`` loses the replica's in-memory state (queue, prefix/session
    caches — the restarted process re-admits with cold caches); ``"stall"``
    models a long pause (GC, preemption): the replica stops answering but its
    state survives recovery.
    """

    replica: int
    t_down_us: float
    t_up_us: float = float("inf")
    kind: str = "kill"

    def __post_init__(self):
        if self.kind not in ("kill", "stall"):
            raise ValueError(f"ReplicaFault.kind must be 'kill' or 'stall', "
                             f"got {self.kind!r}")
        if not self.t_down_us < self.t_up_us:
            raise ValueError(f"ReplicaFault window must be non-empty: "
                             f"[{self.t_down_us}, {self.t_up_us})")


class FaultInjector:
    """Deterministic fault schedule. Two independent APIs:

    * step-based (training): ``check(step)`` raises at scheduled steps —
      the TrainDriver restart loop catches it;
    * time-window (serving): ``down(replica, t_us)`` reports whether a
      scheduled ReplicaFault window covers ``t_us`` — the serving cluster
      polls it as ground truth while its HeartbeatRegistry provides the
      dispatcher's (delayed) view.
    """

    def __init__(self, fail_at_steps: list[int],
                 kill_hosts: Optional[list[int]] = None,
                 replica_faults: Optional[list[ReplicaFault]] = None):
        self.fail_at = set(fail_at_steps)
        self.kill_hosts = kill_hosts or []
        self.replica_faults = list(replica_faults or [])
        self.fired: list[int] = []

    def check(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.append(step)
            raise RuntimeError(f"injected node failure at step {step} "
                               f"(hosts {self.kill_hosts})")

    def down(self, replica: int, t_us: float) -> Optional[ReplicaFault]:
        """The fault window covering (replica, t_us), or None if it is up."""
        for f in self.replica_faults:
            if f.replica == replica and f.t_down_us <= t_us < f.t_up_us:
                return f
        return None

    def faults_for(self, replica: int) -> list[ReplicaFault]:
        return [f for f in self.replica_faults if f.replica == replica]


class TrainDriver:
    """Checkpoint-restart loop around a step function.

    step_fn(state, step) -> state;  save_fn(state, step);  restore_fn() ->
    (state, step);  on_fault(step, error) -> optional remesh hook.
    """

    def __init__(self, step_fn, save_fn, restore_fn, *, ckpt_every: int = 50,
                 max_restarts: int = 10, on_fault=None,
                 monitor: Optional[StepMonitor] = None):
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.on_fault = on_fault
        self.monitor = monitor or StepMonitor()
        self.restarts = 0

    def run(self, state, start_step: int, total_steps: int):
        step = start_step
        while step < total_steps:
            try:
                t0 = time.monotonic()
                state = self.step_fn(state, step)
                self.monitor.record(step, time.monotonic() - t0)
                step += 1
                if step % self.ckpt_every == 0:
                    self.save_fn(state, step)
            except RuntimeError as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                if self.on_fault is not None:
                    self.on_fault(step, e)
                state, step = self.restore_fn()
        return state, step
