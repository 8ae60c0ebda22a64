"""SLO burn-rate monitoring over the interactive latency objective, as in
the JAX package's ``obs/slo.py``.

  * the SLO is "fraction ``objective`` of requests complete within
    ``target_us``", so the *error budget* is ``1 - objective``;
  * the *burn rate* over a window is (violation fraction in window) /
    (error budget): 1.0 spends the budget exactly on schedule;
  * an alert pair (long_window, short_window, threshold) fires only when
    both windows exceed the threshold: the long window proves the burn is
    sustained, the short one that it is still happening.

Windows are virtual microseconds on the serving clock, so the monitor
works the same on trace replays and live feeds. ``observe`` takes each
request's completion time and latency; ``evaluate`` returns per-pair burn
rates, firing flags and the overall compliance.
"""
from __future__ import annotations

from collections import deque

# (long_us, short_us, burn threshold) — the classic 1h/5m, 6h/30m, 3d/6h
# page/ticket ladder, scaled in virtual microseconds.
DEFAULT_WINDOWS = (
    (3_600e6, 300e6, 14.4),
    (21_600e6, 1_800e6, 6.0),
    (259_200e6, 21_600e6, 1.0),
)


class SLOMonitor:
    """Multi-window burn-rate evaluation of a latency SLO (module
    docstring). Samples are (completion_t_us, ok) pairs kept for the
    longest configured window."""

    def __init__(self, *, target_us: float = 50_000.0,
                 objective: float = 0.999, windows=DEFAULT_WINDOWS):
        if target_us <= 0:
            raise ValueError(f"target_us must be positive, got {target_us}")
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), "
                             f"got {objective}")
        windows = tuple(tuple(w) for w in windows)
        for long_us, short_us, thr in windows:
            if not 0 < short_us <= long_us:
                raise ValueError(
                    f"window pair must satisfy 0 < short <= long, "
                    f"got ({long_us}, {short_us})")
            if thr <= 0:
                raise ValueError(f"burn threshold must be positive, "
                                 f"got {thr}")
        self.target_us = float(target_us)
        self.objective = float(objective)
        self.budget = 1.0 - float(objective)
        self.windows = windows
        self.samples: deque = deque()     # (t_us, ok) in completion order
        self.n_total = 0
        self.n_violations = 0
        self._max_window = max((w[0] for w in windows), default=0.0)

    def observe(self, t_us: float, lat_us: float):
        """One completed request at virtual time ``t_us`` with end-to-end
        latency ``lat_us``."""
        ok = lat_us <= self.target_us
        self.n_total += 1
        self.n_violations += not ok
        self.samples.append((float(t_us), ok))
        cutoff = float(t_us) - self._max_window
        while self.samples and self.samples[0][0] < cutoff:
            self.samples.popleft()

    def burn_rate(self, window_us: float, now: float | None = None) -> float | None:
        """Burn over the trailing window ending at ``now`` (default: the
        latest sample). None when the window holds no samples."""
        if not self.samples:
            return None
        if now is None:
            now = self.samples[-1][0]
        lo = now - window_us
        n = bad = 0
        for t, ok in reversed(self.samples):
            if t < lo:
                break
            n += 1
            bad += not ok
        if n == 0:
            return None
        return (bad / n) / self.budget

    def evaluate(self, now: float | None = None) -> dict:
        """Per window-pair burn rates + firing flags + overall compliance.
        Stable schema: ``alerts`` is a list of dicts with
        long_window_us/short_window_us/threshold/long_burn/short_burn/
        firing; ``firing`` is the OR over pairs."""
        alerts = []
        firing = False
        for long_us, short_us, thr in self.windows:
            lb = self.burn_rate(long_us, now)
            sb = self.burn_rate(short_us, now)
            fire = (lb is not None and sb is not None
                    and lb >= thr and sb >= thr)
            firing |= fire
            alerts.append({
                "long_window_us": long_us, "short_window_us": short_us,
                "threshold": thr, "long_burn": lb, "short_burn": sb,
                "firing": fire,
            })
        return {
            "target_us": self.target_us,
            "objective": self.objective,
            "n_requests": self.n_total,
            "n_violations": self.n_violations,
            "compliance": (1.0 - self.n_violations / self.n_total
                           if self.n_total else None),
            "alerts": alerts,
            "firing": firing,
        }
