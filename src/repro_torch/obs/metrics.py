"""One percentile implementation and the metrics registry of the serving
stack, as in the JAX package's ``obs/metrics.py``.

``percentiles`` is pinned to ``np.percentile`` verbatim and explicit about
emptiness: an empty input yields ``None`` for every statistic, never a
fabricated zero (a window that served nothing has no latency). ``fmt``
renders the ``None``.

``MetricsRegistry`` aggregates counters, gauges, exact-reservoir histograms
and *collectors*: named snapshot callables the serving layers register
(``RuntimeTelemetry``, ``ClusterTelemetry``, the launch auditor), so one
``registry.snapshot()`` returns the stack's state under a stable schema:
top-level keys ``counters`` / ``gauges`` / ``histograms`` / ``collectors``,
histogram sub-dicts always carrying ``n`` / ``mean`` / ``max`` / ``p50`` /
``p95`` / ``p99`` (None when empty).
"""
from __future__ import annotations

import numpy as np

DEFAULT_QS = (50, 95, 99)


def percentiles(values, qs=DEFAULT_QS, *, suffix: str = "_us",
                mean: bool = False, vmax: bool = False) -> dict:
    """``{f"p{q}{suffix}": float | None}`` pinned to ``np.percentile``.

    Nonempty input -> ``float(np.percentile(values, q))``; empty input ->
    ``None`` per key. ``mean``/``vmax`` add ``mean{suffix}`` /
    ``max{suffix}`` under the same rule.
    """
    vals = np.asarray(list(values), np.float64)
    out: dict = {}
    if vals.size == 0:
        for q in qs:
            out[f"p{q}{suffix}"] = None
        if mean:
            out[f"mean{suffix}"] = None
        if vmax:
            out[f"max{suffix}"] = None
        return out
    for q in qs:
        out[f"p{q}{suffix}"] = float(np.percentile(vals, q))
    if mean:
        out[f"mean{suffix}"] = float(vals.mean())
    if vmax:
        out[f"max{suffix}"] = float(vals.max())
    return out


def fmt(v, scale: float = 1.0, nd: int = 0, unit: str = "") -> str:
    """Render a possibly-``None`` statistic: ``fmt(None) == "n/a"``."""
    if v is None:
        return "n/a"
    return f"{v / scale:.{nd}f}{unit}"


class Histogram:
    """Exact-reservoir histogram: every observation is kept verbatim up to
    ``capacity`` (so percentiles are exact, not sketched); past capacity
    the count/sum/max stay exact and the reservoir stops growing (the
    snapshot marks itself ``truncated``)."""

    def __init__(self, capacity: int = 1 << 16):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.values: list[float] = []
        self.n = 0
        self.total = 0.0
        self.vmax: float | None = None

    def observe(self, v: float):
        v = float(v)
        self.n += 1
        self.total += v
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        if len(self.values) < self.capacity:
            self.values.append(v)

    def snapshot(self) -> dict:
        out = {"n": self.n,
               "mean": (self.total / self.n) if self.n else None,
               "max": self.vmax}
        out.update(percentiles(self.values, suffix=""))
        if self.n > len(self.values):
            out["truncated"] = True
        return out


class MetricsRegistry:
    """Counters + gauges + exact-reservoir histograms + named collectors,
    one registry per serving deployment (schema in the module docstring)."""

    def __init__(self, *, hist_capacity: int = 1 << 16):
        self._hist_capacity = int(hist_capacity)
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, Histogram] = {}
        self._collectors: dict[str, object] = {}

    def counter(self, name: str, inc: float = 1):
        self.counters[name] = self.counters.get(name, 0) + inc

    def gauge(self, name: str, value: float):
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float):
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(self._hist_capacity)
        h.observe(value)

    def register_collector(self, name: str, snapshot_fn):
        """Register a zero-arg callable returning a dict; re-registering a
        name replaces it (a reset layer re-registers its fresh telemetry).
        """
        if not callable(snapshot_fn):
            raise TypeError(f"collector {name!r} must be callable")
        self._collectors[name] = snapshot_fn

    def snapshot(self) -> dict:
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: h.snapshot()
                           for k, h in sorted(self.histograms.items())},
            "collectors": {k: fn() for k, fn in
                           sorted(self._collectors.items())},
        }
