"""Serving observability, as in the JAX package's ``obs``: four small
pieces threaded through the runtime, the cluster and the frontend.

  metrics.py    ``percentiles``, the one quantile implementation
                (np.percentile semantics, explicit None on empty), and
                ``MetricsRegistry``, where every layer's telemetry registers.
  tracing.py    ``Tracer``: request spans with explicit ids on the virtual
                microsecond clock, 1/N sampling, no cost when off; JSONL and
                Chrome/Perfetto export.
  jit_audit.py  ``JitAuditor``: records every new dispatch callable of the
                frontend (its key and first-call wall time) and asserts the
                closed set online after ``freeze()``.
  slo.py        ``SLOMonitor``: multi-window burn-rate evaluation of the
                interactive 50 ms objective.

``ObsConfig`` bundles the knobs; its defaults are the JAX package's
production preset (1/16 of requests traced, 50 ms at 99.9%).
"""
from __future__ import annotations

import dataclasses

from .metrics import MetricsRegistry, Histogram, percentiles, fmt  # noqa: F401
from .tracing import (Tracer, load_jsonl, request_trees,  # noqa: F401
                      span_children)
from .jit_audit import JitAuditor, JitAuditError  # noqa: F401
from .slo import SLOMonitor, DEFAULT_WINDOWS  # noqa: F401


@dataclasses.dataclass
class ObsConfig:
    """Observability knobs, validated at construction like the other
    serving configs. ``trace_sample_every`` is the 1/N request-sampling
    stride (1 = trace everything)."""

    trace_sample_every: int = 16
    trace_capacity: int = 1 << 20
    hist_capacity: int = 1 << 16
    slo_target_us: float = 50_000.0      # the interactive objective
    slo_objective: float = 0.999
    slo_windows: tuple = DEFAULT_WINDOWS
    strict_jit_audit: bool = False       # raise on a post-freeze callable

    def __post_init__(self):
        if self.trace_sample_every < 1:
            raise ValueError(f"trace_sample_every must be >= 1, "
                             f"got {self.trace_sample_every}")
        if self.trace_capacity < 1:
            raise ValueError(f"trace_capacity must be >= 1, "
                             f"got {self.trace_capacity}")
        if self.hist_capacity < 1:
            raise ValueError(f"hist_capacity must be >= 1, "
                             f"got {self.hist_capacity}")
        if self.slo_target_us <= 0:
            raise ValueError(f"slo_target_us must be positive, "
                             f"got {self.slo_target_us}")
        if not 0.0 < self.slo_objective < 1.0:
            raise ValueError(f"slo_objective must be in (0, 1), "
                             f"got {self.slo_objective}")

    def tracer(self) -> Tracer:
        return Tracer(sample_every=self.trace_sample_every,
                      capacity=self.trace_capacity)

    def registry(self) -> MetricsRegistry:
        return MetricsRegistry(hist_capacity=self.hist_capacity)

    def auditor(self, tracer: Tracer | None = None) -> JitAuditor:
        return JitAuditor(strict=self.strict_jit_audit, tracer=tracer)

    def slo_monitor(self) -> SLOMonitor:
        return SLOMonitor(target_us=self.slo_target_us,
                          objective=self.slo_objective,
                          windows=self.slo_windows)
