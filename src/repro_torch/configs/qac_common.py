"""The paper's own system as a config: QAC serving at eBay scale.

Index sizing mirrors Table 2 EBAY x a production-year growth factor: 10M
completions, 1M unique terms, ~3.1 postings/completion. The JAX package's
``QACArch`` also lowers a docid-striped index onto a TPU mesh
(``index_specs``, ``lowerable``); those parts wait for the port's
dry-run (ROADMAP Queue A item 6b). What the serving stack reads is
here: the widths, ``k``, the engine routes (``frontend``), the online
runtime's, cluster's, live index's and observability's knobs, and the
arch's cells over ``QAC_SHAPES``.
"""
from __future__ import annotations

import dataclasses

from .base import Cell

QAC_SHAPES = {
    "serve_online": dict(kind="serve", batch=4_096),
    "serve_bulk": dict(kind="serve", batch=65_536),
}


@dataclasses.dataclass
class QACArch:
    arch_id: str = "qac-ebay"
    n_completions: int = 10_000_000
    n_terms: int = 1_000_000
    postings_per_comp: float = 3.1
    k: int = 10
    # kernel routing of the batched engines: None means the CUDA kernels on
    # the card and the plain PyTorch versions elsewhere
    use_kernel: bool | None = None
    # single-term engine route: None means the heap_topk kernel on the card,
    # the route that won at every batch size on an H100 (the per-pop RMQ
    # route, ``False``, stays as the tests' way to reach its reference)
    heap_kernel: bool | None = None
    # postings the engines read: "auto" means raw CSR, which served both
    # classes at least as fast as "ef" and "bitpack" on an H100; the JAX
    # package's "auto" falls back to the compressed stream when only it
    # fits the TPU's VMEM, a gate the port does not have, so its
    # ``heap_kernel_max_bytes`` is not carried over. "ef"/"bitpack" force
    # in-kernel decode.
    postings_codec: str | None = "auto"
    # online serving runtime (serve/runtime.py): micro-batch formation and
    # the keystroke-locality caches. slack_us is the batching deadline per
    # request (arrival + slack), a budget spent buying batch occupancy, not
    # the end-to-end SLA, which also pays queueing and engine service.
    online_max_batch: int = 256
    online_slack_us: float = 20_000.0
    online_cache_entries: int = 1 << 17
    online_session_entries: int = 1 << 17
    # multi-replica serving cluster (serve/cluster.py): dispatcher and SLA
    # admission control. The pressure ladder (degrade -> shed_bulk -> shed)
    # is in estimated-wait microseconds; 50 ms is the interactive SLA, so
    # degrade starts at half of it and full shed at twice it.
    # heartbeat_timeout trades detection latency against false deaths from
    # long pauses.
    cluster_replicas: int = 4
    cluster_max_queue: int = 1024
    cluster_degrade_pressure_us: float = 25_000.0
    cluster_shed_bulk_pressure_us: float = 50_000.0
    cluster_shed_pressure_us: float = 100_000.0
    cluster_degraded_k: int = 4
    cluster_heartbeat_timeout_us: float = 200_000.0
    # freshness tier (serve/freshness.py): the in-memory delta absorbing
    # live inserts between rebuilds. swap_threshold counts visible delta
    # changes before a rebuild-and-swap; capacity bounds the delta so it
    # can never overflow between swaps (threshold <= capacity is enforced
    # by FreshnessConfig.__post_init__).
    freshness_delta_capacity: int = 4096
    freshness_swap_threshold: int = 1024
    # observability (obs/): trace 1/N of requests and evaluate the SLO burn
    # against the 50 ms interactive objective at three nines
    obs_trace_sample_every: int = 16
    obs_slo_target_us: float = 50_000.0
    obs_slo_objective: float = 0.999

    family = "qac"

    def frontend(self, qidx, **kw):
        """A ``QACFrontend`` over ``qidx`` on the arch's engine routes and
        ``k``, shaped for online traffic (``specialize_list_pad=False``: one
        callable per (engine, bucket, k), none minted per list length);
        ``kw`` (``auditor``, ...) passes through."""
        from ..serve.frontend import QACFrontend

        return QACFrontend(qidx, k=self.k, use_kernel=self.use_kernel,
                           heap_kernel=self.heap_kernel,
                           postings_codec=self.postings_codec,
                           specialize_list_pad=False, **kw)

    def runtime_config(self):
        """The arch's online-runtime knobs as a ``RuntimeConfig``."""
        from ..serve.runtime import RuntimeConfig

        return RuntimeConfig(
            max_batch=self.online_max_batch,
            slack_us=self.online_slack_us,
            cache_entries=self.online_cache_entries,
            session_entries=self.online_session_entries,
        )

    def cluster_config(self, n_replicas: int | None = None):
        """The arch's dispatcher/admission knobs as a ``ClusterConfig``;
        ``n_replicas`` overrides the preset count."""
        from ..serve.cluster import ClusterConfig

        return ClusterConfig(
            n_replicas=(self.cluster_replicas if n_replicas is None
                        else n_replicas),
            max_queue=self.cluster_max_queue,
            degrade_pressure_us=self.cluster_degrade_pressure_us,
            shed_bulk_pressure_us=self.cluster_shed_bulk_pressure_us,
            shed_pressure_us=self.cluster_shed_pressure_us,
            degraded_k=self.cluster_degraded_k,
            heartbeat_timeout_us=self.cluster_heartbeat_timeout_us,
        )

    def freshness_config(self):
        """The arch's delta-tier/swap knobs as a ``FreshnessConfig``
        (validated there: k >= 1, capacity >= k, threshold in
        [1, capacity])."""
        from ..serve.freshness import FreshnessConfig

        return FreshnessConfig(
            k=self.k,
            delta_capacity=self.freshness_delta_capacity,
            swap_threshold=self.freshness_swap_threshold,
        )

    def obs_config(self):
        """The arch's observability knobs as an ``ObsConfig``: the tracer's
        sampling stride and the SLO the burn-rate monitor evaluates."""
        from ..obs import ObsConfig

        return ObsConfig(
            trace_sample_every=self.obs_trace_sample_every,
            slo_target_us=self.obs_slo_target_us,
            slo_objective=self.obs_slo_objective,
        )

    def cells(self):
        return [Cell(self.arch_id, s, spec["kind"])
                for s, spec in QAC_SHAPES.items()]
