"""QAC serving stack, bottom to top (each layer only knows the one below):

  frontend   (frontend.py)  batch-in/batch-out routed engine dispatch:
                            class routing (single vs conjunctive), pow2
                            batch/k buckets, per-key callable cache.
  runtime    (runtime.py)   one replica: deadline-aware micro-batching over
                            individually arriving keystrokes, plus the
                            generation-tagged exact-prefix LRU and
                            session-filter cache tiers.
  cluster    (cluster.py)   N replicas behind session-affinity dispatch:
                            SLA admission ladder, heartbeat failover,
                            cluster-wide generation swap propagation.
  freshness  (freshness.py) the live index over one runtime: a host delta
                            tier merged exactly over each generation,
                            rebuild-and-swap to the next generation.

Every fast path answers bit-identically to its oracle: the engines to their
plain versions, the runtime and cluster rows to an uncached frontend of the
generation that answered (``check_cluster_parity_timed``), the live
index's answers to a from-scratch build of their version
(``GenerationalQAC.check_parity``).
"""
from .cluster import (ClusterConfig, ClusterResult, QACServingCluster,
                      assign_sla, check_cluster_parity,
                      check_cluster_parity_timed, rendezvous_route)
from .freshness import (FreshnessConfig, FreshResult, GenerationalQAC,
                        parse_and_prepare, witness_answers)
from .frontend import QACFrontend, route_classes
from .qac import (qac_serve_step, qac_serve_step_vmap, qac_serve_striped,
                  serve_multi_term,
                  serve_multi_term_vmap, serve_single_term,
                  serve_single_term_full, serve_single_term_vmap)
from .runtime import (QACOnlineRuntime, QACRequest, RuntimeConfig,
                      prepare_requests, run_naive_trace)

__all__ = ["ClusterConfig", "ClusterResult", "FreshResult", "FreshnessConfig",
           "GenerationalQAC", "QACFrontend", "QACOnlineRuntime", "QACRequest",
           "QACServingCluster", "RuntimeConfig", "assign_sla",
           "check_cluster_parity", "check_cluster_parity_timed",
           "parse_and_prepare", "prepare_requests", "qac_serve_step",
           "qac_serve_step_vmap", "qac_serve_striped", "rendezvous_route", "route_classes",
           "run_naive_trace", "serve_multi_term", "serve_multi_term_vmap",
           "serve_single_term", "serve_single_term_full",
           "serve_single_term_vmap", "witness_answers"]
