"""QAC serving launcher: build an index from a synthetic log and serve
batched completions on the card: the paper's system end to end.

  PYTHONPATH=src python -m repro_torch.launch.serve --queries 20000 \
      --batch 256 [--stripes 4] [--routed] [--interactive "bmw i3 s"] \
      [--device cpu]

It runs on the card unless ``--device cpu`` asks for the plain PyTorch
versions on the host, and raises without a card. The throughput run times
the fused step (``qac_serve_step``: both classes on their kernels), the
class-routed frontend (``--routed``) or the docid-striped index
(``--stripes N``: ``build_striped`` over the index's own rows, then
``qac_serve_striped``'s loop over the stripes on one device).

Online mode replays a keystroke-per-session trace through the
deadline-aware micro-batching runtime and its prefix/session caches and
prints latency telemetry; ``--check`` also asserts every row bit-identical
to one-request-per-dispatch serving and a nonzero hit rate:

  python -m repro_torch.launch.serve --online --queries 3000 \
      --sessions 64 [--check] [--slack-us 20000] [--max-batch 64]

Cluster mode serves the same trace through N runtime replicas behind the
session-affinity dispatcher with SLA-class admission control; ``--drill``
kills replica 0 mid-trace (and brings it back), and ``--check`` asserts
every served answer bit-identical to the uncached frontend, re-routed
traffic under the drill, and service after the failover:

  python -m repro_torch.launch.serve --online --cluster 2 \
      --queries 3000 --sessions 64 [--drill] [--check]

Freshness mode replays keystroke traffic interleaved with live corpus
mutations through the live index (``serve/freshness.py``): the delta tier,
the exact k-way merge, and rebuild-and-swap mid-trace. Generation 0 is the
index the launcher built. ``--check`` asserts sampled answers
bit-identical to a from-scratch build of their visible (generation, seq)
version, at least one swap, one cache invalidation per swap, and delta
hits:

  python -m repro_torch.launch.serve --freshness --queries 3000 \
      --sessions 32 [--mutations 24] [--swap-threshold 8] [--check]

``--observe`` attaches request tracing, the metrics registry, the callable
audit and the SLO burn monitor to the online, cluster and freshness modes;
``--trace-out TRACE.jsonl`` writes the measured pass's spans for
``python -m repro_torch.obs.report``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..backend import resolve_device
from ..configs.qac_common import QACArch
from ..core import build_qac_index, corpus_stats, parse_queries
from ..core.search import describe_single_route
from ..core.strings import decode_string
from ..core.striped import build_striped
from ..core.types import INF_DOCID
from ..obs.metrics import fmt
from ..serve.qac import qac_serve_step, qac_serve_striped
from ..serve.runtime import QACOnlineRuntime, prepare_requests, run_naive_trace
from ..text import (KeystrokeTraceConfig, SynthLogConfig,
                    generate_keystroke_trace, generate_query_log)


def _make_obs(args):
    """The ``--observe`` stack from the arch preset and the flags:
    (ObsConfig, Tracer, JitAuditor, MetricsRegistry)."""
    ocfg = QACArch(k=args.k).obs_config()
    if args.trace_sample is not None:
        ocfg = dataclasses.replace(ocfg, trace_sample_every=args.trace_sample)
    tracer = ocfg.tracer()
    auditor = ocfg.auditor(tracer=tracer)
    registry = ocfg.registry()
    registry.register_collector("jit", auditor.snapshot)
    return ocfg, tracer, auditor, registry


def _export_trace(args, tracer) -> None:
    if not args.trace_out:
        return
    if args.trace_out.endswith(".jsonl"):
        path, kind = tracer.to_jsonl(args.trace_out), "jsonl"
    else:
        path, kind = tracer.to_chrome(args.trace_out), "chrome"
    print(f"[serve] observe: wrote {kind} trace ({len(tracer.spans)} spans,"
          f" {len(tracer.instants)} instants) to {path}")


def _print_slo(ocfg, slo) -> None:
    ev = slo.evaluate()
    worst = max((a for a in ev["alerts"] if a["long_burn"] is not None),
                key=lambda a: a["long_burn"], default=None)
    print(f"[serve] observe SLO: {ev['n_violations']}/{ev['n_requests']} "
          f"over {ocfg.slo_target_us / 1e3:.0f}ms "
          f"(compliance={fmt(ev['compliance'], nd=4)} vs objective "
          f"{ev['objective']}), firing={ev['firing']}"
          + (f", worst long-window burn={worst['long_burn']:.2f} "
             f"@{worst['long_window_us'] / 3.6e9:.1f}h" if worst else ""))


def _runtime_config(args, arch):
    """The arch's runtime knobs with the scheduler flags applied."""
    cfg = arch.runtime_config()
    if args.max_batch is not None:
        cfg.max_batch = args.max_batch
    if args.slack_us is not None:
        cfg.slack_us = args.slack_us
    return cfg


def _keystroke_cfg(args):
    return KeystrokeTraceConfig(n_sessions=args.sessions,
                                mean_keystroke_ms=args.keystroke_ms, seed=0)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def run_online(args, qidx, kept) -> None:
    trace = generate_keystroke_trace(kept, _keystroke_cfg(args))
    reqs = prepare_requests(qidx, trace, k=args.k)
    print(f"[serve] online trace: {len(reqs)} keystroke requests over "
          f"{args.sessions} concurrent sessions")
    arch = QACArch(k=args.k)
    cfg = _runtime_config(args, arch)
    ocfg = tracer = auditor = registry = None
    if args.observe:
        ocfg, tracer, auditor, registry = _make_obs(args)
    # one callable per (engine, bucket, k): a closed set for online traffic
    frontend = arch.frontend(qidx, auditor=auditor)
    rt = QACOnlineRuntime(frontend, cfg, tracer=tracer, registry=registry)
    if args.observe:
        # the measured-replay protocol: the warm pass mints every callable
        # the trace can form, then the trace is cleared and the auditor
        # frozen, so the measured pass is steady state by assertion
        rt.warmup(reqs)
        rt.run_trace(reqs)
        rt.reset()
        tracer.clear()
        auditor.freeze()
        results = rt.run_trace(reqs)
    else:
        results = rt.replay(reqs)
    s = rt.telemetry.snapshot()
    print(f"[serve] online: p50={fmt(s['p50_us'])}us "
          f"p95={fmt(s['p95_us'])}us p99={fmt(s['p99_us'])}us "
          f"mean={fmt(s['mean_us'])}us "
          f"hit_rate={s['cache_hit_rate']:.2f} paths={s['paths']}")
    print(f"[serve] online: {s['n_batches']} batches "
          f"(mean size {fmt(s['mean_batch_size'], nd=1)}, "
          f"hist {s['batch_hist']}), "
          f"triggers={s['triggers']}, queue_peak={s['queue_peak']}, "
          f"engine_wall={s['engine_wall_us'] / 1e3:.1f}ms")
    if args.observe:
        aud = auditor.snapshot()
        print(f"[serve] observe: {len(tracer.spans)} spans + "
              f"{len(tracer.instants)} instants at 1/"
              f"{tracer.sample_every} sampling; callables="
              f"{aud['n_variants']} (first-call wall "
              f"{aud['compile_wall_us_total'] / 1e3:.0f}ms, all pre-freeze), "
              f"post-freeze callables={aud['n_violations']}")
        slo = ocfg.slo_monitor()
        for r in reqs:
            done = rt.done_t_us[r.idx]
            slo.observe(done, done - r.t_us)
        _print_slo(ocfg, slo)
        _export_trace(args, tracer)
    if args.check:
        # the same warm frontend: complete() is pure, so the reference is
        # the same and its B=1 callables are not minted twice
        naive_rows, naive = run_naive_trace(frontend, reqs)
        for i, (g, w) in enumerate(zip(results, naive_rows)):
            _check(np.array_equal(g, w), f"online-runtime parity break at request {i} "
                   f"({reqs[i].query!r}): {g} != {w}")
        _check(s["cache_hit_rate"] > 0, "expected a nonzero cache hit rate")
        if args.observe:
            from ..obs.tracing import request_trees

            _check(bool(tracer.spans), "observe produced no spans")
            auditor.assert_closed()
            # every sampled root span lasts exactly the telemetry latency
            trees = request_trees(tracer.spans)
            _check(bool(trees), "observe produced no request roots")
            for idx, (root, _) in trees.items():
                lat = rt.done_t_us[idx] - reqs[idx].t_us
                _check(abs(root["dur_us"] - lat) < 1e-6,
                       f"request {idx}: root span {root['dur_us']}us vs telemetry {lat}us")
            print(f"[serve] observe check OK: {len(trees)} sampled request "
                  f"trees match telemetry; callable set closed "
                  f"({aud['n_variants']} callables, 0 post-freeze)")
        print(f"[serve] online check OK: {len(reqs)} requests bit-identical "
              f"to one-request-per-dispatch serving "
              f"(naive mean={fmt(naive['mean_us'])}us, "
              f"speedup={(naive['mean_us'] or 0) / max(s['mean_us'] or 1e-9, 1e-9):.2f}x)")


def run_cluster(args, qidx, kept) -> None:
    from ..runtime.fault import FaultInjector, ReplicaFault
    from ..serve.cluster import (QACServingCluster, assign_sla,
                                 check_cluster_parity)

    trace = generate_keystroke_trace(kept, _keystroke_cfg(args))
    reqs = prepare_requests(qidx, trace, k=args.k)
    sla = assign_sla(reqs, bulk_fraction=0.25)
    arch = QACArch(k=args.k)
    rt_cfg = _runtime_config(args, arch)
    cl_cfg = arch.cluster_config(n_replicas=args.cluster)
    injector = None
    t_kill = t_up = None
    if args.drill:
        # kill replica 0 mid-trace, back after 2 heartbeat timeouts: the
        # drill runs detection, failover and re-admission
        t_kill = reqs[len(reqs) // 2].t_us
        t_up = t_kill + 2 * cl_cfg.heartbeat_timeout_us
        injector = FaultInjector([], replica_faults=[ReplicaFault(0, t_kill, t_up)])
    ocfg = tracer = auditor = registry = None
    if args.observe:
        ocfg, tracer, auditor, registry = _make_obs(args)
    # one warm frontend shared by every replica: complete() is pure
    frontend = arch.frontend(qidx, auditor=auditor)
    cluster = QACServingCluster(qidx, cl_cfg, rt_cfg,
                                frontends=[frontend] * args.cluster,
                                injector=injector, tracer=tracer,
                                registry=registry)
    print(f"[serve] cluster: {args.cluster} replicas, {len(reqs)} requests, "
          f"{sum(s == 'bulk' for s in sla)} bulk"
          + (f", drill kill@{t_kill / 1e3:.0f}ms up@{t_up / 1e3:.0f}ms"
             if args.drill else ""))
    if args.observe:
        cluster.run_trace(reqs, sla)         # the warm pass
        cluster.reset()
        tracer.clear()
        auditor.freeze()
        results = cluster.run_trace(reqs, sla)
    else:
        results = cluster.replay(reqs, sla)
    s = cluster.telemetry.snapshot()
    print(f"[serve] cluster: served={s['served']} rejected={s['rejected']} "
          f"(shed_rate={s['shed_rate']:.3f}, degrade_rate="
          f"{s['degrade_rate']:.3f}) per_replica={s['per_replica']}")
    print(f"[serve] cluster: interactive p50={fmt(s['interactive_p50_us'])}"
          f"us p99={fmt(s['interactive_p99_us'])}us | bulk "
          f"p99={fmt(s['bulk_p99_us'])}us | sheds={s['shed']}")
    if args.drill:
        print(f"[serve] cluster: deaths={s['deaths']} "
              f"readmissions={s['readmissions']} rerouted={s['rerouted']} "
              f"failover_p99={fmt(s['failover_p99_us'])}us")
    if args.observe:
        n_adm = sum(1 for e in tracer.instants if e["name"] == "admission")
        print(f"[serve] observe: {len(tracer.spans)} spans + "
              f"{len(tracer.instants)} instants ({n_adm} admission "
              f"decisions sampled); post-freeze callables="
              f"{len(auditor.violations)}")
        _export_trace(args, tracer)
        if args.check:
            _check(bool(tracer.spans), "observe produced no spans")
            auditor.assert_closed()
    if args.check:
        n = check_cluster_parity(frontend, reqs, results)
        _check(n > 0, "no served results to check")
        if args.drill:
            _check(s["rerouted"] > 0, "drill produced no re-routed traffic")
            _check(bool(s["deaths"]), "drill death was never detected")
            # availability: the surviving replicas served requests that
            # arrived after the kill
            post = [r for q, r in zip(reqs, results)
                    if q.t_us > t_kill and r.status == "ok"]
            _check(bool(post), "no requests served after the kill")
        print(f"[serve] cluster check OK: {n} served answers bit-identical "
              f"to the uncached frontend oracle"
              + (f", {s['rerouted']} re-routed" if args.drill else ""))


def run_freshness(args, qidx, kept, kscores, device) -> None:
    """``kept``/``kscores`` are the deduplicated corpus of the launcher's
    build: the mutation trace draws its targets (and trend spikes' old
    scores) from it, and generation 0 serves that build (``qidx``) as it
    is, with no second build."""
    from ..serve.freshness import FreshnessConfig, GenerationalQAC
    from ..text import MutationTraceConfig, generate_mutation_trace

    n_mut = args.mutations
    swap_thr = (args.swap_threshold if args.swap_threshold is not None
                else max(2, n_mut // 3))
    arch = QACArch(k=args.k)
    fr_cfg = FreshnessConfig(
        k=args.k, delta_capacity=max(arch.freshness_delta_capacity, swap_thr),
        swap_threshold=swap_thr)
    rt_cfg = _runtime_config(args, arch)
    events = generate_mutation_trace(kept, kscores, MutationTraceConfig(
        keystrokes=_keystroke_cfg(args), n_mutations=n_mut, seed=0))
    n_req = sum(1 for e in events if e.kind == "request")
    print(f"[serve] freshness trace: {n_req} requests + "
          f"{len(events) - n_req} mutations, swap_threshold={swap_thr}")
    tracer = registry = None
    if args.observe:
        # no callable audit here: a rebuild-and-swap mints the new
        # generation's callables mid-trace (billed to the rebuild), so the
        # closed set holds per generation, not per trace
        _, tracer, _, registry = _make_obs(args)
    gq = GenerationalQAC(None, None, cfg=fr_cfg, rt_cfg=rt_cfg, device=device,
                         tracer=tracer, registry=registry,
                         built=(qidx, kept, kscores))
    if args.observe:
        gq.run_mutation_trace(events)        # the warm pass
        gq.reset()
        tracer.clear()
        results = gq.run_mutation_trace(events)
    else:
        results = gq.replay(events)
    s = gq.snapshot()
    rts = s["runtime"]
    print(f"[serve] freshness: generation={s['generation']} "
          f"swaps={s['n_swaps']} outcomes={s['mutation_outcomes']} "
          f"delta_hit_answers={s['delta_hit_answers']} "
          f"escalations={s['escalations']}")
    print(f"[serve] freshness: apply_p99={s['apply_p99_us']:.0f}us "
          f"swap_stall_p99={s['swap_stall_p99_us'] / 1e3:.1f}ms "
          f"rebuilds={[f'{r / 1e3:.0f}ms' for r in s['rebuild_wall_us']]} "
          f"hit_rate={rts['cache_hit_rate']:.2f}")
    print(f"[serve] freshness: per_generation={rts['per_generation']} "
          f"invalidations={rts['invalidations']}")
    if args.observe:
        merges = sum(1 for sp in tracer.spans if sp["name"] == "merge.kway")
        print(f"[serve] observe: {len(tracer.spans)} spans + "
              f"{len(tracer.instants)} instants ({merges} k-way merges sampled)")
        _export_trace(args, tracer)
        if args.check:
            _check(bool(tracer.spans), "observe produced no spans")
    if args.check:
        _check(s["n_swaps"] >= 1, "trace produced no generation swap")
        _check(s["delta_hit_answers"] > 0, "no answer was served from the delta tier")
        for key, inv in rts["invalidations"].items():
            _check(inv["count"] == 1, f"swap {key} invalidated caches {inv['count']} times")
        _check(len(rts["invalidations"]) == s["n_swaps"],
               "each swap must invalidate the cache tiers exactly once")
        n = gq.check_parity(results, sample_every=max(1, len(results) // 200))
        print(f"[serve] freshness check OK: {n} sampled answers bit-identical"
              f" to from-scratch rebuilds at their visible versions, "
              f"{s['n_swaps']} swaps each invalidating caches exactly once")


def sample_partials(kept, batch: int, seed: int = 0) -> list[str]:
    """``batch`` partial queries: a logged query with its last term cut at
    a random length."""
    rng = np.random.default_rng(seed)
    partials = []
    for qi in rng.integers(0, len(kept), batch):
        toks = kept[qi].split()
        cut = rng.integers(1, len(toks[-1]) + 1)
        partials.append(" ".join(toks[:-1] + [toks[-1][:cut]]))
    return partials


def run_interactive(args, qidx) -> list[str]:
    """Serve one literal partial query with the fused step; prints and
    returns the completion strings."""
    pids, plen, _, suf, slen = parse_queries(qidx.dictionary, [args.interactive])
    docids = qac_serve_step(qidx, pids, plen, suf, slen, k=args.k)[0].cpu().tolist()
    print(f"[serve] completions for {args.interactive!r}:")
    out = []
    comps = qidx.completions
    for d in docids:
        if d == INF_DOCID:
            break
        terms, n = comps.extract(torch.tensor([d], device=qidx.device))
        chars = qidx.dictionary.extract(terms[0, : int(n[0])]).cpu().numpy()
        out.append(" ".join(decode_string(c) for c in chars))
        print(f"   #{d:6d}  {out[-1]}")
    return out


def run_throughput(args, qidx, kept, device) -> int:
    """Time the fused step, the routed frontend or the striped index on
    ``--batch`` sampled partial queries; returns the result count."""
    pids, plen, _, suf, slen = parse_queries(qidx.dictionary,
                                             sample_partials(kept, args.batch))
    on_card = device.type == "cuda"
    if args.routed:
        frontend = QACArch(k=args.k).frontend(qidx)
        fn = lambda a, b, c, d: frontend.complete(a, b, c, d)
    elif args.stripes > 1:
        # the index's own rows (row d = docid d) split into docid stripes
        t0 = time.perf_counter()
        fwd = qidx.completions.fwd_terms.cpu().numpy()
        striped = build_striped(fwd, np.arange(len(fwd), dtype=np.int32),
                                qidx.index.n_terms, args.stripes, device=device)
        single = describe_single_route(use_kernel=on_card)
        multi = "conjunctive_topk[raw]" if on_card else "torch_ref tile loop"
        print(f"[serve] striped index: {args.stripes} stripes built in "
              f"{time.perf_counter() - t0:.1f}s, {striped.n_local_docs} docid rows and "
              f"{striped.postings_pad} postings a stripe (padded), "
              f"{striped.pp_codec or 'no'} packing")
        for s in range(args.stripes):
            print(f"[serve] stripe {s}: single-term {single}, multi-term {multi}, "
                  f"{striped.stripe_nbytes(s) / 2**20:.2f} MiB on {device.type}")
        fn = lambda a, b, c, d: qac_serve_striped(striped, qidx.dictionary, a, b, c, d,
                                                  k=args.k)
    else:
        fn = lambda a, b, c, d: qac_serve_step(qidx, a, b, c, d, k=args.k)

    def call():
        out = fn(pids, plen, suf, slen)
        if on_card:
            torch.cuda.synchronize(device)
        return out

    out = call()
    n_rounds = 5
    t0 = time.perf_counter()
    for _ in range(n_rounds):
        out = call()
    dt = (time.perf_counter() - t0) / n_rounds
    out = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    n_res = int((out != INF_DOCID).sum())
    where = torch.cuda.get_device_name(device) if on_card else "host CPU"
    mode = "routed" if args.routed else f"stripes={max(args.stripes, 1)}"
    print(f"[serve] batch={args.batch} k={args.k} {mode}: "
          f"{dt / args.batch * 1e6:.1f} us/query, {args.batch / dt:.0f} QPS "
          f"({where}), {n_res} results")
    if args.routed:
        print(f"[serve] frontend stats: {frontend.stats}")
    return n_res


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--queries", type=int, default=20_000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--stripes", type=int, default=0)
    ap.add_argument("--routed", action="store_true",
                    help="serve through the class-routed QACFrontend "
                         "(host partition by query class) instead of the "
                         "fused both-engines step")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--interactive", default=None,
                    help="serve one literal partial query and print strings")
    ap.add_argument("--online", action="store_true",
                    help="replay a keystroke-session trace through the "
                         "micro-batching runtime (serve/runtime.py) and "
                         "print latency telemetry")
    ap.add_argument("--sessions", type=int, default=64,
                    help="concurrent keystroke sessions in --online mode")
    ap.add_argument("--keystroke-ms", type=float, default=150.0)
    ap.add_argument("--slack-us", type=float, default=None,
                    help="micro-batch deadline slack per request "
                         "(default: QACArch.online_slack_us)")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="micro-batch size cap "
                         "(default: QACArch.online_max_batch)")
    ap.add_argument("--check", action="store_true",
                    help="--online/--cluster/--freshness: assert the mode's "
                         "parity and its gates")
    ap.add_argument("--cluster", type=int, default=0,
                    help="with --online: serve through a QACServingCluster "
                         "with this many replicas (serve/cluster.py)")
    ap.add_argument("--drill", action="store_true",
                    help="--cluster only: kill replica 0 mid-trace and "
                         "exercise detection/failover/re-admission")
    ap.add_argument("--freshness", action="store_true",
                    help="replay keystroke traffic + live corpus mutations "
                         "through the live index (serve/freshness.py): delta "
                         "tier, k-way merge, mid-trace rebuild-and-swap")
    ap.add_argument("--mutations", type=int, default=24,
                    help="--freshness: mutation events (inserts + trend "
                         "spikes) interleaved into the trace")
    ap.add_argument("--swap-threshold", type=int, default=None,
                    help="--freshness: visible delta changes before a "
                         "rebuild-and-swap (default: ~mutations/3, so a "
                         "default trace swaps at least once)")
    ap.add_argument("--observe", action="store_true",
                    help="attach the observability stack (request tracing, "
                         "metrics registry, callable audit, SLO burn "
                         "monitor) to --online/--cluster/--freshness; with "
                         "--check also asserts nonzero spans, a closed "
                         "callable set in steady state, and span/"
                         "telemetry agreement")
    ap.add_argument("--trace-out", default=None,
                    help="--observe: write the measured pass's trace "
                         "(.jsonl = span records for "
                         "python -m repro_torch.obs.report; any other "
                         "suffix = Chrome/Perfetto trace-event JSON)")
    ap.add_argument("--trace-sample", type=int, default=None,
                    help="--observe: trace every Nth request (default: "
                         "QACArch.obs_trace_sample_every)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu "
                         "(the plain PyTorch versions)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    print(f"[serve] generating {args.queries} synthetic scored queries ...")
    qs, sc = generate_query_log(SynthLogConfig(n_queries=args.queries))
    t0 = time.time()
    qidx, kept, scores = build_qac_index(qs, sc, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stats = corpus_stats(kept)
    print(f"[serve] built index in {time.time() - t0:.1f}s on {device.type}: "
          f"{stats.n_queries} completions, {stats.n_unique_terms} terms, "
          f"{stats.avg_terms_per_query:.2f} terms/query")

    if args.freshness:
        run_freshness(args, qidx, kept, scores, device)
    elif args.online:
        if args.cluster > 0:
            run_cluster(args, qidx, kept)
        else:
            run_online(args, qidx, kept)
    elif args.interactive:
        run_interactive(args, qidx)
    else:
        run_throughput(args, qidx, kept, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
