"""Render a serving trace (tracing JSONL) into a report.

  PYTHONPATH=src python -m repro_torch.obs.report TRACE.jsonl [--check]
      [--slo-target-us 50000] [--slo-objective 0.999] [--waterfall N]

Input is the ``Tracer.to_jsonl`` format that ``python -m
repro_torch.launch.serve --observe --trace-out TRACE.jsonl`` writes (or any
runtime with a tracer). The report has three parts:

  * a per-stage latency budget: for every child span name (queue.wait,
    engine.service, cache.*, merge.kway, ...) the count, mean, p50 and p99,
    where the 50 ms interactive budget goes;
  * an ASCII waterfall of the N slowest sampled requests, each child span
    drawn in place inside its root ``request`` span;
  * an SLO summary: the spans replayed through ``SLOMonitor`` (the
    multi-window burn-rate ladder the online monitor runs), the worst
    long-window burn and which alert pairs would fire.

``--check`` asserts the trace is self-consistent: every child nests inside
its root, per-request child durations sum to the root (queue.wait +
engine.service == e2e on the miss path), and the e2e p99 rebuilt from the
child-span sums alone is within 5% of the root-span p99: the trace alone
tells the latency story. The JAX package's ``scripts/obs_report.py`` on
this package's ``obs``.
"""
from __future__ import annotations

import argparse
import sys

from .metrics import fmt, percentiles
from .slo import SLOMonitor
from .tracing import load_jsonl, request_trees

WATERFALL_COLS = 64


def stage_table(trees: dict) -> list[dict]:
    """Per-stage budget rows aggregated over every sampled request."""
    by_name: dict[str, list[float]] = {}
    for _root, kids in trees.values():
        for c in kids:
            by_name.setdefault(c["name"], []).append(c["dur_us"])
    rows = []
    for name in sorted(by_name):
        durs = by_name[name]
        p = percentiles(durs, (50, 99), mean=True)
        rows.append(dict(name=name, count=len(durs), **p))
    return rows


def print_stage_table(rows: list[dict]) -> None:
    print(f"{'stage':<20} {'count':>6} {'mean':>9} {'p50':>9} {'p99':>9}")
    for r in rows:
        print(f"{r['name']:<20} {r['count']:>6} "
              f"{fmt(r['mean_us'], 1e3, 2, 'ms'):>9} "
              f"{fmt(r['p50_us'], 1e3, 2, 'ms'):>9} "
              f"{fmt(r['p99_us'], 1e3, 2, 'ms'):>9}")


def print_waterfall(root: dict, kids: list[dict]) -> None:
    t0, dur = root["t0_us"], max(root["dur_us"], 1e-9)
    attrs = root.get("attrs", {})
    print(f"request {root.get('req')} "
          f"({attrs.get('query', '?')!r}, path={attrs.get('path', '?')}): "
          f"{fmt(dur, 1e3, 2, 'ms')} e2e")
    for c in sorted(kids, key=lambda c: (c["t0_us"], c["name"])):
        lo = int(round((c["t0_us"] - t0) / dur * WATERFALL_COLS))
        hi = int(round((c["t0_us"] + c["dur_us"] - t0) / dur
                       * WATERFALL_COLS))
        lo = min(max(lo, 0), WATERFALL_COLS)
        hi = min(max(hi, lo + 1), WATERFALL_COLS)
        bar = " " * lo + "#" * (hi - lo) + " " * (WATERFALL_COLS - hi)
        print(f"  {c['name']:<16} |{bar}| {fmt(c['dur_us'], 1e3, 2, 'ms')}")


def check_trace(trees: dict, tol: float = 0.05) -> dict:
    """Span-tree self-consistency: nesting, child-sum identity, and the
    e2e p99 rebuilt from child spans vs measured from root spans."""
    root_lat, child_lat = [], []
    for req, (root, kids) in sorted(trees.items()):
        t0, t1 = root["t0_us"], root["t0_us"] + root["dur_us"]
        for c in kids:
            if not (c["t0_us"] >= t0 - 1e-6 and c["t0_us"] + c["dur_us"] <= t1 + 1e-6):
                raise AssertionError(f"req {req}: child {c['name']} escapes its root span")
        root_lat.append(root["dur_us"])
        child_lat.append(sum(c["dur_us"] for c in kids))
    n_exact = sum(1 for a, b in zip(root_lat, child_lat)
                  if abs(a - b) <= 1e-6 * max(a, 1.0))
    p99_root = percentiles(root_lat, (99,))["p99_us"]
    p99_child = percentiles(child_lat, (99,))["p99_us"]
    rel = abs(p99_child - p99_root) / max(p99_root, 1e-9)
    if rel > tol:
        raise AssertionError(
            f"e2e p99 rebuilt from child spans ({p99_child:.0f}us) is "
            f"{rel:.1%} off the root-span p99 ({p99_root:.0f}us), tol {tol:.0%}")
    return dict(n_requests=len(root_lat), n_child_sum_exact=n_exact,
                p99_root_us=p99_root, p99_from_children_us=p99_child,
                rel_err=rel)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace", help="JSONL trace from --observe --trace-out")
    ap.add_argument("--check", action="store_true",
                    help="assert span-tree invariants + p99-from-spans "
                         "within 5%% of root p99")
    ap.add_argument("--waterfall", type=int, default=3, metavar="N",
                    help="draw the N slowest sampled requests (default 3)")
    ap.add_argument("--slo-target-us", type=float, default=50_000.0)
    ap.add_argument("--slo-objective", type=float, default=0.999)
    args = ap.parse_args(argv)

    spans, instants = load_jsonl(args.trace)
    trees = request_trees(spans)
    if not trees:
        print(f"no sampled request spans in {args.trace} "
              f"({len(spans)} spans, {len(instants)} instants)")
        return 1
    print(f"# {args.trace}: {len(spans)} spans, {len(instants)} instants, "
          f"{len(trees)} sampled requests\n")

    print("## per-stage latency budget")
    print_stage_table(stage_table(trees))

    slowest = sorted(trees.values(), key=lambda t: -t[0]["dur_us"])
    print(f"\n## slowest sampled requests (top {args.waterfall})")
    for root, kids in slowest[: args.waterfall]:
        print_waterfall(root, kids)

    # SLO replay: each sampled request observed at its completion time
    slo = SLOMonitor(target_us=args.slo_target_us,
                     objective=args.slo_objective)
    for root, _kids in sorted(trees.values(), key=lambda t: t[0]["t0_us"]):
        slo.observe(root["t0_us"] + root["dur_us"], root["dur_us"])
    ev = slo.evaluate()
    print(f"\n## SLO ({args.slo_target_us / 1e3:.0f}ms @ "
          f"{args.slo_objective:.3%})")
    print(f"compliance {ev['compliance']:.4f} over {ev['n_requests']} "
          f"sampled requests ({ev['n_violations']} violations)")
    for a in ev["alerts"]:
        burn = a["long_burn"]
        print(f"  window {a['long_window_us'] / 3.6e9:.2f}h/"
              f"{a['short_window_us'] / 6e7:.0f}m thr {a['threshold']:>5}: "
              f"burn {fmt(burn, 1.0, 2)} "
              f"{'FIRING' if a['firing'] else 'ok'}")
    print(f"overall: {'FIRING' if ev['firing'] else 'within budget'}")

    if args.check:
        res = check_trace(trees)
        print(f"\ncheck OK: {res['n_requests']} request trees, "
              f"{res['n_child_sum_exact']} with exact child-sum identity; "
              f"p99 from child spans {fmt(res['p99_from_children_us'], 1e3, 2, 'ms')} "
              f"vs root {fmt(res['p99_root_us'], 1e3, 2, 'ms')} "
              f"({res['rel_err']:.2%} off)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
