"""Request tracing on the serving stack's virtual microsecond clock, as in
the JAX package's ``obs/tracing.py``.

A ``Tracer`` records *spans* (named intervals with explicit ids and parent
links) and *instants* (point events) against the virtual clock the runtime
and cluster schedule on, so a trace pictures the simulated deployment, not
the host's wall clock. Span taxonomy:

  request           root span per sampled request: [arrival, completion],
                    attrs path/session/k/gen/query.
    cache.trivial / cache.hit_exact / cache.hit_session
                    hit-path child covering the whole request interval,
                    attrs carry the hit reason.
    queue.wait      miss-path child: [arrival, dispatch start].
    engine.service  miss-path child: [dispatch start, batch completion].
                    queue.wait + engine.service == the request's recorded
                    end-to-end latency, exactly (same clock arithmetic).
  batch.dispatch    one span per micro-batch (no request id), attrs
                    size/trigger/callable keys/kernel routes taken.
  admission / replica.death / replica.readmit / generation.swap /
  jit.compile       instants (cluster decision points, new callables).

Layers hold ``tracer = None`` when tracing is off and every site is behind
``if tracer is not None`` plus per-request ``want(idx)`` sampling (1/N of
requests carry spans; batch spans fire only when a sampled request is
aboard).

Export: ``to_jsonl`` (one record per line, ``type`` = span|instant) and
``to_chrome`` (Chrome/Perfetto trace-event JSON: ph="X" duration events +
ph="i" instants, ts/dur in microseconds).
"""
from __future__ import annotations

import json


class Tracer:
    """Span/instant recorder with 1/N per-request sampling (module
    docstring has the taxonomy and the zero-overhead contract)."""

    def __init__(self, *, sample_every: int = 1, capacity: int = 1 << 20):
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, "
                             f"got {sample_every}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.sample_every = int(sample_every)
        self.capacity = int(capacity)
        self.clear()

    def clear(self):
        """Drop recorded spans/instants (measured-replay protocol: clear
        after the warm pass so the trace covers only the measured pass).
        Ids keep advancing — parent links can never dangle across clears.
        """
        self.spans: list[dict] = []
        self.instants: list[dict] = []
        self.dropped = 0
        self._next_id = getattr(self, "_next_id", 1)

    def want(self, idx: int) -> bool:
        """Is request ``idx`` sampled? (1/sample_every of the id space.)"""
        return idx % self.sample_every == 0

    def span(self, name: str, t0_us: float, dur_us: float, *,
             cat: str = "serve", req: int | None = None,
             parent: int | None = None, **attrs) -> int | None:
        """Record one interval; returns its span id (parent for children),
        or None once capacity is hit (counted in ``dropped``)."""
        if len(self.spans) >= self.capacity:
            self.dropped += 1
            return None
        sid = self._next_id
        self._next_id += 1
        self.spans.append({
            "id": sid, "parent": parent, "name": name, "cat": cat,
            "req": req, "t0_us": float(t0_us), "dur_us": float(dur_us),
            "attrs": attrs,
        })
        return sid

    def instant(self, name: str, t_us: float, *, cat: str = "serve",
                req: int | None = None, **attrs):
        if len(self.instants) >= self.capacity:
            self.dropped += 1
            return
        self.instants.append({
            "name": name, "cat": cat, "req": req, "t_us": float(t_us),
            "attrs": attrs,
        })

    # -- export ---------------------------------------------------------------
    def to_jsonl(self, path: str) -> str:
        """One JSON record per line: spans (``type: "span"``) then
        instants (``type: "instant"``)."""
        with open(path, "w") as f:
            for s in self.spans:
                f.write(json.dumps({"type": "span", **s}) + "\n")
            for e in self.instants:
                f.write(json.dumps({"type": "instant", **e}) + "\n")
        return path

    def to_chrome(self, path: str) -> str:
        """Chrome/Perfetto trace-event JSON. Requests map to tids so each
        sampled request gets its own lane in the viewer; batch/cluster
        events land on lane 0."""
        events = []
        for s in self.spans:
            events.append({
                "name": s["name"], "cat": s["cat"], "ph": "X",
                "ts": s["t0_us"], "dur": s["dur_us"],
                "pid": 0, "tid": s["req"] if s["req"] is not None else 0,
                "args": dict(s["attrs"], span_id=s["id"],
                             parent=s["parent"]),
            })
        for e in self.instants:
            events.append({
                "name": e["name"], "cat": e["cat"], "ph": "i", "s": "t",
                "ts": e["t_us"], "pid": 0,
                "tid": e["req"] if e["req"] is not None else 0,
                "args": dict(e["attrs"]),
            })
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)
        return path


def load_jsonl(path: str) -> tuple[list[dict], list[dict]]:
    """Read a ``to_jsonl`` trace back -> (spans, instants)."""
    spans, instants = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            (spans if rec.get("type") == "span" else instants).append(rec)
    return spans, instants


def span_children(spans: list[dict]) -> dict:
    """parent span id -> list of child spans (None key = roots)."""
    out: dict = {}
    for s in spans:
        out.setdefault(s.get("parent"), []).append(s)
    return out


def request_trees(spans: list[dict]) -> dict:
    """req idx -> (root request span, [child spans]) for every root named
    ``request``."""
    kids = span_children(spans)
    out = {}
    for root in kids.get(None, []):
        if root["name"] == "request" and root.get("req") is not None:
            out[root["req"]] = (root, kids.get(root["id"], []))
    return out
