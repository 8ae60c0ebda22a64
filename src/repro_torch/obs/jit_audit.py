"""Callable auditor: make every new dispatch callable visible, and assert
that none appears mid-trace.

In the JAX package each (engine, bucket, k, list_pad) key of the frontend's
cache is a jit variant, and its first call is an XLA compile. In the port a
key names the same thing one level down: a new set of launch shapes (grid,
block, shared memory of the ``heap_topk`` and ``conjunctive_topk``
kernels) and of scratch allocations (the caching allocator's first blocks
of those sizes). The frontend's pow2 batch and k buckets plus
``specialize_list_pad=False`` keep that set closed, so a warmed deployment
mints no new callable while serving. The names ``JitAuditor`` and
``JitAuditError`` are kept so the counterpart is easy to find.

  * ``wrap(key, fn)``: the frontend wraps every callable it mints; the
    wrapper times the first call like any other call, synchronising with
    the card when an output holds a CUDA tensor, and records
    ``(key, wall_us, frozen?)``. Later calls pass straight through.
  * ``freeze()``: called when warmup ends. Every callable recorded after it
    is a violation of the closed set; ``strict`` mode raises on the spot,
    default mode accumulates them for ``assert_closed()``.
"""
from __future__ import annotations

import time

import torch


class JitAuditError(AssertionError):
    """A callable was minted after ``freeze()`` in strict mode."""


class JitAuditor:
    """Records every new callable (key + first-call wall time) and enforces
    the closed set after ``freeze()``."""

    def __init__(self, *, strict: bool = False, tracer=None):
        self.strict = strict
        self.tracer = tracer      # optional: new callables as trace instants
        self.compiles: list[dict] = []   # {key, wall_us, frozen}
        self.seen: set = set()
        self.frozen = False

    def wrap(self, key, fn, *, label: str | None = None):
        """Wrap a fresh callable so its first invocation is timed and
        recorded. Must be called at most once per key (the frontend's cache
        guarantees it)."""
        state = {"first": True}

        def wrapped(*args, **kwargs):
            if state["first"]:
                state["first"] = False
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                _block(out)
                self.record(key, (time.perf_counter() - t0) * 1e6,
                            label=label)
                return out
            return fn(*args, **kwargs)

        return wrapped

    def record(self, key, wall_us: float, *, label: str | None = None):
        """One new callable materialized (its first call)."""
        entry = {"key": _keyrepr(key), "wall_us": float(wall_us),
                 "frozen": self.frozen}
        if label:
            entry["label"] = label
        self.compiles.append(entry)
        self.seen.add(_keyrepr(key))
        if self.tracer is not None:
            self.tracer.instant("jit.compile", 0.0, cat="jit",
                                key=_keyrepr(key), wall_us=float(wall_us),
                                frozen=self.frozen)
        if self.frozen and self.strict:
            raise JitAuditError(
                f"callable {key!r} minted after freeze() "
                f"({wall_us / 1e3:.1f}ms): the closed set is broken")

    def freeze(self):
        """Warmup is over: any new callable from here on is a violation."""
        self.frozen = True

    @property
    def violations(self) -> list[dict]:
        return [c for c in self.compiles if c["frozen"]]

    def assert_closed(self):
        """Raise unless zero callables were minted after freeze()."""
        bad = self.violations
        if bad:
            keys = [c["key"] for c in bad]
            raise JitAuditError(
                f"{len(bad)} callable(s) minted after freeze(): {keys[:5]}")

    def snapshot(self) -> dict:
        """Stable schema for the metrics registry."""
        return {
            "n_variants": len(self.compiles),
            "n_violations": len(self.violations),
            "frozen": self.frozen,
            "compile_wall_us_total": float(
                sum(c["wall_us"] for c in self.compiles)),
            "compiles": [dict(c) for c in self.compiles],
        }


def _keyrepr(key):
    """Stable, JSON-able rendering of a cache key."""
    if isinstance(key, tuple):
        return tuple(_keyrepr(k) for k in key)
    if isinstance(key, (str, int, float, bool)) or key is None:
        return key
    return repr(key)


def _holds_cuda(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, (tuple, list)):
        return any(_holds_cuda(o) for o in out)
    return False


def _block(out):
    """Wait for the card when an output holds a CUDA tensor, so the first
    call's time includes its device work; host outputs are already done."""
    if _holds_cuda(out):
        torch.cuda.synchronize()
