"""Class-routed batched QAC serving frontend.

The frontend routes on the host:

  1. **partition** the incoming batch by query class — single-term
     (``prefix_len == 0``) vs multi-term (``prefix_len > 0``);
  2. **pad** each class sub-batch up to a power-of-two bucket size (cyclic
     replication of real rows, so padding adds no pathological lanes);
  3. **dispatch** each sub-batch to *only* its engine through a callable
     cached per (engine, bucket, k, list_pad) — single-term first runs a
     short trip budget and re-runs the whole sub-batch with the exact
     full-budget engine when any lane did not finish;
  4. **scatter** results back into request order.

It runs on the device of the index it is given. Results are bit-identical
to the JAX package's ``QACFrontend``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..backend import default_use_kernel
from ..core.builder import QACIndex
from ..core.search import _resolve_packed, describe_single_route
from ..core.types import INF_DOCID
from .qac import serve_multi_term, serve_single_term, serve_single_term_full


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def route_classes(prefix_len):
    """Host-side classification: (single_rows, multi_rows) index arrays."""
    plen = _host(prefix_len)
    return np.flatnonzero(plen <= 0), np.flatnonzero(plen > 0)


class QACFrontend:
    """Batched QAC completion with host-side class routing.

    ``trips`` is the single-term pop budget (default k + 2). ``use_kernel``
    (default: true on the card) picks the CUDA kernels over the plain
    PyTorch versions. The route rule on the card, measured on an H100 at
    B = 1, 8, 64 and 256: the single-term class takes the ``heap_topk``
    kernel (``heap_kernel`` None or True), which beat the per-pop RMQ
    route by ~80x in device time at every B; ``heap_kernel=False`` stays
    only as the tests' way to reach that per-pop reference. Both classes
    read raw postings unless ``postings_codec`` ("ef" or "bitpack") pins
    the index's compressed ones, decoded in the packed kernels (or their
    plain versions); the index must have been packed with that codec
    (``ValueError`` otherwise). None, "auto" and "raw" read raw CSR, the
    serving default: packed was no faster single-term and slower
    multi-term. ``specialize_list_pad`` derives the multi-term probe depth
    from the longest list each sub-batch probes instead of the longest list
    in the index; the online runtime and the cluster build frontends with
    False, so the set of dispatch callables stays closed. ``auditor`` (an
    ``obs.JitAuditor``) wraps every callable the frontend mints, so its
    first call is timed and one minted after ``auditor.freeze()`` is a
    recorded violation.
    """

    def __init__(self, qidx: QACIndex, *, k: int = 10, tile: int = 128,
                 max_tiles: int = 4096, min_bucket: int = 8,
                 trips: int | None = None, use_kernel: bool | None = None,
                 heap_kernel: bool | None = None,
                 specialize_list_pad: bool = True,
                 postings_codec: str | None = None, auditor=None):
        self.qidx = qidx
        self.postings_codec = postings_codec
        self._explicit_packed = _resolve_packed(qidx.index, postings_codec) is not None
        self.device = qidx.device
        self.k = k
        self.tile = tile
        self.max_tiles = max_tiles
        self.min_bucket = min_bucket
        self.trips = trips
        self.specialize_list_pad = specialize_list_pad
        self.use_kernel = (default_use_kernel(self.device) if use_kernel is None
                           else use_kernel)
        self.heap_kernel = heap_kernel
        offs = qidx.index.offsets.cpu().numpy()
        self._list_lens = (np.diff(offs) if offs.size > 1
                           else np.zeros(1, np.int64))
        max_list = int(self._list_lens.max()) if offs.size > 1 else 1
        self.list_pad = 1 << max(1, (max_list - 1).bit_length())
        self._cache = {}
        self.stats = {"requests": 0, "single_queries": 0, "multi_queries": 0,
                      "single_fallbacks": 0}
        self.auditor = auditor
        self._dispatch_log = None
        self._fwd_host = None

    def host_fwd_terms(self) -> np.ndarray:
        """The forward index (docid -> term row) on the host, copied from
        the device once per frontend; the online runtime's session filter
        reads it."""
        if self._fwd_host is None:
            self._fwd_host = self.qidx.completions.fwd_terms.cpu().numpy()
        return self._fwd_host

    def _multi_list_pad(self, pids, plen) -> int:
        """pow2 pad of the longest probe list THIS sub-batch can touch; it
        sets the probe depth ``list_pad.bit_length()``."""
        if not self.specialize_list_pad:
            return self.list_pad
        valid = np.arange(pids.shape[1])[None, :] < plen[:, None]
        terms = np.clip(pids[valid], 0, len(self._list_lens) - 1)
        max_list = int(self._list_lens[terms].max()) if terms.size else 1
        return 1 << max(1, (max(max_list, 1) - 1).bit_length())

    def _bucket(self, n: int) -> int:
        return max(self.min_bucket, 1 << (n - 1).bit_length())

    def describe_route(self, engine: str, bucket: int = 0,
                       list_pad: int = 0) -> str:
        """The kernel route a dispatch on ``engine`` takes: "heap_topk[raw]",
        "heap_topk[ef]", "heap_topk[bitpack]", "per_pop_rmq[kernel]",
        "intersect[raw]", "intersect[packed]" or "torch_ref"."""
        if engine in ("single", "single_full"):
            return describe_single_route(use_kernel=self.use_kernel,
                                         heap_kernel=self.heap_kernel,
                                         postings_codec=self.postings_codec)
        if engine == "multi":
            if not self.use_kernel:
                return "torch_ref"
            return "intersect[packed]" if self._explicit_packed else "intersect[raw]"
        return engine

    def begin_dispatch_log(self):
        """Start recording (cache key, route) per dispatch."""
        self._dispatch_log = []

    def end_dispatch_log(self) -> list:
        log, self._dispatch_log = self._dispatch_log or [], None
        return log

    def _get(self, engine: str, bucket: int, k: int, list_pad: int = 0):
        key = (engine, bucket, k, list_pad)
        if self._dispatch_log is not None:
            self._dispatch_log.append(
                (key, self.describe_route(engine, bucket, list_pad)))
        fn = self._cache.get(key)
        if fn is None:
            kw = dict(k=k, use_kernel=self.use_kernel,
                      postings_codec=self.postings_codec)
            if engine == "single":
                def fn(suf, slen):
                    out, done = serve_single_term(
                        self.qidx, suf, slen, trips=self.trips,
                        heap_kernel=self.heap_kernel, **kw)
                    return out, bool(done.all())   # one tiny host sync
            elif engine == "single_full":
                fn = lambda suf, slen: serve_single_term_full(
                    self.qidx, suf, slen, heap_kernel=self.heap_kernel, **kw)
            elif engine == "multi":
                fn = lambda pids, plen, suf, slen: serve_multi_term(
                    self.qidx, pids, plen, suf, slen, tile=self.tile,
                    max_tiles=self.max_tiles,
                    probe_iters=list_pad.bit_length(), **kw)
            else:
                raise ValueError(engine)
            if self.auditor is not None:
                fn = self.auditor.wrap(
                    key, fn, label=self.describe_route(engine, bucket, list_pad))
            self._cache[key] = fn
        return fn

    def _k_bucket(self, ki: int) -> int:
        """The default k stays exact; every other k rounds up to a power of
        two, so tail ks share a few cached callables and never inflate the
        default-k trip budget."""
        ki = int(ki)
        if ki == self.k:
            return ki
        return 1 << max(0, (ki - 1).bit_length())

    def _dev(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _run_single(self, bucket: int, k: int, suf, slen) -> np.ndarray:
        res, all_done = self._get("single", bucket, k)(suf, slen)
        if not all_done:
            # a lane needed more than `trips` pops (duplicate-docid run):
            # recompute the sub-batch with the exact full-budget engine
            self.stats["single_fallbacks"] += 1
            res = self._get("single_full", bucket, k)(suf, slen)
        return res.cpu().numpy()

    def complete(self, prefix_ids, prefix_len, suffix_chars, suffix_len, *,
                 k: int | np.ndarray | None = None) -> np.ndarray:
        """Routed batched Complete(): -> host docids int32[B, K] (INF padded),
        in the original request order.

        ``k`` may be a scalar (K = k) or a per-request int array: K = max(k),
        row i holds its exact k[i]-result in columns [0, k[i]) and INF beyond
        — bit-identical to a scalar call at k[i], because the engines' top-k
        is prefix-stable. Inputs may be tensors or host arrays.
        """
        k = self.k if k is None else k
        karr = np.asarray(k)
        if karr.ndim:
            karr = karr.astype(np.int64).reshape(-1)
            if karr.size == 0:
                return np.full((0, 0), INF_DOCID, np.int32)
            if bool((karr == self.k).all()):
                return self._complete_scalar(prefix_ids, prefix_len,
                                             suffix_chars, suffix_len, self.k)
            return self._complete_per_k(prefix_ids, prefix_len, suffix_chars,
                                        suffix_len, karr)
        return self._complete_scalar(prefix_ids, prefix_len, suffix_chars,
                                     suffix_len, int(karr))

    def _complete_per_k(self, prefix_ids, prefix_len, suffix_chars,
                        suffix_len, karr):
        """Mixed-k batch: dispatch each pow2 k-bucket's rows separately."""
        pids, plen = _host(prefix_ids), _host(prefix_len)
        suf, slen = _host(suffix_chars), _host(suffix_len)
        B = plen.shape[0]
        kmax = int(karr.max())
        out = np.full((B, kmax), INF_DOCID, np.int32)
        buckets = np.asarray([self._k_bucket(ki) for ki in karr])
        for kb in np.unique(buckets):
            idx = np.flatnonzero(buckets == kb)
            sub = self._complete_scalar(pids[idx], plen[idx], suf[idx],
                                        slen[idx], int(kb))
            w = min(int(kb), kmax)
            cols = np.arange(w)
            out[idx[:, None], cols[None, :]] = np.where(
                cols[None, :] < karr[idx][:, None], sub[:, :w], INF_DOCID)
        return out

    def _complete_scalar(self, prefix_ids, prefix_len, suffix_chars,
                         suffix_len, k: int) -> np.ndarray:
        plen = _host(prefix_len)
        B = plen.shape[0]
        single_rows, multi_rows = route_classes(plen)
        self.stats["requests"] += 1
        self.stats["single_queries"] += int(single_rows.size)
        self.stats["multi_queries"] += int(multi_rows.size)

        # class-pure batch already at a bucket size: dispatch inputs as-is
        if single_rows.size == B and self._bucket(B) == B:
            return self._run_single(B, k, self._dev(suffix_chars),
                                    self._dev(suffix_len))
        pids = _host(prefix_ids)
        if multi_rows.size == B and self._bucket(B) == B:
            lp = self._multi_list_pad(pids, plen)
            return self._get("multi", B, k, lp)(
                self._dev(prefix_ids), self._dev(plen),
                self._dev(suffix_chars), self._dev(suffix_len)).cpu().numpy()

        suf, slen = _host(suffix_chars), _host(suffix_len)
        out = np.full((B, k), INF_DOCID, np.int32)
        if single_rows.size:
            pad = np.resize(single_rows, self._bucket(single_rows.size))
            res = self._run_single(len(pad), k, self._dev(suf[pad]),
                                   self._dev(slen[pad]))
            out[single_rows] = res[: single_rows.size]
        if multi_rows.size:
            pad = np.resize(multi_rows, self._bucket(multi_rows.size))
            lp = self._multi_list_pad(pids[pad], plen[pad])
            res = self._get("multi", len(pad), k, lp)(
                self._dev(pids[pad]), self._dev(plen[pad]),
                self._dev(suf[pad]), self._dev(slen[pad]))
            out[multi_rows] = res.cpu().numpy()[: multi_rows.size]
        return out
