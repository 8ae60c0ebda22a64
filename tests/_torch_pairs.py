"""Shared inputs for the port's parity tests: one corpus built by the JAX
package and carried into the port on identical arrays, plus partial-query
batches. Inputs are made from seeds with numpy and passed between the two
packages as numpy arrays."""
import dataclasses
import functools

import jax
import numpy as np
import torch

from repro.core import build_qac_index
from repro.core.codecs import pack_postings
from repro.core.search import conjunctive_multi_batch as jax_multi
from repro.text import SynthLogConfig, generate_query_log
from repro_torch.convert import COMPONENTS, qac_index_from_arrays


def qac_index_to_arrays(qidx) -> tuple[dict[str, np.ndarray], dict]:
    """(arrays, meta) of a JAX or a port ``QACIndex``, as
    ``qac_index_from_arrays`` takes them: each leaf through ``np.asarray``
    (a tensor through ``.cpu().numpy()``), the packed postings flattened to
    ``index.packed.<field>``; fields that are None (an index built without
    compressed postings) are left out."""
    arrays, meta = {}, {"k_default": int(qidx.k_default)}

    def flatten(obj, prefix):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            key = f"{prefix}.{f.name}"
            if v is None:
                continue
            if isinstance(v, (int, str)):
                meta[key] = v
            elif dataclasses.is_dataclass(v):
                flatten(v, key)
            elif isinstance(v, torch.Tensor):
                arrays[key] = v.cpu().numpy()
            else:
                arrays[key] = np.asarray(v)

    for comp in COMPONENTS:
        flatten(getattr(qidx, comp), comp)
    return arrays, meta


def build_pair(n_queries, vocab_size, seed, mean_term_chars=4.0,
               postings_codec=None):
    """-> (JAX QACIndex, port QACIndex on the CPU, kept query strings), the
    JAX index built with ``postings_codec`` and carried over as arrays."""
    qs, sc = generate_query_log(SynthLogConfig(
        n_queries=n_queries, vocab_size=vocab_size,
        mean_term_chars=mean_term_chars, seed=seed))
    jq, kept, _ = build_qac_index(qs, sc, postings_codec=postings_codec)
    arrays, meta = qac_index_to_arrays(jq)
    return jq, qac_index_from_arrays(arrays, meta, device="cpu"), kept


def with_codec(jq, codec):
    """(the JAX index with its postings packed as ``codec``, the port's copy
    of it on the CPU). The raw postings and every other array are shared."""
    if jq.index.packed is None or jq.index.packed.codec != codec:
        pk = pack_postings(np.asarray(jq.index.postings), codec)
        jq = dataclasses.replace(jq, index=dataclasses.replace(jq.index, packed=pk))
    return jq, qac_index_from_arrays(*qac_index_to_arrays(jq), device="cpu")


def without_list(jq, term):
    """(the JAX index with ``term``'s postings list emptied, as a stripe that
    holds none of them sees it, the port's copy of it on the CPU). A lane
    that needs the term beside another empty list is dead."""
    idx = jq.index
    post, offs = np.asarray(idx.postings), np.asarray(idx.offsets)
    s, e = int(offs[term]), int(offs[term + 1])
    offs = np.where(np.arange(offs.size) > term, offs - (e - s), offs).astype(np.int32)
    minimal = np.asarray(idx.minimal).copy()
    minimal[term] = 2**31 - 1
    post = np.concatenate([post[:s], post[e:]])
    idx = dataclasses.replace(
        idx, postings=post, offsets=offs, minimal=minimal, n_postings=int(post.size),
        packed=None if idx.packed is None else pack_postings(post, idx.packed.codec))
    jq = dataclasses.replace(jq, index=idx)
    return jq, qac_index_from_arrays(*qac_index_to_arrays(jq), device="cpu")


def jax_multi_answers(jq, pids, plen, tl, th, iters):
    """-> want(k, tile, max_tiles): JAX's ``conjunctive_multi_batch`` (plain
    probes at depth ``iters``) on these lanes, as numpy, each computed once."""
    cache = {}

    def want(k, tile, max_tiles):
        if (k, tile, max_tiles) not in cache:
            cache[k, tile, max_tiles] = host(jax.jit(functools.partial(
                jax_multi, k=k, tile=tile, max_tiles=max_tiles, use_kernel=False,
                probe_iters=iters))(jq.index, jq.completions, host(pids), host(plen),
                                    host(tl), host(th)))
        return cache[k, tile, max_tiles]
    return want


def partials(kept, rng, B, pct_single=50, pct_garbage=0):
    """Random partial queries: pct_single% single-term, pct_garbage% with a
    suffix that matches no term (an empty term range), the rest multi-term."""
    multis = [q for q in kept if len(q.split()) >= 2] or kept
    out = []
    for _ in range(B):
        r = rng.integers(0, 100)
        if r < pct_garbage:
            out.append("zzzzzzqx" if rng.integers(0, 2) else
                       kept[rng.integers(0, len(kept))].split()[0] + " zzzzzzqx")
        elif r < pct_garbage + pct_single:
            t = kept[rng.integers(0, len(kept))].split()[0]
            out.append(t[: rng.integers(1, len(t) + 1)])
        else:
            toks = multis[rng.integers(0, len(multis))].split()
            cut = rng.integers(1, len(toks[-1]) + 1)
            out.append(" ".join(toks[:-1] + [toks[-1][:cut]]))
    return out


def host(x):
    """numpy view of a JAX array, a tensor or a numpy array."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def complete_rows(fe, reqs, batch=256, pad=True):
    """Each request's row of an uncached ``fe.complete`` at its own k (a
    JAX or a port ``QACFrontend``): the requests grouped by k and by class,
    each group in class-pure batches of ``batch``, with ``pad`` the last
    padded by repeating its rows, so a JAX frontend compiles one bucket per
    class and k. A lane's answer depends on its own inputs only, so this
    equals one call per request."""
    out = [None] * len(reqs)
    groups = {}
    for i, r in enumerate(reqs):
        groups.setdefault((r.k, r.plen > 0), []).append(i)
    for (k, _), idx in sorted(groups.items()):
        for s in range(0, len(idx), batch):
            part = idx[s:s + batch]
            rs = [reqs[i] for i in (np.resize(np.asarray(part), batch) if pad else part)]
            got = host(fe.complete(np.stack([r.pids for r in rs]),
                                   np.asarray([r.plen for r in rs], np.int32),
                                   np.stack([r.suf for r in rs]),
                                   np.asarray([r.slen for r in rs], np.int32), k=k))
            for j, i in enumerate(part):
                out[i] = got[j, :k].copy()
    return out


class RowOracle:
    """``complete_rows`` of one frontend with each (parsed key, k) computed
    once across calls: the uncached answer a served row must equal.
    ``batch`` 8, the frontend's smallest bucket, lets a JAX oracle share its
    compiled callables with a JAX runtime on the same frontend."""

    def __init__(self, fe, pad=True, batch=256):
        self.fe, self.pad, self.batch = fe, pad, batch
        self.rows = {}

    def __call__(self, reqs):
        todo = list({(r.key, r.k): r for r in reqs
                     if (r.key, r.k) not in self.rows}.values())
        for r, row in zip(todo, complete_rows(self.fe, todo, batch=self.batch,
                                              pad=self.pad)):
            self.rows[r.key, r.k] = row
        return [self.rows[r.key, r.k] for r in reqs]


def as_jax_requests(reqs):
    """The port's ``QACRequest``s as the JAX package's, field for field
    (``test_torch_runtime.py`` holds ``prepare_requests`` of the two
    packages equal), so a JAX runtime or cluster replays the same trace
    without compiling its own parse for every trace length."""
    from repro.serve.runtime import QACRequest
    return [QACRequest(**{f.name: getattr(r, f.name) for f in dataclasses.fields(r)})
            for r in reqs]
