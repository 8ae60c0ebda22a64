"""The port's RMQ (plain version and wrapper) against the JAX package:
``val`` bit-identical everywhere, ``pos`` wherever ``val < INF``; the
per-query ``RangeMin.query`` (``pos`` too) and the top-k over a range,
``topk_in_range`` and ``topk_in_range_batch``, bit-identical."""
import jax
import numpy as np
import pytest
import torch

from repro.core import rmq as jrmq
from repro.core.rmq import RangeMin as JaxRangeMin
from repro_torch.core import rmq as trmq
from repro.kernels.rmq.ref import rmq_window_batch as jax_window
from repro_torch.core.rmq import RangeMin
from repro_torch.kernels.rmq import ops as rmq_ops
from repro_torch.kernels.rmq.ref import floor_log2, rmq_window_batch

INF = 2**31 - 1


def test_floor_log2_is_exact():
    rng = np.random.default_rng(0)
    xs = np.concatenate([np.arange(1, 5000), 2 ** np.arange(31) - 1,
                         2 ** np.arange(31), rng.integers(1, 2**31 - 1, 5000)])
    xs = np.unique(xs[(xs >= 1) & (xs <= 2**31 - 1)])
    got = floor_log2(torch.tensor(xs, dtype=torch.int32)).numpy()
    want = np.array([int(x).bit_length() - 1 for x in xs])
    assert np.array_equal(got, want)


def _ranges(n, rng, B=600):
    p = rng.integers(-3, n + 3, B)
    q = rng.integers(-3, n + 3, B)
    short = rng.integers(0, 40, B // 4)
    p[: B // 4] = rng.integers(0, max(n, 1), B // 4)
    q[: B // 4] = p[: B // 4] + short                  # mostly single-block
    q[B // 4: B // 4 + 20] = p[B // 4: B // 4 + 20] - 1  # inverted by one
    return p.astype(np.int32), q.astype(np.int32)


@pytest.mark.parametrize("n", [1, 5, 127, 128, 129, 700, 5000])
def test_window_batch_and_query_batch_equal_jax(n):
    rng = np.random.default_rng(n)
    values = rng.integers(0, max(2, n // 3), n).astype(np.int32)  # many ties
    values[rng.integers(0, n, max(1, n // 10))] = INF
    jr = JaxRangeMin.build(values)
    tr = RangeMin.build(values, device="cpu")
    p, q = _ranges(n, rng)
    want_pos, want_val = jax.vmap(jr.query)(p, q)
    want_pos, want_val = np.asarray(want_pos), np.asarray(want_val)
    wp, wv = jax_window(jr.values, jr.ib.reshape(-1), jr.st_pos.reshape(-1),
                        p.clip(0, n - 1), q.clip(0, n - 1), n=n, levels=jr.levels,
                        n_blocks=jr.n_blocks, nb_stride=jr.n_blocks,
                        n_pad=jr.values.shape[0])
    tp, tq = torch.from_numpy(p), torch.from_numpy(q)
    before = rmq_ops.launches
    for use_kernel in (False, True):    # on the CPU the wrapper runs the plain version
        pos, val = tr.query_batch(tp, tq, use_kernel=use_kernel)
        pos, val = pos.numpy(), val.numpy()
        assert np.array_equal(val, want_val)
        live = want_val < INF
        assert np.array_equal(pos[live], want_pos[live])
    assert rmq_ops.launches == before
    pos, val = rmq_window_batch(tr.values, tr.ib, tr.st_pos, tp.clamp(0, n - 1),
                                tq.clamp(0, n - 1), n=n)
    assert np.array_equal(val.numpy(), np.asarray(wv))
    assert np.array_equal(pos.numpy(), np.asarray(wp))


def _structures(n, seed):
    rng = np.random.default_rng(seed)
    values = rng.integers(0, max(2, n // 3), n).astype(np.int32)  # many ties
    values[rng.integers(0, n, max(1, n // 10))] = INF
    return JaxRangeMin.build(values), RangeMin.build(values, device="cpu"), rng


@pytest.mark.parametrize("n", [1, 129, 5000])
def test_per_query_form_equals_jax(n):
    jr, tr, rng = _structures(n, n + 1)
    p, q = _ranges(n, rng, B=160)
    wp, wv = jax.jit(jax.vmap(jr.query))(p, q)
    got = [tuple(int(x) for x in tr.query(a, b)) for a, b in zip(p, q)]
    assert got == list(zip(np.asarray(wp).tolist(), np.asarray(wv).tolist()))


@pytest.mark.parametrize("k", [1, 10])
def test_topk_in_range_equals_jax(k):
    n = 700
    jr, tr, rng = _structures(n, k)
    p, q = _ranges(n, rng, B=24)
    q = np.where(np.arange(q.size) % 4 == 0, q, q + 1)  # half-open ranges
    wv, wp = jax.jit(jax.vmap(lambda a, b: jrmq.topk_in_range(jr, a, b, k)))(p, q)
    got = [trmq.topk_in_range(tr, a, b, k) for a, b in zip(p, q)]
    assert np.array_equal(np.stack([v.numpy() for v, _ in got]), np.asarray(wv))
    assert np.array_equal(np.stack([x.numpy() for _, x in got]), np.asarray(wp))
    assert (np.asarray(wv) < INF).any()
    bv, bp = jrmq.topk_in_range_batch(jr, p, q, k)
    tv, tp_ = trmq.topk_in_range_batch(tr, torch.from_numpy(p), torch.from_numpy(q), k)
    assert np.array_equal(tv.numpy(), np.asarray(bv))
    assert np.array_equal(tp_.numpy(), np.asarray(bp))
