"""The port's RMQ (plain version and wrapper) against the JAX package:
``val`` bit-identical everywhere, ``pos`` wherever ``val < INF``."""
import jax
import numpy as np
import pytest
import torch

from repro.core.rmq import RangeMin as JaxRangeMin
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
