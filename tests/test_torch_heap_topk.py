"""The port's single-term engine against the JAX package: the plain
``heap_topk_ref`` against JAX's ``heap_topk_ref`` (``out`` and ``done``),
and every route of ``single_term_topk_bounded_batch`` against JAX's, over
empty, inverted and full term ranges and duplicate-docid trip starvation."""
import ctypes
import functools
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.search import single_term_topk_bounded_batch as jax_bounded
from repro.kernels.heap_topk.ref import heap_topk_ref as jax_heap_ref
from repro_torch.core import parse_queries
from repro_torch.core.search import single_term_topk_bounded_batch
from repro_torch.kernels.heap_topk import ops as heap_ops
from repro_torch.kernels.heap_topk.ref import heap_topk_ref
from repro_torch.kernels.rmq import ops as rmq_ops

from _torch_pairs import build_pair, host, partials


@pytest.fixture(scope="module")
def pair():
    # small vocab => heavy term co-occurrence => duplicate docids across the
    # lists of a suffix range (the dedup / trip-starvation stressor)
    jq, tq, kept = build_pair(500, 80, seed=9)
    rng = np.random.default_rng(0)
    _, _, _, suf, slen = parse_queries(tq.dictionary,
                                       partials(kept, rng, 90, 100, 25))
    tl, th = tq.dictionary.locate_prefix(suf, slen)
    V = tq.index.n_terms
    extra_lo = torch.tensor([1, 5, 7, 0, V, V + 1, 3], dtype=torch.int32)
    extra_hi = torch.tensor([V + 1, 3, 7, 2, V + 1, V + 2, 4], dtype=torch.int32)
    return jq, tq, torch.cat([tl, extra_lo]), torch.cat([th, extra_hi])


CASES = [(k, t) for k in (1, 10, 16) for t in (k + 2, 2 * k)]


@pytest.mark.parametrize("k,trips", CASES)
def test_plain_heap_topk_equals_jax(pair, k, trips):
    jq, tq, tl, th = pair
    rm, idx = tq.rmq_minimal, tq.index
    out, done = heap_topk_ref(rm.values, rm.st_pos, rm.ib, idx.offsets,
                              idx.postings, tl, th, k=k, trips=trips, n=rm.n,
                              n_terms=idx.n_terms)
    jrm, jidx = jq.rmq_minimal, jq.index
    ref = jax.jit(functools.partial(jax_heap_ref, k=k, trips=trips, n=jrm.n,
                                    n_terms=jidx.n_terms))
    want_out, want_done = ref(jrm.values, jrm.st_pos, jrm.ib, jidx.offsets,
                              jidx.postings, tl.numpy(), th.numpy())
    assert np.array_equal(out.numpy(), host(want_out))
    assert np.array_equal(done.numpy(), host(want_done))
    if k > 1 and trips == k + 2:
        assert not done.all()       # the corpus starves some lane's budget


@pytest.mark.parametrize("k,trips", [(10, 12), (10, 20), (16, 18), (16, 32)])
def test_every_route_equals_jax_engine(pair, k, trips):
    jq, tq, tl, th = pair
    want_out, want_done = jax.jit(functools.partial(
        jax_bounded, k=k, trips=trips, use_kernel=False))(
        jq.index, jq.rmq_minimal, tl.numpy(), th.numpy())
    counts = (heap_ops.launches, rmq_ops.launches)
    for kw in (dict(use_kernel=False), dict(use_kernel=True),
               dict(use_kernel=True, heap_kernel=False)):
        out, done = single_term_topk_bounded_batch(
            tq.index, tq.rmq_minimal, tl, th, k, trips, **kw)
        assert np.array_equal(out.numpy(), host(want_out)), kw
        assert np.array_equal(done.numpy(), host(want_done)), kw
    # CPU tensors: the wrappers ran their plain versions, no kernel launched
    assert (heap_ops.launches, rmq_ops.launches) == counts


def test_plan_fits_every_budget_the_frontend_forms():
    """k = 1..128 (the frontend's k buckets top out at 128) and every trip
    budget up to its 2k fallback, trips = 0 included: each plan fits a block's
    232,448 shared bytes with every lane's cap = 2*trips + 1 slots."""
    for k in range(1, 129):
        for trips in range(0, 2 * k + 1):
            plan = heap_ops.plan_heap_launch(k, trips)
            lane = heap_ops.SLOT_FIELDS * 4 * (2 * trips + 1)
            assert 1 <= plan.warps <= heap_ops.MAX_WARPS
            assert plan.smem == plan.warps * lane <= 232_448, (k, trips)
    # the largest budget: k=128, trips=256, cap=513 (10,260 bytes a lane)
    assert heap_ops.plan_heap_launch(128, 256).smem == 4 * 10_260


@pytest.mark.parametrize("B", [1, 31, 256, 300])
@pytest.mark.parametrize("k,trips", [(1, 0), (10, 12), (128, 256), (1, 6000)])
def test_plan_gives_every_lane_a_warp(B, k, trips):
    """Lane b runs on warp b % warps of block b // warps: every lane of the
    batch has its own warp inside the grid, and no block is all spare."""
    plan = heap_ops.plan_heap_launch(k, trips, B)
    warps_of = {(b // plan.warps, b % plan.warps) for b in range(B)}
    assert len(warps_of) == B
    assert all(blk < plan.blocks and w < plan.warps for blk, w in warps_of)
    assert (plan.blocks - 1) * plan.warps < B <= plan.blocks * plan.warps


def test_plan_refuses_what_the_kernel_does_not_take():
    for k, trips in [(0, 4), (3, -1)]:
        with pytest.raises(ValueError):
            heap_ops.plan_heap_launch(k, trips)
    # one lane's slots past a block's shared memory: one warp, which the card
    # refuses at launch (the wrapper raises its CUDA error)
    plan = heap_ops.plan_heap_launch(1, 6000)
    assert plan.warps == 1 and plan.smem > 232_448


@pytest.mark.parametrize("k,trips", [(10, 12), (16, 32)])
def test_trip_count_is_the_loop_the_kernel_runs(pair, k, trips):
    """``count_trips``: no lane runs more trips than the budget, and cutting
    the budget to the most any lane ran changes neither ``out`` nor ``done``:
    the kernel's loop, which stops at k emitted or an INF pop, runs no more."""
    _, tq, tl, th = pair
    rm, idx = tq.rmq_minimal, tq.index
    args = (rm.values, rm.st_pos, rm.ib, idx.offsets, idx.postings, tl, th)
    kw = dict(k=k, n=rm.n, n_terms=idx.n_terms)
    out, done, ran = heap_topk_ref(*args, trips=trips, **kw, count_trips=True)
    most = int(ran.max())
    assert 0 < most <= trips
    assert not bool((ran[tl >= th] > 0).any())          # empty ranges pop nothing
    cut_out, cut_done = heap_topk_ref(*args, trips=most, **kw)
    assert torch.equal(cut_out, out) and torch.equal(cut_done, done)


@pytest.mark.parametrize("fn,argtypes", [("heap_topk_launch", heap_ops._ARGS),
                                         ("heap_topk_packed_launch", heap_ops._PACKED_ARGS)])
def test_launchers_take_what_the_wrappers_pass(fn, argtypes):
    """The C launchers in csrc/heap_topk.cu take as many parameters as the
    ctypes bindings declare (the plan's blocks, warps and shared bytes among
    them), pointers where they pass pointers: no compiler checks this."""
    src = (Path(heap_ops.__file__).parents[2] / "csrc" / "heap_topk.cu").read_text()
    params = re.search(rf"int {fn}\(([^)]*)\)", src).group(1).split(",")
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        assert ("*" in p) == (t is ctypes.c_void_p), p
