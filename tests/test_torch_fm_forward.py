"""FM's whole forward from the ids: the port's ``fm_forward_ref`` (the plain
version of the one-launch ``fm_forward`` kernel) against the JAX package's
``FMModel.forward`` on the same weights (``recsys_params_from_arrays``) and
the same ids, made with numpy from a seed, with the Pallas kernel in
interpret mode; the CPU wrapper and the model's plain route against it; and
``plan_fm_forward``, the kernel's launch shape, against the rule that every
(field, d) of a row is read by exactly one lane.

Ids include negatives >= -V (they wrap once), negatives < -V (clamped to
row 0 after the wrap) and ids >= V (clamped to row V-1), as JAX's
numpy-style indexing does. Tolerance: rtol 1e-5, atol 1e-6, as
``test_torch_recsys.py`` holds FM.
"""
import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.recsys_common import MODEL_CLS as JAX_MODEL_CLS
from repro_torch import configs
from repro_torch.convert import recsys_params_from_arrays
from repro_torch.kernels.fm_pairwise import ops
from repro_torch.kernels.fm_pairwise.ref import fm_forward_ref, fm_pairwise_ref

RTOL, ATOL = 1e-5, 1e-6
# the smoke width, and FM's own F and D over a small vocabulary
WIDTHS = {"smoke": {}, "fm-f39-d10": dict(n_sparse=39, embed_dim=10, field_vocab=50)}


@functools.lru_cache(maxsize=None)
def _pair(width):
    """(JAX model, its params, the port's model on the same weights); the
    bias is set to 0.3 so that it is read."""
    jcfg = dataclasses.replace(jax_get_arch("fm").smoke_cfg, use_kernel=True,
                               **WIDTHS[width])
    jm = JAX_MODEL_CLS["fm"](jcfg)
    params = dict(jm.init_params(jax.random.PRNGKey(11)), bias=jnp.float32(0.3))
    tcfg = dataclasses.replace(configs.get_arch("fm").smoke_cfg, **WIDTHS[width])
    tm = recsys_params_from_arrays(tcfg, {k: np.asarray(v) for k, v in params.items()},
                                   device="cpu")
    return jm, params, tm


def _ids(F, V, B=64, seed=5):
    """int32 [B, F] in range, with every kind of out-of-range id mixed in."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, size=(B, F)).astype(np.int32)
    bad = np.array([-1, -V, -V - 1, -3 * V, -(2**31), V, V + 7, 2**31 - 1], np.int32)
    mask = rng.random((B, F)) < 0.3
    ids[mask] = rng.choice(bad, size=int(mask.sum()))
    return ids


def _args(tm, ids):
    return torch.from_numpy(ids), tm.tables, tm.linear, tm.bias


@pytest.mark.parametrize("width", list(WIDTHS))
def test_fm_forward_ref_matches_jax_model(width):
    jm, params, tm = _pair(width)
    n_f, V, _ = tm.tables.shape
    ids = _ids(n_f, V)
    want = np.asarray(jm.forward(params, {"sparse_ids": jnp.asarray(ids)}))
    with torch.inference_mode():
        got = fm_forward_ref(*_args(tm, ids))
    assert got.dtype == torch.float32 and got.shape == (64,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_fm_forward_on_cpu_is_the_plain_version(width):
    """Bit for bit, and neither launch counter moves."""
    _, _, tm = _pair(width)
    n_f, V, _ = tm.tables.shape
    args = _args(tm, _ids(n_f, V, seed=6))
    before = (ops.launches, ops.forward_launches)
    with torch.inference_mode():
        got = ops.fm_forward(*args)
        want = fm_forward_ref(*args)
    assert (ops.launches, ops.forward_launches) == before
    assert torch.equal(got, want)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_fm_model_routes_are_fm_forward_ref(width):
    """The model's plain route is fm_forward_ref; its kernel route on CPU
    tensors is the same plain version."""
    _, _, tm = _pair(width)
    n_f, V, _ = tm.tables.shape
    ids = _ids(n_f, V, seed=7)
    with torch.inference_mode():
        want = fm_forward_ref(*_args(tm, ids))
        assert tm.use_kernel is False
        plain = tm({"sparse_ids": torch.from_numpy(ids)})
        tm.use_kernel = True
        try:
            routed = tm({"sparse_ids": torch.from_numpy(ids)})
        finally:
            tm.use_kernel = False
    assert torch.equal(plain, want) and torch.equal(routed, want)


def test_fm_forward_empty_batch():
    _, _, tm = _pair("smoke")
    ids = torch.zeros((0, tm.tables.shape[0]), dtype=torch.int32)
    before = ops.forward_launches
    out = ops.fm_forward(ids, tm.tables, tm.linear, tm.bias)
    assert out.shape == (0,) and out.dtype == torch.float32
    assert ops.forward_launches == before


def test_fm_forward_ref_bf16_dtype_steps():
    """The steps the kernel reproduces in bf16: the linear sum rounded to
    bf16, bias + lin rounded to bf16, then the fp32 pair term added."""
    _, _, tm = _pair("fm-f39-d10")
    n_f, V, _ = tm.tables.shape
    ids = torch.from_numpy(_ids(n_f, V, seed=8))
    t, lw, b = (x.detach().to(torch.bfloat16) for x in (tm.tables, tm.linear, tm.bias))
    got = fm_forward_ref(ids, t, lw, b)
    i = torch.where(ids.long() < 0, ids.long() + V, ids.long()).clamp(0, V - 1)
    f = torch.arange(n_f)
    lin = lw[f, i, 0].float().sum(-1).to(torch.bfloat16)
    head = (b.float() + lin.float()).to(torch.bfloat16).float()
    want = head + fm_pairwise_ref(t[f, i])
    assert got.dtype == torch.float32 and torch.equal(got, want)


def _reads(plan, F, D, elt):
    """How often the kernel's loops, as written in csrc/fm_pairwise.cu, read
    each (field, d) of one row: lane (dl, fl) takes fields fl, fl + lanes_f,
    ... and loads dl, dl + lanes_d, ... of the row's D * elt / vec loads."""
    per = plan.vec // elt
    loads = max(1, ops.ELTS_PER_LANE // per)
    count = np.zeros((F, D), np.int64)
    for dl, fl in itertools.product(range(plan.lanes_d), range(plan.lanes_f)):
        for f in range(fl, F, plan.lanes_f):
            for c in range(loads):
                chunk = dl + c * plan.lanes_d
                if chunk < D // per:
                    count[f, chunk * per:(chunk + 1) * per] += 1
    return count


@pytest.mark.parametrize("elt,align", [(4, 16), (4, 4), (2, 16), (2, 2)])
def test_plan_fm_forward_reads_every_element_once(elt, align):
    for B, F, D in itertools.product((1, 300, 4099, 1 << 20), (1, 13, 39, 64),
                                     (1, 8, 10, 17, 64, 127, 128)):
        p = ops.plan_fm_forward(B, F, D, elt, align)
        group = p.lanes_d * p.lanes_f
        assert group <= 32 and group & (group - 1) == 0 and p.rows * group == ops.THREADS
        assert (D * elt) % p.vec == 0 and align % p.vec == 0 and p.vec >= elt
        assert p.blocks * p.rows >= B > (p.blocks - 1) * p.rows
        assert p.shared_bytes == p.rows * F * 4 <= 48 * 1024
        assert p.lanes_f == 1 or (p.lanes_f < 2 * F and B * group // 2 < ops.FILL_THREADS)
        assert (_reads(p, F, D, elt) == 1).all(), (B, F, D, p)


def test_plan_fm_forward_at_fm_width():
    """FM (F=39, D=10, fp32): 8-byte loads and a thread per row at bulk; the
    fields split over 32 lanes at B = 512; 4-byte loads in bf16."""
    assert ops.plan_fm_forward(1 << 20, 39, 10, 4, 256) == ops.ForwardPlan(
        8, 1, 1, 128, 8192, 128 * 39 * 4)
    assert ops.plan_fm_forward(512, 39, 10, 4, 256) == ops.ForwardPlan(
        8, 1, 32, 4, 128, 4 * 39 * 4)
    assert ops.plan_fm_forward(262_144, 39, 10, 2, 256).vec == 4
