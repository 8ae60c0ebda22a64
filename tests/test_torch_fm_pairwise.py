"""The port's plain ``fm_pairwise`` against the JAX package's: its Pallas
kernel in interpret mode and its ``fm_pairwise_ref``, on the same inputs
made with numpy from a seed.

Tolerance: rtol 1e-5 and atol 1e-6, the atol scaled by the size of the two
sums that the sum-square identity subtracts, ``1 + sum_d (s_d^2 + sq_d)``.
The result is their difference, so fp32 rounding in another summation
order is of their size and not of the result's: at the unit-normal inputs
of ``tests/test_kernels.py`` the JAX package's own kernel and reference
differ by up to 1.5e-4 on results near 0. At the scale of the models'
embeddings (0.02 * N(0, 1)) the unscaled 1e-5 / 1e-6 holds, and is tested.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fm_pairwise.ops import fm_pairwise as jax_fm_pairwise
from repro.kernels.fm_pairwise.ref import fm_pairwise_ref as jax_fm_pairwise_ref
from repro_torch.kernels.fm_pairwise import ops
from repro_torch.kernels.fm_pairwise.ref import fm_pairwise_ref

RTOL, ATOL = 1e-5, 1e-6


def assert_fm_close(got, want, e, scaled=True):
    e = np.asarray(e, np.float64)
    scale = 1 + (e.sum(1) ** 2 + (e * e).sum(1)).sum(1) if scaled else 1.0
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    bound = RTOL * np.abs(np.asarray(want, np.float64)) + ATOL * scale
    assert (err <= bound).all(), f"max err {err.max()}, worst ratio {(err / bound).max()}"


def _pair(rng, shape, dtype, scale=1.0):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    je = jnp.asarray(rng.normal(size=shape) * scale, getattr(jnp, dtype))
    e32 = np.array(je.astype(jnp.float32))
    return je, torch.from_numpy(e32).to(getattr(torch, dtype)), e32


@pytest.mark.parametrize("B,F,D,dtype", [(256, 39, 16, "float32"),
                                         (512, 8, 64, "float32"),
                                         (256, 39, 16, "bfloat16")])
def test_plain_matches_jax_kernel_and_ref(B, F, D, dtype):
    rng = np.random.default_rng(B + F)
    je, te, e32 = _pair(rng, (B, F, D), dtype)
    before = ops.launches
    got = ops.fm_pairwise(te)              # a CPU tensor: the plain version
    assert ops.launches == before
    assert got.dtype == torch.float32 and got.shape == (B,)
    assert torch.equal(got, fm_pairwise_ref(te))
    assert_fm_close(got, jax_fm_pairwise(je, use_kernel=True, interpret=True), e32)
    assert_fm_close(got, jax_fm_pairwise_ref(je), e32)


@pytest.mark.parametrize("B,F,D", [(300, 39, 10), (512, 39, 10), (64, 64, 128)])
def test_plain_matches_jax_at_embedding_scale(B, F, D):
    """At the models' embedding scale the unscaled tolerance holds; B=300 is
    no multiple of the TPU kernel's 256-row tile and goes to the JAX ref."""
    rng = np.random.default_rng(B)
    je, te, e32 = _pair(rng, (B, F, D), "float32", scale=0.02)
    got = ops.fm_pairwise(te)
    assert_fm_close(got, jax_fm_pairwise_ref(je), e32, scaled=False)
    if B % 256 == 0:
        assert_fm_close(got, jax_fm_pairwise(je, use_kernel=True, interpret=True), e32,
                        scaled=False)


def test_plain_equals_explicit_pairs_and_empty_batch():
    """Sum-square identity == explicit sum over field pairs (float64)."""
    rng = np.random.default_rng(3)
    e = rng.normal(size=(8, 10, 6)).astype(np.float32)
    got = ops.fm_pairwise(torch.from_numpy(e))
    e64 = e.astype(np.float64)
    want = sum((e64[:, i] * e64[:, j]).sum(-1) for i in range(10) for j in range(i + 1, 10))
    assert_fm_close(got, want, e)
    empty = ops.fm_pairwise(torch.zeros((0, 39, 10)))
    assert empty.shape == (0,) and empty.dtype == torch.float32
