"""The backward kernels' plain versions, and the autograd Functions around
the kernels on the CPU, against the JAX package's autodiff: ``jax.vjp`` of
its ``flash_attention_ref`` and ``jax.grad`` of its ``fm_pairwise_ref``, on
inputs made with numpy from a seed.

Covered: causal, the decode offset (Sq < Skv), a sliding window, the softcap
(with scores wide enough that it bends them), GQA (dK and dV summed over a
group's heads), rows with no visible column (Sq > Skv: a zero gradient) and
no causal mask. Tolerance: fp32, rtol and atol 2e-5 (the same products summed
in another order by XLA and by torch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref as jax_attention_ref
from repro.kernels.fm_pairwise.ref import fm_pairwise_ref as jax_fm_pairwise_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
from repro_torch.kernels.fm_pairwise import ops as fm_ops
from repro_torch.kernels.fm_pairwise.ref import fm_pairwise_bwd_ref

TOL = dict(rtol=2e-5, atol=2e-5)

CASES = {   # B, H, G, Sq, Skv, D, causal, window, softcap, q scale
    "causal gqa": (2, 4, 2, 48, 48, 32, True, 0, 0.0, 1.0),
    "decode offset": (1, 6, 3, 17, 64, 64, True, 0, 0.0, 1.0),
    "window": (1, 4, 1, 70, 70, 32, True, 19, 0.0, 1.0),
    "softcap bends": (1, 4, 2, 40, 40, 64, True, 0, 5.0, 6.0),
    "window softcap gqa": (2, 8, 4, 33, 50, 32, True, 12, 30.0, 8.0),
    "no visible column": (1, 2, 1, 40, 24, 32, True, 0, 0.0, 1.0),
    "not causal": (1, 4, 2, 30, 45, 32, False, 0, 2.0, 2.0),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """Small shapes: one intra-op thread. Under the suite's parallel workers
    torch's default thread pool oversubscribes the cores, and a loop of tiny
    ops then runs tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, seed=0):
    B, H, G, Sq, Skv, D, causal, window, softcap, qs = CASES[case]
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, H, Sq, D)) * qs).astype(np.float32)
    k = rng.normal(size=(B, G, Skv, D)).astype(np.float32)
    v = rng.normal(size=(B, G, Skv, D)).astype(np.float32)
    do = rng.normal(size=(B, H, Sq, D)).astype(np.float32)
    return (q, k, v, do), dict(causal=causal, window=window, softcap=softcap)


def _jax_grads(q, k, v, do, kw):
    """(output, [dq, dk, dv]) by ``jax.vjp``, jitted (eager JAX compiles
    every op on its own: seconds a case)."""
    @jax.jit
    def run(a, b, c, d):
        out, vjp = jax.vjp(lambda x, y, z: jax_attention_ref(x, y, z, **kw), a, b, c)
        return out, vjp(d)

    out, grads = run(*map(jnp.asarray, (q, k, v, do)))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", list(CASES))
def test_attention_backward_matches_jax_vjp(case):
    (q, k, v, do), kw = _inputs(case)
    out, want = _jax_grads(q, k, v, do, kw)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o = fa_ops.flash_attention(tq, tk, tv, use_kernel=False, **kw)
    np.testing.assert_allclose(o.numpy(), out, **TOL)
    plain = flash_attention_bwd_ref(tq, tk, tv, o, tdo, **kw)
    # the Function on the CPU (use_kernel=True: the plain versions of both
    # kernels), and the plain route differentiated by autograd
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    before = (fa_ops.launches, fa_ops.bwd_launches)
    through = torch.autograd.grad(fa_ops.flash_attention(*leaves, use_kernel=True, **kw),
                                  leaves, tdo)
    assert (fa_ops.launches, fa_ops.bwd_launches) == before
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    autograd = torch.autograd.grad(fa_ops.flash_attention(*leaves, use_kernel=False, **kw),
                                   leaves, tdo)
    for got in (plain, through, autograd):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, **TOL)
    if case == "no visible column":
        B, H, G, Sq, Skv = CASES[case][:5]
        assert float(plain[0][:, :, :Sq - Skv].abs().max()) == 0.0


def test_attention_backward_controls_differ():
    """A backward without the softcap's factor, or with dK and dV from one
    head of a group, is off by far more than the tolerance."""
    (q, k, v, do), kw = _inputs("window softcap gqa")
    _, want = _jax_grads(q, k, v, do, kw)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o = fa_ops.flash_attention(tq, tk, tv, use_kernel=False, **kw)
    no_cap = flash_attention_bwd_ref(tq, tk, tv, o, tdo, cap_grad=False, **kw)
    no_sum = flash_attention_bwd_ref(tq, tk, tv, o, tdo, group_sum=False, **kw)
    assert np.abs(no_cap[0].numpy() - want[0]).max() > 100 * TOL["atol"]
    assert np.abs(no_sum[1].numpy() - want[1]).max() > 100 * TOL["atol"]


def test_attention_grad_refuses_kv_len():
    q = torch.zeros((1, 2, 4, 32), requires_grad=True)
    k = torch.zeros((1, 1, 4, 32))
    with pytest.raises(ValueError, match="kv_len"):
        fa_ops.flash_attention(q, k, k, torch.tensor([4], dtype=torch.int32), use_kernel=True)


@pytest.mark.parametrize("B,F,D", [(7, 39, 10), (64, 13, 8)])
def test_fm_pairwise_backward_matches_jax_grad(B, F, D):
    rng = np.random.default_rng(B)
    e = (rng.normal(size=(B, F, D)) * 0.1).astype(np.float32)
    g = rng.normal(size=(B,)).astype(np.float32)
    want = np.asarray(jax.grad(lambda x: jnp.sum(jax_fm_pairwise_ref(x) * jnp.asarray(g)))(
        jnp.asarray(e)))
    te, tg = torch.from_numpy(e), torch.from_numpy(g)
    np.testing.assert_allclose(fm_pairwise_bwd_ref(te, tg).numpy(), want, rtol=1e-5, atol=1e-6)
    leaf = te.clone().requires_grad_()
    before = (fm_ops.launches, fm_ops.bwd_launches)
    (through,) = torch.autograd.grad(fm_ops.fm_pairwise(leaf), leaf, tg)
    assert (fm_ops.launches, fm_ops.bwd_launches) == before
    np.testing.assert_allclose(through.numpy(), want, rtol=1e-5, atol=1e-6)
    assert fm_pairwise_bwd_ref(te.bfloat16(), tg).dtype == torch.bfloat16
