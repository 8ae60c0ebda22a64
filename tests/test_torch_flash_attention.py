"""The port's plain flash attention against the JAX package's: its Pallas
kernel in interpret mode, its ``flash_attention_ref`` and its scan-based
``xla_flash_attention``, on the same inputs made with numpy from a seed.

Tolerances are those of ``tests/test_kernels.py``: rtol and atol 2e-5 in
fp32 (the softmax sums run in another order), 2e-2 in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ops import flash_decode as jax_flash_decode
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro.kernels.flash_attention.xla_flash import xla_flash_attention
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_blockwise,
                                                     flash_attention_ref)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(rng, shapes, dtype="float32"):
    """The same values as JAX arrays and CPU tensors of ``dtype``."""
    js = [jnp.asarray(rng.normal(size=s), getattr(jnp, dtype)) for s in shapes]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype))
          for j in js]
    return js, ts


def _close(got, want, dtype="float32"):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("B,H,G,S,D,causal,window,softcap", [
    (1, 4, 4, 256, 64, True, 0, 0.0),      # MHA causal
    (2, 4, 2, 256, 64, True, 0, 0.0),      # GQA
    (1, 4, 1, 384, 64, True, 128, 0.0),    # MQA + sliding window (gemma2 local)
    (1, 2, 2, 256, 128, True, 0, 50.0),    # softcap (gemma2)
    (1, 2, 2, 128, 64, False, 0, 0.0),     # bidirectional
])
def test_plain_matches_jax_kernel_and_ref(B, H, G, S, D, causal, window, softcap):
    rng = np.random.default_rng(S + H)
    (jq, jk, jv), (q, k, v) = _inputs(rng, [(B, H, S, D), (B, G, S, D), (B, G, S, D)])
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = ops.launches
    got = ops.flash_attention(q, k, v, **kw)         # CPU tensors: the plain version
    assert ops.launches == before and got.dtype == torch.float32
    assert torch.equal(got, flash_attention_ref(q, k, v, **kw))
    _close(got, jax_flash_attention(jq, jk, jv, use_kernel=True, interpret=True,
                                    block_q=128, block_k=128, **kw))
    _close(got, jax_ref(jq, jk, jv, **kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_dtypes_match_jax_kernel(dtype):
    rng = np.random.default_rng(0)
    (jq, jk, jv), (q, k, v) = _inputs(rng, [(1, 2, 128, 64)] * 3, dtype)
    got = ops.flash_attention(q, k, v)
    assert got.dtype == getattr(torch, dtype)
    _close(got, jax_flash_attention(jq, jk, jv, use_kernel=True, interpret=True)
           .astype(jnp.float32), dtype)
    _close(got, jax_ref(jq, jk, jv).astype(jnp.float32), dtype)


def test_decode_with_kv_len_matches_jax():
    """One query row against a partially filled cache == JAX's 8-row padded
    decode through its Pallas kernel, and its ref's last row."""
    rng = np.random.default_rng(1)
    B, H, G, Skv, D = 2, 4, 2, 512, 64
    (jq, jk, jv), (q, k, v) = _inputs(rng, [(B, H, D), (B, G, Skv, D), (B, G, Skv, D)])
    kv_len = np.array([300, 512], np.int32)
    got = ops.flash_decode(q, k, v, torch.from_numpy(kv_len))
    assert got.shape == (B, H, D)
    _close(got, jax_flash_decode(jq, jk, jv, jnp.asarray(kv_len), use_kernel=True,
                                 interpret=True))
    _close(got, jax_ref(jq[:, :, None, :], jk, jv, causal=True,
                        kv_len=jnp.asarray(kv_len))[:, :, 0, :])


def test_decode_with_window_matches_jax():
    rng = np.random.default_rng(2)
    B, H, G, Skv, D = 1, 2, 1, 256, 64
    (jq, jk, jv), (q, k, v) = _inputs(rng, [(B, H, D), (B, G, Skv, D), (B, G, Skv, D)])
    kv_len = np.array([256], np.int32)
    got = ops.flash_decode(q, k, v, torch.from_numpy(kv_len), window=64)
    _close(got, jax_flash_decode(jq, jk, jv, jnp.asarray(kv_len), window=64,
                                 use_kernel=True, interpret=True))


@pytest.mark.parametrize("causal,window,softcap,G,kv_len", [
    (True, 0, 0.0, 4, None), (True, 96, 0.0, 2, None), (False, 0, 30.0, 1, None),
    (True, 0, 50.0, 2, (200, 320)),
])
def test_blockwise_matches_jax_xla_flash(causal, window, softcap, G, kv_len):
    rng = np.random.default_rng(5)
    B, H, S, D = 2, 4, 320, 32
    (jq, jk, jv), (q, k, v) = _inputs(rng, [(B, H, S, D), (B, G, S, D), (B, G, S, D)])
    kl = None if kv_len is None else np.array(kv_len, np.int32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = flash_attention_blockwise(q, k, v, block_k=128, **kw,
                                    kv_len=None if kl is None else torch.from_numpy(kl))
    _close(got, xla_flash_attention(jq, jk, jv, block_k=128, **kw,
                                    kv_len=None if kl is None else jnp.asarray(kl)))
    _close(got, flash_attention_ref(q, k, v, **kw,
                                    kv_len=None if kl is None else torch.from_numpy(kl)))


@pytest.mark.parametrize("Sq,Skv,window,kv_len", [
    (200, 200, 0, None),         # no multiple of any tile
    (37, 211, 50, (150, 211)),   # Sq < Skv: the causal offset, a window and kv_len
    (1, 1000, 0, (1, 999)),      # one row, ragged cache
    (64, 40, 0, None),           # Sq > Skv: the first rows see nothing and give 0
])
def test_ragged_shapes_match_jax_ref(Sq, Skv, window, kv_len):
    rng = np.random.default_rng(Sq + Skv)
    B, H, G, D = 2, 4, 2, 32
    (jq, jk, jv), (q, k, v) = _inputs(rng, [(B, H, Sq, D), (B, G, Skv, D), (B, G, Skv, D)])
    kl = None if kv_len is None else np.array(kv_len, np.int32)
    kw = dict(causal=True, window=window, softcap=50.0)
    got = ops.flash_attention(q, k, v, None if kl is None else torch.from_numpy(kl), **kw)
    want = jax_ref(jq, jk, jv, kv_len=None if kl is None else jnp.asarray(kl), **kw)
    _close(got, want)
    assert torch.isfinite(got).all()
    if Sq > Skv:
        assert not got[:, :, : Sq - Skv].any()


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(4)
    _, (q, k, v) = _inputs(rng, [(1, 2, 2048, 32), (1, 1, 2048, 32), (1, 1, 2048, 32)])
    before = ops.launches
    for use_kernel in (None, True, False):
        got = ops.flash_attention(q, k, v, window=300, use_kernel=use_kernel)
        # 2048 x 2048 score elements: the blockwise plain version, as JAX's fallback
        assert torch.equal(got, flash_attention_blockwise(q, k, v, window=300,
                                                          sm_scale=32 ** -0.5))
    small = ops.flash_attention(q[:, :, :64], k[:, :, :64], v[:, :, :64])
    assert torch.equal(small, flash_attention_ref(q[:, :, :64], k[:, :, :64], v[:, :, :64]))
    dec = ops.flash_decode(q[:, :, 0], k, v, torch.tensor([700], dtype=torch.int32))
    assert dec.shape == (1, 2, 32)
    assert ops.launches == before
