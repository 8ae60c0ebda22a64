"""``flash_attention`` (prefill) and ``flash_decode`` (one token against a KV
cache), as a CUDA kernel on the card.

On CUDA tensors both launch ``csrc/flash_attention.cu`` (bf16 on the tensor
cores through wmma tiles, fp32 in scalar FMAs; fp32 softmax state either
way) or raise; on CPU tensors they run the plain versions of ``ref.py``,
dispatched as the JAX package dispatches its XLA fallback: the blockwise
online softmax from ``Sq * Skv >= 2048 * 2048`` score elements up, the
materialised scores below. ``use_kernel=False`` asks for the plain versions
on any device. ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes

import torch

from ... import backend
from .ref import flash_attention_blockwise, flash_attention_ref

launches = 0

HEAD_DIMS = (32, 64, 128, 256)
BLOCKWISE_FROM = 2048 * 2048   # score elements from which the plain route goes blockwise
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2 + [ctypes.c_void_p]


def _plain(q, k, v, kv_len, **kw):
    if q.shape[2] * k.shape[2] >= BLOCKWISE_FROM:
        return flash_attention_blockwise(q, k, v, kv_len=kv_len, **kw)
    return flash_attention_ref(q, k, v, kv_len=kv_len, **kw)


def _check(q, k, v, kv_len) -> None:
    backend.require_cuda_float("flash_attention", q=q, k=k, v=v)
    if (torch.is_grad_enabled() and
            any(t.requires_grad for t in (q, k, v))):
        raise ValueError("flash_attention: the kernel has no backward; call it under "
                         "torch.inference_mode() or torch.no_grad()")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q must be [B, H, Sq, D] and k, v [B, G, Skv, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    _, G, Skv, Dk = k.shape
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k and v must share a dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape[0] != B or Dk != D or G < 1 or H % G:
        raise ValueError(f"flash_attention: needs k, v [B={B}, G, Skv, D={D}] with H={H} "
                         f"a multiple of G, got {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim must be one of {HEAD_DIMS}, got {D}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must start on a 16-byte boundary")
    if kv_len is not None:
        backend.require_cuda_int32("flash_attention", kv_len=kv_len)
        if kv_len.shape != (B,) or kv_len.device != q.device:
            raise ValueError(f"flash_attention: kv_len must be int32[{B}] on {q.device}, "
                             f"got {tuple(kv_len.shape)} on {kv_len.device}")


def flash_attention(q, k, v, kv_len=None, *, causal=True, window=0, softcap=0.0,
                    sm_scale=None, use_kernel=None):
    """q [B, H, Sq, D] x k, v [B, G, Skv, D] -> [B, H, Sq, D] in q's dtype;
    ``kv_len`` int32 [B] or None. ``use_kernel=None``: the kernel exactly
    when the tensors are on CUDA. On the card q, k and v are contiguous fp32
    or bf16 of one dtype, D is 32, 64, 128 or 256 and H a multiple of G."""
    global launches
    if use_kernel is None:
        use_kernel = backend.default_use_kernel(q.device)
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if not use_kernel or not q.is_cuda:
        return _plain(q, k, v, kv_len, causal=causal, window=window, softcap=softcap,
                      sm_scale=scale)
    _check(q, k, v, kv_len)
    B, H, Sq, D = q.shape
    G, Skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = backend.load("flash_attention", "flash_attention_launch", _ARGS)
    err = fn(backend.ptr(q), backend.ptr(k), backend.ptr(v),
             None if kv_len is None else backend.ptr(kv_len), backend.ptr(out),
             backend.FLOAT_CODES[q.dtype], B, H, G, Sq, Skv, D, int(bool(causal)),
             int(window or 0), float(softcap or 0.0), float(scale),
             backend.stream(q.device))
    backend.check("flash_attention", err)
    launches += 1
    return out


def flash_decode(q, k, v, kv_len, *, window=0, softcap=0.0, sm_scale=None,
                 use_kernel=None):
    """One token per row: q [B, H, D] x cache k, v [B, G, Skv, D] -> [B, H, D].

    The same kernel with Sq = 1 (no padding to 8 rows as on the TPU): under
    the offset-aware causal rule the one row sees the whole cache, up to
    ``kv_len``."""
    out = flash_attention(q[:, :, None, :], k, v, kv_len, causal=True, window=window,
                          softcap=softcap, sm_scale=sm_scale, use_kernel=use_kernel)
    return out[:, :, 0, :]
