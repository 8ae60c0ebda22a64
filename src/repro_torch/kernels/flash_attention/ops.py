"""``flash_attention`` (prefill) and ``flash_decode`` (one token against a KV
cache), as a CUDA kernel on the card.

On CUDA tensors both launch ``csrc/flash_attention.cu`` or raise: in bf16
the prefill kernel (wgmma on a TMA-fed ring) or, for up to ``DECODE_MAX_SQ``
query rows per head, the split-KV decode kernel, chosen by shape
(``plan_splits``); in fp32 scalar FMAs; fp32 softmax state either way. On
CPU tensors they run the plain versions of ``ref.py``,
dispatched as the JAX package dispatches its XLA fallback: the blockwise
online softmax from ``Sq * Skv >= 2048 * 2048`` score elements up, the
materialised scores below. ``use_kernel=False`` asks for the plain versions
on any device. ``launches`` counts kernel launches only.

Under grad (grad enabled and q, k or v requiring it) the kernel route goes
through ``FlashAttention``, a ``torch.autograd.Function`` whose forward is
the same kernel and whose backward is ``flash_attention_bwd``: the
hand-written backward in ``csrc/flash_attention_bwd.cu`` on the card
(``bwd_launches`` counts its calls, three kernels each), its plain version
``ref.flash_attention_bwd_ref`` on the CPU. The plain route
(``use_kernel=False``, or a CPU tensor with ``use_kernel=None``) is
differentiated by autograd through its torch ops. No training path passes
``kv_len``: under grad it raises.
"""
from __future__ import annotations

import ctypes

import torch

from ... import backend
from .ref import flash_attention_blockwise, flash_attention_bwd_ref, flash_attention_ref

launches = 0
bwd_launches = 0

HEAD_DIMS = (32, 64, 128, 256)
BLOCKWISE_FROM = 2048 * 2048   # score elements from which the plain route goes blockwise
_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2 +
         [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
_BWD_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2 +
             [ctypes.c_void_p])

SMS = 132               # streaming multiprocessors of an H100 SXM
DECODE_MAX_SQ = 8       # query rows per head up to which the decode kernel takes a call
DECODE_ROWS = 64        # ... if all rep heads' rows of a kv head fit its one wgmma tile
MAX_SPLITS = 64         # the merge keeps a weight per split and row in shared memory
BLOCKS_PER_SM = 8       # decode blocks aimed at per SM, one resident at a time
MIN_SPLIT_TILES = 8     # kv tiles a split holds at least
DECODE_BLOCK_K = 64     # the decode kernel's kv tile (``Tc<D, true>::BK``)


def plan_splits(B: int, H: int, G: int, Sq: int, Skv: int) -> tuple[int, int]:
    """(splits, columns per split) for the bf16 decode kernel, or (0, 0) for
    the prefill kernel. Decode takes a call when every query row of a kv
    head (rep = H / G heads x Sq rows) fits one 64-row tile and Sq is at
    most ``DECODE_MAX_SQ``; it splits the cache so that the B * G kv heads
    give some ``BLOCKS_PER_SM`` blocks per SM, each split a multiple of the
    kv tile and at least ``MIN_SPLIT_TILES`` tiles long."""
    if Sq > DECODE_MAX_SQ or (H // G) * Sq > DECODE_ROWS:
        return 0, 0
    tiles = -(-Skv // DECODE_BLOCK_K)
    want = -(-BLOCKS_PER_SM * SMS // (B * G))
    n = max(1, min(want, MAX_SPLITS, tiles // MIN_SPLIT_TILES))
    per = -(-tiles // n)
    return -(-tiles // per), per * DECODE_BLOCK_K


def _plain(q, k, v, kv_len, **kw):
    if q.shape[2] * k.shape[2] >= BLOCKWISE_FROM:
        return flash_attention_blockwise(q, k, v, kv_len=kv_len, **kw)
    return flash_attention_ref(q, k, v, kv_len=kv_len, **kw)


def _check(q, k, v, kv_len) -> None:
    backend.require_cuda_float("flash_attention", q=q, k=k, v=v)
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
    if use_kernel is None:
        use_kernel = backend.default_use_kernel(q.device)
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if not use_kernel:
        return _plain(q, k, v, kv_len, causal=causal, window=window, softcap=softcap,
                      sm_scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if kv_len is not None:
            raise ValueError("flash_attention: no gradient with kv_len (no training path "
                             "passes one)")
        return FlashAttention.apply(q, k, v, bool(causal), int(window or 0),
                                    float(softcap or 0.0), float(scale))
    return _forward(q, k, v, kv_len, causal, window, softcap, scale)


def _forward(q, k, v, kv_len, causal, window, softcap, scale):
    """The forward kernel on CUDA tensors, its plain version on the CPU."""
    global launches
    if not q.is_cuda:
        return _plain(q, k, v, kv_len, causal=causal, window=window, softcap=softcap,
                      sm_scale=scale)
    _check(q, k, v, kv_len)
    B, H, Sq, D = q.shape
    G, Skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    splits, cols = plan_splits(B, H, G, Sq, Skv) if q.dtype == torch.bfloat16 else (0, 0)
    part = counters = None
    if splits > 1:   # the merge's scratch: each split's (acc, m, l), a ticket per kv head
        part = torch.empty(B * G * splits * (H // G) * Sq * (D + 2), dtype=torch.float32,
                           device=q.device)
        counters = torch.zeros(B * G, dtype=torch.int32, device=q.device)
    elif splits == 0 and q.dtype == torch.bfloat16:   # prefill: its work queue's counter
        counters = torch.zeros(1, dtype=torch.int32, device=q.device)
    fn = backend.load("flash_attention", "flash_attention_launch", _ARGS)
    err = fn(backend.ptr(q), backend.ptr(k), backend.ptr(v),
             None if kv_len is None else backend.ptr(kv_len), backend.ptr(out),
             backend.FLOAT_CODES[q.dtype], B, H, G, Sq, Skv, D, int(bool(causal)),
             int(window or 0), float(softcap or 0.0), float(scale), splits, cols,
             None if part is None else backend.ptr(part),
             None if counters is None else backend.ptr(counters),
             backend.stream(q.device))
    backend.check("flash_attention", err)
    launches += 1
    return out


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` (no ``kv_len``) with ``flash_attention_bwd`` as its
    backward: the kernels on CUDA tensors, their plain versions on the CPU.
    Saves q, k, v and the output for the backward, which recomputes the
    scores (no [Sq, Skv] tensor is kept)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        o = _forward(q, k, v, None, causal, window, softcap, scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap, sm_scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention_bwd(q, k, v, o, do, *, causal=True, window=0, softcap=0.0,
                        sm_scale=None):
    """The gradient of ``flash_attention`` (no ``kv_len``): q, o, do [B, H,
    Sq, D] and k, v [B, G, Skv, D] -> (dq, dk, dv) in the inputs' dtype. On
    CUDA tensors (contiguous, fp32 or bf16 of one dtype, D in ``HEAD_DIMS``)
    three kernel launches: the row statistics, dk and dv, dq; on CPU tensors
    ``ref.flash_attention_bwd_ref``."""
    global bwd_launches
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    kw = dict(causal=causal, window=window, softcap=softcap, sm_scale=scale)
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, o, do, **kw)
    _check(q, k, v, None)
    backend.require_cuda_float("flash_attention_bwd", o=o, do=do)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o and do must be {tuple(q.shape)} {q.dtype}, "
                         f"got {tuple(o.shape)} {o.dtype} and {tuple(do.shape)} {do.dtype}")
    if any(t.data_ptr() % 16 for t in (o, do)):
        raise ValueError("flash_attention_bwd: o and do must start on a 16-byte boundary")
    B, H, Sq, D = q.shape
    G, Skv = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    fn = backend.load("flash_attention_bwd", "flash_attention_bwd_launch", _BWD_ARGS)
    err = fn(*(backend.ptr(t) for t in (q, k, v, o, do, dq, dk, dv, lse, delta)),
             backend.FLOAT_CODES[q.dtype], B, H, G, Sq, Skv, D, int(bool(causal)),
             int(window or 0), float(softcap or 0.0), float(scale), backend.stream(q.device))
    backend.check("flash_attention_bwd", err)
    bwd_launches += 1
    return dq, dk, dv


def flash_decode(q, k, v, kv_len, *, window=0, softcap=0.0, sm_scale=None,
                 use_kernel=None):
    """One token per row: q [B, H, D] x cache k, v [B, G, Skv, D] -> [B, H, D].

    ``flash_attention`` with Sq = 1 (no padding to 8 rows as on the TPU),
    so in bf16 the split-KV decode kernel wherever its rule takes the shape:
    under the offset-aware causal rule the one row sees the whole cache, up
    to ``kv_len``."""
    out = flash_attention(q[:, :, None, :], k, v, kv_len, causal=True, window=window,
                          softcap=softcap, sm_scale=sm_scale, use_kernel=use_kernel)
    return out[:, :, 0, :]
