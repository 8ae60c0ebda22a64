"""``fm_pairwise``: the FM second-order term, as a CUDA kernel on the card.

On CUDA tensors it launches ``csrc/fm_pairwise.cu`` (one warp per row,
fp32 or bf16 input, fp32 accumulation); on CPU tensors it runs the plain
version ``ref.fm_pairwise_ref``. Same contract either way: emb [B, F, D]
-> float32[B]. ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes

import torch

from ... import backend
from .ref import fm_pairwise_ref

launches = 0

MAX_F, MAX_D = 64, 128
_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p]


def fm_pairwise(emb: torch.Tensor) -> torch.Tensor:
    """emb float32 or bfloat16 [B, F, D], contiguous, 1 <= F <= 64 and
    1 <= D <= 128 on the card -> float32[B]."""
    global launches
    if not emb.is_cuda:
        return fm_pairwise_ref(emb)
    backend.require_cuda_float("fm_pairwise", emb=emb)
    if emb.requires_grad and torch.is_grad_enabled():
        raise ValueError("fm_pairwise: the kernel has no backward; call it under "
                         "torch.inference_mode() or torch.no_grad()")
    if emb.dim() != 3:
        raise ValueError(f"fm_pairwise: emb must be [B, F, D], got {tuple(emb.shape)}")
    B, F, D = emb.shape
    if not (1 <= F <= MAX_F and 1 <= D <= MAX_D):
        raise ValueError(f"fm_pairwise: needs 1 <= F <= {MAX_F} and 1 <= D <= {MAX_D}, "
                         f"got F={F}, D={D}")
    out = torch.empty(B, dtype=torch.float32, device=emb.device)
    if B == 0:
        return out
    fn = backend.load("fm_pairwise", "fm_pairwise_launch", _ARGS)
    err = fn(backend.ptr(emb), backend.FLOAT_CODES[emb.dtype], backend.ptr(out),
             B, F, D, backend.stream(emb.device))
    backend.check("fm_pairwise", err)
    launches += 1
    return out
