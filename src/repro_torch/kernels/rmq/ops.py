"""``rmq_query``: the batched RMQ, as a CUDA kernel on the card.

On CUDA tensors it launches ``csrc/rmq.cu`` (one thread per query, the
shared ``qac::rmq_window`` body); on CPU tensors it runs the plain version
``ref.rmq_window_batch``. ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes

import torch

from ... import backend
from .ref import rmq_window_batch

launches = 0

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4 \
    + [ctypes.c_int, ctypes.c_void_p]


def rmq_query(values, ib, st_pos, p, q, *, n: int):
    """(pos, val) int32[B] of the argmin over values[p[i] .. q[i]] inclusive;
    same contract as :func:`ref.rmq_window_batch`."""
    global launches
    if not values.is_cuda:
        return rmq_window_batch(values, ib, st_pos, p, q, n=n)
    p = p.to(torch.int32).contiguous()
    q = q.to(torch.int32).contiguous()
    backend.require_cuda_int32("rmq_query", values=values, st_pos=st_pos,
                               p=p, q=q)
    if ib.dtype != torch.int8 or not ib.is_contiguous() or ib.device != values.device:
        raise ValueError("rmq_query: ib must be a contiguous int8 tensor on the card")
    levels, n_blocks = st_pos.shape
    B = p.shape[0]
    pos = torch.empty(B, dtype=torch.int32, device=values.device)
    val = torch.empty(B, dtype=torch.int32, device=values.device)
    if B == 0:
        return pos, val
    fn = backend.load("rmq", "rmq_query_launch", _ARGS)
    err = fn(backend.ptr(values), backend.ptr(ib), backend.ptr(st_pos),
             n, values.shape[0], levels, n_blocks,
             backend.ptr(p), backend.ptr(q), backend.ptr(pos), backend.ptr(val),
             B, backend.stream(values.device))
    backend.check("rmq", err)
    launches += 1
    return pos, val
