"""Plain PyTorch version of the batched RMQ: ``rmq_window_batch``.

For each i, (pos, val) of the argmin over ``values[p[i] .. q[i]]``
inclusive, by the two-overlapping-window formulation of the JAX package's
``kernels/rmq/ref.py::rmq_window_batch``: both partial blocks resolve
through two overlapping in-block windows of the ``ib`` table, the middle
blocks through two overlapping windows of the block sparse table. ``val``
is exact; ``pos`` is meaningful wherever ``val < INF``.

JAX gathers clamp out-of-range indices and torch indexing raises, so every
index here is in range by construction or clamped explicitly. torch has no
int32 count-leading-zeros: :func:`floor_log2` computes ``31 - clz(x)`` with
integer shifts. Ties keep the candidate order of the JAX version: each
window pair takes its left window on ties, then (c1, c2), then (c3, c4),
then the middle only when strictly smaller.
"""
from __future__ import annotations

import torch

INF = 2**31 - 1
BLOCK = 128


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """Exact ``floor(log2(x))`` for int32 ``x >= 1`` (``31 - clz(x)``)."""
    x = x.to(torch.int32)
    r = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = x >= (1 << s)
        r = r + torch.where(big, s, 0).to(torch.int32)
        x = torch.where(big, x >> s, x)
    return r


def rmq_window_batch(values, ib, st_pos, p, q, *, n: int):
    """values int32[n_pad] (INF padded to a BLOCK multiple); ib int8[7, n_pad];
    st_pos int32[levels, n_blocks]; p, q int32[B] -> (pos, val) int32[B]."""
    levels, n_blocks = st_pos.shape
    n_pad = values.shape[0]
    ib_flat = ib.reshape(-1)
    st_flat = st_pos.reshape(-1)
    p = p.clamp(0, max(n - 1, 0)).to(torch.int32)
    qc = q.clamp(0, max(n - 1, 0)).to(torch.int32)
    invalid = (p > qc) | (n == 0)
    bp, bq = p // BLOCK, qc // BLOCK
    same = bp == bq
    lo1 = p
    hi1 = torch.maximum(torch.where(same, qc, bp * BLOCK + (BLOCK - 1)), p)
    lo2, hi2 = bq * BLOCK, qc
    j1 = floor_log2((hi1 - lo1 + 1).clamp(min=1))
    j2 = floor_log2((hi2 - lo2 + 1).clamp(min=1))
    s1 = hi1 - (1 << j1) + 1
    s2 = hi2 - (1 << j2) + 1

    def window(j, start):
        """Absolute position of the in-block window minimum at ``start``."""
        off = ib_flat[(j - 1).clamp(min=0) * n_pad + start].to(torch.int32)
        return start + torch.where(j == 0, 0, off)

    p1a, p1b = window(j1, lo1), window(j1, s1)
    p2a, p2b = window(j2, lo2), window(j2, s2)
    v1a, v1b, v2a, v2b = values[p1a], values[p1b], values[p2a], values[p2b]
    cnt = bq - bp - 1
    has_mid = cnt > 0
    jm = torch.where(has_mid, floor_log2(cnt.clamp(min=1)), 0)
    jc = jm.clamp(max=levels - 1)
    lo_b = (bp + 1).clamp(max=n_blocks - 1)
    hi_b = (bq - (1 << jc)).clamp(0, n_blocks - 1)
    c3_pos = st_flat[jc * n_blocks + lo_b]
    c4_pos = st_flat[jc * n_blocks + hi_b]
    c1_pos = torch.where(v1b < v1a, p1b, p1a)
    c1_val = torch.minimum(v1a, v1b)
    c2_pos = torch.where(v2b < v2a, p2b, p2a)
    c2_val = torch.where(same, INF, torch.minimum(v2a, v2b))
    c3_val = torch.where(has_mid, values[c3_pos], INF)
    c4_val = torch.where(has_mid, values[c4_pos], INF)
    p12 = torch.where(c2_val < c1_val, c2_pos, c1_pos)
    v12 = torch.minimum(c1_val, c2_val)
    p34 = torch.where(c4_val < c3_val, c4_pos, c3_pos)
    v34 = torch.minimum(c3_val, c4_val)
    pos = torch.where(v34 < v12, p34, p12)
    val = torch.where(invalid, INF, torch.minimum(v12, v34))
    return pos.to(torch.int32), val.to(torch.int32)
