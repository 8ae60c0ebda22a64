"""Range-minimum queries over int32 arrays (paper §3.2).

A two-level structure in place of the paper's succinct cartesian tree:
128-wide blocks with an in-block window table ``ib`` and a sparse table of
argmin positions over the block minima. A query is two overlapping in-block
windows per partial block plus two overlapping sparse-table windows
(``kernels/rmq``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .types import INF_DOCID

BLOCK = 128
IB_LEVELS = 7            # in-block windows 2^1 .. 2^7 (= BLOCK)


def build_inblock_table(vp: np.ndarray) -> np.ndarray:
    """int8[IB_LEVELS, n_pad] leftmost-argmin offsets of in-block windows.

    ``ib[j-1, i]`` is the offset (relative to i) of the leftmost minimum of
    ``vp[i : i + 2^j]`` clipped to i's 128-block. Level 0 (window length 1,
    offset 0) is implicit.
    """
    n_pad = len(vp)
    nb = n_pad // BLOCK
    v = vp.reshape(nb, BLOCK).astype(np.int64)
    lane = np.arange(BLOCK)
    cur = np.zeros((nb, BLOCK), np.int32)
    ib = np.zeros((IB_LEVELS, nb, BLOCK), np.int8)
    for j in range(1, IB_LEVELS + 1):
        half = 1 << (j - 1)
        other_i = np.minimum(lane + half, BLOCK - 1)
        abs1 = lane[None, :] + cur
        abs2 = other_i[None, :] + cur[:, other_i]
        cross = (lane + half) > (BLOCK - 1)
        take2 = (np.take_along_axis(v, abs2, 1)
                 < np.take_along_axis(v, abs1, 1)) & ~cross[None, :]
        absm = np.where(take2, abs2, abs1)
        cur = (absm - lane[None, :]).astype(np.int32)
        ib[j - 1] = cur.astype(np.int8)
    return ib.reshape(IB_LEVELS, n_pad)


@dataclasses.dataclass(frozen=True)
class RangeMin:
    values: torch.Tensor     # int32[n_pad] (INF padded)
    st_pos: torch.Tensor     # int32[levels, n_blocks]: global argmin positions
    ib: torch.Tensor         # int8[IB_LEVELS, n_pad]: in-block window argmins
    n: int
    n_blocks: int
    levels: int

    @staticmethod
    def build(values: np.ndarray, *, device: torch.device) -> "RangeMin":
        v = np.asarray(values, dtype=np.int64)
        n = len(v)
        n_pad = ((n + BLOCK - 1) // BLOCK) * BLOCK
        vp = np.full(n_pad, INF_DOCID, dtype=np.int64)
        vp[:n] = v
        nb = n_pad // BLOCK
        blocks = vp.reshape(nb, BLOCK)
        base = np.arange(nb) * BLOCK
        pos0 = base + blocks.argmin(axis=1)
        levels = max(1, int(np.ceil(np.log2(max(nb, 1)))) + 1)
        st = np.zeros((levels, nb), dtype=np.int32)
        st[0] = pos0
        for j in range(1, levels):
            half = 1 << (j - 1)
            prev = st[j - 1]
            other = st[j - 1][np.minimum(np.arange(nb) + half, nb - 1)]
            take_other = vp[other] < vp[prev]
            st[j] = np.where(take_other, other, prev)
        t = lambda a: torch.from_numpy(a).to(device)
        return RangeMin(values=t(vp.astype(np.int32)), st_pos=t(st),
                        ib=t(build_inblock_table(vp)), n=n, n_blocks=nb,
                        levels=levels)

    def query_batch(self, p, q, *, use_kernel: bool = False):
        """Batched argmin over values[p[i]..q[i]] -> (pos int32[B], val int32[B]).

        ``val`` is exact (INF for an empty or inverted range); ``pos`` is
        meaningful wherever ``val < INF``. ``use_kernel`` routes through
        ``kernels.rmq.ops.rmq_query`` (the CUDA kernel on the card); else the
        plain version runs on whatever device the tensors are on.
        """
        from ..kernels.rmq.ops import rmq_query
        from ..kernels.rmq.ref import rmq_window_batch

        n = self.n
        p = p.clamp(0, max(n - 1, 0)).to(torch.int32)
        qc = q.clamp(0, max(n - 1, 0)).to(torch.int32)
        fn = rmq_query if use_kernel else rmq_window_batch
        return fn(self.values, self.ib, self.st_pos, p, qc, n=n)
