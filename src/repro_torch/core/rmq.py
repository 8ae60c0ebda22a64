"""Range-minimum queries over int32 arrays (paper §3.2).

A two-level structure in place of the paper's succinct cartesian tree:
128-wide blocks with an in-block window table ``ib`` and a sparse table of
argmin positions over the block minima. A batched query is two overlapping
in-block windows per partial block plus two overlapping sparse-table
windows (``kernels/rmq``). ``RangeMin.query`` is the JAX package's
per-query form (a masked scan of each partial block), and
``topk_in_range``/``topk_in_range_batch`` the paper's heap-of-subranges
top-k over a dense (k+1)-slot buffer: the per-query reference and the
batched form that issues one batched RMQ per pop.
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

    def query(self, p, q):
        """argmin over values[p..q] inclusive, one query -> (pos, val) int32
        scalars on the structure's device. Invalid (p > q after clipping to
        [0, n-1]) -> (the left partial block's position, INF). The left and
        right partial blocks are masked scans, the middle the sparse table;
        ties keep the first of (left, right, middle low, middle high)."""
        n = self.n
        p = min(max(int(p), 0), max(n - 1, 0))
        qc = min(max(int(q), 0), max(n - 1, 0))
        bp, bq = p // BLOCK, qc // BLOCK
        lane = torch.arange(BLOCK, device=self.values.device)

        def partial(block, lo_lane, hi_lane):
            vals = self.values[block * BLOCK:(block + 1) * BLOCK]
            vals = torch.where((lane >= lo_lane) & (lane <= hi_lane), vals, INF_DOCID)
            a = int(torch.argmin(vals))
            return block * BLOCK + a, int(vals[a])

        same = bp == bq
        c1 = partial(bp, p % BLOCK, qc % BLOCK if same else BLOCK - 1)
        c2_pos, c2_val = partial(bq, 0, qc % BLOCK)
        cnt = bq - bp - 1
        jc = min(cnt.bit_length() - 1 if cnt > 0 else 0, self.levels - 1)
        lo_b = min(bp + 1, self.n_blocks - 1)
        hi_b = min(max(bq - (1 << jc), 0), self.n_blocks - 1)
        c3_pos, c4_pos = int(self.st_pos[jc, lo_b]), int(self.st_pos[jc, hi_b])
        cands = [c1, (c2_pos, INF_DOCID if same else c2_val),
                 (c3_pos, int(self.values[c3_pos]) if cnt > 0 else INF_DOCID),
                 (c4_pos, int(self.values[c4_pos]) if cnt > 0 else INF_DOCID)]
        if p > qc or n == 0:
            cands = [(c, INF_DOCID) for c, _ in cands]
        pos, val = min(cands, key=lambda c: c[1])        # first minimum
        as32 = lambda x: torch.tensor(x, dtype=torch.int32, device=self.values.device)
        return as32(pos), as32(val)


def topk_in_range(rmq: RangeMin, p, q, k: int):
    """k smallest values in rmq.values[p..q-1] (half-open), ascending, one
    range: the paper's heap-of-subranges with a dense (k+1)-slot buffer.

    Returns (vals int32[k], pos int32[k]) padded with (INF, -1).
    """
    qi = int(q) - 1                                  # inclusive
    p = int(p)
    pos0, val0 = (int(x) for x in rmq.query(p, qi))
    K = k + 1
    slot_lo, slot_hi = [p] + [0] * k, [qi] + [-1] * k
    slot_pos = [pos0] + [0] * k
    slot_val = [val0 if p <= qi else INF_DOCID] + [INF_DOCID] * k
    out_v, out_p = [INF_DOCID] * k, [-1] * k
    for i in range(k):
        best = min(range(K), key=slot_val.__getitem__)     # first minimum
        bval = slot_val[best]
        found = bval < INF_DOCID
        out_v[i] = bval
        out_p[i] = slot_pos[best] if found else -1
        lo, hi, pos = slot_lo[best], slot_hi[best], slot_pos[best]
        # the left subrange replaces the popped slot, the right takes i+1
        lpos, lval = (int(x) for x in rmq.query(lo, pos - 1))
        rpos, rval = (int(x) for x in rmq.query(pos + 1, hi))
        slot_lo[best], slot_hi[best], slot_pos[best] = lo, pos - 1, lpos
        slot_val[best] = lval if (lo <= pos - 1 and found) else INF_DOCID
        slot_lo[i + 1], slot_hi[i + 1], slot_pos[i + 1] = pos + 1, hi, rpos
        slot_val[i + 1] = rval if (pos + 1 <= hi and found) else INF_DOCID
    dev = rmq.values.device
    return (torch.tensor(out_v, dtype=torch.int32, device=dev),
            torch.tensor(out_p, dtype=torch.int32, device=dev))


def topk_in_range_batch(rmq: RangeMin, p, q, k: int, *,
                        use_kernel: bool = False):
    """Batched :func:`topk_in_range`: p, q int32[B] half-open ranges ->
    (vals int32[B, k], pos int32[B, k]). Each pop issues ONE batched RMQ
    over the 2B left/right split subranges of all lanes (through the
    ``rmq`` kernel with ``use_kernel``)."""
    B = p.shape[0]
    dev = rmq.values.device
    rows = torch.arange(B, device=dev)
    p = p.to(torch.int32)
    qi = (q - 1).to(torch.int32)
    pos0, val0 = rmq.query_batch(p, qi, use_kernel=use_kernel)
    K = k + 1
    i32 = dict(dtype=torch.int32, device=dev)
    slot_lo = torch.zeros((B, K), **i32)
    slot_hi = torch.full((B, K), -1, **i32)
    slot_pos = torch.zeros((B, K), **i32)
    slot_val = torch.full((B, K), INF_DOCID, **i32)
    slot_lo[:, 0], slot_hi[:, 0], slot_pos[:, 0] = p, qi, pos0
    slot_val[:, 0] = torch.where(p <= qi, val0, INF_DOCID)
    out_v = torch.full((B, k), INF_DOCID, **i32)
    out_p = torch.full((B, k), -1, **i32)
    for i in range(k):
        best = torch.argmin(slot_val, dim=1)
        bval = slot_val[rows, best]
        found = bval < INF_DOCID
        out_v[:, i] = bval
        out_p[:, i] = torch.where(found, slot_pos[rows, best], -1)
        lo, hi, pos = slot_lo[rows, best], slot_hi[rows, best], slot_pos[rows, best]
        l_lo, l_hi, r_lo, r_hi = lo, pos - 1, pos + 1, hi
        pos2, val2 = rmq.query_batch(torch.cat([l_lo, r_lo]), torch.cat([l_hi, r_hi]),
                                     use_kernel=use_kernel)
        slot_lo[rows, best], slot_hi[rows, best] = l_lo, l_hi
        slot_pos[rows, best] = pos2[:B]
        slot_val[rows, best] = torch.where((l_lo <= l_hi) & found, val2[:B], INF_DOCID)
        slot_lo[:, i + 1], slot_hi[:, i + 1], slot_pos[:, i + 1] = r_lo, r_hi, pos2[B:]
        slot_val[:, i + 1] = torch.where((r_lo <= r_hi) & found, val2[B:], INF_DOCID)
    return out_v, out_p
