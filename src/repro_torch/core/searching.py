"""Batched, range-restricted binary search.

Every pointer walk of the paper (dictionary lookups, NextGeq) reduces to a
fixed-depth binary search with valid-guarded halving: once ``lo == hi`` an
iteration changes nothing, so any iteration count at or above the bound
gives the same insertion point. The bound is the JAX package's:
``max_iters``, else ``min(31, len.bit_length())``.
"""
from __future__ import annotations

import torch

_ITERS = 31  # ceil(log2(2^31)): always enough; extra iterations are no-ops


def _lex_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over the trailing chunk axis: int32[B, C] -> bool[B]."""
    neq = a != b
    idx = torch.argmax(neq.to(torch.int32), dim=-1, keepdim=True)  # first differing chunk
    lt = torch.gather(a, -1, idx) < torch.gather(b, -1, idx)
    return neq.any(-1) & lt[..., 0]


def ranged_searchsorted(arr, query, lo, hi, *, side: str, max_iters: int = 0):
    """Insertion points of ``query`` into sorted ``arr[lo:hi]`` (elementwise).

    ``arr`` is int32[N]; query/lo/hi broadcast to one shape; returns
    positions in [lo, hi].
    """
    assert side in ("left", "right")
    n = arr.shape[0]
    iters = max_iters or min(_ITERS, max(1, n.bit_length()))
    lo = lo.to(torch.int32)
    hi = hi.to(torch.int32)
    for _ in range(iters):
        mid = (lo + hi) // 2
        v = arr[mid.clamp(0, n - 1)]          # explicit clamp: torch raises
        go_right = (v < query) if side == "left" else (v <= query)
        valid = lo < hi
        lo, hi = (torch.where(valid & go_right, mid + 1, lo),
                  torch.where(valid & ~go_right, mid, hi))
    return lo


def ranged_searchsorted_keys(keys, query, lo, hi, *, side: str):
    """:func:`ranged_searchsorted` over lexicographic chunk keys.

    keys: int32[N, C] sorted lexicographically; query: int32[B, C];
    lo/hi: int32[B].
    """
    assert side in ("left", "right")
    n = keys.shape[0]
    iters = min(_ITERS, max(1, n.bit_length()))
    lo = lo.to(torch.int32)
    hi = hi.to(torch.int32)
    for _ in range(iters):
        mid = (lo + hi) // 2
        row = keys[mid.clamp(0, n - 1)]
        go_right = _lex_lt(row, query) if side == "left" else ~_lex_lt(query, row)
        valid = lo < hi
        lo, hi = (torch.where(valid & go_right, mid + 1, lo),
                  torch.where(valid & ~go_right, mid, hi))
    return lo
