"""Plain PyTorch version of the FM pairwise interaction: ``fm_pairwise_ref``.

The FM second-order term (Rendle, ICDM'10) by the O(nk) sum-square
identity, a transcription of the JAX package's
``kernels/fm_pairwise/ref.py``:
   sum_{i<j} <v_i, v_j> = 0.5 * sum_d [ (sum_f v_fd)^2 - sum_f v_fd^2 ]
"""
from __future__ import annotations

import torch


def fm_pairwise_ref(emb: torch.Tensor) -> torch.Tensor:
    """emb float[B, F, D] -> float32[B], computed in fp32."""
    e = emb.float()
    s = e.sum(1)                      # [B, D]
    sq = (e * e).sum(1)               # [B, D]
    return 0.5 * (s * s - sq).sum(1)
