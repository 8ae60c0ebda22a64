"""Plain PyTorch versions of FM's kernels: ``fm_pairwise_ref`` and
``fm_forward_ref``.

The FM second-order term (Rendle, ICDM'10) by the O(nk) sum-square
identity, a transcription of the JAX package's
``kernels/fm_pairwise/ref.py``:
   sum_{i<j} <v_i, v_j> = 0.5 * sum_d [ (sum_f v_fd)^2 - sum_f v_fd^2 ]

``fm_forward_ref`` is FM's whole forward from the ids (the JAX package's
``FMModel.forward``, ``models/recsys.py:104-113``): the row index of
numpy-style indexing (:func:`clamp_rows`), the embedding and linear
gathers, the pairwise term, and ``bias + lin + pair`` in that order.

``fm_pairwise_bwd_ref`` is the pairwise term's gradient in closed form
(what ``jax.grad`` of the JAX package's ``fm_pairwise_ref`` gives).
"""
from __future__ import annotations

import torch


def clamp_rows(ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    """int64 row index of JAX's numpy-style indexing: a negative id wraps
    once, then the index clamps to [0, n_rows-1] (torch would raise, on the
    card by a device-side assert)."""
    i = ids.long()
    return torch.where(i < 0, i + n_rows, i).clamp(0, n_rows - 1)


def fm_pairwise_ref(emb: torch.Tensor) -> torch.Tensor:
    """emb float[B, F, D] -> float32[B], computed in fp32."""
    e = emb.float()
    s = e.sum(1)                      # [B, D]
    sq = (e * e).sum(1)               # [B, D]
    return 0.5 * (s * s - sq).sum(1)


def fm_pairwise_bwd_ref(emb: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """emb [B, F, D] and the cotangent g float32[B] -> the gradient of
    ``fm_pairwise_ref`` at emb, ``g[b] * (sum_f' e[b, f'] - e[b, f])``,
    computed in fp32 and returned in emb's dtype."""
    e = emb.float()
    return (g.float()[:, None, None] * (e.sum(1, keepdim=True) - e)).to(emb.dtype)


def fm_forward_ref(ids: torch.Tensor, tables: torch.Tensor, linear: torch.Tensor,
                   bias: torch.Tensor, pairwise=fm_pairwise_ref) -> torch.Tensor:
    """ids int[B, F], tables [F, V, D], linear [F, V, 1], bias [] -> logits
    [B]: float32, or in bf16 the linear sum and ``bias + lin`` rounded to
    bf16 before the fp32 pair term is added. ``pairwise`` computes the pair
    term from the gathered [B, F, D] rows (``ops.fm_pairwise`` puts the
    kernel there)."""
    n_f, V, D = tables.shape
    # one flat index into the [F*V] rows: field f's table starts at f*V
    flat = clamp_rows(ids, V) + torch.arange(n_f, device=ids.device) * V
    emb = tables.view(n_f * V, D)[flat]                  # [B, F, D]
    lin = linear.view(n_f * V)[flat].sum(-1)
    return bias + lin + pairwise(emb)
