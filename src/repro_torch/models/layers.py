"""Shared neural layers of the JAX package's ``models/layers.py``: norms,
RoPE, gated activations and initialisers, plus ``clamp_rows``, the row index
of JAX's numpy-style gather written out (defined beside FM's plain version in
``kernels/fm_pairwise/ref.py``, which the kernels package imports without
the models).

The initialisers draw from a ``torch.Generator``; the JAX package draws from
``jax.random`` keys, so the same seed gives other values. Parity with the
JAX package goes through ``convert.recsys_params_from_arrays`` and
``convert.lm_params_from_arrays``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.fm_pairwise.ref import clamp_rows  # noqa: F401  (kept importable here)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with a ``(1 + scale)`` gain, computed in fp32, returned in
    ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """fp32 [head_dim / 2] inverse frequencies."""
    half = head_dim // 2
    i = torch.arange(half, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i * 2 / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding in the half-split form (``x1, x2 = split(x, 2, -1)``,
    not interleaved): x [..., S, D] with positions [..., S] (broadcast), or
    x [..., D] with positions [...]. Angles in fp32; returned in x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    ang = positions.float()[..., None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def gated_act(gate: torch.Tensor, up: torch.Tensor, kind: str) -> torch.Tensor:
    """``swiglu``: silu(gate) * up; ``geglu``: tanh-approximate gelu(gate) * up
    (JAX's ``gelu(approximate=True)``)."""
    if kind == "swiglu":
        return F.silu(gate) * up
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    raise ValueError(kind)


def dense_init(shape, generator: torch.Generator, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """Normal / sqrt(fan_in), drawn on the generator's device (no generator:
    an empty tensor on ``meta``, for shapes only)."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=generator, device=generator.device)
    return w.div_(shape[in_axis] ** 0.5).to(dtype)


def embed_init(shape, generator: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    """Normal * 0.02, drawn on the generator's device (no generator: an
    empty tensor on ``meta``)."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=generator, device=generator.device)
    return w.mul_(0.02).to(dtype)
