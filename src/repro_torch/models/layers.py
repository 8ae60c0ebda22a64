"""Shared neural layers of the JAX package's ``models/layers.py``: what the
recsys models need (``rms_norm``, ``dense_init``, ``embed_init``).

The initialisers draw from a ``torch.Generator``; the JAX package draws from
``jax.random`` keys, so the same seed gives other values. Parity with the
JAX package goes through ``convert.recsys_params_from_arrays``.
"""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with a ``(1 + scale)`` gain, computed in fp32, returned in
    ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def dense_init(shape, generator: torch.Generator, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """Normal / sqrt(fan_in), drawn on the generator's device."""
    w = torch.randn(shape, generator=generator, device=generator.device)
    return w.div_(shape[in_axis] ** 0.5).to(dtype)


def embed_init(shape, generator: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    """Normal * 0.02, drawn on the generator's device."""
    w = torch.randn(shape, generator=generator, device=generator.device)
    return w.mul_(0.02).to(dtype)
