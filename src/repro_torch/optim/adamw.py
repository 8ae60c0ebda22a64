"""Decoupled AdamW with a warmup-cosine schedule and global-norm clipping,
the JAX package's ``optim/adamw.py`` on torch tensors.

Parameters, gradients and the moments are dicts of tensors keyed by the
model's parameter names (``dict(model.named_parameters())``); the optimizer
state keeps the JAX tree's names: ``{"mu": {...}, "nu": {...}, "step":
int32 []}``. As in JAX: the moments are fp32 even for bf16 parameters, the
new parameter is computed in fp32 and cast back to the parameter's dtype,
``scale`` is exactly 1.0 when ``clip_norm == 0``, and the schedule is
computed in fp32. Unlike JAX, ``adamw_update`` updates the parameters and
the moments in place, under ``torch.no_grad()``, so that a model's
parameters stay bound to it; it returns the same dicts.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """fp32 learning rate at ``step`` (an integer tensor or number)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    t = ((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.min_lr_frac * cfg.lr + (1 - cfg.min_lr_frac) * cfg.lr * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: dict) -> dict:
    """fp32 zero moments for every parameter and an int32 step of 0."""
    zeros = {n: torch.zeros_like(p, dtype=torch.float32)     # a DTensor's placements too
             for n, p in params.items()}
    device = next(iter(params.values())).device if params else None
    return {"mu": zeros, "nu": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree.values()))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, state: dict):
    """-> (params, state, metrics), params and moments updated in place."""
    step = state["step"] + 1
    gn = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
             if cfg.clip_norm > 0 else None)       # None: exactly 1.0
    lr = cosine_lr(cfg, step)
    t = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** t
    b2c = 1 - cfg.b2 ** t
    for name, p in params.items():
        g = grads[name].float()
        if scale is not None:
            g = g * scale
        mu, nu = state["mu"][name], state["nu"][name]
        mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
        nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * g * g)
        step_v = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        pf = p.float()
        p.copy_(pf - lr * (step_v + cfg.weight_decay * pf))
    state["step"] = step
    return params, state, {"grad_norm": gn, "lr": lr}
