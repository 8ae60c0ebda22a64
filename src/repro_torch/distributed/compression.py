"""Gradient compression for the cross-pod reduction: int8 with error
feedback, the JAX package's ``distributed/compression.py``.

Per-tensor symmetric quantisation: ``scale = max(max|g|, 1e-12) / 127`` in
fp32, ``q = clip(round(g / scale), -127, 127)`` (round half to even, as
``jnp.round``). Error feedback keeps each round's residual ``g - q * scale``
and adds it to the next round's gradient. Both forms are JAX's bit for bit:
``compress`` as JAX runs it op by op (a true division by 127, the residual's
product and difference each rounded), ``psum_compressed`` as XLA compiles
it inside ``shard_map``, which folds the division by the constant into a
product with fp32(1/127) and fuses the residual into one multiply-add (a
gradient element exactly between two steps rounds by it).

  * :func:`compress` / :func:`decompress` / :func:`compress_tree`: pure;
  * :func:`psum_compressed`: the int8 sum over a group. The scale is made
    common with an ``all_reduce(MAX)`` of the local max (one scalar), the
    integers are summed as int32 (exact for up to 2**23 members), and the
    sum is dequantised after the wire.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


_INV_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))
_CHUNK = 1 << 24           # elements a pass of _fused_residual (its fp64 temporaries)


def _quantize(g32: torch.Tensor, scale: torch.Tensor):
    return torch.clamp(torch.round(g32 / scale), -127, 127)


def compress(g: torch.Tensor, ef: torch.Tensor | None = None):
    """-> (q int8, scale fp32 [], new_ef fp32)."""
    g32 = g.float()
    if ef is not None:
        g32 = g32 + ef
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = _quantize(g32, scale).to(torch.int8)
    return q, scale, g32 - q.float() * scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: dict, ef_tree: dict):
    """{name: g}, {name: ef} -> ({name: dequantised g}, {name: new ef})."""
    out = {n: compress(g, ef_tree[n]) for n, g in grads.items()}
    return ({n: decompress(q, s) for n, (q, s, _) in out.items()},
            {n: e for n, (_, _, e) in out.items()})


def init_ef(params: dict) -> dict:
    """fp32 zeros of each parameter's (global) shape."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


class ReplicaGroup:
    """``n`` members that all hold the same tensor, as the pod's members do
    in ``compress_pod`` (the gradient that enters it is the global one):
    ``all_reduce(MAX)`` leaves a tensor as it is and ``all_reduce(SUM)``
    multiplies it by n, which is what the collective returns on n equal
    copies. Stands in for the pod's group where one device plays all of it."""

    def __init__(self, n: int):
        self.n = n

    def size(self) -> int:
        return self.n

    def all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if op == dist.ReduceOp.SUM:
            t.mul_(self.n)
        return t


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    if isinstance(group, ReplicaGroup):
        return group.all_reduce(t, op)
    dist.all_reduce(t, op=op, group=group)
    return t


def _fused_residual(g32: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``g32 - q * scale`` rounded once, as XLA's fused multiply-add gives it:
    in fp64 the product and the difference are exact (the residual is within
    half a step of g32), so their cast is the fused result. In chunks, so
    the fp64 temporaries stay small beside a large gradient."""
    out = torch.empty_like(g32)
    g, qf, o, s = g32.reshape(-1), q.reshape(-1), out.view(-1), scale.double()
    for i in range(0, g.numel(), _CHUNK):
        o[i:i + _CHUNK] = (g[i:i + _CHUNK].double() - qf[i:i + _CHUNK].double() * s).float()
    return out


def psum_compressed(g: torch.Tensor, group, ef: torch.Tensor | None = None):
    """int8-over-the-wire sum of ``g`` over ``group`` (a process group, or a
    :class:`ReplicaGroup`) -> (the fp32 sum, new_ef)."""
    g32 = g.float()
    if ef is not None:
        g32 = g32 + ef
    global_max = _all_reduce(g32.abs().max().clone(), dist.ReduceOp.MAX, group)
    # XLA's form of the division by 127 (module docstring)
    scale = torch.clamp(global_max, min=1e-12) * _INV_127
    q = _quantize(g32, scale).to(torch.int32)
    new_ef = _fused_residual(g32, q, scale)
    total = _all_reduce(q, dist.ReduceOp.SUM, group)
    return total.float() * scale, new_ef
