"""FM's CUDA kernels on the card: ``fm_pairwise`` and ``fm_forward``.

On CUDA tensors each wrapper launches its kernel in ``csrc/fm_pairwise.cu``
or raises ``ValueError``; on CPU tensors it runs its plain version in
``ref.py``. Same contract either way.

* ``fm_pairwise(emb)``: the TPU kernel's contract, emb [B, F, D] ->
  float32[B] (one warp per row). ``launches`` counts its launches. Under
  grad (grad enabled and emb requiring it) it goes through ``FMPairwise``,
  whose backward is ``fm_pairwise_bwd``: a second kernel in the same source
  on the card (``bwd_launches``), ``ref.fm_pairwise_bwd_ref`` on the CPU.
* ``fm_forward(ids, tables, linear, bias)``: FM's whole forward from the
  ids in one launch (clamp, both gathers, the pairwise term, the bias),
  with no index or [B, F, D] tensor in device memory; its launch shape is
  :func:`plan_fm_forward`. ``forward_launches`` counts its launches. It
  is the serving fusion and has no backward: it refuses grad. FM trains
  through the gathers and ``fm_pairwise`` (``models/recsys.py``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from ... import backend
from .ref import fm_forward_ref, fm_pairwise_bwd_ref, fm_pairwise_ref

launches = 0
forward_launches = 0
bwd_launches = 0

MAX_F, MAX_D = 64, 128
# csrc/fm_pairwise.cu's kThreads, kEltsPerLane: threads a block, fp32
# accumulators (s and sq each) a lane holds
THREADS, ELTS_PER_LANE = 128, 16
FILL_THREADS = 132 * 1024     # split the fields over lanes until B rows give this many
_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_FORWARD_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p] \
    + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def fm_pairwise(emb: torch.Tensor) -> torch.Tensor:
    """emb float32 or bfloat16 [B, F, D], contiguous, 1 <= F <= 64 and
    1 <= D <= 128 on the card -> float32[B]."""
    if emb.requires_grad and torch.is_grad_enabled():
        return FMPairwise.apply(emb)
    return _pairwise(emb)


def _check_emb(name: str, emb: torch.Tensor) -> None:
    backend.require_cuda_float(name, emb=emb)
    if emb.dim() != 3:
        raise ValueError(f"{name}: emb must be [B, F, D], got {tuple(emb.shape)}")
    B, F, D = emb.shape
    if not (1 <= F <= MAX_F and 1 <= D <= MAX_D):
        raise ValueError(f"{name}: needs 1 <= F <= {MAX_F} and 1 <= D <= {MAX_D}, "
                         f"got F={F}, D={D}")


def _pairwise(emb: torch.Tensor) -> torch.Tensor:
    global launches
    if not emb.is_cuda:
        return fm_pairwise_ref(emb)
    _check_emb("fm_pairwise", emb)
    B, F, D = emb.shape
    out = torch.empty(B, dtype=torch.float32, device=emb.device)
    if B == 0:
        return out
    fn = backend.load("fm_pairwise", "fm_pairwise_launch", _ARGS)
    err = fn(backend.ptr(emb), backend.FLOAT_CODES[emb.dtype], backend.ptr(out),
             B, F, D, backend.stream(emb.device))
    backend.check("fm_pairwise", err)
    launches += 1
    return out


class FMPairwise(torch.autograd.Function):
    """``fm_pairwise`` with ``fm_pairwise_bwd`` as its backward: the kernels
    on CUDA tensors, their plain versions on the CPU."""

    @staticmethod
    def forward(ctx, emb):
        ctx.save_for_backward(emb)
        return _pairwise(emb)

    @staticmethod
    def backward(ctx, g):
        (emb,) = ctx.saved_tensors
        return fm_pairwise_bwd(emb, g.float().contiguous())


def fm_pairwise_bwd(emb: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient of ``fm_pairwise`` at emb for the cotangent g float32[B]:
    ``g[b] * (sum_f' emb[b, f'] - emb[b, f])`` in emb's dtype [B, F, D]. On
    the card emb is as ``fm_pairwise`` takes it and g contiguous fp32."""
    global bwd_launches
    if not emb.is_cuda:
        return fm_pairwise_bwd_ref(emb, g)
    _check_emb("fm_pairwise_bwd", emb)
    B, F, D = emb.shape
    if g.shape != (B,) or g.dtype != torch.float32 or not g.is_contiguous() \
            or g.device != emb.device:
        raise ValueError(f"fm_pairwise_bwd: g must be contiguous float32[{B}] on "
                         f"{emb.device}, got {tuple(g.shape)} {g.dtype} on {g.device}")
    grad = torch.empty_like(emb)
    if B == 0:
        return grad
    fn = backend.load("fm_pairwise", "fm_pairwise_bwd_launch", _BWD_ARGS)
    err = fn(backend.ptr(emb), backend.ptr(g), backend.ptr(grad),
             backend.FLOAT_CODES[emb.dtype], B, F, D, backend.stream(emb.device))
    backend.check("fm_pairwise", err)
    bwd_launches += 1
    return grad


@dataclasses.dataclass(frozen=True)
class ForwardPlan:
    vec: int          # bytes a table load brings
    lanes_d: int      # lanes splitting a row's d
    lanes_f: int      # lanes splitting its fields
    rows: int         # rows a block
    blocks: int
    shared_bytes: int


@functools.lru_cache(maxsize=256)   # a plan costs ~6 us of host time a call
def plan_fm_forward(B: int, F: int, D: int, elt: int, align: int,
                    elts_per_lane: int = ELTS_PER_LANE) -> ForwardPlan:
    """The launch shape of ``fm_forward_kernel`` for B rows of F fields of D
    elements of ``elt`` bytes, from a table whose address is a multiple of
    ``align``: the widest load (16, 8, 4 or 2 bytes, at least an element)
    that divides a row and the address; the fewest lanes_d (a power of two)
    whose loads hold a row in ``elts_per_lane`` accumulators a lane (the
    kernel's kEltsPerLane, or at least one load's elements); then lanes_f
    doubled, up to a warp's group and F, while the rows give fewer than
    FILL_THREADS threads."""
    row_bytes = D * elt
    vec = max(v for v in (16, 8, 4, 2)
              if v >= elt and row_bytes % v == 0 and align % v == 0)
    per = vec // elt
    loads = max(1, elts_per_lane // per)
    lanes_d = 1
    while -(-(row_bytes // vec) // lanes_d) > loads:
        lanes_d *= 2
    lanes_f = 1
    while lanes_d * lanes_f < 32 and lanes_f < F and B * lanes_d * lanes_f < FILL_THREADS:
        lanes_f *= 2
    rows = THREADS // (lanes_d * lanes_f)
    return ForwardPlan(vec, lanes_d, lanes_f, rows, -(-B // rows), rows * F * 4)


def fm_forward(ids: torch.Tensor, tables: torch.Tensor, linear: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """FM's forward, ``bias + sum_f linear[f, id] + pair(tables[f, id])``:
    ids int32 [B, F], tables float32 or bfloat16 [F, V, D], linear [F, V, 1]
    and bias [] (or [1]) of the tables' dtype, all contiguous on one card,
    1 <= F <= 64 and 1 <= D <= 128 -> float32[B]. A negative id wraps once,
    then every id clamps to [0, V-1] (numpy-style indexing)."""
    global forward_launches
    if not any(t.is_cuda for t in (ids, tables, linear, bias)):
        return fm_forward_ref(ids, tables, linear, bias)
    backend.require_cuda_int32("fm_forward", ids=ids)
    backend.require_cuda_float("fm_forward", tables=tables, linear=linear, bias=bias)
    if ids.device != tables.device:
        raise ValueError(f"fm_forward: ids on {ids.device}, tables on {tables.device}")
    if any(t.requires_grad for t in (tables, linear, bias)) and torch.is_grad_enabled():
        raise ValueError("fm_forward: the serving fusion has no backward; call it under "
                         "torch.inference_mode() or torch.no_grad() (FMModel trains through "
                         "the gathers and fm_pairwise)")
    if ids.dim() != 2 or tables.dim() != 3:
        raise ValueError(f"fm_forward: needs ids [B, F] and tables [F, V, D], got "
                         f"{tuple(ids.shape)} and {tuple(tables.shape)}")
    F, V, D = tables.shape
    if not (1 <= F <= MAX_F and 1 <= D <= MAX_D and V >= 1):
        raise ValueError(f"fm_forward: needs 1 <= F <= {MAX_F}, 1 <= D <= {MAX_D} and "
                         f"V >= 1, got F={F}, V={V}, D={D}")
    if ids.shape[1] != F or linear.shape != (F, V, 1) or bias.numel() != 1 \
            or bias.dim() > 1 or linear.dtype != tables.dtype or bias.dtype != tables.dtype:
        raise ValueError(f"fm_forward: ids {tuple(ids.shape)}, linear "
                         f"{tuple(linear.shape)} {linear.dtype} and bias "
                         f"{tuple(bias.shape)} {bias.dtype} do not fit tables "
                         f"{tuple(tables.shape)} {tables.dtype}")
    B = ids.shape[0]
    out = torch.empty(B, dtype=torch.float32, device=tables.device)
    if B == 0:
        return out
    plan = plan_fm_forward(B, F, D, tables.element_size(), math.gcd(tables.data_ptr(), 16))
    fn = backend.load("fm_pairwise", "fm_forward_launch", _FORWARD_ARGS)
    err = fn(backend.ptr(ids), backend.ptr(tables), backend.ptr(linear), backend.ptr(bias),
             backend.FLOAT_CODES[tables.dtype], backend.ptr(out), B, F, V, D,
             plan.vec, plan.lanes_d, plan.lanes_f, backend.stream(tables.device))
    backend.check("fm_pairwise", err)
    forward_launches += 1
    return out
