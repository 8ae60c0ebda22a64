"""E(3) machinery for MACE, the JAX package's ``models/e3.py`` on torch:
real spherical harmonics (l <= 2) and the real Gaunt coefficients by
spherical quadrature.

G[i, j, k] = ∫ Y_i Y_j Y_k dΩ over the 9 real SH basis functions (l = 0, 1,
2 flattened as [00, 1-1, 10, 11, 2-2, 2-1, 20, 21, 22]): Gauss-Legendre x
uniform-phi quadrature integrates these degree <= 6 polynomials exactly.
:func:`gaunt_tensor` computes it in numpy float64 with JAX's quadrature and
order of operations, so it is the same array; the model casts it to fp32.

:func:`tensor_product` contracts two [..., C, 9] feature vectors with G.
Its backward is two more such products (it is bilinear), so it is twice
differentiable, and neither direction keeps the [rows, 81] outer products
(``einsum`` would keep one for its backward): the contraction runs over row
chunks of ``TP_CHUNK_ROWS`` (exact: every row is its own sum).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

# real SH normalization constants
_C00 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2A = 1.0925484305920792
_C20 = 0.31539156525252005
_C22 = 0.5462742152960396

N_LM = 9                       # (l_max+1)^2 for l_max = 2
L_OF = np.array([0, 1, 1, 1, 2, 2, 2, 2, 2])  # l of each flattened component
L_SLICES = {0: slice(0, 1), 1: slice(1, 4), 2: slice(4, 9)}
TP_CHUNK_ROWS = 1 << 22        # rows of a [rows, 81] product at a time (1.36 GB fp32)


def real_sph_harm(rhat):
    """rhat [..., 3] unit vectors -> Y [..., 9] (torch or numpy)."""
    xp = np if isinstance(rhat, np.ndarray) else torch
    x, y, z = rhat[..., 0], rhat[..., 1], rhat[..., 2]
    one = xp.ones_like(x)
    return xp.stack(
        [
            _C00 * one,
            _C1 * y, _C1 * z, _C1 * x,
            _C2A * x * y, _C2A * y * z, _C20 * (3 * z * z - 1),
            _C2A * x * z, _C22 * (x * x - y * y),
        ],
        axis=-1,
    )


@functools.lru_cache(maxsize=1)
def gaunt_tensor() -> np.ndarray:
    """G[i, j, k] = ∫ Y_i Y_j Y_k dΩ, shape [9, 9, 9] (numpy, float64)."""
    nt, nphi = 24, 48
    ct, wt = np.polynomial.legendre.leggauss(nt)       # cos(theta) nodes
    phi = (np.arange(nphi) + 0.5) * (2 * np.pi / nphi)
    wphi = 2 * np.pi / nphi
    st = np.sqrt(1 - ct**2)
    # grid of unit vectors [nt*nphi, 3]
    x = st[:, None] * np.cos(phi)[None, :]
    y = st[:, None] * np.sin(phi)[None, :]
    z = np.broadcast_to(ct[:, None], x.shape)
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    w = (wt[:, None] * wphi * np.ones_like(phi)[None, :]).reshape(-1)
    Y = real_sph_harm(pts)                              # [P, 9]
    return np.einsum("p,pi,pj,pk->ijk", w, Y, Y, Y)


def _contract(a, b, gaunt):
    """out[r, k] = sum_ij a[r, i] b[r, j] G[i, j, k] over rows r, in chunks:
    the outer products a_i b_j [r, 81], then one GEMM with G [81, 9]."""
    g = gaunt.reshape(N_LM * N_LM, N_LM)
    out = a.new_empty(a.shape)
    for lo in range(0, a.shape[0], TP_CHUNK_ROWS):
        hi = lo + TP_CHUNK_ROWS
        outer = (a[lo:hi, :, None] * b[lo:hi, None, :]).view(-1, N_LM * N_LM)
        torch.mm(outer, g, out=out[lo:hi])
    return out


class _GauntProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, gaunt):
        ctx.save_for_backward(a, b, gaunt)
        return _contract(a, b, gaunt)

    @staticmethod
    def backward(ctx, grad):
        a, b, gaunt = ctx.saved_tensors
        # d/da_i = sum_jk b_j g_k G_ijk; d/db_j = sum_ik a_i g_k G_ijk
        return (_GauntProduct.apply(b, grad, gaunt.permute(1, 2, 0).contiguous()),
                _GauntProduct.apply(a, grad, gaunt.permute(0, 2, 1).contiguous()), None)


def tensor_product(a, b, gaunt):
    """Equivariant product: a, b [..., C, 9] x G [9, 9, 9] -> [..., C, 9]
    (JAX's ``einsum("...ci,...cj,ijk->...ck")``)."""
    shape = a.shape
    out = _GauntProduct.apply(a.reshape(-1, N_LM), b.reshape(-1, N_LM), gaunt)
    return out.view(shape)


def bessel_rbf(r, n_rbf: int, r_cut: float):
    """Bessel radial basis (MACE/NequIP): sqrt(2/rc)·sin(nπr/rc)/r, n=1..n_rbf."""
    eps = 1e-9
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    rr = torch.clamp(r[..., None], min=eps)
    return math.sqrt(2.0 / r_cut) * torch.sin(n * math.pi * rr / r_cut) / rr


def poly_cutoff(r, r_cut: float, p: int = 6):
    """Polynomial cutoff envelope (DimeNet eq. 8); smooth -> 0 at r_cut."""
    u = torch.clamp(r / r_cut, 0.0, 1.0)
    return (1.0
            - (p + 1) * (p + 2) / 2 * u**p
            + p * (p + 2) * u ** (p + 1)
            - p * (p + 1) / 2 * u ** (p + 2))
