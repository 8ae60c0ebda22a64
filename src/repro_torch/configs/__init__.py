"""Arch registry of the ported architectures: ``get_arch(<id>)``. One
module per architecture, with the JAX package's configs' values, and the
paper's own system (``qac-ebay``)."""
from __future__ import annotations

from .base import Cell  # noqa: F401
from .bst import ARCH as _bst
from .din import ARCH as _din
from .fm import ARCH as _fm
from .gemma2_2b import ARCH as _gemma2
from .mace import ARCH as _mace
from .mind import ARCH as _mind
from .qac_ebay import ARCH as _qac
from .qwen2_moe_a2_7b import ARCH as _qwen2moe
from .qwen3_14b import ARCH as _qwen3
from .qwen3_moe_235b_a22b import ARCH as _qwen3moe
from .smollm_360m import ARCH as _smollm

ARCHS = {a.arch_id: a for a in [_smollm, _qwen3, _gemma2, _qwen2moe, _qwen3moe, _mace, _mind,
                                _bst, _din, _fm, _qac]}


def get_arch(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch '{arch_id}'; have {sorted(ARCHS)}")
    return ARCHS[arch_id]


def list_archs():
    return sorted(ARCHS)
