"""LM-family arch definition: the four assigned shapes per arch and the
serving config of each transformer arch.

Shapes (assigned): train_4k (train), prefill_32k (prefill), decode_32k and
long_500k (serve_step: one token against a KV cache). long_500k runs only for
archs with a sub-quadratic path (gemma2 local/global); pure full-attention
archs skip it.

The JAX package's ``lowerable`` (mesh lowering), ``_traffic`` and the
sharding rule overrides wait for the port's distribution work.
"""
from __future__ import annotations

import dataclasses

from .base import Cell
from ..models.transformer import TransformerConfig, TransformerLM

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


@dataclasses.dataclass
class LMArch:
    arch_id: str
    cfg: TransformerConfig
    smoke_cfg: TransformerConfig
    supports_long: bool = False

    family = "lm"

    def cells(self):
        out = []
        for shape, spec in LM_SHAPES.items():
            skip = None
            if shape == "long_500k" and not self.supports_long:
                skip = ("pure full-attention arch: no sub-quadratic path for "
                        "524k decode (DESIGN.md §5)")
            out.append(Cell(self.arch_id, shape, spec["kind"], skip))
        return out

    def smoke_model(self, device=None, seed: int = 0) -> TransformerLM:
        return TransformerLM(self.smoke_cfg, device=device, seed=seed)
