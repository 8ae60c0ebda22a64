"""LM-family arch definition: the four assigned shapes per arch and the
serving config of each transformer arch.

Shapes (assigned): train_4k (train), prefill_32k (prefill), decode_32k and
long_500k (serve_step: one token against a KV cache). long_500k runs only for
archs with a sub-quadratic path (gemma2 local/global); pure full-attention
archs skip it.

Sharding plans (the JAX package's, ``distributed/sharding.py``):
  train/prefill: batch->(pod,data); heads/kv_heads/d_ff/experts/vocab->model;
  decode:        ``DECODE_RULES``: heads replicated, the KV cache's seq over
                 model, d_ff/vocab/experts over model.
Each arch may override rules for every kind (``rule_overrides``) and for
decode or prefill alone; :func:`rules_for` stacks them in JAX's order. The
JAX package's ``lowerable`` and ``_traffic`` (the mesh lowering of each cell)
come with the port's dry-run.
"""
from __future__ import annotations

import dataclasses

from .base import Cell
from ..distributed.sharding import DEFAULT_LM_RULES, AxisRules
from ..models.transformer import TransformerConfig, TransformerLM

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

DECODE_RULES: AxisRules = dict(DEFAULT_LM_RULES)
DECODE_RULES.update({
    "heads": None, "kv_heads": None, "d_ff": "model",
    "kv_seq": "model", "vocab": "model", "experts": "model",
})


@dataclasses.dataclass
class LMArch:
    arch_id: str
    cfg: TransformerConfig
    smoke_cfg: TransformerConfig
    supports_long: bool = False
    train_microbatches: int = 1
    rule_overrides: dict = None          # per-arch logical-axis remaps
    decode_rule_overrides: dict = None   # extra remaps for decode cells only
    prefill_rule_overrides: dict = None  # extra remaps for prefill cells only

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


def rules_for(arch: LMArch, kind: str) -> AxisRules:
    """The defaults (``DECODE_RULES`` for decode), then the arch's
    ``rule_overrides``, then its overrides for the kind, as JAX's
    ``lowerable`` stacks them."""
    rules = dict(DECODE_RULES if kind == "decode" else DEFAULT_LM_RULES)
    rules.update(arch.rule_overrides or {})
    if kind in ("prefill", "decode"):
        rules.update(getattr(arch, f"{kind}_rule_overrides") or {})
    return rules
