"""RecSys arch definition: the four assigned serving/training shapes per
arch, the feature shapes a batch has, and the analytic FLOPs and minimum
device-memory traffic of a step. ``retrieval_cand`` scores one user against
1M candidates for MIND; the other archs score a batch of candidates through
the ranking path (offline bulk semantics).
"""
from __future__ import annotations

import dataclasses

import torch

from .base import Cell
from ..models.recsys import BSTModel, DINModel, FMModel, MINDModel, RecsysConfig

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_cand=1_048_576),
}

MODEL_CLS = {"fm": FMModel, "din": DINModel, "bst": BSTModel, "mind": MINDModel}


@dataclasses.dataclass
class RecsysArch:
    arch_id: str
    cfg: RecsysConfig
    smoke_cfg: RecsysConfig

    family = "recsys"

    def cells(self):
        return [Cell(self.arch_id, s, spec["kind"])
                for s, spec in RECSYS_SHAPES.items()]

    def feat_specs(self, batch: int) -> dict[str, tuple[tuple, torch.dtype]]:
        """{feature: (shape, dtype)} of a batch of ``batch`` rows."""
        c = self.cfg
        if c.kind == "fm":
            return {"sparse_ids": ((batch, c.n_sparse), torch.int32)}
        f = {
            "hist_items": ((batch, c.seq_len), torch.int32),
            "hist_mask": ((batch, c.seq_len), torch.float32),
            "target_item": ((batch,), torch.int32),
        }
        if c.kind == "din":
            f["hist_cates"] = ((batch, c.seq_len), torch.int32)
            f["target_cate"] = ((batch,), torch.int32)
        return f

    def _flops(self, batch: int) -> float:
        c = self.cfg
        d = c.embed_dim
        if c.kind == "fm":
            return 2.0 * batch * c.n_sparse * d * 2
        L = c.seq_len
        if c.kind == "din":
            att = L * (8 * d) * 80 + L * 80 * 40
            mlp = (6 * d) * 200 + 200 * 80
            return 2.0 * batch * (att + mlp)
        if c.kind == "bst":
            blk = c.n_blocks * (4 * (L + 1) * d * d + 2 * (L + 1) ** 2 * d
                                + 8 * (L + 1) * d * d)
            mlp = (L + 1) * d * 1024 + 1024 * 512 + 512 * 256
            return 2.0 * batch * (blk + mlp)
        # mind: routing iters x (K x L x D) + retrieval handled separately
        return 2.0 * batch * c.capsule_iters * c.n_interests * L * d * 2

    def _traffic(self, batch: int, train: bool, params) -> float:
        """Minimum bytes of a step; ``params`` iterates over the model's
        parameter tensors (shapes are all it reads: meta tensors do)."""
        c = self.cfg
        pbytes = sum(float(p.numel()) * 4 for p in params)
        n_rows = batch * (c.n_sparse if c.kind == "fm" else c.seq_len + 1)
        gather = 2.0 * n_rows * c.embed_dim * 4
        if train:
            # dense AdamW touches every table row each step: 34x param bytes
            return 34.0 * pbytes + 3 * gather
        return gather + pbytes * 0.01  # serving reads MLP params only
