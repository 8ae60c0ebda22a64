"""GNN (MACE) arch definition: the four assigned graph shapes.

The JAX package's ``lowerable`` (mesh lowering with edges and nodes sharded
over the mesh) and its analytic FLOPs and traffic wait for the port's
dry-run (ROADMAP Queue A item 6b); ``ogb_products``, whose [E, C, 9] fp32
messages alone are 285 GB, waits for several cards (item 6c).
"""
from __future__ import annotations

import dataclasses

import torch

from .base import Cell
from ..models.mace import MACEConfig, MACEModel

# shape table (assigned): padded sizes are chosen divisible by 512
GNN_SHAPES = {
    "full_graph_sm": dict(kind="train", n_nodes=2_708, n_edges=10_556,
                          d_feat=1_433, n_classes=7, task="node_class",
                          pad_nodes=3_072, pad_edges=10_752, n_graphs=1),
    "minibatch_lg": dict(kind="train", n_nodes=232_965, n_edges=114_615_892,
                         batch_nodes=1_024, fanout=(15, 10), d_feat=602,
                         n_classes=41, task="node_class",
                         pad_nodes=172_032, pad_edges=169_984, n_graphs=1),
    "ogb_products": dict(kind="train", n_nodes=2_449_029, n_edges=61_859_140,
                         d_feat=100, n_classes=47, task="node_class",
                         pad_nodes=2_457_600, pad_edges=61_865_984, n_graphs=1),
    "molecule": dict(kind="train", n_nodes=30, n_edges=64, batch=128,
                     task="energy", pad_nodes=3_840, pad_edges=8_192,
                     n_graphs=128),
}


@dataclasses.dataclass
class GNNArch:
    arch_id: str
    base_cfg: MACEConfig
    smoke_cfg: MACEConfig

    family = "gnn"

    def cells(self):
        return [Cell(self.arch_id, s, spec["kind"])
                for s, spec in GNN_SHAPES.items()]

    def cfg_for(self, shape: str) -> MACEConfig:
        s = GNN_SHAPES[shape]
        if s["task"] == "node_class":
            return dataclasses.replace(
                self.base_cfg, d_feat=s["d_feat"], n_classes=s["n_classes"],
                task="node_class")
        return dataclasses.replace(self.base_cfg, d_feat=0, task="energy")

    def batch_specs(self, shape: str) -> dict:
        """name -> (shape, dtype) of a padded batch of ``shape``."""
        s = GNN_SHAPES[shape]
        N, E = s["pad_nodes"], s["pad_edges"]
        specs = {
            "positions": ((N, 3), torch.float32),
            "node_mask": ((N,), torch.float32),
            "senders": ((E,), torch.int32),
            "receivers": ((E,), torch.int32),
            "edge_mask": ((E,), torch.float32),
            "graph_ids": ((N,), torch.int32),
        }
        if s["task"] == "node_class":
            specs["node_feat"] = ((N, s["d_feat"]), torch.float32)
            specs["labels"] = ((N,), torch.int32)
            specs["label_mask"] = ((N,), torch.float32)
        else:
            specs["node_feat"] = ((N,), torch.int32)
            specs["targets"] = ((s["n_graphs"],), torch.float32)
        return specs

    def smoke_model(self, device=None, seed: int = 0) -> MACEModel:
        return MACEModel(self.smoke_cfg, device=device, seed=seed)
