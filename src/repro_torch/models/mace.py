"""MACE: higher-order equivariant message passing (arXiv:2206.07697), the
JAX package's ``models/mace.py`` on torch, in fp32 end to end.

  * edge embedding: Bessel RBF x polynomial cutoff x real spherical harmonics;
  * density (A-features): A_i = Σ_{j∈N(i)} R_cl(r_ij) · TP(h_j, Y(r̂_ij)) with
    the real Gaunt coupling tensor and a segment sum over receivers;
  * correlation order 3 by iterated equivariant products: B1 = A,
    B2 = TP(A, A), B3 = TP(B2, A), mixed per l by learned channel matrices;
  * residual update + gated nonlinearity on scalars; invariant readout.

Tasks: "energy" (per-graph energy; forces by autograd in
``energy_force_loss``) and "node_class" (node classification; positions for
such graphs are synthesized upstream, ``data/graphs.synth_positions``).

``MACEModel`` is an ``nn.Module`` built on ``device`` (default: the card)
from a ``torch.Generator`` seeded with ``seed``; ``convert.
mace_params_from_arrays`` carries JAX parameters across. The parameters keep
the JAX tree's names: ``embed``, ``layers.<i>.<name>`` (an ``nn.ModuleList``
of ``MACELayer``), ``read1``, ``read2``. The model runs no TPU kernel: its
products are library calls (``einsum``, ``matmul``, ``bmm``).

Graph batch layout (padded, fixed shapes; see ``data/graphs.py``):
  positions [N,3]  node_feat [N,F] (or species int [N])  node_mask [N]
  senders/receivers int[E]  edge_mask [E]  graph_ids int[N]  n_graphs

Hazards written out:
  * ``jax.ops.segment_sum`` drops out-of-range segment ids; ``segment_sum``
    here sends them to a spare row, and sums with an accumulating
    ``index_put_`` (sorted, not atomic, on the card: two calls give the same
    bytes).
  * Gathers by node id (species, ``h[senders]``, ``positions[...]``) clamp
    as JAX's do (``clamp_rows``); an out-of-range label gives a NaN nll, as
    ``take_along_axis`` does.
  * A padded self-edge has ``vec = 0``: ``norm(vec + 1e-12)`` and
    ``vec / max(dist, 1e-9)`` keep Y finite, and its mask zeroes its
    message and gradient. JAX gathers and sums every padded edge at node 0;
    here an edge whose mask is 0 gathers and sums its (zero) message at node
    ``e % N`` instead: the sums are the same, and the sorted accumulations
    of the scatter and of the gather's backward do not add ~10^5 zeros into
    one row one after another (minibatch_lg pads 153,570 of its 169,984
    edges). The geometry keeps the edges' own ids.
  * The edge product TP(h_src, Y) contracts Y with G first ([E, 9, 9]), so
    no [E, C, 9, 9] tensor is made; the node products go through
    ``e3.tensor_product``, which keeps no [N * C, 81] tensor either.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..backend import resolve_device
from ..distributed.sharding import shard_hint
from .e3 import L_SLICES, N_LM, bessel_rbf, gaunt_tensor, poly_cutoff, real_sph_harm, \
    tensor_product
from .layers import clamp_rows, dense_init
from .transformer import take_targets


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128            # channels C
    l_max: int = 2
    correlation_order: int = 3
    n_rbf: int = 8
    r_cut: float = 5.0
    n_species: int = 16            # for molecular inputs
    d_feat: int = 0                # >0: dense node features (citation graphs)
    n_classes: int = 0             # >0: node classification head
    task: str = "energy"           # "energy" | "node_class"
    dtype: Any = torch.float32


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    positions: torch.Tensor    # [N, 3]
    node_feat: torch.Tensor    # [N, F] float or [N] int species
    node_mask: torch.Tensor    # [N] float
    senders: torch.Tensor      # [E] int (message source)
    receivers: torch.Tensor    # [E] int
    edge_mask: torch.Tensor    # [E] float
    graph_ids: torch.Tensor    # [N] int
    n_graphs: int


def segment_sum(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(data, ids, num_segments=n)``: rows with an id
    outside [0, n) are dropped. Deterministic on the card."""
    ids = ids.long()
    ids = torch.where((ids >= 0) & (ids < n), ids, n)
    out = data.new_zeros((n + 1,) + data.shape[1:])
    return out.index_put((ids,), data, accumulate=True)[:n]


def _mix(w, feat):
    """out[n, d, m] = sum_c w[c, d] feat[n, c, m] (JAX's "cd,ncm->ndm")."""
    return torch.einsum("cd,ncm->ndm", w, feat)


class MACELayer(nn.Module):
    def __init__(self, C: int, n_rbf: int, g: torch.Generator):
        super().__init__()
        n_l = len(L_SLICES)

        def dense(*shape):
            return nn.Parameter(dense_init(shape, g))

        self.rad1 = dense(n_rbf, 64)          # radial MLP: n_rbf -> C per output l
        self.rad2 = dense(64, C * n_l)
        self.w_self = dense(C, C)             # neighbor-feature mix before the edge TP
        self.w_b1 = dense(n_l, C, C)          # per-correlation-order, per-l channel mixing
        self.w_b2 = dense(n_l, C, C)
        self.w_b3 = dense(n_l, C, C)
        self.w_res = dense(C, C)              # residual + update
        self.gate = dense(C, C)


class MACEModel(nn.Module):
    def __init__(self, cfg: MACEConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        g = torch.Generator(device=self.device).manual_seed(seed)
        c, C = cfg, cfg.d_hidden
        if c.d_feat > 0:
            self.embed = nn.Parameter(dense_init((c.d_feat, C), g))
        else:
            self.embed = nn.Parameter(0.1 * torch.randn((c.n_species, C), generator=g,
                                                        device=self.device))
        self.layers = nn.ModuleList(MACELayer(C, c.n_rbf, g) for _ in range(c.n_layers))
        self.read1 = nn.Parameter(dense_init((C, 64), g))
        self.read2 = nn.Parameter(dense_init((64, 1 if c.task == "energy" else c.n_classes), g))
        self.register_buffer("gaunt", torch.tensor(gaunt_tensor(), dtype=torch.float32,
                                                   device=self.device), persistent=False)

    # -- helpers -----------------------------------------------------------------
    def _mix_per_l(self, w, feat):
        """w [n_l, C, C] x feat [N, C, 9] -> [N, C, 9] (per-l channel mix)."""
        return torch.cat([_mix(w[li], feat[:, :, sl])
                          for li, (_, sl) in enumerate(sorted(L_SLICES.items()))], dim=-1)

    def _layer(self, lp: MACELayer, h, edges):
        """h [N, C, 9] -> [N, C, 9]."""
        senders, receivers, Y, rad, edge_mask, N = edges
        C = self.cfg.d_hidden
        h_src = _mix(lp.w_self, h)[senders]                              # [E, C, 9]
        # edge TP with Y as a one-channel irrep vector: contract Y with G first
        yg = torch.einsum("ej,ijk->eik", Y, self.gaunt)                  # [E, 9, 9]
        msg = torch.bmm(h_src, yg)                                       # [E, C, 9]
        # radial modulation per output l
        r = (F.silu(rad @ lp.rad1) @ lp.rad2).reshape(-1, C, len(L_SLICES))
        rw = torch.cat([r[:, :, li:li + 1].expand(-1, -1, sl.stop - sl.start)
                        for li, (_, sl) in enumerate(sorted(L_SLICES.items()))], dim=2)
        msg = msg * rw * edge_mask[:, None, None]
        A = shard_hint(segment_sum(msg, receivers, N), "nodes", None, None)   # [N, C, 9]
        # higher-order products (correlation order 3)
        B2 = tensor_product(A, A, self.gaunt)
        B3 = tensor_product(B2, A, self.gaunt)
        m = (self._mix_per_l(lp.w_b1, A) + self._mix_per_l(lp.w_b2, B2)
             + self._mix_per_l(lp.w_b3, B3))
        # update: residual + scalar-gated nonlinearity
        out = m + _mix(lp.w_res, h)
        gate = F.silu(out[:, :, 0] @ lp.gate)                            # [N, C]
        return out * gate[:, :, None]

    # -- forward -------------------------------------------------------------------
    def forward(self, batch: GraphBatch):
        """-> per-graph energy [n_graphs] ("energy") or logits [N, n_classes]."""
        c = self.cfg
        N = batch.positions.shape[0]
        if c.d_feat > 0:
            h0 = batch.node_feat @ self.embed                            # [N, C]
        else:
            h0 = self.embed[clamp_rows(batch.node_feat, c.n_species)]
        h = torch.cat([h0[:, :, None], h0.new_zeros(N, c.d_hidden, N_LM - 1)], dim=-1)
        h = h * batch.node_mask[:, None, None]
        # edge geometry
        pos = batch.positions
        vec = pos[clamp_rows(batch.receivers, N)] - pos[clamp_rows(batch.senders, N)]
        dist = torch.linalg.norm(vec + 1e-12, dim=-1)
        rhat = vec / torch.clamp(dist[:, None], min=1e-9)
        Y = real_sph_harm(rhat)                                          # [E, 9]
        rad = bessel_rbf(dist, c.n_rbf, c.r_cut) * poly_cutoff(dist, c.r_cut)[:, None]
        live = batch.edge_mask != 0
        spread = torch.arange(live.shape[0], device=live.device) % N
        edges = (torch.where(live, clamp_rows(batch.senders, N), spread),
                 torch.where(live, batch.receivers.long(), spread), Y, rad, batch.edge_mask, N)
        for lp in self.layers:
            h = self._layer(lp, h, edges)
            h = h * batch.node_mask[:, None, None]
        feat = F.silu(h[:, :, 0] @ self.read1)                           # invariants
        out = feat @ self.read2
        if c.task == "energy":
            return segment_sum(out[:, 0] * batch.node_mask, batch.graph_ids, batch.n_graphs)
        return out                                                       # [N, n_classes]

    # -- losses ----------------------------------------------------------------------
    def energy_force_loss(self, batch: GraphBatch, targets, force_targets=None,
                          force_w: float = 1.0):
        """Mean squared energy error, plus ``force_w`` x the mean squared force
        error over real nodes when ``force_targets`` [N, 3] are given (forces
        = -dE/dpositions, kept in the graph for the parameters' gradient)."""
        if force_targets is None:
            return torch.mean((self(batch) - targets) ** 2)
        pos = batch.positions.detach().requires_grad_()
        pred_e = self(dataclasses.replace(batch, positions=pos))
        (neg_f,) = torch.autograd.grad(pred_e.sum(), pos, create_graph=True)
        loss = torch.mean((pred_e - targets) ** 2)
        return loss + force_w * torch.mean(
            ((-neg_f - force_targets) * batch.node_mask[:, None]) ** 2)

    def node_class_loss(self, batch: GraphBatch, labels, label_mask):
        """Masked mean nll over labelled real nodes (NaN for a label outside
        [-n_classes, n_classes), as JAX's ``take_along_axis``)."""
        logp = torch.log_softmax(self(batch), dim=-1)
        nll = -take_targets(logp, labels)
        w = label_mask * batch.node_mask
        return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
