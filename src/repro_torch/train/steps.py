"""Train-step factories, the JAX package's ``train/steps.py`` on torch.

A step is ``train_step(state, batch) -> (state, metrics)``. ``state.params``
holds the model's own parameters by name (``dict(model.named_parameters())``)
and the step updates them, and the optimizer state, in place: the model
computes its loss with the parameters it owns, so they stay bound to it.
``batch`` is a dict of tensors on the model's device (``feats`` may be a
dict itself).

  * Microbatch gradient accumulation: with ``microbatches = m`` the batch is
    cut along its first axis into m slices; loss and gradients are the
    fp32 *sum* over the slices times ``1/m``, as JAX's ``lax.scan`` does.
  * ``make_fm_sparse_train_step``: FM's step with lazy sparse-row Adam for
    the tables (``optim/sparse_adam.py``) and inline Adam for the bias; the
    pairwise term goes through ``fm_pairwise``, whose backward is a kernel
    on the card.

  * ``make_gnn_train_step``: MACE's step on a padded graph batch, the
    energy task (``energy_force_loss`` without force targets) or node
    classification.

  * ``compress_pod``: under a mesh whose ``pod`` axis is > 1 each gradient
    crosses the pods as int8 with error feedback (JAX's
    ``_maybe_compress_pod``): the gradient that enters is the global one
    (a DTensor gradient is made whole first), every pod member adds its
    quantised copy of ``g / pod`` through ``psum_compressed`` over the
    mesh's ``pod`` group, and the sum goes back to the parameter's
    placements. ``state.ef`` holds fp32 residuals of each parameter's global
    shape on every rank (``init_train_state(compress=True)``), updated in
    place like the moments. Without such a mesh it changes nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..distributed.compression import init_ef, psum_compressed
from ..distributed.sharding import as_dtensor, get_mesh, mesh_shape, plain_as_replicated
from ..kernels.fm_pairwise import ops as fm_ops
from ..kernels.fm_pairwise.ref import clamp_rows, fm_pairwise_ref
from ..optim.adamw import AdamWConfig, adamw_update, cosine_lr, init_opt_state
from ..optim.sparse_adam import sparse_table_update

@dataclasses.dataclass
class TrainState:
    params: dict       # name -> the model's parameter
    opt: dict          # {"mu": {...}, "nu": {...}, "step": int32 []}
    ef: dict           # compress_pod's error-feedback buffers (empty without it)


def init_train_state(params: dict, *, compress: bool = False) -> TrainState:
    return TrainState(params=dict(params), opt=init_opt_state(params),
                      ef=init_ef(params) if compress else {})


def _grads(loss, params: dict) -> dict:
    """d loss / d params; zeros (in the parameter's dtype) for a parameter
    the loss does not reach, as JAX's grad gives."""
    names = list(params)
    with plain_as_replicated():          # the backward meets the blocks' plain tensors too
        got = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    return {n: torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, got)}


def _slice(batch, i: int, m: int):
    """Slice i of m along the first axis (JAX's reshape to [m, B / m])."""
    if isinstance(batch, dict):
        return {k: _slice(v, i, m) for k, v in batch.items()}
    if batch.shape[0] % m:
        raise ValueError(f"microbatches={m} does not divide the batch of {batch.shape[0]}")
    n = batch.shape[0] // m
    return batch[i * n:(i + 1) * n]


def _accumulate_grads(loss_fn: Callable, params: dict, batch, microbatches: int):
    """-> (loss, grads): one pass, or the fp32 sum over ``microbatches``
    slices times 1/microbatches."""
    if microbatches <= 1:
        loss = loss_fn(params, batch)
        return loss.detach(), _grads(loss, params)
    total = torch.zeros((), dtype=torch.float32, device=next(iter(params.values())).device)
    acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in params.items()}
    for i in range(microbatches):
        loss = loss_fn(params, _slice(batch, i, microbatches))
        for n, g in _grads(loss, params).items():
            acc[n] = acc[n] + g
        total = total + loss.detach()
    inv = 1.0 / microbatches
    return total * inv, {n: g * inv for n, g in acc.items()}


def _maybe_compress_pod(grads: dict, ef: dict, mesh, group=None):
    """int8 sum over the pod (module docstring) -> (grads, ef), both dicts
    updated in place: each gradient replaced by its sum and each residual
    written over as it is made, so neither is held twice. ``group`` stands
    in for the mesh's ``pod`` group (a ``ReplicaGroup`` plays a pod on one
    device)."""
    if group is None:
        if mesh is None or mesh_shape(mesh).get("pod", 1) <= 1:
            return grads, ef
        group = mesh.get_group("pod")
    pod = group.size()
    for n, g in grads.items():
        sharded = hasattr(g, "full_tensor")
        total, new_ef = psum_compressed((g.full_tensor() if sharded else g) / pod, group, ef[n])
        ef[n].copy_(new_ef)
        grads[n] = (as_dtensor(total, g.device_mesh).redistribute(g.device_mesh,
                                                                  _summed_placements(g))
                    if sharded else total)
    return grads, ef


def _summed_placements(g) -> tuple:
    """A gradient's placements with any ``Partial`` (already summed into the
    whole gradient) replicated."""
    from torch.distributed.tensor import Partial, Replicate

    return tuple(Replicate() if isinstance(p, Partial) else p for p in g.placements)


def _make_step(loss_fn: Callable, opt_cfg: AdamWConfig, *, microbatches: int = 1,
               compress_pod: bool = False, pod_group=None):
    def train_step(state: TrainState, batch):
        loss, grads = _accumulate_grads(loss_fn, state.params, batch, microbatches)
        ef = state.ef
        if compress_pod:
            grads, ef = _maybe_compress_pod(grads, ef, get_mesh(), pod_group)
        with plain_as_replicated():
            params, opt, metrics = adamw_update(opt_cfg, state.params, grads, state.opt)
        metrics["loss"] = loss
        return TrainState(params=params, opt=opt, ef=ef), metrics

    return train_step


# -- family-specific wrappers -------------------------------------------------
def make_lm_train_step(model, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                       compress_pod: bool = False, pod_group=None):
    def loss_fn(params, batch):
        return model.loss_fn(batch["tokens"], batch["targets"], batch["mask"])

    return _make_step(loss_fn, opt_cfg, microbatches=microbatches,
                      compress_pod=compress_pod, pod_group=pod_group)


def make_gnn_train_step(model, opt_cfg: AdamWConfig, *, task: str = "energy",
                        n_graphs: int = 1, compress_pod: bool = False):
    """``batch`` holds the ``GraphBatch`` fields by name, plus ``targets``
    [n_graphs] (energy) or ``labels`` and ``label_mask`` [N] (node_class)."""
    from ..models.mace import GraphBatch

    def loss_fn(params, batch):
        gb = GraphBatch(
            positions=batch["positions"], node_feat=batch["node_feat"],
            node_mask=batch["node_mask"], senders=batch["senders"],
            receivers=batch["receivers"], edge_mask=batch["edge_mask"],
            graph_ids=batch["graph_ids"], n_graphs=n_graphs,
        )
        if task == "energy":
            return model.energy_force_loss(gb, batch["targets"])
        return model.node_class_loss(gb, batch["labels"], batch["label_mask"])

    return _make_step(loss_fn, opt_cfg, compress_pod=compress_pod)


def make_recsys_train_step(model, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                           compress_pod: bool = False):
    from ..models.recsys import bce_loss

    def loss_fn(params, batch):
        return bce_loss(model(batch["feats"]), batch["labels"])

    return _make_step(loss_fn, opt_cfg, microbatches=microbatches,
                      compress_pod=compress_pod)


def make_fm_sparse_train_step(model, opt_cfg: AdamWConfig):
    """FM's step with lazy sparse-row table updates: only the rows the batch
    touches are read and written. The bias updates by inline Adam (no clip,
    no weight decay), as in JAX. ``state.params`` holds ``tables``,
    ``linear`` and ``bias``; the flat ids of the sparse update are
    ``f * V + id`` from the raw ids, as JAX forms them (the gathers clamp)."""
    from ..models.recsys import bce_loss

    cfg = model.cfg
    V, D, F = cfg.field_vocab, cfg.embed_dim, cfg.n_sparse
    pairwise = fm_ops.fm_pairwise if model.use_kernel else fm_pairwise_ref

    def train_step(state: TrainState, batch):
        params, opt = state.params, state.opt
        ids = batch["feats"]["sparse_ids"]                        # [B, F]
        labels = batch["labels"]
        f_idx = torch.arange(F, device=ids.device)
        rows = clamp_rows(ids, V) + f_idx * V                     # JAX's clamped gathers
        emb_rows = params["tables"].detach().view(F * V, D)[rows].requires_grad_()
        lin_rows = params["linear"].detach().view(F * V, 1)[rows].requires_grad_()
        bias = params["bias"].detach().requires_grad_()
        with torch.enable_grad():
            pair = pairwise(emb_rows)
            loss = bce_loss(bias + lin_rows[..., 0].sum(-1) + pair, labels)
            g_emb, g_lin, g_bias = torch.autograd.grad(loss, (emb_rows, lin_rows, bias))

        step = opt["step"] + 1
        flat_ids = (f_idx[None, :] * V + ids).reshape(-1)
        sparse_table_update(opt_cfg, params["tables"].detach().view(F * V, D),
                            g_emb.reshape(-1, D), flat_ids,
                            opt["mu"]["tables"].view(F * V, D),
                            opt["nu"]["tables"].view(F * V, D), step)
        sparse_table_update(opt_cfg, params["linear"].detach().view(F * V, 1),
                            g_lin.reshape(-1, 1), flat_ids,
                            opt["mu"]["linear"].view(F * V, 1),
                            opt["nu"]["linear"].view(F * V, 1), step)
        with torch.no_grad():    # dense bias: inline Adam
            t = step.to(torch.float32)
            mu_b, nu_b = opt["mu"]["bias"], opt["nu"]["bias"]
            mu_b.copy_(opt_cfg.b1 * mu_b + (1 - opt_cfg.b1) * g_bias)
            nu_b.copy_(opt_cfg.b2 * nu_b + (1 - opt_cfg.b2) * g_bias ** 2)
            upd = (mu_b / (1 - opt_cfg.b1 ** t)) / (
                torch.sqrt(nu_b / (1 - opt_cfg.b2 ** t)) + opt_cfg.eps)
            lr = cosine_lr(opt_cfg, step)
            params["bias"].copy_(params["bias"] - lr * upd)
        opt["step"] = step
        metrics = {"loss": loss.detach(), "lr": lr,
                   "grad_norm": torch.sqrt((g_emb ** 2).sum() + (g_lin ** 2).sum()
                                           + g_bias ** 2)}
        return TrainState(params=params, opt=opt, ef=state.ef), metrics

    return train_step
