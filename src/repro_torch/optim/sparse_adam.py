"""Lazy (touched-rows-only) AdamW for sparse embedding tables, the JAX
package's ``optim/sparse_adam.py`` on torch tensors.

Dense AdamW reads and writes every table row every step; this updates only
the rows a batch touches:
  1. flatten the batch's (field, id) pairs, sort, and sum duplicate rows'
     gradients (duplicates within a batch are summed, not raced);
  2. gather the moments of the <= B*F unique rows and run Adam on them;
  3. scatter the rows and moments back.

Semantics are "lazy Adam", exactly as in JAX: a row no batch touches keeps
stale moments and gets no weight decay. With weight_decay = 0 and every row
touched it equals dense AdamW.

Written out where torch differs from JAX's indexing: JAX's gathers wrap a
negative index once and clamp (``clamp_rows``), and its
``.at[ids].set(..., mode="drop")`` wraps a negative index once and drops
any index still outside [0, R) -- the sentinel ``R`` that pads the unique
ids among them. Torch would raise (on the card, fault), so the drop is an
explicit mask. The table and moments are updated in place.
"""
from __future__ import annotations

import torch

from ..kernels.fm_pairwise.ref import clamp_rows
from .adamw import AdamWConfig, cosine_lr


def dedup_row_grads(flat_ids: torch.Tensor, grad_rows: torch.Tensor, n_rows: int):
    """Sum duplicate rows' gradients.

    flat_ids int[N]; grad_rows [N, D] -> (uniq_ids int32[N] padded with the
    sentinel ``n_rows``, uniq_grads [N, D], valid bool[N])."""
    N = flat_ids.shape[0]
    order = torch.argsort(flat_ids, stable=True)
    s_ids = flat_ids[order]
    s_g = grad_rows[order]
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=flat_ids.device),
                          s_ids[1:] != s_ids[:-1]])
    seg = torch.cumsum(is_start.to(torch.int32), 0) - 1                # [N]
    uniq_g = torch.zeros_like(s_g).index_add_(0, seg, s_g)              # segment_sum
    uniq_ids = torch.full((N,), n_rows, dtype=torch.int32, device=flat_ids.device)
    uniq_ids[seg.long()] = s_ids.to(torch.int32)
    valid = torch.arange(N, device=flat_ids.device) <= seg[-1]
    uniq_ids = torch.where(valid, uniq_ids, n_rows)
    return uniq_ids, uniq_g, valid


@torch.no_grad()
def sparse_table_update(cfg: AdamWConfig, table, grad_rows, flat_ids, mu, nu, step):
    """Lazy-Adam update of ``table`` [R, D] at this batch's rows, in place.

    grad_rows [N, D] are d(loss)/d(gathered rows); flat_ids int[N]; mu, nu
    fp32 [R, D]; step the int32 step of this update. Returns (table, mu, nu)."""
    R, D = table.shape
    uniq_ids, uniq_g, _ = dedup_row_grads(flat_ids, grad_rows, R)
    idx = clamp_rows(torch.clamp(uniq_ids, max=R - 1), R)
    lr = cosine_lr(cfg, step)
    t = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** t
    b2c = 1 - cfg.b2 ** t
    g = uniq_g.float()
    mu_new = cfg.b1 * mu[idx] + (1 - cfg.b1) * g
    nu_new = cfg.b2 * nu[idx] + (1 - cfg.b2) * g * g
    upd = (mu_new / b1c) / (torch.sqrt(nu_new / b2c) + cfg.eps)
    p_rows = table[idx].float()
    p_new = p_rows - lr * (upd + cfg.weight_decay * p_rows)
    # the scatter of mode="drop": wrap a negative id once, drop what is left
    # outside [0, R) (the sentinel R among it)
    ids = uniq_ids.long()
    ids = torch.where(ids < 0, ids + R, ids)
    keep = (ids >= 0) & (ids < R)
    rows = ids[keep]
    table[rows] = p_new[keep].to(table.dtype)
    mu[rows] = mu_new[keep]
    nu[rows] = nu_new[keep]
    return table, mu, nu
