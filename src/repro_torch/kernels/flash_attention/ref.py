"""Plain PyTorch versions of flash attention, transcriptions of the JAX
package's ``kernels/flash_attention/ref.py`` (``flash_attention_ref``) and
``xla_flash.py`` (``flash_attention_blockwise``), the split-KV decode
kernel's split-and-merge arithmetic (``flash_decode_split``, for the tests),
and the backward kernel's equations (``flash_attention_bwd_ref``: the
gradient that ``jax.vjp`` of the JAX package's ``flash_attention_ref``
gives).

Semantics shared with the kernel (``csrc/flash_attention.cu``):
  q: [B, H, Sq, D]; k, v: [B, G, Skv, D] with H = G * rep (GQA: head h reads
     kv head h // rep)
  causal: offset-aware -- query row i attends to kv col j iff
     j <= i + (Skv - Sq), so decode with Sq = 1 sees the whole cache
  window: if w > 0, additionally j > i + (Skv - Sq) - w (sliding window)
  softcap: if c > 0, scores = c * tanh(scores / c)
  kv_len: [B] valid kv length per batch row (cols >= kv_len are masked)
Scores and the softmax are fp32; masked scores are filled with ``NEG`` and
their weights set to 0, and the denominator is clamped at 1e-30, so a fully
masked row gives 0 and not NaN. The output has q's dtype.
"""
from __future__ import annotations

import torch

NEG = -1e30


def _mask(Sq: int, cols: torch.Tensor, Skv: int, causal: bool, window: int,
          kv_len, device) -> torch.Tensor:
    """bool [B or 1, 1, Sq, len(cols)]: which (row, col) pairs are live."""
    row = torch.arange(Sq, device=device)[:, None] + (Skv - Sq)
    col = cols[None, :]
    mask = torch.ones((Sq, cols.numel()), dtype=torch.bool, device=device)
    if causal:
        mask &= col <= row
    if window and window > 0:
        mask &= col > row - window
    mask = mask[None, None]
    if kv_len is not None:
        mask = mask & (col[None, None] < kv_len.to(device)[:, None, None, None])
    return mask


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                        kv_len=None, sm_scale=None):
    """Attention with the whole [Sq, Skv] score matrix materialised."""
    B, H, Sq, D = q.shape
    G, Skv = k.shape[1], k.shape[2]
    rep = H // G
    scale = sm_scale if sm_scale is not None else D ** -0.5
    kk = k.repeat_interleave(rep, dim=1).float()
    vv = v.repeat_interleave(rep, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    if softcap and softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    m = _mask(Sq, torch.arange(Skv, device=q.device), Skv, causal, window, kv_len,
              q.device)
    s = torch.where(m, s, NEG)
    w = torch.exp(s - s.amax(-1, keepdim=True))
    w = torch.where(m, w, 0.0)
    denom = w.sum(-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", w / denom, vv)
    return out.to(q.dtype)


def flash_attention_blockwise(q, k, v, *, causal=True, window=0, softcap=0.0,
                              kv_len=None, sm_scale=None, block_k: int = 1024):
    """The online-softmax recurrence over kv blocks of ``block_k`` (the JAX
    package's scan, as a loop): O(Sq * D) memory beside one [Sq, block_k]
    score tile per head instead of the whole [Sq, Skv] matrix."""
    B, H, Sq, D = q.shape
    G, Skv = k.shape[1], k.shape[2]
    rep = H // G
    scale = sm_scale if sm_scale is not None else D ** -0.5
    bk = min(block_k, Skv)
    qg = q.reshape(B, G, rep, Sq, D).float() * scale
    m = torch.full((B, G, rep, Sq, 1), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, G, rep, Sq, D), dtype=torch.float32, device=q.device)
    for c0 in range(0, Skv, bk):
        kb = k[:, :, c0:c0 + bk].float()
        vb = v[:, :, c0:c0 + bk].float()
        s = torch.einsum("bgrqd,bgkd->bgrqk", qg, kb)
        if softcap and softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        cols = torch.arange(c0, c0 + kb.shape[2], device=q.device)
        mask = _mask(Sq, cols, Skv, causal, window, kv_len, q.device)[:, :, None]
        s = torch.where(mask, s, NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bgrqk,bgkd->bgrqd", p, vb)
        m = m_new
    out = acc / l.clamp(min=1e-30)
    return out.reshape(B, H, Sq, D).to(q.dtype)


def split_ranges(splits: int, split_cols: int, Skv: int) -> list[tuple[int, int]]:
    """The column range [lo, hi) of each split of an ``ops.plan_splits`` plan."""
    return [(i * split_cols, min((i + 1) * split_cols, Skv)) for i in range(splits)]


def flash_decode_split(q, k, v, kv_len=None, *, causal=True, window=0, softcap=0.0,
                       sm_scale=None, splits: int = 1, split_cols=None):
    """The decode kernel's arithmetic written out: the cache's columns cut
    into ``splits`` ranges of ``split_cols`` (``split_ranges``); each split's
    masked softmax state (m, l, acc) in fp32, a split with no live column
    giving (NEG, 0, 0); then the merge in split order: M the largest m,
    L = sum over the splits with l > 0 of l * exp(m - M), and the output
    sum of acc * exp(m - M) over those splits, divided by max(L, 1e-30).
    q [B, H, Sq, D], k, v [B, G, Skv, D] as ``flash_attention_ref``."""
    B, H, Sq, D = q.shape
    G, Skv = k.shape[1], k.shape[2]
    rep = H // G
    scale = sm_scale if sm_scale is not None else D ** -0.5
    cols = split_cols if split_cols is not None else -(-Skv // splits)
    qg = q.reshape(B, G, rep, Sq, D).float() * scale
    parts = []
    for lo, hi in split_ranges(splits, cols, Skv):
        if hi <= lo:    # past the cache: an empty partial
            parts.append((torch.full((B, G, rep, Sq, 1), NEG, device=q.device),
                          torch.zeros((B, G, rep, Sq, 1), device=q.device), 0.0))
            continue
        kb, vb = k[:, :, lo:hi].float(), v[:, :, lo:hi].float()
        s = torch.einsum("bgrqd,bgkd->bgrqk", qg, kb)
        if softcap and softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        mask = _mask(Sq, torch.arange(lo, hi, device=q.device), Skv, causal, window, kv_len,
                     q.device)[:, :, None]
        s = torch.where(mask, s, NEG)
        m = s.amax(-1, keepdim=True)
        w = torch.where(mask, torch.exp(s - torch.where(m == NEG, 0.0, m)), 0.0)
        parts.append((m, w.sum(-1, keepdim=True), torch.einsum("bgrqk,bgkd->bgrqd", w, vb)))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    mu = torch.where(M == NEG, 0.0, M)
    L = torch.zeros_like(M)
    acc = torch.zeros((B, G, rep, Sq, D), dtype=torch.float32, device=q.device)
    for m, l, a in parts:
        f = torch.where(l > 0, torch.exp(m - mu), 0.0)
        L = L + l * f
        acc = acc + a * f
    out = acc / L.clamp(min=1e-30)
    return out.reshape(B, H, Sq, D).to(q.dtype)


def flash_attention_bwd_ref(q, k, v, o, do, *, causal=True, window=0, softcap=0.0,
                            sm_scale=None, cap_grad: bool = True, group_sum: bool = True):
    """The gradient of ``flash_attention_ref`` (no ``kv_len``) by FA2's
    equations, with the whole score matrix materialised in fp32: from q
    [B, H, Sq, D], k, v [B, G, Skv, D], the forward's output o and its
    cotangent do [B, H, Sq, D] -> (dq, dk, dv) in the inputs' dtypes.

    With x = scale * q.k and s = c * tanh(x / c) under a softcap c (else
    s = x): P = softmax of s over the live columns (``lse`` its row
    log-sum-exp), D_i = sum_d do * o, dP = do V^T, dS = P (dP - D_i), dX =
    dS (1 - tanh^2(x / c)); dq = scale dX K, dk = scale dX^T Q and dv = P^T
    do, each summed over the rep query heads of a kv head. A row with no
    live column has P = 0 and a zero gradient. ``cap_grad=False`` drops the
    softcap's factor and ``group_sum=False`` takes dk and dv from the first
    head of each group instead of the sum: wrong gradients, for checks that
    must reject them."""
    B, H, Sq, D = q.shape
    G, Skv = k.shape[1], k.shape[2]
    rep = H // G
    scale = sm_scale if sm_scale is not None else D ** -0.5
    kk = k.repeat_interleave(rep, dim=1).float()
    vv = v.repeat_interleave(rep, dim=1).float()
    qf, dof = q.float(), do.float()
    x = torch.einsum("bhqd,bhkd->bhqk", qf, kk) * scale
    dcap = 1.0
    if softcap and softcap > 0:
        t = torch.tanh(x / softcap)
        x = softcap * t
        if cap_grad:
            dcap = 1.0 - t * t
    m = _mask(Sq, torch.arange(Skv, device=q.device), Skv, causal, window, None, q.device)
    x = torch.where(m, x, NEG)
    mx = x.amax(-1, keepdim=True)
    lse = mx + torch.where(m, torch.exp(x - mx), 0.0).sum(-1, keepdim=True).clamp(
        min=1e-30).log()
    p = torch.where(m, torch.exp(x - lse), 0.0)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vv)
    ds = p * (dp - delta) * dcap * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf).reshape(B, G, rep, Skv, D)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof).reshape(B, G, rep, Skv, D)
    dk, dv = (dk.sum(2), dv.sum(2)) if group_sum else (dk[:, :, 0], dv[:, :, 0])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
