"""Decoder-only transformer: the JAX package's ``models/transformer.py``.

One config expresses llama-style GQA (smollm), qk-norm GQA (qwen3),
local/global alternating layers with softcaps and sandwich norms (gemma2)
and shared + routed mixture-of-experts blocks (qwen2-moe, qwen3-moe).

``TransformerLM`` is an ``nn.Module`` built on ``device`` (default: the
card) from a ``torch.Generator`` seeded with ``seed``; the values differ
from those ``jax.random`` draws, and ``convert.lm_params_from_arrays``
carries JAX parameters across. The parameters keep the JAX tree's names and
layouts: ``embed`` [V, d], ``final_norm`` [d], ``lm_head`` [d, V] when the
embeddings are not tied, and each per-layer weight stacked as
``layers.<name>`` [n_steps, layers_per_step, ...], so that layer
``l = step * layers_per_step + i`` has the window ``window_of(i)`` (gemma2's
local layer is the first of each pair).

Every attention goes through ``kernels/flash_attention`` (``use_flash=None``:
the CUDA kernel on the card, the plain version on the CPU): ``forward`` with
the causal mask and each layer's window, ``decode_step`` with one query row
against the cache and ``kv_len``. Serving (``forward``, ``init_cache`` and
``decode_step``) runs under ``torch.inference_mode()``. Training goes through
``loss_fn`` (JAX's ``loss_fn``, with the MoE aux term ``aux_coef * aux /
n_layers``), which runs the same trunk with grad enabled: on the card each
attention is the forward kernel inside ``FlashAttention``, whose backward is
the hand-written ``flash_attention_bwd``. With ``cfg.remat`` each scan step
(its ``layers_per_step`` layers) runs under
``torch.utils.checkpoint(..., use_reentrant=False)``, as JAX's
``jax.checkpoint(step)``: its activations are recomputed in the backward.

The MoE block (JAX's ``_route``, ``_experts_apply`` and ``_moe_mlp``
without a mesh) runs no TPU kernel: the router, the experts' FFNs and the
shared expert are library products. JAX scans the experts one at a time;
:func:`experts_apply` does the same work batched (an [E, T] one-hot and its
running count give every expert's kept tokens, one [E, C, d] gather, three
``bmm``), with JAX's drops and JAX's order of adds. The sharding switches
(``moe_shard_map``, ``moe_fsdp``, ``moe_psum_bf16``) change nothing without
a mesh, as in JAX; in a ``torch.distributed`` group of more than one rank a
MoE block raises (expert parallelism: ROADMAP Queue A item 6).

Hazards written out:
  * The token gather clamps as JAX's ``embed[tokens]`` does (a negative id
    wraps once, then the index clamps): torch would raise, on the card by a
    device-side assert.
  * ``decode_step`` writes the new K and V into the cache tensors in place
    (JAX's ``.at[].set`` makes a new array): a cache passed to it must not
    be used again; use the cache it returns.
  * ``loss_fn``'s target gather is ``jnp.take_along_axis``'s: a negative
    target >= -V wraps once, any other out-of-range target gives a NaN nll
    (torch's gather would raise), and ``nll * mask`` keeps that NaN even
    where the mask is 0 (:func:`take_targets`).
  * Decode passes ``window=0`` to the kernel for every layer: a local
    layer's ring of ``Sc = min(window, max_len)`` rows, written at
    ``pos % Sc`` and read up to ``min(pos + 1, Sc)``, carries the window.
    RoPE positions stay absolute.
  * Routing ties: ``lax.top_k`` puts the lower expert first; ``torch.topk``
    promises no order, so ``_route`` takes a stable descending sort.
  * Capacity is ``max(8, int(T * top_k / n_experts * capacity_factor))`` in
    Python floats with T = B * S of the call: a decode step (T = B) keeps
    other tokens than the teacher-forced forward does.
  * JAX adds each expert's output into a carry of the activation dtype in
    ascending expert id; in bf16 every add rounds, so a token's
    contributions are summed in that order here too. Padded experts
    (``pad_experts_to``) keep their weights and receive no token.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..backend import resolve_device
from ..kernels.flash_attention import ops as fa_ops
from .layers import apply_rope, clamp_rows, dense_init, embed_init, gated_act, rms_norm


@dataclasses.dataclass(frozen=True)
class MoESettings:
    n_experts: int
    top_k: int
    d_expert: int
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    norm_topk: bool = True
    aux_coef: float = 1e-2
    pad_experts_to: int = 0   # > n_experts: padded weight arrays (never routed to)

    @property
    def e_padded(self) -> int:
        return max(self.pad_experts_to, self.n_experts)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "swiglu"
    qk_norm: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    window: int = 0                  # local-layer sliding window (gemma2: 4096)
    layer_pattern: str = "global"    # "global" | "local_global"
    post_norms: bool = False         # gemma2 sandwich norms
    embed_scale: bool = False        # gemma2 sqrt(d) embedding scale
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    moe: Optional[MoESettings] = None
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    use_flash: Optional[bool] = None  # flash_attention kernel; None: on CUDA
    # The JAX config's training and distribution switches: remat recomputes
    # each scan step in loss_fn's backward; the MoE sharding switches change
    # nothing on one device and raise in a group of more than one rank.
    remat: bool = True
    moe_shard_map: bool = False
    moe_fsdp: bool = False
    moe_psum_bf16: bool = False

    @property
    def layers_per_step(self) -> int:
        return 2 if self.layer_pattern == "local_global" else 1

    @property
    def n_steps(self) -> int:
        assert self.n_layers % self.layers_per_step == 0
        return self.n_layers // self.layers_per_step

    def window_of(self, pos_in_step: int) -> int:
        if self.layer_pattern == "local_global":
            return self.window if pos_in_step == 0 else 0
        return self.window

    def param_count(self) -> int:
        c = self
        attn = c.d_model * c.head_dim * (c.n_heads * 2 + c.n_kv_heads * 2)
        if c.moe:
            ffn = c.moe.n_experts * 3 * c.d_model * c.moe.d_expert
            ffn += c.d_model * c.moe.n_experts
            if c.moe.shared_d_ff:
                ffn += 3 * c.d_model * c.moe.shared_d_ff + c.d_model
        else:
            ffn = 3 * c.d_model * c.d_ff
        per_layer = attn + ffn + 2 * c.d_model * (2 if c.post_norms else 1)
        head = 0 if c.tie_embeddings else c.d_model * c.vocab
        return c.n_layers * per_layer + c.vocab * c.d_model + head + c.d_model

    def active_param_count(self) -> int:
        """MoE: params touched per token (6·N_active·D convention)."""
        if not self.moe:
            return self.param_count()
        c = self
        attn = c.d_model * c.head_dim * (c.n_heads * 2 + c.n_kv_heads * 2)
        ffn = c.moe.top_k * 3 * c.d_model * c.moe.d_expert
        ffn += c.d_model * c.moe.n_experts
        if c.moe.shared_d_ff:
            ffn += 3 * c.d_model * c.moe.shared_d_ff
        head = 0 if c.tie_embeddings else c.d_model * c.vocab
        return c.n_layers * (attn + ffn) + c.vocab * c.d_model + head


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with JAX's promotion of mixed float dtypes."""
    if x.dtype != w.dtype:
        t = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(t), w.to(t)
    return x @ w


def take_targets(logp: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``jnp.take_along_axis(logp, targets[..., None], -1)[..., 0]``: a
    negative target >= -V wraps once; any other target outside [0, V) gives
    NaN (torch's gather would raise)."""
    V = logp.shape[-1]
    t = targets.long()
    t = torch.where(t < 0, t + V, t)
    ok = (t >= 0) & (t < V)
    got = logp.gather(-1, t.clamp(0, V - 1)[..., None])[..., 0]
    return torch.where(ok, got, float("nan"))


def moe_capacity(T: int, m: MoESettings) -> int:
    """Tokens an expert keeps of a call's T = B * S, in JAX's Python floats."""
    return max(8, int(T * m.top_k / m.n_experts * m.capacity_factor))


def experts_apply(x2d, idx, gates, we_gate, we_up, we_down, capacity: int, act: str):
    """JAX's ``_experts_apply`` over experts ``0..E-1`` (E = ``we_gate.shape[0]``),
    batched: x2d [T, d]; idx int[T, k] (distinct in a row), gates fp32 [T, k];
    we_* [E, ...] -> [T, d] in x2d's dtype.

    Expert e keeps its first ``capacity`` tokens in token order; a kept
    token's output is the expert's FFN times its gate cast to x2d's dtype,
    and a token sums its contributions in ascending expert id (JAX's scan
    adds them into a carry of that dtype one expert at a time).

    A slot no token fills reads the row ``slot % T`` of x2d (JAX reads a
    row of zeros): its FFN output is never gathered, so it only gets a zero
    gradient, and spreading those rows keeps the gather's backward (a sorted
    accumulation) from summing thousands of zeros into one row."""
    T, d = x2d.shape
    E, C = we_gate.shape[0], capacity
    dev = x2d.device
    # [E, T] one-hot, its running count along T (a scan along the inner dim:
    # along the outer dim of a [T, E] one the card's scan takes 7 ms at T = 32k)
    tok = torch.zeros((E, T), dtype=torch.int32, device=dev).scatter_(0, idx.long().t(), 1)
    pos = (tok.cumsum(1) - 1).gather(0, idx.long().t()).t()  # [T, k] rank among e's tokens
    kept = pos < C
    slot = torch.where(kept, idx.long() * C + pos, E * C)     # E * C: a dropped pair
    t_ids = torch.arange(T, device=dev)[:, None].expand_as(slot)
    slot_ids = torch.arange(E * C + 1, device=dev) % T
    slot_ids.scatter_(0, slot.reshape(-1), t_ids.reshape(-1))
    xe = x2d[slot_ids[:E * C]].view(E, C, d)
    he = _mm(gated_act(_mm(xe, we_gate), _mm(xe, we_up), act), we_down)
    he = torch.cat([he.reshape(E * C, d).to(x2d.dtype), x2d.new_zeros(1, d)])
    order = idx.argsort(dim=1)                                # ascending expert id
    slot, g = slot.gather(1, order), gates.gather(1, order).to(x2d.dtype)
    contrib = he[slot] * g[:, :, None]                        # [T, k, d], 0 where dropped
    out = contrib[:, 0]
    for j in range(1, idx.shape[1]):
        out = out + contrib[:, j]
    return out


def _group_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class TransformerLM(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        g = torch.Generator(device=self.device).manual_seed(seed)
        c, pd = cfg, cfg.param_dtype
        H, G, hd, d = c.n_heads, c.n_kv_heads, c.head_dim, c.d_model
        n = (c.n_steps, c.layers_per_step)

        def dense(*shape, in_axis=0, dtype=pd):   # every layer's weight in one draw
            return nn.Parameter(dense_init(n + shape, g, in_axis=2 + in_axis, dtype=dtype))

        def zeros(width):
            return nn.Parameter(torch.zeros(n + (width,), dtype=pd, device=self.device))

        layers = {"wq": dense(d, H * hd), "wk": dense(d, G * hd), "wv": dense(d, G * hd),
                  "wo": dense(H * hd, d), "pre_attn": zeros(d), "pre_mlp": zeros(d)}
        if c.post_norms:
            layers |= {"post_attn": zeros(d), "post_mlp": zeros(d)}
        if c.qk_norm:
            layers |= {"q_norm": zeros(hd), "k_norm": zeros(hd)}
        if c.moe:
            m = c.moe
            layers |= {"router": dense(d, m.n_experts, dtype=torch.float32),
                       "we_gate": dense(m.e_padded, d, m.d_expert, in_axis=1),
                       "we_up": dense(m.e_padded, d, m.d_expert, in_axis=1),
                       "we_down": dense(m.e_padded, m.d_expert, d, in_axis=1)}
            if m.shared_d_ff:
                layers |= {"ws_gate": dense(d, m.shared_d_ff), "ws_up": dense(d, m.shared_d_ff),
                           "ws_down": dense(m.shared_d_ff, d), "ws_gate_proj": dense(d, 1)}
        else:
            layers |= {"w_gate": dense(d, c.d_ff), "w_up": dense(d, c.d_ff),
                       "w_down": dense(c.d_ff, d)}
        self.layers = nn.ParameterDict(layers)
        self.embed = nn.Parameter(embed_init((c.vocab, d), g, dtype=pd))
        self.final_norm = nn.Parameter(torch.zeros(d, dtype=pd, device=self.device))
        if not c.tie_embeddings:
            self.lm_head = nn.Parameter(dense_init((d, c.vocab), g, dtype=pd))

    def _layer(self, step: int, i: int) -> dict[str, torch.Tensor]:
        return {name: p[step, i] for name, p in self.layers.items()}

    # -- blocks ----------------------------------------------------------------
    def _attention(self, lp, x, positions, window: int, *, cache=None,
                   cache_pos=None, kv_len=None):
        c = self.cfg
        H, G, hd = c.n_heads, c.n_kv_heads, c.head_dim
        B, S, _ = x.shape
        h = rms_norm(x, lp["pre_attn"], c.norm_eps)
        q = _mm(h, lp["wq"]).reshape(B, S, H, hd)
        k = _mm(h, lp["wk"]).reshape(B, S, G, hd)
        v = _mm(h, lp["wv"]).reshape(B, S, G, hd)
        if c.qk_norm:
            q = rms_norm(q, lp["q_norm"], c.norm_eps)
            k = rms_norm(k, lp["k_norm"], c.norm_eps)
        q = apply_rope(q.transpose(1, 2), positions[:, None, :], c.rope_theta)
        k = apply_rope(k.transpose(1, 2), positions[:, None, :], c.rope_theta)
        v = v.transpose(1, 2).contiguous()
        sm_scale = hd ** -0.5
        if cache is None:
            out = fa_ops.flash_attention(q, k, v, causal=True, window=window,
                                         softcap=c.attn_softcap, sm_scale=sm_scale,
                                         use_kernel=c.use_flash)
            new_cache = (k, v)
        else:
            ck, cv = cache                                   # [B, G, Sc, hd], in place
            bidx = torch.arange(B, device=x.device)
            ck[bidx, :, cache_pos, :] = k[:, :, 0, :]
            cv[bidx, :, cache_pos, :] = v[:, :, 0, :]
            out = fa_ops.flash_decode(q[:, :, 0, :], ck, cv, kv_len, window=0,
                                      softcap=c.attn_softcap, sm_scale=sm_scale,
                                      use_kernel=c.use_flash)[:, :, None, :]
            new_cache = (ck, cv)
        out = _mm(out.transpose(1, 2).reshape(B, S, H * hd), lp["wo"])
        if c.post_norms:
            out = rms_norm(out, lp["post_attn"], c.norm_eps)
        return out, new_cache

    def _dense_mlp(self, lp, x):
        c = self.cfg
        h = rms_norm(x, lp["pre_mlp"], c.norm_eps)
        out = _mm(gated_act(_mm(h, lp["w_gate"]), _mm(h, lp["w_up"]), c.act), lp["w_down"])
        if c.post_norms:
            out = rms_norm(out, lp["post_mlp"], c.norm_eps)
        return out, 0.0

    # -- MoE -------------------------------------------------------------------
    def _route(self, lp, h2d):
        """Router: h2d [T, d] -> (idx int64[T, k], gates fp32[T, k], aux fp32 [])."""
        m = self.cfg.moe
        probs = torch.softmax(_mm(h2d.float(), lp["router"]), dim=-1)      # [T, E]
        idx = probs.sort(dim=-1, descending=True, stable=True).indices[:, :m.top_k]
        gates = probs.gather(1, idx)
        if m.norm_topk:
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        # Switch-style load balance: each expert's share of the k * T choices
        T = h2d.shape[0]
        f = torch.zeros((T, m.n_experts), dtype=torch.float32, device=h2d.device)
        f = f.scatter_(1, idx, 1.0).sum(0) / (T * m.top_k)
        aux = m.n_experts * (f * probs.mean(0)).sum()
        return idx, gates, aux

    def _moe_mlp(self, lp, x):
        c, m = self.cfg, self.cfg.moe
        if (c.moe_shard_map or c.moe_fsdp or c.moe_psum_bf16) and _group_size() > 1:
            raise NotImplementedError(
                "moe_shard_map/moe_fsdp/moe_psum_bf16 across ranks: expert parallelism "
                "waits for the port's distribution work (ROADMAP Queue A item 6)")
        B, S, d = x.shape
        h = rms_norm(x, lp["pre_mlp"], c.norm_eps)
        h2d = h.reshape(B * S, d)
        idx, gates, aux = self._route(lp, h2d)
        E = m.n_experts                            # padded experts receive no token
        out = experts_apply(h2d, idx, gates, lp["we_gate"][:E], lp["we_up"][:E],
                            lp["we_down"][:E], moe_capacity(B * S, m), c.act).reshape(B, S, d)
        if m.shared_d_ff:
            gate = torch.sigmoid(_mm(h, lp["ws_gate_proj"]))
            shared = _mm(gated_act(_mm(h, lp["ws_gate"]), _mm(h, lp["ws_up"]), c.act),
                         lp["ws_down"])
            out = out + gate * shared
        if c.post_norms:
            out = rms_norm(out, lp["post_mlp"], c.norm_eps)
        return out, aux

    def _mlp(self, lp, x):
        """-> (the block's output, its aux loss: 0.0 for a dense block)."""
        return self._moe_mlp(lp, x) if self.cfg.moe else self._dense_mlp(lp, x)

    def _embed(self, tokens):
        c = self.cfg
        x = self.embed[clamp_rows(tokens, c.vocab)].to(c.dtype)
        if c.embed_scale:
            x = x * torch.tensor(float(c.d_model)).sqrt().to(c.dtype)
        return x

    def _scan_step(self, x, positions, step: int, kvs=None):
        """The ``layers_per_step`` layers of scan step ``step`` -> (x, the
        sum of their aux losses); appends each layer's (k, v) to ``kvs`` when
        given."""
        c = self.cfg
        aux = 0.0
        for i in range(c.layers_per_step):
            lp = self._layer(step, i)
            attn, (k, v) = self._attention(lp, x, positions, c.window_of(i))
            x2 = x + attn
            mlp, a = self._mlp(lp, x2)
            x = x2 + mlp
            aux = aux + a
            if kvs is not None:
                kvs[i][0].append(k)
                kvs[i][1].append(v)
        return x, aux

    def _trunk(self, tokens, *, return_cache: bool = False, remat: bool = False):
        """tokens int32[B, S] -> (the last layer's output [B, S, d] before the
        final norm, the layers' aux losses summed (fp32 []), and per layer of
        a step (k, v) [n_steps, B, G, S, hd] when ``return_cache``).
        ``remat`` checkpoints each scan step."""
        c = self.cfg
        B, S = tokens.shape
        x = self._embed(tokens)
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        kvs = [([], []) for _ in range(c.layers_per_step)] if return_cache else None
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for step in range(c.n_steps):
            if remat:
                x, a = checkpoint(self._scan_step, x, positions, step, use_reentrant=False)
            else:
                x, a = self._scan_step(x, positions, step, kvs)
            aux = aux + a
        cache = (tuple((torch.stack(ks), torch.stack(vs)) for ks, vs in kvs)
                 if return_cache else None)
        return x, aux, cache

    def _head(self, x):
        """Final norm, the (tied) head in ``dtype`` and the final softcap:
        [..., d] -> fp32 logits [..., V]."""
        c = self.cfg
        x = rms_norm(x, self.final_norm, c.norm_eps)
        w = self.embed.t() if c.tie_embeddings else self.lm_head
        logits = _mm(x, w.to(c.dtype)).float()
        if c.final_softcap:
            logits = c.final_softcap * torch.tanh(logits / c.final_softcap)
        return logits

    # -- full forward (prefill) ------------------------------------------------
    @torch.inference_mode()
    def forward(self, tokens, *, return_cache: bool = False):
        """tokens int32[B, S] -> (logits f32[B, S, V], the layers' aux loss
        summed (0 without MoE), cache|None)."""
        x, aux, cache = self._trunk(tokens, return_cache=return_cache)
        return self._head(x), aux, cache

    # -- training ----------------------------------------------------------------
    def loss_fn(self, tokens, targets, mask):
        """Masked mean next-token nll, plus ``aux_coef * aux / n_layers`` with
        MoE: tokens, targets int[B, S], mask float [B, S] -> fp32 []. Runs
        with grad (when enabled), remat per scan step when ``cfg.remat``."""
        c = self.cfg
        x, aux, _ = self._trunk(tokens, remat=c.remat and torch.is_grad_enabled())
        logp = torch.log_softmax(self._head(x), dim=-1)
        nll = -take_targets(logp, targets)
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
        if c.moe:
            loss = loss + c.moe.aux_coef * aux / c.n_layers
        return loss

    # -- KV-cache serving --------------------------------------------------------
    @torch.inference_mode()
    def init_cache(self, batch: int, max_len: int) -> dict:
        """{"pos": int32[B], "k"/"v": per layer of a step [n_steps, B, G, Sc,
        hd] in ``dtype``, Sc = min(window, max_len) on a local layer}."""
        c = self.cfg
        ks, vs = [], []
        for i in range(c.layers_per_step):
            w = c.window_of(i)
            Sc = min(w, max_len) if w > 0 else max_len
            shape = (c.n_steps, batch, c.n_kv_heads, Sc, c.head_dim)
            ks.append(torch.zeros(shape, dtype=c.dtype, device=self.device))
            vs.append(torch.zeros(shape, dtype=c.dtype, device=self.device))
        return {"pos": torch.zeros(batch, dtype=torch.int32, device=self.device),
                "k": tuple(ks), "v": tuple(vs)}

    @torch.inference_mode()
    def decode_step(self, cache: dict, tokens):
        """One token per sequence: tokens int32[B] -> (logits f32[B, V], the
        new cache). Writes K and V into ``cache``'s tensors in place: use the
        returned cache, not the one passed in."""
        c = self.cfg
        pos = cache["pos"]
        x = self._embed(tokens)[:, None, :]
        positions = pos[:, None]
        for step in range(c.n_steps):
            for i in range(c.layers_per_step):
                lp = self._layer(step, i)
                ck, cv = cache["k"][i][step], cache["v"][i][step]
                Sc = ck.shape[2]
                attn, _ = self._attention(
                    lp, x, positions, 0, cache=(ck, cv), cache_pos=(pos % Sc).long(),
                    kv_len=torch.clamp(pos + 1, max=Sc))
                x2 = x + attn
                x = x2 + self._mlp(lp, x2)[0]
        new_cache = {"pos": pos + 1, "k": cache["k"], "v": cache["v"]}
        return self._head(x[:, 0, :]), new_cache
