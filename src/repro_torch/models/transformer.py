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
``decode_step``) runs under ``torch.inference_mode()`` (``torch.no_grad()``
under a mesh). Training goes through
``loss_fn`` (JAX's ``loss_fn``, with the MoE aux term ``aux_coef * aux /
n_layers``), which runs the same trunk with grad enabled: on the card each
attention is the forward kernel inside ``FlashAttention``, whose backward is
the hand-written ``flash_attention_bwd``. With ``cfg.remat`` each scan step
(its ``layers_per_step`` layers) runs under
``torch.utils.checkpoint(..., use_reentrant=False)``, as JAX's
``jax.checkpoint(step)``: its activations are recomputed in the backward.

The MoE block (JAX's ``_route``, ``_experts_apply`` and ``_moe_mlp``)
runs no TPU kernel: the router, the experts' FFNs and the shared expert are
library products. JAX scans the experts one at a time;
:func:`experts_apply` does the same work batched (an [E, T] one-hot and its
running count give every expert's kept tokens, one [E, C, d] gather, three
``bmm``), with JAX's drops and JAX's order of adds.

Sharded execution (``distributed/sharding.py``): inside
``mesh_context(mesh, rules)``, with the parameters made DTensors by
``shard_params(model, model.param_axes(), mesh)``, every entry point runs
on the mesh. Tokens, targets and masks are plain tensors holding the global
batch on every rank (or DTensors); activations are DTensors, the
``shard_hint`` calls sit at JAX's sites and redistribute, and DTensor's
sharding propagation partitions the products as GSPMD does. Plain tensors
the blocks make (positions, RoPE angles, scalars) count as replicated
(``implicit_replication``). Three parts run per rank inside ``local_map``:
  * each attention: ``flash_attention`` (and ``flash_decode``) on the
    rank's batch rows and heads (:meth:`TransformerLM._attention_local`);
    where the kv heads are not split as the q heads are (qwen3-moe's decode
    rules: heads over ``model``, kv heads replicated), the rank takes the kv
    heads its q heads read. The KV cache under a mesh holds each rank's own
    rows and kv heads as plain tensors, written in place;
  * the expert-parallel MoE (JAX's ``shard_map`` branch), under JAX's
    condition: ``moe_shard_map`` and a mesh whose ``model`` axis is > 1 and
    divides ``e_padded``. Rank m of ``model`` holds the expert slots
    ``[m * e_padded / ep, (m + 1) * e_padded / ep)`` and runs every token
    of its data shard through them (capacity from the shard's
    ``(B // dp) * S`` tokens; a choice outside its slots adds nothing); the
    partial sums leave the body as a ``Partial`` DTensor, cast to bf16 first
    under ``moe_psum_bf16``, and the redistribution to replicated is the
    ``psum`` over ``model``. Under ``moe_fsdp`` the experts' ff shards are
    all-gathered over ``data`` before the FFNs. The router runs on the shard
    too; its load-balance statistics are summed over the data shards, so
    the aux term is JAX's global one;
  * without that condition the MoE block runs on the whole batch, gathered
    (``local_map`` with replicated placements), as GSPMD's
    global semantics ask: capacity couples every token of the call.
The loss sums each data shard's masked nll locally and the sums are reduced.

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
    Python floats with T = B * S of the call (of a data shard under expert
    parallelism): a decode step (T = B) keeps other tokens than the
    teacher-forced forward does.
  * JAX adds each expert's output into a carry of the activation dtype in
    ascending expert id; in bf16 every add rounds, so a token's
    contributions are summed in that order here too. Padded experts
    (``pad_experts_to``) keep their weights and receive no token.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..backend import resolve_device
from ..distributed.sharding import (as_dtensor, get_mesh, logical_sharding, mesh_shape,
                                    no_grad_serving, plain_as_replicated, shard_hint)
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
    # each scan step in loss_fn's backward; the MoE sharding switches act
    # only under a mesh (module docstring).
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


def experts_apply(x2d, idx, gates, we_gate, we_up, we_down, capacity: int, act: str,
                  base: int = 0):
    """JAX's ``_experts_apply`` over experts ``base..base+E-1`` (E =
    ``we_gate.shape[0]``), batched: x2d [T, d]; idx int[T, k] (distinct in a
    row), gates fp32 [T, k]; we_* [E, ...] -> [T, d] in x2d's dtype. A
    choice outside those experts adds nothing (another rank holds it).

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
    loc = idx.long() - base
    mine = (loc >= 0) & (loc < E)
    loc = torch.where(mine, loc, E)                             # row E: another rank's
    # [E + 1, T] one-hot, its running count along T (a scan along the inner
    # dim: along the outer dim of a [T, E] one the card's scan takes 7 ms at
    # T = 32k)
    tok = torch.zeros((E + 1, T), dtype=torch.int32, device=dev).scatter_(0, loc.t(), 1)
    pos = (tok.cumsum(1) - 1).gather(0, loc.t()).t()           # [T, k] rank among e's tokens
    kept = mine & (pos < C)
    slot = torch.where(kept, loc * C + pos, E * C)              # E * C: not added here
    t_ids = torch.arange(T, device=dev)[:, None].expand_as(slot)
    slot_ids = torch.arange(E * C + 1, device=dev) % T
    slot_ids.scatter_(0, slot.reshape(-1), t_ids.reshape(-1))
    xe = x2d[slot_ids[:E * C]].view(E, C, d)
    he = _mm(gated_act(_mm(xe, we_gate), _mm(xe, we_up), act), we_down)
    he = torch.cat([he.reshape(E * C, d).to(x2d.dtype), x2d.new_zeros(1, d)])
    order = idx.argsort(dim=1)                                # ascending expert id
    slot, g = slot.gather(1, order), gates.gather(1, order).to(x2d.dtype)
    contrib = he[slot] * g[:, :, None]                        # [T, k, d], 0 where not added
    out = contrib[:, 0]
    for j in range(1, idx.shape[1]):
        out = out + contrib[:, j]
    return out


def moe_ep_partial(x2d, idx, gates, we_gate, we_up, we_down, *, rank: int, ep: int,
                   m: MoESettings, capacity: int, act: str, psum_bf16: bool):
    """One rank's part of the expert-parallel MoE (the body of JAX's
    ``shard_map``, before its ``psum`` over ``model``): the tokens of its
    data shard through its ``e_padded / ep`` expert slots, which start at
    ``rank * e_padded / ep``; we_* are those slots' weights, their ff dim
    whole. -> [T, d], cast to bf16 under ``psum_bf16``."""
    part = experts_apply(x2d, idx, gates, we_gate, we_up, we_down, capacity, act,
                         base=rank * (m.e_padded // ep))
    return part.to(torch.bfloat16) if psum_bf16 else part


def load_balance_aux(counts, prob_sum, T: int, m: MoESettings):
    """Switch-style aux from the choices each expert got (``counts``) and
    the router probabilities summed over the T tokens."""
    return m.n_experts * ((counts / (T * m.top_k)) * (prob_sum / T)).sum()


def _nll_sums(logits, targets, mask):
    """(sum of the masked next-token nll, sum of the mask), fp32 []."""
    nll = -take_targets(torch.log_softmax(logits, dim=-1), targets)
    return (nll * mask).sum(), mask.sum()


def expert_parallel(cfg: TransformerConfig, mesh) -> bool:
    """JAX's condition for the expert-parallel MoE: ``moe_shard_map`` and a
    mesh (a ``DeviceMesh`` or {axis: size}) whose ``model`` axis is > 1 and
    divides ``e_padded``."""
    if not (cfg.moe and cfg.moe_shard_map) or mesh is None:
        return False
    ep = mesh_shape(mesh).get("model", 1)
    return ep > 1 and cfg.moe.e_padded % ep == 0


def _extent(pl, mesh, dim: int, size: int) -> tuple[int, int]:
    """(offset, length) of this rank's slice of tensor dim ``dim`` (global
    ``size``) under placements ``pl``: DTensor cuts a dim over its mesh dims
    in the mesh's order, ``torch.chunk``'s way."""
    from torch.distributed.tensor import Shard

    off, n = 0, size
    coord = mesh.get_coordinate()
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-n // mesh.size(i))
            lo = min(coord[i] * chunk, n)
            off, n = off + lo, min(chunk, n - lo)
    return off, n


def _dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


class TransformerLM(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        g = (None if self.device.type == "meta"     # shapes only: empty meta tensors
             else torch.Generator(device=self.device).manual_seed(seed))
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

    _AXES = {
        "embed": ("vocab", "d_model"), "lm_head": ("d_model", "vocab"),
        "final_norm": ("d_model",),
        "wq": ("d_model", "heads"), "wk": ("d_model", "kv_heads"),
        "wv": ("d_model", "kv_heads"), "wo": ("heads", "d_model"),
        "w_gate": ("d_model", "d_ff"), "w_up": ("d_model", "d_ff"),
        "w_down": ("d_ff", "d_model"), "router": ("d_model", None),
        "we_gate": ("experts", "d_model", "expert_ff"),
        "we_up": ("experts", "d_model", "expert_ff"),
        "we_down": ("experts", "expert_ff", "d_model"),
        "ws_gate": ("d_model", "d_ff"), "ws_up": ("d_model", "d_ff"),
        "ws_down": ("d_ff", "d_model"), "ws_gate_proj": ("d_model", None),
        "pre_attn": (None,), "pre_mlp": (None,), "post_attn": (None,),
        "post_mlp": (None,), "q_norm": (None,), "k_norm": (None,),
    }

    def param_axes(self) -> dict:
        """{parameter name: logical axes}, JAX's ``param_axes``: a
        layer-stacked parameter gets two leading replicated dims."""
        return {n: ((None, None) if n.startswith("layers.") else ())
                + self._AXES[n.rpartition(".")[2]] for n, _ in self.named_parameters()}

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
        q = shard_hint(q, "batch", "heads", "seq", None)
        k = shard_hint(k, "batch", "kv_heads", "seq", None)
        sm_scale = hd ** -0.5
        if get_mesh() is not None:
            out, new_cache = self._attention_local(q, k, v, window, cache, cache_pos, kv_len)
        elif cache is None:
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

    def _attention_local(self, q, k, v, window, cache, cache_pos, kv_len):
        """The attention under a mesh: ``flash_attention`` (or, with a cache,
        the in-place cache write and ``flash_decode``) inside ``local_map`` on
        this rank's batch rows and heads, q's placements for the output.
        q [B, H, S, hd], k and v [B, G, S, hd] DTensors; ``cache`` the rank's
        own (k, v) rows [B_loc, G_loc, Sc, hd]; cache_pos and kv_len [B]
        global. -> (out DTensor, (k, v) of the rank: plain tensors)."""
        from torch.distributed.tensor import Partial, Shard
        from torch.distributed.tensor.experimental import local_map

        c = self.cfg
        mesh = q.device_mesh
        qpl = logical_sharding(("batch", "heads", "seq", None))
        kpl = logical_sharding(("batch", "kv_heads", "seq", None))
        B, H = q.shape[:2]
        G = k.shape[1]
        b0, nb = _extent(qpl, mesh, 0, B)
        h0, nh = _extent(qpl, mesh, 1, H)
        g0, ng = _extent(kpl, mesh, 1, G)
        # the kv heads this rank's q heads read (h // rep), as local indices:
        # all of the rank's own when the kv heads are split as the q heads
        # are, else a block of them or one for each q head
        need = [(h0 + j) // (H // G) - g0 for j in range(nh)]
        sel = None
        if nh and not (nh % ng == 0 and need == [j // (nh // ng) for j in range(nh)]):
            lo, n = need[0], need[-1] + 1 - need[0]
            sel = (slice(lo, lo + n) if nh % n == 0 and need == [lo + j // (nh // n)
                                                                 for j in range(nh)]
                   else need)

        def pick(t):
            return t if sel is None else t[:, sel].contiguous()

        sm_scale, cap = c.head_dim ** -0.5, c.attn_softcap

        def body(q_l, k_l, v_l):
            if cache is None:
                out = fa_ops.flash_attention(q_l, pick(k_l), pick(v_l), causal=True,
                                             window=window, softcap=cap, sm_scale=sm_scale,
                                             use_kernel=c.use_flash)
                return out, k_l, v_l
            ck, cv = cache
            bidx = torch.arange(nb, device=q_l.device)
            ck[bidx, :, cache_pos[b0:b0 + nb], :] = k_l[:, :, 0, :]
            cv[bidx, :, cache_pos[b0:b0 + nb], :] = v_l[:, :, 0, :]
            out = fa_ops.flash_decode(q_l[:, :, 0, :], pick(ck), pick(cv), kv_len[b0:b0 + nb],
                                      window=0, softcap=cap, sm_scale=sm_scale,
                                      use_kernel=c.use_flash)[:, :, None, :]
            return out, ck, cv

        # where the q heads are split and the kv heads are not, a rank's
        # gradient of k and v is its own q heads' share
        kgrad = tuple(Partial() if isinstance(a, Shard) and a.dim == 1 and b != a else b
                      for a, b in zip(qpl, kpl))
        out, k_l, v_l = local_map(body, (qpl, None, None), in_placements=(qpl, kpl, kpl),
                                  in_grad_placements=(qpl, kgrad, kgrad), device_mesh=mesh,
                                  redistribute_inputs=True)(q, k, as_dtensor(v, mesh))
        return out, (k_l, v_l)

    def _dense_mlp(self, lp, x):
        c = self.cfg
        h = rms_norm(x, lp["pre_mlp"], c.norm_eps)
        h = shard_hint(h, "batch", "seq", "d_model")
        out = _mm(gated_act(_mm(h, lp["w_gate"]), _mm(h, lp["w_up"]), c.act), lp["w_down"])
        if c.post_norms:
            out = rms_norm(out, lp["post_mlp"], c.norm_eps)
        return out, 0.0

    # -- MoE -------------------------------------------------------------------
    def _route(self, lp, h2d, *, stats: bool = False):
        """Router: h2d [T, d] -> (idx int64[T, k], gates fp32[T, k], aux fp32
        []); with ``stats``, in place of aux the choices each expert got and
        the probabilities summed over T ([E] each: a data shard's share of
        the global aux, :func:`load_balance_aux`)."""
        m = self.cfg.moe
        probs = torch.softmax(_mm(h2d.float(), lp["router"]), dim=-1)      # [T, E]
        idx = probs.sort(dim=-1, descending=True, stable=True).indices[:, :m.top_k]
        gates = probs.gather(1, idx)
        if m.norm_topk:
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        # Switch-style load balance: each expert's share of the k * T choices
        T = h2d.shape[0]
        f = torch.zeros((T, m.n_experts), dtype=torch.float32, device=h2d.device)
        f = f.scatter_(1, idx, 1.0).sum(0)
        if stats:
            return idx, gates, (f, probs.sum(0))
        aux = m.n_experts * (f / (T * m.top_k) * probs.mean(0)).sum()
        return idx, gates, aux

    def _routed_experts(self, lp, h):
        """The routed experts on the whole batch: h [B, S, d] -> ([B, S, d], aux)."""
        m = self.cfg.moe
        B, S, d = h.shape
        h2d = h.reshape(B * S, d)
        idx, gates, aux = self._route(lp, h2d)
        E = m.n_experts                            # padded experts receive no token
        out = experts_apply(h2d, idx, gates, lp["we_gate"][:E], lp["we_up"][:E],
                            lp["we_down"][:E], moe_capacity(B * S, m), self.cfg.act)
        return out.reshape(B, S, d), aux

    def _ep_experts(self, lp, h, mesh):
        """JAX's expert-parallel ``shard_map`` branch (module docstring):
        h [B, S, d] DTensor -> (out [B, S, d] DTensor, aux)."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        c, m = self.cfg, self.cfg.moe
        names, sizes = mesh.mesh_dim_names, mesh_shape(mesh)
        ep = sizes["model"]
        dp_axes = _dp_axes(mesh)
        dp = math.prod(sizes[a] for a in dp_axes)
        B, S, d = h.shape
        cap = moe_capacity((B // dp) * S, m)
        rank = mesh.get_local_rank("model")

        def pl(**by_axis):
            return tuple(by_axis.get(a, Replicate()) for a in names)

        dp_shard = {a: Shard(0) for a in dp_axes if sizes[a] > 1}
        dp_partial = {a: Partial() for a in dp_axes if sizes[a] > 1}
        # each rank's experts whole: local_map redistributes the weights to
        # P("model"); under moe_fsdp they arrive with their ff dim sharded
        # over data (qwen3-moe's rule expert_ff -> data), and that
        # redistribution is the FSDP gather, an all_gather of the ff shards
        w_pl = pl(model=Shard(0))

        def route(h_l, router):
            idx, gates, stats = self._route({"router": router}, h_l.reshape(-1, d), stats=True)
            return idx, gates, *stats

        def experts(h_l, idx, gates, w1, w3, w2):
            part = moe_ep_partial(h_l.reshape(-1, d), idx, gates, w1, w3, w2, rank=rank,
                                  ep=ep, m=m, capacity=cap, act=c.act,
                                  psum_bf16=c.moe_psum_bf16)
            return part.reshape(h_l.shape)

        # the router on each data shard, the same on every model rank
        tok = pl(**dp_shard)
        idx, gates, counts, prob_sum = local_map(
            route, (tok, tok, pl(**dp_partial), pl(**dp_partial)), in_placements=(tok, pl()),
            in_grad_placements=(tok, pl(**dp_partial)), device_mesh=mesh,
            redistribute_inputs=True)(h, lp["router"])
        # the rank's experts: its gradients are those experts' share
        share = pl(**dp_shard, model=Partial())
        part = local_map(
            experts, list(share), in_placements=(tok, tok, tok, w_pl, w_pl, w_pl),
            in_grad_placements=(share, tok, share, *[pl(**dp_partial, model=Shard(0))] * 3),
            device_mesh=mesh, redistribute_inputs=True)(
            h, idx, gates, lp["we_gate"], lp["we_up"], lp["we_down"])
        # the psum over model (in bf16 under moe_psum_bf16), and the router's
        # statistics over the data shards
        out = part.redistribute(mesh, pl(**dp_shard)).to(h.dtype)
        rep = pl()
        aux = load_balance_aux(counts.redistribute(mesh, rep), prob_sum.redistribute(mesh, rep),
                               B * S, m)
        return out, aux

    def _moe_mlp(self, lp, x):
        c, m = self.cfg, self.cfg.moe
        h = rms_norm(x, lp["pre_mlp"], c.norm_eps)
        mesh = get_mesh()
        if mesh is None:
            out, aux = self._routed_experts(lp, h)
        elif expert_parallel(c, mesh):
            out, aux = self._ep_experts(lp, h, mesh)
        else:
            # GSPMD's global semantics: capacity couples every token of the
            # call, so the block runs on the gathered batch, on every rank
            from torch.distributed.tensor import Replicate
            from torch.distributed.tensor.experimental import local_map

            names = ("router", "we_gate", "we_up", "we_down")
            rep = (Replicate(),) * mesh.ndim
            out, aux = local_map(
                lambda h_, *w: self._routed_experts(dict(zip(names, w)), h_), (rep, rep),
                in_placements=(rep,) * 5, device_mesh=mesh, redistribute_inputs=True)(
                as_dtensor(h, mesh), *(as_dtensor(lp[n], mesh) for n in names))
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
        if hasattr(tokens, "full_tensor"):         # a DTensor: its global value
            tokens = tokens.full_tensor()
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
            x = shard_hint(x2 + mlp, "batch", "seq", "d_model")
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
        with plain_as_replicated():
            return self._trunk_steps(tokens, return_cache, remat)

    def _trunk_steps(self, tokens, return_cache: bool, remat: bool):
        c = self.cfg
        B, S = tokens.shape
        x = shard_hint(self._embed(tokens), "batch", "seq", "d_model")
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
        with plain_as_replicated():
            x = rms_norm(x, self.final_norm, c.norm_eps)
            w = self.embed.t() if c.tie_embeddings else self.lm_head
            logits = _mm(x, w.to(c.dtype)).float()
            if c.final_softcap:
                logits = c.final_softcap * torch.tanh(logits / c.final_softcap)
            return shard_hint(logits, "batch", "seq", "vocab") if logits.ndim == 3 else logits

    # -- full forward (prefill) ------------------------------------------------
    @no_grad_serving
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
        with plain_as_replicated():
            logits = self._head(x)
            if get_mesh() is None:
                total, count = _nll_sums(logits, targets, mask)
            else:
                total, count = self._sharded_nll_sums(logits, targets, mask)
            loss = total / torch.clamp(count, min=1)
            if c.moe:
                loss = loss + c.moe.aux_coef * aux / c.n_layers
            return loss

    @staticmethod
    def _sharded_nll_sums(logits, targets, mask):
        """:func:`_nll_sums` of each data shard inside ``local_map``, the
        vocab gathered; the shards' sums reduced -> two replicated DTensors."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        mesh = get_mesh()
        bl = logical_sharding(("batch", "seq", None))
        part = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in bl)
        rep = (Replicate(),) * mesh.ndim
        total, count = local_map(_nll_sums, (part, part), in_placements=(bl, bl, bl),
                                 device_mesh=mesh, redistribute_inputs=True)(
            logits, as_dtensor(targets, mesh), as_dtensor(mask, mesh))
        return total.redistribute(mesh, rep), count.redistribute(mesh, rep)

    # -- KV-cache serving --------------------------------------------------------
    @no_grad_serving
    def init_cache(self, batch: int, max_len: int) -> dict:
        """{"pos": int32[B], "k"/"v": per layer of a step [n_steps, B, G, Sc,
        hd] in ``dtype``, Sc = min(window, max_len) on a local layer}. Under
        a mesh k and v hold the rank's own batch rows and kv heads."""
        c = self.cfg
        rows, heads = batch, c.n_kv_heads
        mesh = get_mesh()
        if mesh is not None:              # the rank's own rows and kv heads
            kpl = logical_sharding(("batch", "kv_heads", "seq", None))
            rows, heads = _extent(kpl, mesh, 0, batch)[1], _extent(kpl, mesh, 1, heads)[1]
        ks, vs = [], []
        for i in range(c.layers_per_step):
            w = c.window_of(i)
            Sc = min(w, max_len) if w > 0 else max_len
            shape = (c.n_steps, rows, heads, Sc, c.head_dim)
            ks.append(torch.zeros(shape, dtype=c.dtype, device=self.device))
            vs.append(torch.zeros(shape, dtype=c.dtype, device=self.device))
        return {"pos": torch.zeros(batch, dtype=torch.int32, device=self.device),
                "k": tuple(ks), "v": tuple(vs)}

    @no_grad_serving
    def decode_step(self, cache: dict, tokens):
        """One token per sequence: tokens int32[B] -> (logits f32[B, V], the
        new cache). Writes K and V into ``cache``'s tensors in place: use the
        returned cache, not the one passed in."""
        with plain_as_replicated():
            return self._decode(cache, tokens)

    def _decode(self, cache: dict, tokens):
        c = self.cfg
        pos = cache["pos"]
        x = shard_hint(self._embed(tokens)[:, None, :], "batch", None, "d_model")
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
