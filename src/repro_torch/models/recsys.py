"""RecSys architectures: FM, DIN, BST, MIND, the serving side of the JAX
package's ``models/recsys.py``.

Each model is an ``nn.Module`` that owns its parameters, under the names
of the JAX package's parameter tree flattened with ``.`` (``tables``,
``mlp.0.w``, ``blocks.0.wq``, ...), so that ``convert.recsys_params_from_arrays``
can carry JAX parameters across. Models are built on ``device`` (default:
the card) from a ``torch.Generator`` seeded with ``seed``; the values differ
from those ``jax.random`` draws for the same seed. Serve them under
``torch.inference_mode()``; with grad enabled they train
(``train/steps.py``): DIN, BST and MIND through torch's autograd, FM through
the JAX forward's own composition (the clamped gathers, then
``fm_pairwise``, on the card a kernel whose backward is a kernel too),
since its serving fusion ``fm_forward`` has no backward.

Gathers keep the JAX package's out-of-range semantics, written out
explicitly, because torch raises on an out-of-range index (on the card, a
device-side assert):
  * FM's numpy-style ``tables[f, ids]``: a negative id wraps once, then the
    index clamps to [0, V-1] (:func:`clamp_rows`);
  * ``jnp.take(table, ids, axis=0)`` (DIN, BST, MIND, the embedding bags): a
    negative id >= -V wraps, any other out-of-range id gives a NaN row
    (:func:`take_rows`);
  * ``jax.ops.segment_sum``: out-of-range segment ids are dropped.

``param_axes`` gives each parameter's logical axes (JAX's: the tables'
rows over "table_rows", everything else replicated) and ``shard_hint`` sits
at JAX's sites; without a mesh (``distributed/sharding.py``) the hints
return their input and nothing changes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..backend import default_use_kernel, resolve_device
from ..distributed.sharding import shard_hint
from ..kernels.fm_pairwise import ops as fm_ops
from ..kernels.fm_pairwise.ref import fm_forward_ref, fm_pairwise_ref
# clamp_rows is also imported from here
from .layers import clamp_rows, dense_init, embed_init, rms_norm  # noqa: F401


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str                      # fm | din | bst | mind
    embed_dim: int
    n_sparse: int = 39             # categorical fields (fm)
    field_vocab: int = 100_000     # rows per field table (fm)
    item_vocab: int = 1_000_000    # item table rows (din/bst/mind)
    cate_vocab: int = 10_000       # category table rows (din)
    seq_len: int = 100             # behavior history length
    n_heads: int = 8               # bst
    n_blocks: int = 1              # bst
    mlp: tuple = (200, 80)
    attn_mlp: tuple = (80, 40)     # din
    n_interests: int = 4           # mind
    capsule_iters: int = 3         # mind
    dtype: torch.dtype = torch.float32
    use_kernel: Optional[bool] = None   # fm_forward kernel; None: on CUDA


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: ids [...] -> [..., D]; a negative
    id >= -V wraps, any other out-of-range id gives a NaN row."""
    V = table.shape[0]
    i = ids.long()
    i = torch.where(i < 0, i + V, i)
    ok = (i >= 0) & (i < V)
    rows = table[i.clamp(0, V - 1)]
    return torch.where(ok[..., None], rows, float("nan"))


def embedding_bag(table, ids, mask=None, mode: str = "sum"):
    """EmbeddingBag from take + masked reduce. ids [..., L] -> [..., D]."""
    emb = take_rows(table, ids)                             # [..., L, D]
    if mask is not None:
        emb = emb * mask[..., None]
    out = emb.sum(-2)
    if mode == "mean":
        out = out / (mask.sum(-1, keepdim=True).clamp(min=1.0) if mask is not None
                     else max(float(ids.shape[-1]), 1.0))
    return out


def embedding_bag_csr(table, flat_ids, segment_ids, n_segments: int):
    """Ragged CSR variant: the rows of ``flat_ids`` summed per segment;
    segment ids outside [0, n_segments) are dropped."""
    emb = take_rows(table, flat_ids)
    seg = segment_ids.long()
    seg = torch.where((seg >= 0) & (seg < n_segments), seg, n_segments)
    out = torch.zeros((n_segments + 1, emb.shape[-1]), dtype=emb.dtype,
                      device=emb.device)
    return out.index_add_(0, seg, emb)[:n_segments]


class Dense(nn.Module):
    """``x @ w + b`` with the JAX package's [d_in, d_out] weight layout."""

    def __init__(self, d_in: int, d_out: int, g: torch.Generator, dtype):
        super().__init__()
        self.w = nn.Parameter(dense_init((d_in, d_out), g, dtype=dtype))
        self.b = nn.Parameter(torch.zeros(d_out, dtype=dtype, device=self.w.device))

    def forward(self, x):
        return x @ self.w + self.b


def mlp_layers(sizes, d_in: int, g: torch.Generator, dtype) -> nn.ModuleList:
    """Dense layers d_in -> sizes... -> 1."""
    dims = [d_in, *sizes, 1]
    return nn.ModuleList(Dense(dims[i], dims[i + 1], g, dtype)
                         for i in range(len(dims) - 1))


def mlp_apply(layers: nn.ModuleList, x):
    """ReLU between layers, none after the last."""
    for i, layer in enumerate(layers):
        x = layer(x)
        if i < len(layers) - 1:
            x = F.relu(x)
    return x


class _Recsys(nn.Module):
    def __init__(self, cfg: RecsysConfig, device, seed: int):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self._g = (None if self.device.type == "meta"     # shapes only: empty meta tensors
                   else torch.Generator(device=self.device).manual_seed(seed))

    _AXES: dict = {}   # parameter name -> logical axes; any other: (None,)

    def _embed(self, shape):
        return nn.Parameter(embed_init(shape, self._g, dtype=self.cfg.dtype))

    def param_axes(self) -> dict:
        """{parameter name: logical axes}, JAX's ``param_axes``."""
        return {n: self._AXES.get(n, (None,)) for n, _ in self.named_parameters()}


# ---------------------------------------------------------------------------
class FMModel(_Recsys):
    """Factorization Machine (Rendle ICDM'10), O(nk) sum-square interaction.

    ``use_kernel`` (from ``cfg.use_kernel``; None means on CUDA) sends the
    whole forward through the ``fm_forward`` CUDA kernel, one launch per
    forward (ids in, logits out); otherwise its plain version
    ``fm_forward_ref`` runs. Under grad (grad enabled and a parameter
    requiring it) the kernel route is the JAX forward's composition
    (``models/recsys.py:104-113``): the gathers, then ``fm_pairwise``, one
    forward and, in the backward, one ``fm_pairwise_bwd`` launch.
    """

    _AXES = {"tables": (None, "table_rows", None), "linear": (None, "table_rows", None),
             "bias": ()}

    def __init__(self, cfg: RecsysConfig, device=None, seed: int = 0):
        super().__init__(cfg, device, seed)
        c = cfg
        self.tables = self._embed((c.n_sparse, c.field_vocab, c.embed_dim))
        self.linear = self._embed((c.n_sparse, c.field_vocab, 1))
        self.bias = nn.Parameter(torch.zeros((), dtype=c.dtype, device=self.device))
        self.use_kernel = (default_use_kernel(self.device) if c.use_kernel is None
                           else c.use_kernel)

    def forward(self, feats):
        """feats["sparse_ids"] int[B, F] -> logits [B]."""
        # JAX hints the gathered rows [B, F, D] ("batch", None, None); the
        # fused forward gathers them inside, so the ids carry the batch's
        args = (shard_hint(feats["sparse_ids"], "batch", None), self.tables, self.linear,
                self.bias)
        if torch.is_grad_enabled() and any(p.requires_grad for p in args[1:]):
            return fm_forward_ref(*args, pairwise=(fm_ops.fm_pairwise if self.use_kernel
                                                   else fm_pairwise_ref))
        return (fm_ops.fm_forward if self.use_kernel else fm_forward_ref)(*args)


# ---------------------------------------------------------------------------
class DINModel(_Recsys):
    """Deep Interest Network (arXiv:1706.06978): target attention over history."""

    _AXES = {"item_table": ("table_rows", None), "cate_table": ("table_rows", None)}

    def __init__(self, cfg: RecsysConfig, device=None, seed: int = 0):
        super().__init__(cfg, device, seed)
        c, d = cfg, cfg.embed_dim
        self.item_table = self._embed((c.item_vocab, d))
        self.cate_table = self._embed((c.cate_vocab, d))
        # attention input [h, t, h-t, h*t] over concat(item, cate) embeddings
        self.att_mlp = mlp_layers(c.attn_mlp, 4 * (2 * d), self._g, c.dtype)
        self.mlp = mlp_layers(c.mlp, 3 * (2 * d), self._g, c.dtype)

    def forward(self, feats):
        """hist_items/hist_cates int[B, L], hist_mask f32[B, L],
        target_item/target_cate int[B] -> logits [B]."""
        hi = take_rows(self.item_table, feats["hist_items"])
        hc = take_rows(self.cate_table, feats["hist_cates"])
        h = torch.cat([hi, hc], -1)                            # [B, L, 2D]
        ti = take_rows(self.item_table, feats["target_item"])
        tc = take_rows(self.cate_table, feats["target_cate"])
        t = torch.cat([ti, tc], -1)                            # [B, 2D]
        tt = t[:, None, :].expand_as(h)
        att_in = torch.cat([h, tt, h - tt, h * tt], -1)
        score = mlp_apply(self.att_mlp, att_in)[..., 0]        # [B, L]
        mask = feats["hist_mask"]
        score = torch.where(mask > 0, score, -1e30)
        w = torch.softmax(score, -1) * (mask.sum(-1, keepdim=True) > 0)
        pooled = (w[..., None] * h).sum(1)                     # [B, 2D]
        x = torch.cat([pooled, t, pooled * t], -1)
        return mlp_apply(self.mlp, x)[..., 0]


# ---------------------------------------------------------------------------
class BSTBlock(nn.Module):
    """One pre-norm transformer block of BST (parameters as the JAX tree's)."""

    def __init__(self, d: int, g: torch.Generator, dtype):
        super().__init__()
        for name, shape in (("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)),
                            ("wo", (d, d)), ("ff1", (d, 4 * d)), ("ff2", (4 * d, d))):
            setattr(self, name, nn.Parameter(dense_init(shape, g, dtype=dtype)))
        self.ln1 = nn.Parameter(torch.zeros(d, dtype=dtype, device=self.wq.device))
        self.ln2 = nn.Parameter(torch.zeros(d, dtype=dtype, device=self.wq.device))


class BSTModel(_Recsys):
    """Behavior Sequence Transformer (arXiv:1905.06874)."""

    _AXES = {"item_table": ("table_rows", None)}

    def __init__(self, cfg: RecsysConfig, device=None, seed: int = 0):
        super().__init__(cfg, device, seed)
        c, d = cfg, cfg.embed_dim
        self.item_table = self._embed((c.item_vocab, d))
        self.pos_table = self._embed((c.seq_len + 1, d))
        self.blocks = nn.ModuleList(BSTBlock(d, self._g, c.dtype)
                                    for _ in range(c.n_blocks))
        self.mlp = mlp_layers(c.mlp, (c.seq_len + 1) * d, self._g, c.dtype)

    def _block(self, bp: BSTBlock, x, mask):
        c = self.cfg
        B, L, d = x.shape
        hd = d // c.n_heads

        def split(z):
            return z.reshape(B, L, c.n_heads, hd).transpose(1, 2)

        h = rms_norm(x, bp.ln1)
        q, k, v = split(h @ bp.wq), split(h @ bp.wk), split(h @ bp.wv)
        s = torch.einsum("bhqd,bhkd->bhqk", q, k) / hd ** 0.5
        s = torch.where(mask[:, None, None, :] > 0, s, -1e30)
        a = torch.softmax(s, -1)
        o = torch.einsum("bhqk,bhkd->bhqd", a, v).transpose(1, 2).reshape(B, L, d)
        x = x + o @ bp.wo
        h = rms_norm(x, bp.ln2)
        return x + F.leaky_relu(h @ bp.ff1) @ bp.ff2

    def forward(self, feats):
        """hist_items int[B, L], hist_mask [B, L], target_item int[B]."""
        hist = take_rows(self.item_table, feats["hist_items"])
        tgt = take_rows(self.item_table, feats["target_item"])
        x = torch.cat([hist, tgt[:, None, :]], 1)              # [B, L+1, D]
        x = x + self.pos_table[None]
        mask = torch.cat([feats["hist_mask"],
                          torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)], 1)
        x = x * mask[..., None]
        for bp in self.blocks:
            x = self._block(bp, x, mask)
        return mlp_apply(self.mlp, x.reshape(x.shape[0], -1))[..., 0]


# ---------------------------------------------------------------------------
def _squash(v):
    n2 = (v * v).sum(-1, keepdim=True)
    return (n2 / (1 + n2)) * v / torch.sqrt(n2 + 1e-9)


class MINDModel(_Recsys):
    """Multi-Interest Network with Dynamic routing (arXiv:1904.08030).

    The routing logits start from the buffer ``routing_init`` float[K, L]
    (K interests, L = ``seq_len``), shared across the batch and not learned.
    The JAX package draws it inside ``interests`` from ``PRNGKey(0)``; the
    port draws it from its own generator, so its values differ from JAX's
    unless ``convert.recsys_params_from_arrays`` fills it.
    """

    _AXES = {"item_table": ("table_rows", None), "s_matrix": (None, None)}

    def __init__(self, cfg: RecsysConfig, device=None, seed: int = 0):
        super().__init__(cfg, device, seed)
        c, d = cfg, cfg.embed_dim
        self.item_table = self._embed((c.item_vocab, d))
        self.s_matrix = nn.Parameter(dense_init((d, d), self._g, dtype=c.dtype))
        self.register_buffer("routing_init", torch.randn(
            (c.n_interests, c.seq_len), generator=self._g, device=self.device)
            if self._g is not None else torch.empty((c.n_interests, c.seq_len), device="meta"))

    def interests(self, hist_ids, hist_mask):
        """Capsule B2I dynamic routing -> [B, K, D] interest capsules."""
        if hist_ids.shape[-1] != self.cfg.seq_len:
            raise ValueError(f"MIND: histories must hold seq_len={self.cfg.seq_len} "
                             f"items, got {hist_ids.shape[-1]}")
        e = take_rows(self.item_table, hist_ids)               # [B, L, D]
        eh = (e @ self.s_matrix) * hist_mask[..., None]        # behavior caps
        blog = self.routing_init[None].expand(eh.shape[0], -1, -1)
        caps = None
        for _ in range(self.cfg.capsule_iters):
            w = torch.softmax(blog, 1) * hist_mask[:, None, :]  # over K
            caps = _squash(torch.einsum("bkl,bld->bkd", w, eh))
            blog = blog + torch.einsum("bkd,bld->bkl", caps, eh)
        return caps

    def forward(self, feats):
        """Training score: label-aware attention (pow 2) to the target item."""
        caps = self.interests(feats["hist_items"], feats["hist_mask"])
        tgt = take_rows(self.item_table, feats["target_item"])
        s = torch.einsum("bkd,bd->bk", caps, tgt)
        w = torch.softmax(s * s, -1)                           # label-aware pow-2
        u = torch.einsum("bk,bkd->bd", w, caps)
        return torch.einsum("bd,bd->b", u, tgt)

    def retrieve(self, feats, cand_emb, k: int = 100):
        """Score users against n_cand items: batched dot + max over interests
        -> (values float[B, k], indices int32[B, k]), best first."""
        caps = self.interests(feats["hist_items"], feats["hist_mask"])
        s = shard_hint(torch.einsum("bkd,nd->bkn", caps, cand_emb), "batch", None, "candidates")
        score = s.amax(1)                                             # [B, N]
        vals, idx = torch.topk(score, k)
        return vals, idx.to(torch.int32)


def bce_loss(logits, labels):
    return (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs()))).mean()
