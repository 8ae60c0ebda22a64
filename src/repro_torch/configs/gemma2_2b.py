"""gemma2-2b [arXiv:2408.00118]: local+global alternating, logit softcaps,
sandwich norms, GeGLU. 26L d_model=2304 8H (GQA kv=4) head_dim=256 d_ff=9216
vocab=256000, window=4096, attn softcap 50, final softcap 30."""
import torch

from .lm_common import LMArch
from ..models.transformer import TransformerConfig

ARCH = LMArch(
    arch_id="gemma2-2b",
    cfg=TransformerConfig(
        name="gemma2-2b", n_layers=26, d_model=2304, n_heads=8,
        n_kv_heads=4, head_dim=256, d_ff=9216, vocab=256000,
        act="geglu", layer_pattern="local_global", window=4096,
        post_norms=True, attn_softcap=50.0, final_softcap=30.0,
        embed_scale=True, tie_embeddings=True, rope_theta=10000.0,
    ),
    smoke_cfg=TransformerConfig(
        name="gemma2-2b-smoke", n_layers=4, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=384, vocab=512,
        act="geglu", layer_pattern="local_global", window=16,
        post_norms=True, attn_softcap=50.0, final_softcap=30.0,
        embed_scale=True, tie_embeddings=True,
        dtype=torch.float32, param_dtype=torch.float32, remat=False,
    ),
    supports_long=True,   # local layers are sub-quadratic
    # pure DP + ZeRO-1 (8 heads shard unevenly 16 ways)
    rule_overrides={"heads": None, "kv_heads": None, "d_ff": None, "seq": None},
)
