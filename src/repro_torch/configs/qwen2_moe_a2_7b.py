"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 4-way shared expert (5632 ff,
gated) + 60 routed experts top-4 (1408 ff each), norm_topk off.
24L d_model=2048 16H (kv 16) head_dim=128 d_ff(expert)=1408 vocab=151936.
The expert arrays are padded 60 -> 64 as in the JAX config (the padded
experts receive no token)."""
import torch

from .lm_common import LMArch
from ..models.transformer import MoESettings, TransformerConfig

ARCH = LMArch(
    arch_id="qwen2-moe-a2.7b",
    cfg=TransformerConfig(
        name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
        n_kv_heads=16, head_dim=128, d_ff=5632, vocab=151936,
        act="swiglu", tie_embeddings=False, rope_theta=1_000_000.0,
        moe=MoESettings(n_experts=60, top_k=4, d_expert=1408,
                        shared_d_ff=5632, norm_topk=False,
                        pad_experts_to=64),
        moe_shard_map=True,
    ),
    smoke_cfg=TransformerConfig(
        name="qwen2-moe-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, head_dim=32, d_ff=256, vocab=512,
        act="swiglu", tie_embeddings=False,
        moe=MoESettings(n_experts=6, top_k=2, d_expert=64, shared_d_ff=128,
                        norm_topk=False, capacity_factor=4.0),
        dtype=torch.float32, param_dtype=torch.float32, remat=False,
    ),
    supports_long=False,
    # experts over model; attention and the shared expert in pure DP
    rule_overrides={"experts": "model", "expert_ff": None,
                    "heads": None, "kv_heads": None, "d_ff": None},
)
