"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-235B-A22B]: 128 experts top-8, qk_norm.
94L d_model=4096 64H (GQA kv=4) head_dim=128 d_ff(expert)=1536 vocab=151936.
At full depth its weights (~470 GB in bf16) need several cards: its run
across them waits for a machine that has them (ROADMAP Queue A item 6c)."""
import torch

from .lm_common import LMArch
from ..models.transformer import MoESettings, TransformerConfig

ARCH = LMArch(
    arch_id="qwen3-moe-235b-a22b",
    cfg=TransformerConfig(
        name="qwen3-moe-235b-a22b", n_layers=94, d_model=4096, n_heads=64,
        n_kv_heads=4, head_dim=128, d_ff=1536, vocab=151936,
        act="swiglu", qk_norm=True, tie_embeddings=False,
        rope_theta=1_000_000.0,
        moe=MoESettings(n_experts=128, top_k=8, d_expert=1536,
                        shared_d_ff=0, norm_topk=True),
        moe_shard_map=True,
        moe_fsdp=True,
    ),
    smoke_cfg=TransformerConfig(
        name="qwen3-moe-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab=512,
        act="swiglu", qk_norm=True, tie_embeddings=False,
        moe=MoESettings(n_experts=8, top_k=2, d_expert=64,
                        capacity_factor=4.0),
        dtype=torch.float32, param_dtype=torch.float32, remat=False,
    ),
    supports_long=False,
    # no microbatching (FSDP shards memory already); the experts' ff over
    # data, kv projections replicated (4 kv heads shard unevenly 16 ways)
    train_microbatches=1,
    rule_overrides={"expert_ff": "data", "kv_heads": None},
    # big-model serving: the attention projections over model too
    decode_rule_overrides={"heads": "model"},
)
