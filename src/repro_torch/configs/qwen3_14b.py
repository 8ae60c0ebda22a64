"""qwen3-14b [hf:Qwen/Qwen3-14B family]: qk_norm, GQA.
40L d_model=5120 40H (GQA kv=8) head_dim=128 d_ff=17408 vocab=151936."""
import torch

from .lm_common import LMArch
from ..models.transformer import TransformerConfig

ARCH = LMArch(
    arch_id="qwen3-14b",
    cfg=TransformerConfig(
        name="qwen3-14b", n_layers=40, d_model=5120, n_heads=40,
        n_kv_heads=8, head_dim=128, d_ff=17408, vocab=151936,
        act="swiglu", qk_norm=True, tie_embeddings=False,
        rope_theta=1_000_000.0,
    ),
    smoke_cfg=TransformerConfig(
        name="qwen3-14b-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=320, vocab=512,
        act="swiglu", qk_norm=True, tie_embeddings=False,
        dtype=torch.float32, param_dtype=torch.float32, remat=False,
    ),
    supports_long=False,
    # full FSDP in training (batch over data x model, weights gathered);
    # decode shards d_ff over model; prefill B=32 shards the sequence
    train_microbatches=1,
    rule_overrides={"batch": ("data", "model"), "heads": "data",
                    "kv_heads": "data", "d_ff": "data", "seq": None},
    decode_rule_overrides={"batch": ("pod", "data"), "heads": None,
                           "kv_heads": None, "d_ff": "model"},
    prefill_rule_overrides={"batch": ("pod", "data"), "heads": None,
                            "kv_heads": None, "d_ff": "model", "seq": "model"},
)
