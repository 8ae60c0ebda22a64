"""smollm-360m [hf:HuggingFaceTB/SmolLM-360M]: llama-arch small.
32L d_model=960 15H (GQA kv=5) head_dim=64 d_ff=2560 vocab=49152."""
import torch

from .lm_common import LMArch
from ..models.transformer import TransformerConfig

ARCH = LMArch(
    arch_id="smollm-360m",
    cfg=TransformerConfig(
        name="smollm-360m", n_layers=32, d_model=960, n_heads=15,
        n_kv_heads=5, head_dim=64, d_ff=2560, vocab=49152,
        act="swiglu", tie_embeddings=True, rope_theta=10000.0,
    ),
    smoke_cfg=TransformerConfig(
        name="smollm-360m-smoke", n_layers=2, d_model=96, n_heads=3,
        n_kv_heads=1, head_dim=32, d_ff=256, vocab=512,
        act="swiglu", tie_embeddings=True,
        dtype=torch.float32, param_dtype=torch.float32, remat=False,
    ),
    supports_long=False,
    # pure DP + ZeRO-1 (the JAX package's choice at 360M parameters)
    rule_overrides={"heads": None, "kv_heads": None, "d_ff": None, "seq": None},
)
