"""din [arXiv:1706.06978]: embed_dim=18 seq_len=100 attn_mlp=80-40
mlp=200-80, target attention over user history."""
from .recsys_common import RecsysArch
from ..models.recsys import RecsysConfig

ARCH = RecsysArch(
    arch_id="din",
    cfg=RecsysConfig(name="din", kind="din", embed_dim=18, seq_len=100,
                     attn_mlp=(80, 40), mlp=(200, 80),
                     item_vocab=10_000_000, cate_vocab=10_000),
    smoke_cfg=RecsysConfig(name="din-smoke", kind="din", embed_dim=8,
                           seq_len=16, attn_mlp=(32, 16), mlp=(32, 16),
                           item_vocab=2_000, cate_vocab=50),
)
