"""bst [arXiv:1905.06874] (Alibaba): embed_dim=32 seq_len=20 n_blocks=1
n_heads=8 mlp=1024-512-256, transformer over the behavior sequence."""
from .recsys_common import RecsysArch
from ..models.recsys import RecsysConfig

ARCH = RecsysArch(
    arch_id="bst",
    cfg=RecsysConfig(name="bst", kind="bst", embed_dim=32, seq_len=20,
                     n_blocks=1, n_heads=8, mlp=(1024, 512, 256),
                     item_vocab=10_000_000),
    smoke_cfg=RecsysConfig(name="bst-smoke", kind="bst", embed_dim=16,
                           seq_len=8, n_blocks=1, n_heads=4,
                           mlp=(64, 32), item_vocab=2_000),
)
