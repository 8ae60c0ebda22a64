"""mind [arXiv:1904.08030]: embed_dim=64 n_interests=4 capsule_iters=3,
multi-interest retrieval. Item table 10M rows (production-scale)."""
from .recsys_common import RecsysArch
from ..models.recsys import RecsysConfig

ARCH = RecsysArch(
    arch_id="mind",
    cfg=RecsysConfig(name="mind", kind="mind", embed_dim=64, seq_len=50,
                     item_vocab=10_000_000, n_interests=4, capsule_iters=3),
    smoke_cfg=RecsysConfig(name="mind-smoke", kind="mind", embed_dim=16,
                           seq_len=12, item_vocab=2_000, n_interests=4,
                           capsule_iters=3),
)
