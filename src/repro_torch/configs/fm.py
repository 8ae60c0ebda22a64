"""fm [Rendle ICDM'10]: n_sparse=39 embed_dim=10, pairwise interactions via
the O(nk) sum-square trick (Criteo-style field layout, 1M rows/field)."""
from .recsys_common import RecsysArch
from ..models.recsys import RecsysConfig

ARCH = RecsysArch(
    arch_id="fm",
    cfg=RecsysConfig(name="fm", kind="fm", embed_dim=10, n_sparse=39,
                     field_vocab=1_000_000),
    smoke_cfg=RecsysConfig(name="fm-smoke", kind="fm", embed_dim=8,
                           n_sparse=13, field_vocab=500),
)
