from .recsys import (  # noqa: F401
    RecsysConfig, FMModel, DINModel, BSTModel, MINDModel,
    embedding_bag, embedding_bag_csr, bce_loss,
)
