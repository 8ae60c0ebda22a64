from .adamw import AdamWConfig, adamw_update, cosine_lr, global_norm, init_opt_state  # noqa: F401
from .sparse_adam import dedup_row_grads, sparse_table_update  # noqa: F401
