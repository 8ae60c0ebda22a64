from .steps import (  # noqa: F401
    TrainState, init_train_state, make_fm_sparse_train_step, make_gnn_train_step,
    make_lm_train_step, make_recsys_train_step,
)
