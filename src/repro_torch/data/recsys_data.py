"""Synthetic recsys batches (Zipfian ids, ragged histories); numpy only, a
copy of the JAX package's ``data/recsys_data.py``: the same generator state
gives the same arrays."""
from __future__ import annotations

import numpy as np


def recsys_batch(cfg, batch: int, rng: np.random.Generator):
    """Feature dict + labels matching models/recsys.py contracts."""
    kind = cfg.kind
    if kind == "fm":
        ids = (rng.zipf(1.2, size=(batch, cfg.n_sparse)) - 1) % cfg.field_vocab
        feats = {"sparse_ids": ids.astype(np.int32)}
    else:
        L = cfg.seq_len
        hist = (rng.zipf(1.2, size=(batch, L)) - 1) % cfg.item_vocab
        lens = rng.integers(1, L + 1, size=batch)
        mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
        feats = {
            "hist_items": hist.astype(np.int32),
            "hist_mask": mask,
            "target_item": ((rng.zipf(1.2, size=batch) - 1) % cfg.item_vocab).astype(np.int32),
        }
        if kind == "din":
            feats["hist_cates"] = (hist % cfg.cate_vocab).astype(np.int32)
            feats["target_cate"] = (feats["target_item"] % cfg.cate_vocab).astype(np.int32)
    labels = rng.integers(0, 2, size=batch).astype(np.float32)
    return feats, labels
