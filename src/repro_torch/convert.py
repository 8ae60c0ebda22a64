"""Carry a built QAC index across as plain arrays.

``qac_index_from_arrays`` turns the numpy leaves of a built index (the JAX
package's ``QACIndex`` after ``np.asarray`` on each leaf) into this
package's ``QACIndex`` on ``device``. It is how the engines
are held against the JAX package on identical arrays, independently of the
builder. Keys are ``"<component>.<field>"`` for arrays and meta alike, e.g.
``"rmq_minimal.values"`` and ``"rmq_minimal.levels"``; meta also holds
``"k_default"``. Compressed postings go one level deeper:
``"index.packed.words"`` (and ``.base``, ``.meta``, ``.wordoff``) among the
arrays, ``"index.packed.n_post"`` and ``"index.packed.codec"`` (a string)
among the meta; an index given none of them gets ``packed=None``.

``striped_index_from_arrays`` does the same for a docid-striped index: the
JAX package's ``StripedQACIndex`` leaves as numpy arrays, keyed by field
name (``"postings"``, ``"rmq_ib"``, ``"pp_words"``), and its meta fields
(``"n_stripes"``, ``"pp_codec"``), become the port's ``StripedQACIndex``.

``recsys_params_from_arrays`` does the same for a recsys model: the JAX
model's parameters as numpy arrays, keyed by their tree path joined with
``.`` (``"tables"``, ``"mlp.0.w"``, ``"blocks.0.ln1"``), become the port
model's parameters; MIND also takes ``"routing_init"``, the routing-logit
init the JAX package draws inside ``interests``.

``lm_params_from_arrays`` does the same for a transformer LM: ``"embed"``,
``"final_norm"``, ``"lm_head"`` (untied embeddings only) and the stacked
per-layer weights ``"layers.wq"`` etc. of shape ``(n_steps,
layers_per_step, ...)`` become a ``TransformerLM``; a MoE config takes
``"layers.router"``, ``"layers.we_gate"``/``we_up``/``we_down`` (all
``e_padded`` experts) and, with a shared expert, ``"layers.ws_gate"``,
``ws_up``, ``ws_down`` and ``ws_gate_proj`` instead of the dense FFN.

``mace_params_from_arrays`` does the same for MACE: ``"embed"``,
``"layers.<i>.<name>"`` (``rad1``, ``w_b2``, ...), ``"read1"``, ``"read2"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .backend import resolve_device
from .configs.recsys_common import MODEL_CLS
from .core.builder import QACIndex
from .core.codecs import PackedPostings
from .core.completions import Completions
from .core.dictionary import TermDictionary
from .core.inverted_index import InvertedIndex
from .core.rmq import RangeMin
from .core.striped import StripedQACIndex
from .models.mace import MACEConfig, MACEModel
from .models.recsys import RecsysConfig
from .models.transformer import TransformerConfig, TransformerLM

COMPONENTS = {"dictionary": TermDictionary, "completions": Completions,
              "index": InvertedIndex, "rmq_docids": RangeMin,
              "rmq_minimal": RangeMin}


def qac_index_from_arrays(arrays: dict[str, np.ndarray], meta: dict,
                          device=None) -> QACIndex:
    """Build a ``QACIndex`` on ``device`` (default: the card) from numpy
    arrays and meta fields (integers, and the packed codec's name); every
    field must be given exactly once."""
    device = resolve_device(device)
    used = set()

    def fields_of(cls, prefix):
        fields = {}
        for f in dataclasses.fields(cls):
            key = f"{prefix}.{f.name}"
            if cls is InvertedIndex and f.name == "packed":
                if any(k.startswith(key + ".") for k in (*arrays, *meta)):
                    fields[f.name] = PackedPostings(**fields_of(PackedPostings, key))
                continue
            if key in arrays:
                fields[f.name] = torch.tensor(np.ascontiguousarray(arrays[key]), device=device)
            elif key in meta:
                v = meta[key]
                fields[f.name] = v if isinstance(v, str) else int(v)
            else:
                raise KeyError(f"missing index field {key!r}")
            used.add(key)
        return fields

    parts = {comp: cls(**fields_of(cls, comp)) for comp, cls in COMPONENTS.items()}
    extra = (set(arrays) | set(meta)) - used - {"k_default"}
    if extra:
        raise KeyError(f"unknown index fields {sorted(extra)}")
    return QACIndex(**parts, k_default=int(meta["k_default"]))


def striped_index_from_arrays(arrays: dict[str, np.ndarray], meta: dict,
                              device=None) -> StripedQACIndex:
    """Build a ``StripedQACIndex`` on ``device`` (default: the card) from
    numpy arrays and meta fields; the packed fields (``pp_*``) may be
    absent together, every other field must be given exactly once."""
    device = resolve_device(device)
    fields, optional = {}, {"pp_words", "pp_base", "pp_meta", "pp_wordoff", "pp_codec"}
    for f in dataclasses.fields(StripedQACIndex):
        if f.name in arrays:
            fields[f.name] = torch.tensor(np.ascontiguousarray(arrays[f.name]),
                                          device=device)
        elif f.name in meta:
            v = meta[f.name]
            fields[f.name] = v if v is None or isinstance(v, str) else int(v)
        elif f.name not in optional:
            raise KeyError(f"missing striped index field {f.name!r}")
    extra = (set(arrays) | set(meta)) - set(fields)
    if extra:
        raise KeyError(f"unknown striped index fields {sorted(extra)}")
    return StripedQACIndex(**fields)


def _load_arrays(model: torch.nn.Module, arrays: dict[str, np.ndarray], what: str):
    """Load ``arrays`` into ``model``: every parameter and buffer exactly
    once, each of its shape, cast to its dtype."""
    want = model.state_dict()
    missing, extra = sorted(set(want) - set(arrays)), sorted(set(arrays) - set(want))
    if missing or extra:
        raise KeyError(f"{what} fields: missing {missing}, unknown {extra}")
    state = {}
    for key, t in want.items():
        a = np.asarray(arrays[key])
        if a.shape != tuple(t.shape):
            raise ValueError(f"{key}: shape {a.shape}, the model needs {tuple(t.shape)}")
        state[key] = torch.tensor(a, dtype=t.dtype)
    model.load_state_dict(state)
    return model


def recsys_params_from_arrays(cfg: RecsysConfig, arrays: dict[str, np.ndarray],
                              device=None):
    """The recsys model of ``cfg`` on ``device`` (default: the card) holding
    ``arrays``; every parameter and buffer must be given exactly once, each
    of its shape."""
    return _load_arrays(MODEL_CLS[cfg.kind](cfg, device=device), arrays, "recsys")


def lm_params_from_arrays(arrays: dict[str, np.ndarray], cfg: TransformerConfig,
                          device=None) -> TransformerLM:
    """The ``TransformerLM`` of ``cfg`` on ``device`` (default: the card)
    holding the JAX parameters ``arrays``, keyed by tree path joined with
    ``.``; every key must be used exactly once, each of its shape."""
    return _load_arrays(TransformerLM(cfg, device=device), arrays, "lm")


def mace_params_from_arrays(arrays: dict[str, np.ndarray], cfg: MACEConfig,
                            device=None) -> MACEModel:
    """The ``MACEModel`` of ``cfg`` on ``device`` (default: the card) holding
    the JAX parameters ``arrays``, keyed by tree path joined with ``.``;
    every key must be used exactly once, each of its shape."""
    return _load_arrays(MACEModel(cfg, device=device), arrays, "mace")
