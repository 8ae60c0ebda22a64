"""LM serving steps: prefill and KV-cache decode, the JAX package's
``serve/lm.py`` on a ``TransformerLM`` that holds its own parameters."""
from __future__ import annotations

import torch

from ..distributed.sharding import no_grad_serving
from ..models.transformer import TransformerLM


@no_grad_serving
def prefill_step(model: TransformerLM, tokens):
    """tokens int32[B, S] -> fp32 logits of the LAST position [B, V].

    The JAX package's ``forward(...)[:, -1]``, with the final norm and the
    head applied to the last position only: full logits at S = 32768 would
    be 33.5 GB in fp32 for one row of gemma2-2b's 256,000-token vocabulary."""
    x, _, _ = model._trunk(tokens)
    return model._head(x[:, -1, :])


def make_decode_step(model: TransformerLM):
    """-> decode_step(cache, tokens[B]) -> (logits [B, V], cache); the cache
    passed in is updated in place (``TransformerLM.decode_step``)."""

    def step(cache, tokens):
        return model.decode_step(cache, tokens)

    return step


@no_grad_serving
def greedy_generate(model: TransformerLM, prompt, max_new: int, max_len: int):
    """Host loop: the prompt through repeated decode steps (a simple
    reference generator), then ``max_new`` argmax tokens -> int64[B, max_new]."""
    B, S = prompt.shape
    cache = model.init_cache(B, max_len)
    logits = None
    for t in range(S):
        logits, cache = model.decode_step(cache, prompt[:, t])
    out = [logits.argmax(-1)]
    for _ in range(max_new - 1):
        logits, cache = model.decode_step(cache, out[-1])
        out.append(logits.argmax(-1))
    return torch.stack(out, dim=1)
