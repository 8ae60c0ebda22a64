"""The port's LM serving path against the JAX package on the same weights:
each dense LM arch at its ``smoke_cfg`` (fp32), JAX's ``init_params`` carried
across as numpy arrays through ``lm_params_from_arrays``; ``forward``,
``prefill_step``, 24 ``decode_step``s from ``init_cache(2, 32)`` (gemma2's
16-token local ring wraps, the global cache does not), ``greedy_generate``,
the layers, the data stream and the configs.

Tolerance: rtol and atol 1e-4 on fp32 logits (matrix products and the
softmax run in another order in XLA and in torch on the CPU); tokens and the
data stream are exact.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.lm_common import LM_SHAPES as JAX_LM_SHAPES
from repro.data.lm import TokenStream as JaxTokenStream
from repro.data.lm import lm_batches as jax_lm_batches
from repro.models.layers import apply_rope as jax_apply_rope
from repro.models.layers import gated_act as jax_gated_act
from repro.serve.lm import greedy_generate as jax_greedy_generate
from repro.serve.lm import prefill_step as jax_prefill_step
from repro_torch import configs
from repro_torch.configs.lm_common import LM_SHAPES
from repro_torch.convert import lm_params_from_arrays
from repro_torch.data import TokenStream, lm_batches
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import apply_rope, gated_act
from repro_torch.models import transformer
from repro_torch.models.transformer import TransformerLM
from repro_torch.serve.lm import greedy_generate, make_decode_step, prefill_step

LM_ARCHS = ["smollm-360m", "qwen3-14b", "gemma2-2b"]
TOL = dict(rtol=1e-4, atol=1e-4)


def params_to_arrays(params) -> dict[str, np.ndarray]:
    """The JAX parameter tree as numpy arrays keyed by path joined with '.'."""
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path):
            np.asarray(v) for path, v in flat}


@functools.lru_cache(maxsize=None)
def _pair(arch_id):
    """(JAX model, its params, the port's model on the CPU) at smoke width."""
    jm = jax_get_arch(arch_id).smoke_model()
    params = jm.init_params(jax.random.PRNGKey(0))
    tm = lm_params_from_arrays(params_to_arrays(params),
                               configs.get_arch(arch_id).smoke_cfg, device="cpu")
    return jm, params, tm


def _tokens(arch_id, B, S, seed=0):
    vocab = configs.get_arch(arch_id).smoke_cfg.vocab
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_forward_and_prefill_match_jax(arch_id):
    jm, params, tm = _pair(arch_id)
    S = 48 if arch_id == "gemma2-2b" else 32      # gemma2's window of 16 bites
    toks = _tokens(arch_id, 2, S)
    want, want_aux, _ = jax.jit(jm.forward)(params, jnp.asarray(toks))
    before = fa_ops.launches
    got, aux, cache = tm(torch.from_numpy(toks))
    assert fa_ops.launches == before              # CPU tensors: the plain version
    assert got.shape == (2, S, tm.cfg.vocab) and got.dtype == torch.float32
    assert cache is None and float(aux) == float(want_aux) == 0.0
    _close(got, want)
    pre = prefill_step(tm, torch.from_numpy(toks))
    _close(pre, jax_prefill_step(jm, params, jnp.asarray(toks)))
    # the head on one row or on all of them: the same function, other blockings
    torch.testing.assert_close(pre, got[:, -1], rtol=1e-6, atol=1e-6)
    _, _, jcache = jm.forward(params, jnp.asarray(toks), return_cache=True)
    _, _, cache = tm(torch.from_numpy(toks), return_cache=True)
    assert len(cache) == len(jcache) == tm.cfg.layers_per_step
    for (k, v), (jk, jv) in zip(cache, jcache):
        assert k.shape == (tm.cfg.n_steps, 2, tm.cfg.n_kv_heads, S, tm.cfg.head_dim)
        _close(k, jk)
        _close(v, jv)


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_decode_steps_match_jax(arch_id):
    jm, params, tm = _pair(arch_id)
    toks = _tokens(arch_id, 2, 24, seed=1)
    jstep = jax.jit(jm.decode_step)
    jcache = jm.init_cache(2, 32)
    cache = tm.init_cache(2, 32)
    shapes = [tuple(k.shape) for k in cache["k"]]
    assert shapes == [tuple(k.shape) for k in jcache["k"]]
    step = make_decode_step(tm)
    for t in range(24):
        want, jcache = jstep(params, jcache, jnp.asarray(toks[:, t]))
        got, cache = step(cache, torch.from_numpy(toks[:, t]))
        _close(got, want)
    assert cache["pos"].tolist() == [24, 24]
    for i in range(len(cache["k"])):
        _close(cache["k"][i], jcache["k"][i])
        _close(cache["v"][i], jcache["v"][i])


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_greedy_generate_matches_jax(arch_id):
    jm, params, tm = _pair(arch_id)
    prompt = _tokens(arch_id, 2, 6, seed=2)
    # JAX's own host loop, over its decode step compiled once
    jitted = types.SimpleNamespace(init_cache=jm.init_cache, decode_step=jax.jit(jm.decode_step))
    want = jax_greedy_generate(jitted, params, jnp.asarray(prompt), 6, 32)
    got = greedy_generate(tm, torch.from_numpy(prompt), 6, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_token_stream_and_batches_equal_jax():
    got, want = TokenStream.synthetic(vocab=512, seed=3), JaxTokenStream.synthetic(vocab=512, seed=3)
    assert np.array_equal(got.tokens, want.tokens) and got.tokens.dtype == want.tokens.dtype
    assert np.array_equal(got.doc_bounds, want.doc_bounds)
    b_got = next(lm_batches(got, 4, 64, seed=5))
    b_want = next(jax_lm_batches(want, 4, 64, seed=5))
    for a, b in zip(b_got, b_want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_and_gated_act_match_jax(dtype):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 3, 40, 32))
    pos = rng.integers(0, 5000, (2, 1, 40)).astype(np.int32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    tol = 1e-4 if dtype == "float32" else 2e-2
    got = apply_rope(tx, torch.from_numpy(pos), 10000.0)
    want = jax_apply_rope(jx, jnp.asarray(pos), 10000.0)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    up = rng.normal(size=x.shape)
    for kind in ("swiglu", "geglu"):
        got = gated_act(tx, torch.from_numpy(up).to(tx.dtype), kind)
        want = jax_gated_act(jx, jnp.asarray(up, jx.dtype), kind)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)
    with pytest.raises(ValueError):
        gated_act(tx, tx, "relu")


@pytest.mark.parametrize("switch", ["moe_shard_map", "moe_fsdp", "moe_psum_bf16"])
def test_moe_sharding_switch_raises(switch, tmp_path):
    """JAX's MoE sharding switches change nothing without a mesh: set, on one
    device, the logits equal those of the switch unset bit for bit. The
    expert-parallel branch is taken only under JAX's condition (a mesh whose
    ``model`` axis is > 1 and divides ``e_padded``, with ``moe_shard_map``),
    not by the size of a process group: on a one-rank gloo group with a
    (1, 1) mesh and the parameters as DTensors the set switch runs the
    gathered branch and gives the unset logits bit for bit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.sharding import mesh_context, shard_params

    base = dataclasses.replace(configs.get_arch("qwen2-moe-a2.7b").smoke_cfg,
                               moe_shard_map=False)
    on_cfg = dataclasses.replace(base, **{switch: True})
    off = TransformerLM(base, device="cpu", seed=3)
    on = TransformerLM(on_cfg, device="cpu", seed=3)
    toks = torch.from_numpy(_tokens("qwen2-moe-a2.7b", 2, 16))
    (l_off, a_off, _), (l_on, a_on, _) = off(toks), on(toks)
    assert torch.equal(l_off, l_on) and torch.equal(a_off, a_on)
    ep = switch == "moe_shard_map"
    assert not transformer.expert_parallel(on_cfg, None)
    assert not transformer.expert_parallel(on_cfg, {"data": 1, "model": 1})
    assert not transformer.expert_parallel(on_cfg, {"pod": 2, "data": 2, "model": 1})
    assert transformer.expert_parallel(on_cfg, {"data": 1, "model": 2}) == ep
    assert transformer.expert_parallel(on_cfg, {"pod": 2, "data": 2, "model": 3}) == ep
    assert not transformer.expert_parallel(on_cfg, {"data": 1, "model": 4})  # 6 experts
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        with mesh_context(mesh):
            shard_params(on, on.param_axes(), mesh)
            l_mesh, a_mesh, _ = on(toks)
        assert torch.equal(l_mesh.full_tensor(), l_off)
        assert torch.equal(a_mesh.full_tensor(), a_off)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_configs_equal_jax(arch_id):
    """Every field of cfg and smoke_cfg but the torch-typed ones, the
    parameter counts, the shapes and the cells; the port's parameters have
    JAX's names and shapes."""
    port, ref = configs.get_arch(arch_id), jax_get_arch(arch_id)
    for c_t, c_j in ((port.cfg, ref.cfg), (port.smoke_cfg, ref.smoke_cfg)):
        f_t, f_j = dataclasses.asdict(c_t), dataclasses.asdict(c_j)
        for k in ("dtype", "param_dtype", "use_flash"):
            f_t.pop(k), f_j.pop(k)
        assert f_t == f_j
        assert str(c_t.dtype).split(".")[-1] == jnp.dtype(c_j.dtype).name
        assert c_t.use_flash is None and c_j.use_flash is False
        assert c_t.param_count() == c_j.param_count()
        assert c_t.active_param_count() == c_j.active_param_count()
    assert LM_SHAPES == JAX_LM_SHAPES
    assert port.supports_long == ref.supports_long
    assert [dataclasses.astuple(c) for c in port.cells()] == \
        [dataclasses.astuple(c) for c in ref.cells()]
    _, params, tm = _pair(arch_id)
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == \
        {k: v.shape for k, v in params_to_arrays(params).items()}
