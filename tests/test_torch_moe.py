"""The port's MoE transformer against the JAX package on the same weights:
qwen2-moe-a2.7b (shared expert, norm_topk off) and qwen3-moe-235b-a22b
(qk-norm, norm_topk) at ``smoke_cfg`` (fp32), JAX's ``init_params`` carried
across through ``lm_params_from_arrays``. The router (indices equal, ties
to the lower expert), the experts at a capacity that drops tokens, padded
experts, the forward and its aux loss, ``prefill_step``, 12 decode steps
against JAX's decode (its own capacity, T = B), ``loss_fn`` with the aux
term and its gradient (with and without remat), three train steps, and
the experts in bf16. JAX's functions are jitted once where tests share
them, and no eager JAX op is left to compile on its own: this file runs
beside JAX's 20-minute ``test_freshness.py``. It holds fewer tests than
that file (13 against 14): pytest-xdist's loadfile schedule hands out
files with more tests first, so this one never goes ahead of it.

Tolerance: fp32; gates and aux 1e-6, the experts' output 1e-5, logits 1e-4
(as ``test_torch_lm.py``), gradients 1e-4 of each parameter's gradient
norm; train steps: losses and gradient norms 1e-4, each parameter within
1e-4 of its norm (Adam moves an element whose gradient sits at its rounding
floor by a fraction of lr either way: an embedding element differed by
1.4e-4 after 3 steps at lr 1e-3). In bf16 the experts' FFN products are
rounded by two libraries: within 2e-2.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models.transformer import TransformerLM as JaxTransformerLM
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.train import steps as jax_steps
from repro_torch import configs
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models import transformer
from repro_torch.models.transformer import TransformerLM, experts_apply, moe_capacity
from repro_torch.optim import AdamWConfig
from repro_torch.serve.lm import prefill_step
from repro_torch.train import steps

MOE_ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"]
TOL = dict(rtol=1e-4, atol=1e-4)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.1, clip_norm=1.0)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small shapes: one intra-op thread (see ``test_torch_train_steps.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def params_to_arrays(params) -> dict[str, np.ndarray]:
    """The JAX parameter tree as numpy arrays keyed by path joined with '.'."""
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path):
            np.asarray(v) for path, v in flat}


@functools.lru_cache(maxsize=None)
def _pair(arch_id):
    """(JAX model, its params, the port's model on the CPU) at smoke width."""
    jm = JaxTransformerLM(jax_get_arch(arch_id).smoke_cfg)
    params = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    return jm, params, lm_params_from_arrays(params_to_arrays(params),
                                             configs.get_arch(arch_id).smoke_cfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_route(arch_id):
    """JAX's router, jitted once an arch (every caller passes 96 rows)."""
    return jax.jit(_pair(arch_id)[0]._route)


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


def _layer0(jparams, tm):
    """Layer 0's JAX parameters (sliced in numpy: no eager JAX op to
    compile) and the port's."""
    return ({k: jnp.asarray(np.asarray(v)[0, 0]) for k, v in jparams["layers"].items()},
            tm._layer(0, 0))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_route_matches_jax(arch_id):
    """Indices equal, gates and aux within 1e-6; a router of zeros ties every
    expert, and both take the lowest k."""
    _, jparams, tm = _pair(arch_id)
    jlp, tlp = _layer0(jparams, tm)
    x = np.random.default_rng(1).normal(size=(96, tm.cfg.d_model)).astype(np.float32)
    idx, gates, aux = _jax_route(arch_id)(jlp, jnp.asarray(x))
    t_idx, t_gates, t_aux = tm._route(tlp, torch.from_numpy(x))
    assert np.array_equal(t_idx.numpy(), np.asarray(idx))
    _close(t_gates, gates, rtol=1e-6, atol=1e-6)
    _close(t_aux, aux, rtol=1e-6, atol=1e-6)
    zero = dict(jlp, router=jnp.asarray(np.zeros(jlp["router"].shape, np.float32)))
    idx, gates, _ = _jax_route(arch_id)(zero, jnp.asarray(x))
    t_idx, t_gates, _ = tm._route(dict(tlp, router=torch.zeros_like(tlp["router"])),
                                  torch.from_numpy(x))
    k = tm.cfg.moe.top_k
    assert np.array_equal(t_idx.numpy(), np.asarray(idx))
    assert t_idx.tolist() == [list(range(k))] * 96
    _close(t_gates, gates, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_experts_apply_drops_as_jax(arch_id):
    """capacity_factor 0.25: every expert keeps only its first tokens in
    token order; the same tokens lose the same contributions."""
    jm, jparams, tm = _pair(arch_id)
    jlp, tlp = _layer0(jparams, tm)
    m = dataclasses.replace(tm.cfg.moe, capacity_factor=0.25)
    x = np.random.default_rng(2).normal(size=(96, tm.cfg.d_model)).astype(np.float32)
    idx, gates, _ = _jax_route(arch_id)(jlp, jnp.asarray(x))
    cap = moe_capacity(96, m)
    assert cap == max(8, int(96 * m.top_k / m.n_experts * 0.25)) == 8
    want = jax.jit(jm._experts_apply, static_argnums=(7, 8))(
        jnp.asarray(x), idx, gates, jlp["we_gate"], jlp["we_up"], jlp["we_down"],
        jnp.int32(0), cap, "swiglu")
    got = experts_apply(torch.from_numpy(x), torch.from_numpy(np.asarray(idx)).long(),
                        torch.from_numpy(np.asarray(gates)), tlp["we_gate"], tlp["we_up"],
                        tlp["we_down"], cap, "swiglu")
    dropped = (np.asarray(want) == 0).all(-1)
    assert dropped.sum() > 10                       # tokens with every choice dropped
    assert np.array_equal((got == 0).all(-1).numpy(), dropped)
    _close(got, want, rtol=1e-5, atol=1e-5)


def test_experts_apply_in_bf16_matches_jax():
    """bf16 activations and weights: the same drops, each token's
    contributions added in ascending expert id into a bf16 sum."""
    jm, jparams, tm = _pair("qwen2-moe-a2.7b")
    jlp, tlp = _layer0(jparams, tm)
    x = np.random.default_rng(3).normal(size=(96, tm.cfg.d_model)).astype(np.float32)
    idx, gates, _ = _jax_route("qwen2-moe-a2.7b")(jlp, jnp.asarray(x))
    w = [jnp.asarray(np.asarray(jlp[k]).astype(jnp.bfloat16))
         for k in ("we_gate", "we_up", "we_down")]
    xb = jnp.asarray(x.astype(jnp.bfloat16))
    want = jax.jit(jm._experts_apply, static_argnums=(7, 8))(
        xb, idx, gates, *w, jnp.int32(0), 8, "swiglu")
    got = experts_apply(torch.from_numpy(np.asarray(xb).astype(np.float32)).bfloat16(),
                        torch.from_numpy(np.asarray(idx)).long(),
                        torch.from_numpy(np.asarray(gates)),
                        *(tlp[k].detach().bfloat16()
                          for k in ("we_gate", "we_up", "we_down")), 8, "swiglu")
    assert got.dtype == torch.bfloat16
    assert np.array_equal((got == 0).all(-1).numpy(), (np.asarray(want) == 0).all(-1))
    _close(got, np.asarray(want).astype(np.float32), rtol=2e-2, atol=2e-2)


def test_expert_padding_is_inert():
    """pad_experts_to adds experts that never receive a token: the padded
    model with garbage in the padded rows gives the unpadded logits, bit for
    bit (mirrors JAX's test_expert_padding_is_semantically_inert)."""
    _, jparams, tm = _pair("qwen3-moe-235b-a22b")
    cfg = tm.cfg
    padded = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, pad_experts_to=12))
    arrays = params_to_arrays(jparams)
    for k in ("we_gate", "we_up", "we_down"):
        w = arrays[f"layers.{k}"]
        arrays[f"layers.{k}"] = np.concatenate(
            [w, np.ones(w.shape[:2] + (4,) + w.shape[3:], w.dtype)], axis=2)
    tp = lm_params_from_arrays(arrays, padded, device="cpu")
    toks = torch.from_numpy(_tokens(2, 16, seed=1))
    l0, a0, _ = tm(toks)
    l1, a1, _ = tp(toks)
    assert torch.equal(l0, l1) and torch.equal(a0, a1)


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_forward_prefill_and_decode_match_jax(arch_id):
    """Forward logits and aux, ``prefill_step`` (JAX's is the forward's last
    position), and 12 decode steps from ``init_cache(2, 32)`` against JAX's
    decode, each with its own capacity."""
    jm, params, tm = _pair(arch_id)
    toks = _tokens(2, 32)
    want, want_aux, _ = jax.jit(jm.forward)(params, jnp.asarray(toks))
    got, aux, _ = tm(torch.from_numpy(toks))
    assert got.shape == (2, 32, tm.cfg.vocab) and float(aux) > 0
    _close(got, want)
    _close(aux, want_aux, rtol=1e-5, atol=1e-6)
    _close(prefill_step(tm, torch.from_numpy(toks)), np.asarray(want)[:, -1])
    jstep = jax.jit(jm.decode_step)
    jcache = jax.tree_util.tree_map(lambda a: jnp.asarray(np.zeros(a.shape, a.dtype)),
                                    jax.eval_shape(lambda: jm.init_cache(2, 32)))
    cache = tm.init_cache(2, 32)
    for t in range(12):
        want, jcache = jstep(params, jcache, jnp.asarray(toks[:, t]))
        got, cache = tm.decode_step(cache, torch.from_numpy(toks[:, t]))
        _close(got, want)
    assert cache["pos"].tolist() == [12, 12]


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_loss_with_aux_and_its_gradient_match_jax(arch_id):
    """``loss_fn`` with ``aux_coef * aux / n_layers``, and every parameter's
    gradient within 1e-4 of its norm, without and with remat (the port's
    checkpointed trunk; JAX's remat recomputes the same values)."""
    jm, params, tm = _pair(arch_id)
    rng = np.random.default_rng(4)
    toks = _tokens(2, 25, seed=5)
    mask = (rng.random((2, 24)) > 0.2).astype(np.float32)
    args = (toks[:, :-1], toks[:, 1:], mask)
    want, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(params, *map(jnp.asarray, args))
    jg = params_to_arrays(jgrads)
    assert np.linalg.norm(jg["layers.router"]) > 0
    remat = lm_params_from_arrays(params_to_arrays(params), dataclasses.replace(
        tm.cfg, remat=True), device="cpu")
    for model in (tm, remat):
        loss = model.loss_fn(*map(torch.from_numpy, args))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5, atol=1e-5)
        for (name, _), g in zip(model.named_parameters(), grads):
            ref = jg[name]
            rel = np.linalg.norm(g.numpy() - ref) / max(np.linalg.norm(ref), 1e-30)
            assert rel <= 1e-4, (model.cfg.remat, name, rel)
    _, aux, _ = tm(torch.from_numpy(args[0]))
    with torch.no_grad():
        nll_only = (tm.loss_fn(*map(torch.from_numpy, args))
                    - tm.cfg.moe.aux_coef * aux / tm.cfg.n_layers)
    assert float(aux) > 0 and 0 < float(nll_only) < float(loss.detach())


def test_lm_train_steps_match_jax():
    """Three AdamW steps of qwen2-moe on three batches: losses (with the aux
    term), gradient norms and every parameter as JAX's."""
    jm, jparams, _ = _pair("qwen2-moe-a2.7b")
    tm = lm_params_from_arrays(params_to_arrays(jparams), configs.get_arch(
        "qwen2-moe-a2.7b").smoke_cfg, device="cpu")
    jstep = jax.jit(jax_steps.make_lm_train_step(jm, JaxAdamWConfig(**OPT)))
    tstep = steps.make_lm_train_step(tm, AdamWConfig(**OPT))
    js = jax.jit(jax_steps.init_train_state)(jparams)
    ts = steps.init_train_state(dict(tm.named_parameters()))
    for seed in range(3):
        toks = _tokens(4, 17, seed=10 + seed)
        b = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "mask": np.ones((4, 16), np.float32)}
        js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tmet = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL, err_msg=k)
    for n, a in params_to_arrays(js.params).items():   # norm-relative: see the docstring
        rel = np.linalg.norm(ts.params[n].detach().numpy() - a) / np.linalg.norm(a)
        assert rel <= 1e-4, (n, rel)


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_moe_configs_equal_jax(arch_id):
    """Every field of cfg and smoke_cfg but the torch-typed ones (the MoE
    settings and the sharding switches included), the parameter counts, the
    arch's supports_long, microbatches and rule overrides, and JAX's
    parameter names and shapes."""
    port, ref = configs.get_arch(arch_id), jax_get_arch(arch_id)
    for c_t, c_j in ((port.cfg, ref.cfg), (port.smoke_cfg, ref.smoke_cfg)):
        f_t, f_j = dataclasses.asdict(c_t), dataclasses.asdict(c_j)
        for k in ("dtype", "param_dtype", "use_flash"):
            f_t.pop(k), f_j.pop(k)
        assert f_t == f_j
        assert c_t.moe.e_padded == c_j.moe.e_padded
        assert c_t.param_count() == c_j.param_count()
        assert c_t.active_param_count() == c_j.active_param_count()
    assert port.supports_long == ref.supports_long
    assert [dataclasses.astuple(c) for c in port.cells()] == \
        [dataclasses.astuple(c) for c in ref.cells()]
    _, params, tm = _pair(arch_id)
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == \
        {k: v.shape for k, v in params_to_arrays(params).items()}
    assert tm.layers["router"].dtype == torch.float32
    assert isinstance(port.smoke_model(device="cpu"), TransformerLM)
    for f in ("train_microbatches", "rule_overrides", "decode_rule_overrides",
              "prefill_rule_overrides"):
        assert getattr(port, f) == getattr(ref, f), f
