"""The port's train steps against the JAX package's on the same weights and
batches: 3 LM steps of smollm-360m and gemma2-2b at ``smoke_cfg`` (fp32),
with and without ``microbatches=2``; one recsys step (two, FM) of FM, DIN,
BST and MIND; FM's lazy sparse step; the loss's rule for out-of-range
targets. JAX parameters cross as numpy arrays through
``lm_params_from_arrays`` and ``recsys_params_from_arrays``; batches come
from numpy generators with a seed.

Tolerance: fp32, losses and parameters within rtol and atol 1e-4. The
gradients are sums in another order in XLA and in torch, and Adam's
normalised step (about lr in size whatever the gradient's) carries their
last digits into the parameters where a gradient is at its rounding floor:
so lr is 1e-3, and such an element may differ by up to ~lr a step (a BST
item row at lr 1e-2 differed by 1.5e-4).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.recsys_common import MODEL_CLS as JAX_MODEL_CLS
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.train import steps as jax_steps
from repro_torch import configs
from repro_torch.convert import lm_params_from_arrays, recsys_params_from_arrays
from repro_torch.data import recsys_batch
from repro_torch.models.transformer import take_targets
from repro_torch.optim import AdamWConfig
from repro_torch.train import steps as steps

TOL = dict(rtol=1e-4, atol=1e-4)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.1, clip_norm=1.0)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small shapes: one intra-op thread. Under the suite's parallel workers
    torch's default thread pool oversubscribes the cores, and a loop of tiny
    ops then runs tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def params_to_arrays(params) -> dict[str, np.ndarray]:
    """The JAX parameter tree as numpy arrays keyed by path joined with '.'."""
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path):
            np.asarray(v) for path, v in flat}


def _assert_params(tparams: dict, jparams, what):
    arrays = params_to_arrays(jparams)
    assert set(arrays) == set(tparams), what
    for n, a in arrays.items():
        np.testing.assert_allclose(tparams[n].detach().float().numpy(), a, **TOL,
                                   err_msg=f"{what}: {n}")


def _lm_batch(vocab, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}


@pytest.mark.parametrize("arch_id,microbatches", [("smollm-360m", 1), ("smollm-360m", 2),
                                                  ("gemma2-2b", 1), ("gemma2-2b", 2)])
def test_lm_train_steps_match_jax(arch_id, microbatches):
    jm = jax_get_arch(arch_id).smoke_model()
    jparams = jm.init_params(jax.random.PRNGKey(0))
    tm = lm_params_from_arrays(params_to_arrays(jparams), configs.get_arch(arch_id).smoke_cfg,
                               device="cpu")
    jstep = jax.jit(jax_steps.make_lm_train_step(jm, JaxAdamWConfig(**OPT),
                                                 microbatches=microbatches))
    tstep = steps.make_lm_train_step(tm, AdamWConfig(**OPT), microbatches=microbatches)
    js = jax_steps.init_train_state(jparams)
    ts = steps.init_train_state(dict(tm.named_parameters()))
    for i in range(3):
        b = _lm_batch(tm.cfg.vocab, 4, 32, seed=i)
        js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tmet = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL, err_msg=k)
    _assert_params(ts.params, js.params, arch_id)
    assert all(p is q for p, q in zip(ts.params.values(), tm.parameters()))


def test_lm_remat_changes_nothing_but_memory():
    cfg = dataclasses.replace(configs.get_arch("gemma2-2b").smoke_cfg, remat=False)
    b = {k: torch.from_numpy(v) for k, v in _lm_batch(cfg.vocab, 2, 24, 5).items()}
    out = []
    for remat in (False, True):
        m = configs.get_arch("gemma2-2b").smoke_model(device="cpu")
        m.cfg = dataclasses.replace(cfg, remat=remat)
        loss = m.loss_fn(b["tokens"], b["targets"], b["mask"])
        out.append((loss, torch.autograd.grad(loss, list(m.parameters()))))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    for a, c in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-7)


def test_lm_loss_out_of_range_targets_follow_jax():
    """take_along_axis: a negative target >= -V wraps once, any other
    out-of-range target gives NaN, and nll * mask keeps the NaN."""
    logp = torch.log_softmax(torch.tensor([[0.1, 0.2, 0.3, 0.4]]), -1).expand(3, 4)
    got = take_targets(logp, torch.tensor([5, -1, -6]))
    assert bool(got[0].isnan()) and float(got[1]) == float(logp[0, 3]) and bool(got[2].isnan())
    jm = jax_get_arch("smollm-360m").smoke_model()
    jparams = jm.init_params(jax.random.PRNGKey(0))
    tm = lm_params_from_arrays(params_to_arrays(jparams),
                               configs.get_arch("smollm-360m").smoke_cfg, device="cpu")
    V = tm.cfg.vocab
    b = _lm_batch(V, 2, 8, 1)
    b["mask"][:] = 1.0
    for bad, nan in ((-1, False), (-V, False), (V, True), (-V - 1, True)):
        t = b["targets"].copy()
        t[0, 3] = bad
        for masked in (False, True):
            mask = b["mask"].copy()
            mask[0, 3] = 0.0 if masked else 1.0
            jl = float(jm.loss_fn(jparams, jnp.asarray(b["tokens"]), jnp.asarray(t),
                                  jnp.asarray(mask)))
            with torch.no_grad():
                tl = float(tm.loss_fn(torch.from_numpy(b["tokens"]), torch.from_numpy(t),
                                      torch.from_numpy(mask)))
            assert np.isnan(jl) == np.isnan(tl) == nan, (bad, masked)
            if not nan:
                np.testing.assert_allclose(tl, jl, **TOL)


@functools.lru_cache(maxsize=None)
def _recsys_arrays(arch_id):
    jcfg = jax_get_arch(arch_id).smoke_cfg
    jm = JAX_MODEL_CLS[jcfg.kind](jcfg)
    jparams = jm.init_params(jax.random.PRNGKey(7))
    arrays = params_to_arrays(jparams)
    if arch_id == "mind":
        arrays["routing_init"] = np.asarray(jax.random.normal(
            jax.random.PRNGKey(0), (jcfg.n_interests, jcfg.seq_len)))
    return jm, jparams, arrays


def _recsys_pair(arch_id):
    jm, jparams, arrays = _recsys_arrays(arch_id)
    tm = recsys_params_from_arrays(configs.get_arch(arch_id).smoke_cfg, arrays, device="cpu")
    return jm, jparams, tm


def _recsys_batches(cfg, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        feats, labels = recsys_batch(cfg, 64, rng)
        out.append(({"feats": {k: jnp.asarray(v) for k, v in feats.items()},
                     "labels": jnp.asarray(labels)},
                    {"feats": {k: torch.from_numpy(v) for k, v in feats.items()},
                     "labels": torch.from_numpy(labels)}))
    return out


@pytest.mark.parametrize("arch_id", ["fm", "din", "bst", "mind"])
def test_recsys_train_step_matches_jax(arch_id):
    jm, jparams, tm = _recsys_pair(arch_id)
    jstep = jax.jit(jax_steps.make_recsys_train_step(jm, JaxAdamWConfig(**OPT)))
    tstep = steps.make_recsys_train_step(tm, AdamWConfig(**OPT))
    js = jax_steps.init_train_state(jparams)
    ts = steps.init_train_state(dict(tm.named_parameters()))
    for jb, tb in _recsys_batches(tm.cfg, 2, seed=3):
        js, jmet = jstep(js, jb)
        ts, tmet = tstep(ts, tb)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), **TOL)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), **TOL)
    _assert_params(ts.params, js.params, arch_id)


def test_fm_sparse_train_step_matches_jax():
    """Three lazy sparse steps: the touched rows of tables and linear, their
    moments and the bias as JAX's; untouched rows keep their values."""
    jm, jparams, tm = _recsys_pair("fm")
    jstep = jax.jit(jax_steps.make_fm_sparse_train_step(jm, JaxAdamWConfig(**OPT)))
    tstep = steps.make_fm_sparse_train_step(tm, AdamWConfig(**OPT))
    js = jax_steps.init_train_state(jparams)
    ts = steps.init_train_state(dict(tm.named_parameters()))
    before = tm.tables.detach().clone()
    touched = torch.zeros(tm.tables.shape[:2], dtype=torch.bool)
    for jb, tb in _recsys_batches(tm.cfg, 3, seed=4):
        js, jmet = jstep(js, jb)
        ts, tmet = tstep(ts, tb)
        ids = tb["feats"]["sparse_ids"].long()
        touched[torch.arange(ids.shape[1]), ids] = True
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL, err_msg=k)
    _assert_params(ts.params, js.params, "fm sparse")
    for m in ("mu", "nu"):
        _assert_params(ts.opt[m], js.opt[m], f"fm sparse {m}")
    assert int(ts.opt["step"]) == int(js.opt["step"]) == 3
    assert torch.equal(tm.tables.detach()[~touched], before[~touched])


def test_unported_training_paths_and_a_ragged_microbatch_raise():
    """``compress=True`` builds fp32 zero error-feedback buffers of every
    parameter's shape, and ``compress_pod`` without a mesh changes nothing:
    the step equals the uncompressed one bit for bit. A microbatch count
    that does not divide the batch raises."""
    m = configs.get_arch("smollm-360m").smoke_model(device="cpu")
    m2 = configs.get_arch("smollm-360m").smoke_model(device="cpu")
    params = dict(m.named_parameters())
    st = steps.init_train_state(params, compress=True)
    assert set(st.ef) == set(params)
    for n, e in st.ef.items():
        assert e.dtype == torch.float32 and e.shape == params[n].shape and not e.any()
    assert steps.init_train_state(params).ef == {}
    b = {k: torch.from_numpy(v) for k, v in _lm_batch(m.cfg.vocab, 4, 8, 0).items()}
    st, met = steps.make_lm_train_step(m, AdamWConfig(**OPT), compress_pod=True)(st, b)
    st2, met2 = steps.make_lm_train_step(m2, AdamWConfig(**OPT))(
        steps.init_train_state(dict(m2.named_parameters())), b)
    assert torch.equal(met["loss"], met2["loss"])
    for n, p in st.params.items():
        assert torch.equal(p, st2.params[n]) and not st.ef[n].any(), n
    step = steps.make_lm_train_step(m, AdamWConfig(), microbatches=3)
    b = {k: torch.from_numpy(v) for k, v in _lm_batch(m.cfg.vocab, 4, 8, 0).items()}
    with pytest.raises(ValueError, match="microbatches=3"):
        step(steps.init_train_state(dict(m.named_parameters())), b)
