"""The port's checkpoints and restart driver: a round trip (bf16 too),
retention and the async save's snapshot, the crash-and-restore drill of
``tests/test_distributed.py``, ``ElasticPolicy``, and checkpoints crossing
between the packages in JAX's on-disk layout: one written by the JAX
package's ``save_checkpoint`` for a smoke LM ``TrainState`` restored into
the port gives the same next-step loss (rtol and atol 1e-4, fp32), and one
written by the port restores into JAX's ``restore_checkpoint``.
"""
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as jax_restore
from repro.ckpt import save_checkpoint as jax_save
from repro.configs import get_arch as jax_get_arch
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.train import steps as jax_steps
from repro_torch import configs
from repro_torch.ckpt import CheckpointManager, restore_checkpoint, save_checkpoint
from repro_torch.convert import lm_params_from_arrays
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.runtime import ElasticPolicy, FaultInjector, TrainDriver
from repro_torch.train import steps

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small shapes: one intra-op thread. Under the suite's parallel workers
    torch's default thread pool oversubscribes the cores, and a loop of tiny
    ops then runs tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.randn(3, 4).bfloat16(), "d": torch.tensor(7, dtype=torch.int32)}}
    want = {"a": tree["a"].clone(), "c": tree["b"]["c"].clone()}
    save_checkpoint(str(tmp_path), 5, tree, {"note": "x"})
    with torch.no_grad():
        for t in (tree["a"], tree["b"]["c"], tree["b"]["d"]):
            t.zero_()
    got, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 5 and got is tree
    assert torch.equal(tree["a"], want["a"]) and torch.equal(tree["b"]["c"], want["c"])
    assert tree["b"]["c"].dtype == torch.bfloat16 and int(tree["b"]["d"]) == 7
    man = json.loads((tmp_path / "step_00000005" / "manifest.json").read_text())
    assert man["dtypes"] == {"a": "float32", "b/c": "bfloat16", "b/d": "int32"}
    assert man["shapes"]["b/d"] == [] and man["metadata"] == {"note": "x"}
    assert np.load(tmp_path / "step_00000005" / "arrays.npz")["b/c"].dtype == np.uint16


def test_checkpoint_manager_retention_and_async_snapshot(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    w = torch.zeros(4)
    for s in (10, 20, 30, 40):
        w.fill_(s)
        mgr.save(s, {"w": w})
        w.fill_(-1.0)     # the next step's in-place update, while the writer runs
    mgr.wait()
    assert mgr.latest_step() == 40
    assert sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)) == [30, 40]
    got, step = mgr.restore({"w": torch.zeros(4)})
    assert step == 40 and torch.equal(got["w"], torch.full((4,), 40.0))
    got, step = mgr.restore({"w": torch.zeros(4)}, step=30)
    assert float(got["w"][0]) == 30.0
    with pytest.raises(ValueError, match="w"):
        mgr.restore({"w": torch.zeros(5)})


def test_checkpoint_restart_resumes_training(tmp_path):
    """The drill: train, crash at step 25, restore the step-20 checkpoint,
    converge on."""
    g = torch.Generator().manual_seed(0)
    w_true = torch.tensor([2.0, -1.0])
    X = torch.randn((64, 2), generator=g)
    y = X @ w_true

    def loss(w):
        return torch.mean((X @ w - y) ** 2)

    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=200, clip_norm=0)
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    inject = FaultInjector(fail_at_steps=[25])
    params = {"w": torch.zeros(2, requires_grad=True)}
    state = (params, init_opt_state(params))

    def step_fn(state, step):
        inject.check(step)
        p, opt = state
        (gw,) = torch.autograd.grad(loss(p["w"]), [p["w"]])
        adamw_update(cfg, p, {"w": gw}, opt)
        return state

    def restore_fn():
        got, step = mgr.restore({"params": state[0], "opt": state[1]})
        return (got["params"], got["opt"]), step

    driver = TrainDriver(step_fn, lambda s, i: mgr.save(i, {"params": s[0], "opt": s[1]}),
                         restore_fn, ckpt_every=10)
    (p, opt), step = driver.run(state, 0, 120)
    assert step == 120 and driver.restarts == 1 and int(opt["step"]) == 120
    assert float(loss(p["w"].detach())) < 1e-2


def test_driver_reraises_past_max_restarts_and_elastic_policy():
    inject = FaultInjector(fail_at_steps=[1, 2])
    driver = TrainDriver(lambda s, i: (inject.check(i), s)[1], lambda s, i: None,
                         lambda: (0, 0), ckpt_every=100, max_restarts=1)
    with pytest.raises(RuntimeError, match="step 2"):
        driver.run(0, 0, 5)
    pol = ElasticPolicy(chips_per_host=4, model_axis=4)
    assert pol.propose_mesh(8) == (8, 4)
    assert pol.propose_mesh(6) == (4, 4)      # 24 chips -> data 6 -> 4
    assert pol.propose_mesh(0) is None
    assert ElasticPolicy(chips_per_host=1, model_axis=8, min_data_axis=2).propose_mesh(8) is None


def _lm_batch(vocab, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (4, 33)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            "mask": np.ones((4, 32), np.float32)}


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A smoke LM TrainState after one step of JAX training, written by JAX,
    restored into the port (a fresh model): the next step's loss and the
    parameters after it equal JAX's. Then the port writes its state and JAX
    restores it, leaf for leaf."""
    arch = "gemma2-2b"
    jm = jax_get_arch(arch).smoke_model()
    jparams = jm.init_params(jax.random.PRNGKey(0))
    jstep = jax.jit(jax_steps.make_lm_train_step(jm, JaxAdamWConfig(**OPT)))
    js, _ = jstep(jax_steps.init_train_state(jparams),
                  {k: jnp.asarray(v) for k, v in _lm_batch(512, 0).items()})
    jax_save(str(tmp_path / "jax"), 1, js)

    tm = configs.get_arch(arch).smoke_model(device="cpu", seed=5)
    ts = steps.init_train_state(dict(tm.named_parameters()))
    _, step = restore_checkpoint(str(tmp_path / "jax"), ts)
    assert step == 1 and int(ts.opt["step"]) == 1
    b = _lm_batch(512, 1)
    js2, jmet = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
    ts2, tmet = steps.make_lm_train_step(tm, AdamWConfig(**OPT))(
        ts, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tm.layers["wq"].detach().numpy(),
                               np.asarray(js2.params["layers"]["wq"]), rtol=1e-4, atol=1e-4)

    save_checkpoint(str(tmp_path / "port"), 2, ts2)
    back, step = jax_restore(str(tmp_path / "port"), js2)
    assert step == 2 and int(back.opt["step"]) == 2
    np.testing.assert_array_equal(np.asarray(back.params["embed"]), tm.embed.detach().numpy())
    np.testing.assert_array_equal(np.asarray(back.opt["nu"]["layers"]["w_up"]),
                                  ts2.opt["nu"]["layers.w_up"].numpy())
