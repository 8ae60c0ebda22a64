"""The port's optimizers against the JAX package's on the same inputs:
``cosine_lr``, ``adamw_update`` (with and without clipping, fp32 and bf16
parameters) and the lazy sparse Adam (``dedup_row_grads``,
``sparse_table_update``), inputs made with numpy from a seed.

Ids are bit-identical; values within 1e-6 (fp32 arithmetic in the same
order; ``pow`` and the reductions may round differently in XLA and torch),
and bf16 parameters within one bf16 unit in the last place.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jax_adamw
from repro.optim import sparse_adam as jax_sparse
from repro_torch.optim import (AdamWConfig, adamw_update, cosine_lr, dedup_row_grads,
                               global_norm, init_opt_state, sparse_table_update)

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small shapes: one intra-op thread. Under the suite's parallel workers
    torch's default thread pool oversubscribes the cores, and a loop of tiny
    ops then runs tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(cfg):
    return jax_adamw.AdamWConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def test_cosine_lr_matches_jax():
    cfg = AdamWConfig(lr=3e-3, warmup_steps=7, total_steps=90, min_lr_frac=0.1)
    steps = np.arange(0, 120, dtype=np.int32)
    got = cosine_lr(cfg, torch.from_numpy(steps))
    want = np.asarray(jax_adamw.cosine_lr(_jcfg(cfg), jnp.asarray(steps)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert float(cosine_lr(cfg, 0)) == 0.0


def _tree(rng, dtype=np.float32):
    return {"w": rng.normal(size=(6, 5)).astype(dtype), "b": rng.normal(size=(5,)).astype(dtype),
            "s": np.asarray(rng.normal(size=()), dtype)}


@pytest.mark.parametrize("clip", [0.0, 1.0, 100.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(clip, dtype):
    rng = np.random.default_rng(3)
    cfg = AdamWConfig(lr=0.05, warmup_steps=2, total_steps=10, clip_norm=clip,
                      weight_decay=0.1)
    p0 = _tree(rng)
    jp = {k: jnp.asarray(v).astype(dtype) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in p0.items()}
    js, ts = jax_adamw.init_opt_state(jp), init_opt_state(tp)
    assert all(t.dtype == torch.float32 for t in ts["mu"].values())
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    for _ in range(4):
        g0 = {k: np.asarray(v * 3, np.float32) for k, v in _tree(rng).items()}
        jg = {k: jnp.asarray(v).astype(dtype) for k, v in g0.items()}
        tg = {k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in g0.items()}
        jp, js, jm = jax_adamw.adamw_update(_jcfg(cfg), jp, jg, js)
        tp, ts, tm = adamw_update(cfg, tp, tg, ts)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), **TOL)
        assert int(ts["step"]) == int(js["step"])
        for k in p0:
            assert tp[k].dtype == getattr(torch, dtype)
            want = np.asarray(jp[k].astype(jnp.float32))
            ulp = 0.0 if dtype == "float32" else 2.0 ** -7 * np.abs(want)
            err = np.abs(tp[k].float().numpy() - want)
            assert (err <= 1e-6 + 1e-6 * np.abs(want) + ulp).all(), (k, err.max())
            for m in ("mu", "nu"):
                np.testing.assert_allclose(ts[m][k].numpy(), np.asarray(js[m][k]),
                                           rtol=1e-5, atol=1e-6)


def test_adamw_clip_zero_is_exactly_unscaled_and_converges():
    """clip_norm = 0 leaves the gradient as it is (JAX's scale of exactly
    1.0), and AdamW drives a quadratic to its minimum (tests/test_training.py)."""
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0, total_steps=400, clip_norm=0)
    w = {"w": torch.tensor([5.0, -3.0])}
    target = torch.tensor([1.0, 2.0])
    st = init_opt_state(w)
    for _ in range(400):
        adamw_update(cfg, w, {"w": 2 * (w["w"] - target)}, st)
    assert float(((w["w"] - target) ** 2).sum()) < 1e-3
    big = {"w": torch.zeros(4)}
    _, _, m = adamw_update(AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                                       total_steps=10, clip_norm=1.0),
                           big, {"w": torch.full((4,), 1e6)}, init_opt_state(big))
    assert float(m["grad_norm"]) > 1e5 and float(big["w"].abs().max()) < 1.0
    assert float(global_norm({"a": torch.tensor([3.0]), "b": torch.tensor([4.0])})) == 5.0


def test_dedup_row_grads_matches_jax():
    rng = np.random.default_rng(7)
    for n, R in ((6, 10), (200, 37), (64, 5000)):
        ids = rng.integers(0, R, n).astype(np.int32)
        g = rng.normal(size=(n, 3)).astype(np.float32)
        ju, jg, jv = jax_sparse.dedup_row_grads(jnp.asarray(ids), jnp.asarray(g), R)
        tu, tg, tv = dedup_row_grads(torch.from_numpy(ids), torch.from_numpy(g), R)
        assert tu.dtype == torch.int32
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    ids = torch.tensor([3, 1, 3, 7, 1, 3], dtype=torch.int32)
    u, ug, _ = dedup_row_grads(ids, torch.arange(6.0)[:, None] + 1, 10)
    assert {int(i): float(v[0]) for i, v in zip(u, ug) if int(i) < 10} == {1: 7, 3: 10, 7: 4}


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_sparse_table_update_matches_jax(wd):
    """Three lazy updates with duplicate ids, the sentinel, and rows no batch
    touches (stale moments, no weight decay)."""
    rng = np.random.default_rng(11)
    R, D, N = 40, 4, 30
    cfg = AdamWConfig(lr=0.02, warmup_steps=1, total_steps=20, weight_decay=wd)
    table = rng.normal(size=(R, D)).astype(np.float32)
    jt, jmu, jnu = jnp.asarray(table), jnp.zeros((R, D)), jnp.zeros((R, D))
    tt, tmu, tnu = torch.from_numpy(table.copy()), torch.zeros(R, D), torch.zeros(R, D)
    touched = np.zeros(R, bool)
    for s in range(1, 4):
        ids = rng.integers(0, R // 2, N).astype(np.int32)      # rows >= R/2 never touched
        touched[ids] = True
        g = rng.normal(size=(N, D)).astype(np.float32)
        jt, jmu, jnu = jax_sparse.sparse_table_update(
            _jcfg(cfg), jt, jnp.asarray(g), jnp.asarray(ids), jmu, jnu, jnp.int32(s))
        sparse_table_update(cfg, tt, torch.from_numpy(g), torch.from_numpy(ids), tmu, tnu,
                            torch.tensor(s, dtype=torch.int32))
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
        np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), **TOL)
        np.testing.assert_allclose(tnu.numpy(), np.asarray(jnu), **TOL)
    np.testing.assert_array_equal(tt.numpy()[~touched], table[~touched])
    assert float(tmu[~touched].abs().max()) == 0.0
