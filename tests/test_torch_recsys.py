"""The port's recsys serving path against the JAX package on the same
weights and features: each model at its ``smoke_cfg`` (FM's JAX side through
its Pallas kernel in interpret mode), MIND's retrieval, the embedding bags,
the loss, the out-of-range gather semantics, the batch generator and the
configs. JAX parameters cross as numpy arrays through
``recsys_params_from_arrays``; features come from ``recsys_batch`` with a
seeded numpy generator.

Tolerances: FM logits rtol 1e-5, atol 1e-6; DIN, BST and MIND logits and
MIND's capsules rtol 1e-4, atol 1e-5 (sums and matrix products run in
another order in XLA and in torch on the CPU). Gather semantics are exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import list_archs as jax_list_archs
from repro.configs.recsys_common import MODEL_CLS as JAX_MODEL_CLS
from repro.configs.recsys_common import RECSYS_SHAPES as JAX_SHAPES
from repro.data.recsys_data import recsys_batch as jax_recsys_batch
from repro.models import recsys as jr
from repro.models.layers import rms_norm as jax_rms_norm
from repro_torch import configs
from repro_torch.configs.recsys_common import MODEL_CLS, RECSYS_SHAPES
from repro_torch.convert import recsys_params_from_arrays
from repro_torch.data import recsys_batch
from repro_torch.kernels.fm_pairwise import ops as fm_ops
from repro_torch.models import recsys as tr
from repro_torch.models.layers import rms_norm

ARCHS = ["fm", "din", "bst", "mind"]
TOL = {"fm": dict(rtol=1e-5, atol=1e-6)}
FLOAT_TOL = dict(rtol=1e-4, atol=1e-5)


def params_to_arrays(params) -> dict[str, np.ndarray]:
    """The JAX parameter tree as numpy arrays keyed by path joined with '.'."""
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path):
            np.asarray(v) for path, v in flat}


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def _pair(arch_id):
    """(arch id, JAX model, its params, port model) at smoke width."""
    jcfg = jax_get_arch(arch_id).smoke_cfg
    if arch_id == "fm":
        jcfg = dataclasses.replace(jcfg, use_kernel=True)
    jm = JAX_MODEL_CLS[jcfg.kind](jcfg)
    params = jm.init_params(jax.random.PRNGKey(7))
    arrays = params_to_arrays(params)
    if arch_id == "mind":
        arrays["routing_init"] = np.asarray(jax.random.normal(
            jax.random.PRNGKey(0), (jcfg.n_interests, jcfg.seq_len)))
    tm = recsys_params_from_arrays(configs.get_arch(arch_id).smoke_cfg, arrays,
                                   device="cpu")
    return arch_id, jm, params, tm


@pytest.fixture(params=ARCHS)
def pair(request):
    return _pair(request.param)


def _feats(cfg, batch, seed):
    feats, labels = recsys_batch(cfg, batch, np.random.default_rng(seed))
    return ({k: jnp.asarray(v) for k, v in feats.items()},
            {k: torch.from_numpy(v) for k, v in feats.items()}, labels)


def test_forward_matches_jax(pair):
    arch_id, jm, params, tm = pair
    jf, tf, _ = _feats(tm.cfg, 64, 11)
    want = np.asarray(jm.forward(params, jf))
    before = fm_ops.launches
    with torch.inference_mode():
        got = tm(tf)
    assert fm_ops.launches == before            # the CPU runs the plain version
    assert got.shape == (64,) and got.dtype == torch.float32
    assert np.isfinite(_host(got)).all()
    np.testing.assert_allclose(_host(got), want, **TOL.get(arch_id, FLOAT_TOL))
    if arch_id == "fm":
        assert tm.use_kernel is False           # None on the CPU: no kernel
    if arch_id == "mind":
        np.testing.assert_allclose(
            _host(tm.interests(tf["hist_items"], tf["hist_mask"])),
            np.asarray(jm.interests(params, jf["hist_items"], jf["hist_mask"])),
            **FLOAT_TOL)


def test_fm_kernel_route_on_cpu_equals_plain():
    """use_kernel=True on CPU tensors runs the plain version, not the card."""
    _, _, _, tm = _pair("fm")
    _, tf, _ = _feats(tm.cfg, 32, 2)
    with torch.inference_mode():
        plain = tm(tf)
        tm.use_kernel = True
        try:
            routed = tm(tf)
        finally:
            tm.use_kernel = False
    assert torch.equal(plain, routed)


def test_mind_retrieve_matches_jax():
    """Top-k values within tolerance; indices where neighbouring values
    differ by more than it (torch.topk orders ties its own way); every index
    scores its value. Duplicated candidates make exact ties."""
    _, jm, params, tm = _pair("mind")
    jf, tf, _ = _feats(tm.cfg, 2, 5)
    table = np.asarray(params["item_table"])
    cand = np.concatenate([table[:300], table[:40]])
    jv, ji = jm.retrieve(params, jf, jnp.asarray(cand), k=50)
    with torch.inference_mode():
        tv, ti = tm.retrieve(tf, torch.from_numpy(cand), k=50)
        score = torch.einsum("bkd,nd->bkn", tm.interests(tf["hist_items"], tf["hist_mask"]),
                             torch.from_numpy(cand)).amax(1)
    assert ti.dtype == torch.int32 and tv.shape == (2, 50)
    np.testing.assert_allclose(_host(tv), np.asarray(jv), **FLOAT_TOL)
    torch.testing.assert_close(torch.gather(score, 1, ti.long()), tv, rtol=0, atol=0)
    v = np.asarray(jv)
    gap = FLOAT_TOL["atol"] + FLOAT_TOL["rtol"] * np.abs(v)
    apart = np.ones_like(v, dtype=bool)
    apart[:, 1:] &= np.abs(np.diff(v, axis=1)) > gap[:, 1:]
    apart[:, :-1] &= np.abs(np.diff(v, axis=1)) > gap[:, :-1]
    assert apart.any() and (~apart).any()       # both cases occur
    assert np.array_equal(_host(ti)[apart], np.asarray(ji)[apart])


def test_embedding_bags_and_loss_match_jax():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(50, 6)).astype(np.float32)
    ids = rng.integers(0, 50, (4, 7)).astype(np.int32)
    mask = (rng.random((4, 7)) < 0.6).astype(np.float32)
    mask[1] = 0
    T, I, M = torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(mask)
    for m_j, m_t in ((None, None), (jnp.asarray(mask), M)):
        for mode in ("sum", "mean"):
            np.testing.assert_allclose(
                _host(tr.embedding_bag(T, I, m_t, mode)),
                np.asarray(jr.embedding_bag(jnp.asarray(table), jnp.asarray(ids), m_j, mode)),
                **FLOAT_TOL)
    flat = rng.integers(0, 50, 30).astype(np.int32)
    seg = np.sort(rng.integers(0, 6, 30)).astype(np.int32)
    np.testing.assert_allclose(
        _host(tr.embedding_bag_csr(T, torch.from_numpy(flat), torch.from_numpy(seg), 6)),
        np.asarray(jr.embedding_bag_csr(jnp.asarray(table), flat, seg, 6)), **FLOAT_TOL)
    logits = (rng.normal(size=64) * 5).astype(np.float32)
    labels = rng.integers(0, 2, 64).astype(np.float32)
    np.testing.assert_allclose(
        float(tr.bce_loss(torch.from_numpy(logits), torch.from_numpy(labels))),
        float(jr.bce_loss(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    s = rng.normal(size=16).astype(np.float32)
    np.testing.assert_allclose(_host(rms_norm(torch.from_numpy(x), torch.from_numpy(s))),
                               np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(s))),
                               rtol=1e-6, atol=1e-6)


def test_out_of_range_ids_behave_as_in_jax(pair):
    """JAX gathers never raise: numpy-style indexing (FM) wraps a negative
    id once and clamps; jnp.take (DIN, BST, MIND) wraps negatives >= -V and
    gives NaN rows otherwise. The port writes each out: NaN for NaN."""
    arch_id, jm, params, tm = pair
    cfg = tm.cfg
    V = cfg.field_vocab if arch_id == "fm" else cfg.item_vocab
    bad = np.array([V, V + 3, -1, -V, -V - 1, 2**31 - 1, -(2**31)], np.int32)
    jf, tf, _ = _feats(cfg, len(bad), 3)
    key = "sparse_ids" if arch_id == "fm" else "hist_items"
    jf = dict(jf, **{key: jf[key].at[:, 0].set(bad)})
    tf = dict(tf, **{key: tf[key].clone()})
    tf[key][:, 0] = torch.from_numpy(bad)
    if arch_id != "fm":
        tgt = np.array([V, -2, 0, 5, -V - 7, 1, 2], np.int32)
        jf["target_item"] = jnp.asarray(tgt)
        tf["target_item"] = torch.from_numpy(tgt)
    want = np.asarray(jm.forward(params, jf))
    with torch.inference_mode():
        got = _host(tm(tf))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    if arch_id == "fm":
        assert not np.isnan(got).any()
    else:
        assert np.isnan(got).any() and not np.isnan(got).all()
    live = ~np.isnan(want)
    np.testing.assert_allclose(got[live], want[live], **TOL.get(arch_id, FLOAT_TOL))


def test_take_and_segment_sum_out_of_range_as_in_jax():
    """Exactly: jnp.take's wrap and NaN rows, segment_sum dropping segment
    ids outside [0, n)."""
    table = np.arange(5 * 2, dtype=np.float32).reshape(5, 2)
    ids = np.array([[0, 4, 5, 7], [-1, -5, -6, -100]], np.int32)
    np.testing.assert_array_equal(
        _host(tr.take_rows(torch.from_numpy(table), torch.from_numpy(ids))),
        np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0)))
    seg = np.array([0, 1, 3, -1, 2, 9], np.int32)
    flat = np.array([0, 1, 2, 3, 4, 6], np.int32)
    np.testing.assert_array_equal(
        _host(tr.embedding_bag_csr(torch.from_numpy(table), torch.from_numpy(flat),
                                   torch.from_numpy(seg), 3)),
        np.asarray(jr.embedding_bag_csr(jnp.asarray(table), flat, seg, 3)))


@pytest.mark.parametrize("arch_id", ARCHS)
def test_recsys_batch_equals_jax(arch_id):
    cfg = configs.get_arch(arch_id).smoke_cfg
    got, got_l = recsys_batch(cfg, 40, np.random.default_rng(9))
    want, want_l = jax_recsys_batch(jax_get_arch(arch_id).smoke_cfg, 40,
                                    np.random.default_rng(9))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert np.array_equal(got_l, want_l)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_configs_equal_jax(arch_id):
    """Every field of cfg and smoke_cfg but the torch-typed ones; the shapes,
    cells, feature specs and the analytic FLOPs and traffic."""
    port, ref = configs.get_arch(arch_id), jax_get_arch(arch_id)
    assert configs.list_archs() == jax_list_archs()     # every arch of the JAX package
    for c_t, c_j in ((port.cfg, ref.cfg), (port.smoke_cfg, ref.smoke_cfg)):
        f_t, f_j = dataclasses.asdict(c_t), dataclasses.asdict(c_j)
        for k in ("dtype", "use_kernel"):
            f_t.pop(k), f_j.pop(k)
        assert f_t == f_j
        assert c_t.dtype == torch.float32 and c_t.use_kernel is None
    assert RECSYS_SHAPES == JAX_SHAPES
    assert [dataclasses.astuple(c) for c in port.cells()] == \
        [dataclasses.astuple(c) for c in ref.cells()]
    for B in (512, 262_144):
        specs = port.feat_specs(B)
        assert {k: (s, str(d).split(".")[-1]) for k, (s, d) in specs.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in ref.feat_specs(B).items()}
        assert port._flops(B) == ref._flops(B)
    jparams = jax.eval_shape(JAX_MODEL_CLS[ref.smoke_cfg.kind](ref.smoke_cfg).init_params,
                             jax.random.PRNGKey(0))
    tparams = list(MODEL_CLS[port.smoke_cfg.kind](port.smoke_cfg, device="cpu").parameters())
    for train in (True, False):
        assert port._traffic(512, train, tparams) == ref._traffic(512, train, jparams)
