"""The port's MACE against the JAX package's on the same weights and graphs:
``e3`` (the Gaunt tensor bit-identical in float64), the forward of both
tasks, ``energy_force_loss`` with force targets (value and every
parameter's gradient, through the forces' double backward),
``node_class_loss`` and its out-of-range labels, rotation invariance, three
``make_gnn_train_step`` steps per task, and ``GNNArch``'s shapes. JAX
parameters cross as numpy arrays through ``mace_params_from_arrays``; the
graphs come from the port's ``data/graphs.py`` (``test_torch_graphs.py``
holds it bit-identical to JAX's).

Tolerance: fp32; forward 1e-5 (rtol and atol), losses, gradients and
parameters after Adam steps 1e-4 (the gradients' sums run in another order
in XLA and in torch; lr 1e-3, see ``test_torch_train_steps.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.gnn_common import GNN_SHAPES as JAX_GNN_SHAPES
from repro.models import e3 as jax_e3
from repro.models.mace import GraphBatch as JaxGraphBatch
from repro.models.mace import MACEModel as JaxMACEModel
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.train import steps as jax_steps
from repro_torch import configs
from repro_torch.configs.gnn_common import GNN_SHAPES
from repro_torch.convert import mace_params_from_arrays
from repro_torch.data.graphs import (batch_molecules, build_csr, neighbor_sample, pad_subgraph,
                                     random_graph, synth_positions)
from repro_torch.models import e3
from repro_torch.models.mace import GraphBatch, segment_sum
from repro_torch.optim import AdamWConfig
from repro_torch.train import steps

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.1, clip_norm=1.0)
FIELDS = ("positions", "node_feat", "node_mask", "senders", "receivers", "edge_mask",
          "graph_ids")


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


def _cfg(task):
    smoke = configs.get_arch("mace").smoke_cfg
    if task == "energy":
        return smoke
    return dataclasses.replace(smoke, d_feat=12, n_classes=5, task="node_class")


@functools.lru_cache(maxsize=None)
def _pair(task):
    """(JAX model, its params, the port's model on the CPU) at smoke width."""
    tcfg = _cfg(task)
    jcfg = jax_get_arch("mace").smoke_cfg
    if task != "energy":
        jcfg = dataclasses.replace(jcfg, d_feat=12, n_classes=5, task="node_class")
    jm = JaxMACEModel(jcfg)
    # JAX's init on an "rbg" key: XLA compiles its bit generator in about
    # half the time of threefry's
    params = jax.jit(jm.init_params)(jax.random.key(0, impl="rbg"))
    return jm, params, mace_params_from_arrays(params_to_arrays(params), tcfg, device="cpu")


def _arrays(task, seed=0):
    """A padded batch as numpy arrays: 4 molecules of 8 atoms (16 edges each,
    some padded) for "energy"; a 64-node graph's 2-hop sample from 8 seeds,
    padded to 96 nodes and 256 edges, for "node_class"."""
    rng = np.random.default_rng(seed)
    if task == "energy":
        pos, sp, nm, s, r, em, gi = batch_molecules(rng, 4, 8, 16, 8)
        return {"positions": pos, "node_feat": sp, "node_mask": nm, "senders": s,
                "receivers": r, "edge_mask": em, "graph_ids": gi,
                "targets": rng.normal(size=4).astype(np.float32)}
    src, dst = random_graph(64, 400, seed=seed)
    indptr, indices = build_csr(src, dst, 64)
    nodes, s, r = neighbor_sample(indptr, indices, np.arange(8), (4, 3), rng)
    nodes_p, s, r, em, nm = pad_subgraph(nodes, s, r, 96, 256)
    feat = rng.normal(size=(64, 12)).astype(np.float32)
    labels = rng.integers(0, 5, 96).astype(np.int32)
    return {"positions": synth_positions(nodes_p), "node_feat": feat[nodes_p] * nm[:, None],
            "node_mask": nm, "senders": s, "receivers": r, "edge_mask": em,
            "graph_ids": np.zeros(96, np.int32), "labels": labels,
            "label_mask": (np.arange(96) < 8).astype(np.float32)}


def _n_graphs(task):
    return 4 if task == "energy" else 1


def _batches(arrays, task):
    jb = JaxGraphBatch(**{k: jnp.asarray(arrays[k]) for k in FIELDS}, n_graphs=_n_graphs(task))
    tb = GraphBatch(**{k: torch.from_numpy(arrays[k]) for k in FIELDS}, n_graphs=_n_graphs(task))
    return jb, tb


@functools.lru_cache(maxsize=None)
def _jax_forward(task):
    """JAX's forward and loss, jitted once a task (the tests share shapes):
    (params, a, b, *FIELDS) -> (output, loss), the loss
    ``node_class_loss(labels=a, label_mask=b)``, or for "energy"
    ``value_and_grad`` of ``energy_force_loss(targets=a, force_targets=b)``."""
    jm = _pair(task)[0]

    def fn(p, a, b, *f):
        gb = JaxGraphBatch(*f, n_graphs=_n_graphs(task))
        if task == "node_class":
            return jm.forward(p, gb), jm.node_class_loss(p, gb, a, b)
        return jm.forward(p, gb), jax.value_and_grad(
            lambda q: jm.energy_force_loss(q, gb, a, b))(p)

    return jax.jit(fn)


def _jax_run(task, arrays, a=None, b=None):
    """_jax_forward on ``arrays``: a, b default to the batch's labels and
    label mask, or to its targets and zero forces."""
    if a is None:
        a, b = ((arrays["labels"], arrays["label_mask"]) if task == "node_class" else
                (arrays["targets"], np.zeros((len(arrays["positions"]), 3), np.float32)))
    return _jax_forward(task)(_pair(task)[1], jnp.asarray(a), jnp.asarray(b),
                              *(jnp.asarray(arrays[k]) for k in FIELDS))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_e3_matches_jax():
    """The Gaunt tensor bit for bit in float64; the harmonics, the radial
    basis, the cutoff and the tensor product (and its gradient) at 1e-5."""
    want = jax_e3.gaunt_tensor()
    got = e3.gaunt_tensor()
    assert got.dtype == want.dtype == np.float64 and np.array_equal(got, want)
    rng = np.random.default_rng(0)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    rhat = v / np.linalg.norm(v, axis=1, keepdims=True)
    r = np.r_[0.0, 1e-12, rng.uniform(0, 6, 40)].astype(np.float32)
    g32 = np.asarray(want, np.float32)
    a, b, cot = (rng.normal(size=(6, 5, 9)).astype(np.float32) for _ in range(3))

    @jax.jit        # one compile for every JAX function held here
    def jax_ref(rhat, r, x, y, c):
        tp, vjp = jax.vjp(lambda x, y: jax_e3.tensor_product(x, y, jnp.asarray(g32)), x, y)
        return (jax_e3.real_sph_harm(rhat), jax_e3.bessel_rbf(r, 8, 5.0),
                jax_e3.poly_cutoff(r, 5.0), tp, vjp(c))

    w_sh, w_rbf, w_cut, want, jgrads = jax_ref(*map(jnp.asarray, (rhat, r, a, b, cot)))
    _close(e3.real_sph_harm(torch.from_numpy(rhat)), w_sh, FWD_TOL)
    assert np.array_equal(e3.real_sph_harm(rhat.astype(np.float64)),
                          jax_e3.real_sph_harm(rhat.astype(np.float64)))
    _close(e3.bessel_rbf(torch.from_numpy(r), 8, 5.0), w_rbf, FWD_TOL)
    _close(e3.poly_cutoff(torch.from_numpy(r), 5.0), w_cut, FWD_TOL)
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    got = e3.tensor_product(ta, tb, torch.from_numpy(g32))
    _close(got, want, FWD_TOL)
    for t, w in zip(torch.autograd.grad(got, (ta, tb), torch.from_numpy(cot)), jgrads):
        _close(t, w, FWD_TOL)
    # the chunked contraction: a chunk boundary inside the rows changes nothing
    old = e3.TP_CHUNK_ROWS
    try:
        e3.TP_CHUNK_ROWS = 7
        assert torch.equal(e3.tensor_product(ta, tb, torch.from_numpy(g32)), got)
    finally:
        e3.TP_CHUNK_ROWS = old


def test_segment_sum_drops_out_of_range_ids_as_jax():
    data = np.arange(24, dtype=np.float32).reshape(6, 4)
    ids = np.array([0, 2, -1, 3, 2, 5], np.int32)
    want = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids), num_segments=4)
    got = segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 4)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("task", ["energy", "node_class"])
def test_forward_matches_jax(task):
    """Both tasks' outputs at 1e-5, out-of-range species ids included."""
    _, _, tm = _pair(task)
    arrays = _arrays(task)
    if task == "energy":    # species outside [0, 8): -1 wraps, 99 and -20 clamp, as in JAX
        arrays["node_feat"][:3] = [-1, 99, -20]
    want, _ = _jax_run(task, arrays)
    got = tm(_batches(arrays, task)[1])
    shape = (4,) if task == "energy" else (96, 5)
    assert got.shape == shape and got.dtype == torch.float32
    _close(got, want, FWD_TOL)


def test_energy_force_loss_and_gradients_match_jax():
    """With force targets: the loss and every parameter's gradient (the
    forces are dE/dpositions, so this goes through a double backward)."""
    _, _, tm = _pair("energy")
    arrays = _arrays("energy", seed=1)
    ft = np.random.default_rng(2).normal(size=(32, 3)).astype(np.float32)
    tb = _batches(arrays, "energy")[1]
    _, (want, jgrads) = _jax_run("energy", arrays, arrays["targets"], ft)
    loss = tm.energy_force_loss(tb, torch.from_numpy(arrays["targets"]), torch.from_numpy(ft))
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    jg = params_to_arrays(jgrads)
    assert set(jg) == set(names)
    for n, g in zip(names, grads):
        scale = max(float(np.abs(jg[n]).max()), 1e-6)
        np.testing.assert_allclose(g.numpy() / scale, jg[n] / scale, **TOL, err_msg=n)


def test_node_class_loss_and_out_of_range_labels_match_jax():
    _, _, tm = _pair("node_class")
    arrays = _arrays("node_class", seed=3)
    tb = _batches(arrays, "node_class")[1]
    for labels in (arrays["labels"], np.r_[arrays["labels"][:3], -2, 7,
                                           arrays["labels"][5:]].astype(np.int32)):
        want = _jax_run("node_class", arrays, labels, arrays["label_mask"])[1]
        got = tm.node_class_loss(tb, torch.from_numpy(labels),
                                 torch.from_numpy(arrays["label_mask"]))
        if np.isnan(float(want)):
            assert np.isnan(float(got))           # label 7 of 5 classes: NaN
        else:
            np.testing.assert_allclose(float(got), float(want), **TOL)
    assert np.isnan(float(got))


def test_energy_is_rotation_invariant():
    """A rotation of every position leaves each molecule's energy (rtol
    2e-4, as ``tests/test_models_smoke.py``), and the l = 1 harmonics turn
    as (y, z, x) do."""
    _, _, tm = _pair("energy")
    arrays = _arrays("energy", seed=4)
    q, _ = np.linalg.qr(np.random.default_rng(5).normal(size=(3, 3)))
    R = q * np.sign(np.linalg.det(q))
    rot = dict(arrays, positions=(arrays["positions"] @ R.T).astype(np.float32))
    e0 = tm(_batches(arrays, "energy")[1])
    e1 = tm(_batches(rot, "energy")[1])
    np.testing.assert_allclose(e1.detach().numpy(), e0.detach().numpy(), rtol=2e-4, atol=1e-6)
    v = np.random.default_rng(6).normal(size=(5, 3))
    Y, Yr = e3.real_sph_harm(v), e3.real_sph_harm(v @ R.T)
    P = np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], dtype=np.float64)
    np.testing.assert_allclose(Yr[:, 1:4], Y[:, 1:4] @ (P @ R @ P.T).T, atol=1e-12)


@pytest.mark.parametrize("task", ["energy", "node_class"])
def test_gnn_train_steps_match_jax(task):
    """Three AdamW steps on three batches: losses, gradient norms and every
    parameter as JAX's."""
    jm, jparams, _ = _pair(task)
    tm = mace_params_from_arrays(params_to_arrays(jparams), _cfg(task), device="cpu")
    jstep = jax.jit(jax_steps.make_gnn_train_step(jm, JaxAdamWConfig(**OPT), task=task,
                                                  n_graphs=_n_graphs(task)))
    tstep = steps.make_gnn_train_step(tm, AdamWConfig(**OPT), task=task,
                                      n_graphs=_n_graphs(task))
    js = jax.jit(jax_steps.init_train_state)(jparams)
    ts = steps.init_train_state(dict(tm.named_parameters()))
    for seed in range(3):
        arrays = _arrays(task, seed=10 + seed)
        keys = FIELDS + (("targets",) if task == "energy" else ("labels", "label_mask"))
        js, jmet = jstep(js, {k: jnp.asarray(arrays[k]) for k in keys})
        ts, tmet = tstep(ts, {k: torch.from_numpy(arrays[k]) for k in keys})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL, err_msg=k)
    jarr = params_to_arrays(js.params)
    assert set(jarr) == set(ts.params)
    for n, a in jarr.items():
        np.testing.assert_allclose(ts.params[n].detach().numpy(), a, **TOL, err_msg=n)


def test_gnn_arch_equals_jax():
    """The registry entry: configs, shapes, cells, ``cfg_for`` and the
    batch specs' shapes and dtypes; the port's parameters have JAX's names
    and shapes at every shape's config."""
    port, ref = configs.get_arch("mace"), jax_get_arch("mace")
    assert port.family == ref.family == "gnn"
    assert GNN_SHAPES == JAX_GNN_SHAPES
    assert [dataclasses.astuple(c) for c in port.cells()] == \
        [dataclasses.astuple(c) for c in ref.cells()]
    for c_t, c_j in ((port.base_cfg, ref.base_cfg), (port.smoke_cfg, ref.smoke_cfg)):
        f_t, f_j = dataclasses.asdict(c_t), dataclasses.asdict(c_j)
        assert str(f_t.pop("dtype")).split(".")[-1] == jnp.dtype(f_j.pop("dtype")).name
        assert f_t == f_j
    for shape in GNN_SHAPES:
        f_t, f_j = (dataclasses.asdict(a.cfg_for(shape)) for a in (port, ref))
        f_t.pop("dtype"), f_j.pop("dtype")
        assert f_t == f_j
        want = ref.batch_specs(shape)
        got = port.batch_specs(shape)
        assert list(got) == list(want)
        for k, (shp, dt) in got.items():
            assert shp == want[k].shape and str(dt).split(".")[-1] == jnp.dtype(want[k].dtype).name
        cfg = port.cfg_for(shape)
        small = dataclasses.replace(cfg, d_hidden=8)
        jcfg = dataclasses.replace(ref.cfg_for(shape), d_hidden=8)
        jparams = jax.eval_shape(JaxMACEModel(jcfg).init_params, jax.random.PRNGKey(0))
        tm = configs.get_arch("mace").smoke_model(device="cpu")
        tm = type(tm)(small, device="cpu")
        assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == \
            {".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path): v.shape
             for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
