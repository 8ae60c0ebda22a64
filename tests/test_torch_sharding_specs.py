"""The logical-axis rules against the JAX package's, on the two production
meshes ((16, 16) over ("data", "model") and (2, 16, 16) over ("pod", "data",
"model")), for every arch that names its parameters' axes: the five LMs
under the train, prefill and decode rules of each (``rules_for``, held to
JAX's stacking), and FM, DIN, BST and MIND under the recsys cells' rules.

For every parameter: its spec (``spec_for``) equals JAX's ``PartitionSpec``
(``_spec_for``), its shard shape (``local_shape``) JAX's
``NamedSharding(AbstractMesh(...), spec).shard_shape`` (both raise where a
dim does not divide), and ``zero1_shardings`` JAX's ZeRO-1 spec. The port's
parameters come from models built on ``meta`` (no memory), JAX's from
``jax.eval_shape``; no devices are needed. One test builds both meshes for
real over a ``fake`` process group of 256 and 512 ranks (in a process of
its own) and holds DTensor's rank-0 shard of every parameter, on ``meta``,
to ``local_shape``."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs import get_arch as jax_get_arch
from repro.configs.lm_common import DECODE_RULES as JAX_DECODE_RULES
from repro.configs.recsys_common import MODEL_CLS as JAX_RECSYS
from repro.distributed import sharding as jsh
from repro.models.transformer import TransformerLM as JaxLM
from repro_torch import configs
from repro_torch.configs.lm_common import DECODE_RULES, rules_for
from repro_torch.configs.recsys_common import MODEL_CLS
from repro_torch.distributed import sharding as sh
from repro_torch.models.transformer import TransformerLM

from _torch_dist import spawn

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
LM_ARCHS = ["smollm-360m", "qwen3-14b", "gemma2-2b", "qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"]
RECSYS_ARCHS = ["fm", "din", "bst", "mind"]


def _jax_rules(arch, kind):
    """JAX's ``lowerable``: the defaults, the arch's, then the kind's."""
    rules = dict(JAX_DECODE_RULES if kind == "decode" else jsh.DEFAULT_LM_RULES)
    rules.update(arch.rule_overrides or {})
    if kind != "train":
        rules.update(getattr(arch, f"{kind}_rule_overrides") or {})
    return rules


def _flat_axes(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, tuple))
    return {".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path): v
            for path, v in flat}


def _shard_shape(shape, spec, mesh):
    try:
        return NamedSharding(mesh, spec).shard_shape(tuple(shape))
    except ValueError:
        return "uneven"


def _port_shard_shape(shape, spec, sizes):
    try:
        return sh.local_shape(shape, spec, sizes)
    except ValueError:
        return "uneven"


def _hold(port_axes, port_shapes, jax_axes, jax_shapes, port_rules, jax_rules, zero1=False):
    assert port_rules == jax_rules
    assert set(port_axes) == set(jax_axes)
    n_sharded = 0
    for (mshape, names) in MESHES.values():
        amesh = AbstractMesh(mshape, names)
        sizes = dict(zip(names, mshape))
        pspecs, jshard = {}, {}
        for n, axes in port_axes.items():
            assert tuple(axes) == tuple(jax_axes[n]), n
            spec = sh.spec_for(axes, names, port_rules)
            jspec = jsh._spec_for(jax_axes[n], amesh, jax_rules)
            assert spec == tuple(jspec), (n, names, spec, jspec)
            assert tuple(port_shapes[n]) == tuple(jax_shapes[n]), n
            assert _port_shard_shape(port_shapes[n], spec, sizes) == \
                _shard_shape(jax_shapes[n], jspec, amesh), (n, names, spec)
            pl = sh.placements(spec, sizes)
            assert len(pl) == len(names)
            n_sharded += any(e is not None for e in spec)
            pspecs[n], jshard[n] = spec, NamedSharding(amesh, jspec)
        if zero1:
            jz = jsh.zero1_shardings({n: jax.ShapeDtypeStruct(s, np.float32)
                                      for n, s in jax_shapes.items()}, jshard, amesh)
            pz = sh.zero1_shardings(port_shapes, pspecs, sizes)
            assert pz == {n: tuple(z.spec) + (None,) * (len(jax_shapes[n]) - len(z.spec))
                          for n, z in jz.items()}
    return n_sharded


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_param_specs_and_shards_match_jax(arch_id):
    port, ref = configs.get_arch(arch_id), jax_get_arch(arch_id)
    model = TransformerLM(port.cfg, device="meta")
    p_axes = model.param_axes()
    p_shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    jmodel = JaxLM(ref.cfg)
    jparams = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    j_axes = _flat_axes(jmodel.param_axes(jparams))
    j_shapes = {n: tuple(v.shape) for n, v in _flat_axes(jparams).items()}
    for kind in ("train", "prefill", "decode"):
        assert _hold(p_axes, p_shapes, j_axes, j_shapes, rules_for(port, kind),
                     _jax_rules(ref, kind), zero1=kind == "train") > 0
    assert port.train_microbatches == ref.train_microbatches
    assert DECODE_RULES == JAX_DECODE_RULES


@pytest.mark.parametrize("arch_id", RECSYS_ARCHS)
def test_recsys_param_specs_and_shards_match_jax(arch_id):
    port, ref = configs.get_arch(arch_id), jax_get_arch(arch_id)
    model = MODEL_CLS[port.cfg.kind](port.cfg, device="meta")
    jmodel = JAX_RECSYS[ref.cfg.kind](ref.cfg)
    jparams = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    j_axes = _flat_axes(jmodel.param_axes(jparams))
    j_shapes = {n: tuple(v.shape) for n, v in _flat_axes(jparams).items()}
    p_shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    for (_, names) in MESHES.values():
        bax = tuple(a for a in ("pod", "data") if a in names)
        rules = {"batch": bax, "table_rows": "model", "candidates": "model"}
        assert _hold(model.param_axes(), p_shapes, j_axes, j_shapes, rules, rules,
                     zero1=True) > 0


def test_spec_rules_placements_and_hints():
    """JAX's first-mapping-wins rule, a tuple split in the mesh's order, a
    tuple out of that order refused, a mesh dim of size 1 replicated, and
    every hint inert without a mesh."""
    from torch.distributed.tensor import Replicate, Shard

    names = ("pod", "data", "model")
    rules = dict(sh.DEFAULT_LM_RULES, heads="model", d_ff="model", seq="data")
    assert sh.spec_for(("heads", "d_ff"), names, rules) == ("model", None)
    assert sh.spec_for(("batch", "seq"), names, rules) == (("pod", "data"), None)
    assert sh.spec_for(("seq", "batch"), names, rules) == ("data", ("pod",))
    assert sh.spec_for(("batch", None, "vocab"), ("data", "model"), rules) == \
        (("data",), None, "model")
    sizes = {"pod": 2, "data": 4, "model": 8}
    assert sh.placements((("pod", "data"), "model"), sizes) == (Shard(0), Shard(0), Shard(1))
    assert sh.placements((None,), sizes) == (Replicate(),) * 3
    assert sh.placements((("pod", "data"), "model"), {"pod": 1, "data": 4, "model": 1}) == \
        (Replicate(), Shard(0), Replicate())          # a mesh dim of size 1 splits nothing
    with pytest.raises(ValueError, match="axis order"):
        sh.placements((("data", "pod"),), sizes)
    assert sh.local_shape((16, 24), (("pod", "data"), "model"), sizes) == (2, 3)
    with pytest.raises(ValueError, match="does not divide"):
        sh.local_shape((12,), ("model",), sizes)
    x = torch.arange(6.0)
    assert sh.get_mesh() is None and sh.shard_hint(x, "batch") is x
    assert sh.logical_sharding(("batch",)) is None
    assert sh.tree_shardings({"w": ("d_model", "d_ff")}) == {"w": None}
    with sh.mesh_context("a mesh", {"batch": None}):
        assert sh.get_mesh() == "a mesh" and sh.get_rules() == {"batch": None}
    assert sh.get_mesh() is None and sh.get_rules() is sh.DEFAULT_LM_RULES


def _fake_group_worker(rank, n, init, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    checked, seen = 0, set()
    for key, (mshape, names) in MESHES.items():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=int(np.prod(mshape)))
        try:
            mesh = init_device_mesh("cpu", mshape, mesh_dim_names=names)
            sizes = dict(zip(names, mshape))
            for arch_id in LM_ARCHS:
                arch = configs.get_arch(arch_id)
                model = TransformerLM(arch.cfg, device="meta")
                for n, axes in model.param_axes().items():
                    spec = sh.spec_for(axes, names, rules_for(arch, "train"))
                    p = dict(model.named_parameters())[n]
                    try:
                        want = sh.local_shape(p.shape, spec, sizes)
                    except ValueError:
                        continue
                    if (key, tuple(p.shape), spec) in seen:
                        continue
                    seen.add((key, tuple(p.shape), spec))
                    d = distribute_tensor(torch.empty(p.shape, device="meta"), mesh,
                                          sh.placements(spec, mesh))
                    assert tuple(d.to_local().shape) == want, (key, arch_id, n)
                    checked += 1
        finally:
            dist.destroy_process_group()
    np.save(os.path.join(out_dir, "checked.npy"), checked)


def test_dtensor_shards_on_fake_production_meshes(tmp_path):
    spawn(_fake_group_worker, 1, tmp_path)
    assert int(np.load(tmp_path / "checked.npy")) > 50
