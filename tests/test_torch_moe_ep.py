"""The expert-parallel MoE against the JAX package's ``shard_map`` branch.

The smoke configs of qwen2-moe and qwen3-moe with ``moe_shard_map`` (and
``moe_fsdp`` or ``moe_psum_bf16``, :data:`_torch_mesh_jax.MOE_CASES`) run
their meshed forward on (data, model) meshes of (1, 2), (1, 4) and (2, 2)
``gloo`` ranks, each arch under its own train rules, the parameters JAX's
(through ``convert.lm_params_from_arrays``) made DTensors by
``shard_params``. One group is spawned per mesh shape and runs every case of
that shape; every rank must take the expert-parallel branch once per layer.
Held to JAX's forward on a mesh of as many host devices:
  * fp32 partial sums: logits and aux within 1e-5;
  * ``moe_psum_bf16`` (the partials summed in bf16, in the collective's
    order): the floor rule. The floor is JAX's own distance between its
    bf16-summed and fp32-summed logits on that mesh; the port's bf16 logits
    must lie within 1.5 floors of JAX's fp32 ones, and away from the
    port's own fp32 logits (the cast was made).
With dp = 2 each data shard keeps its own capacity (JAX's ``T_loc``), so
qwen3-moe's (2, 2) case is no single-process forward. qwen2-moe's (1, 4)
case pads its 6 experts to 8 slots: rank 3 holds two slots no token
reaches. JAX's references come from one subprocess with four host devices."""
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_mesh_jax as mj
from _torch_dist import jax_reference, spawn

SHAPES = sorted({c[2] for c in mj.MOE_CASES})
FLOOR_FACTOR = 1.5


def _worker(rank, n, init, out_dir, shape):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=n, rank=rank)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import get_arch
        from repro_torch.configs.lm_common import rules_for
        from repro_torch.convert import lm_params_from_arrays
        from repro_torch.distributed.sharding import mesh_context, shard_params
        from repro_torch.models.transformer import TransformerLM

        ref = np.load(os.path.join(out_dir, "ref.npz"))
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        calls = []
        ep = TransformerLM._ep_experts

        def counted(self, *a):
            calls.append(1)
            return ep(self, *a)

        TransformerLM._ep_experts = counted
        got = {}
        for name, arch_id, shp, switches, pad in mj.MOE_CASES:
            if shp != shape:
                continue
            arch = get_arch(arch_id)
            cfg = mj.moe_cfg(arch, switches, pad)
            pre = f"param.{arch_id}.{pad}."
            model = lm_params_from_arrays({k[len(pre):]: ref[k] for k in ref.files
                                           if k.startswith(pre)}, cfg, device="cpu")
            calls.clear()
            with mesh_context(mesh, rules_for(arch, "train")):
                shard_params(model, model.param_axes(), mesh)
                logits, aux, _ = model(torch.from_numpy(mj.moe_tokens(cfg.vocab)))
                got[f"{name}_logits"] = logits.full_tensor().numpy()
                got[f"{name}_aux"] = aux.full_tensor().numpy()
            assert len(calls) == cfg.n_layers, (name, len(calls))
            if switches.get("moe_psum_bf16"):            # the same case, fp32 partials
                cfg32 = dataclasses.replace(cfg, moe_psum_bf16=False)
                m32 = lm_params_from_arrays({k[len(pre):]: ref[k] for k in ref.files
                                             if k.startswith(pre)}, cfg32, device="cpu")
                with mesh_context(mesh, rules_for(arch, "train")):
                    shard_params(m32, m32.param_axes(), mesh)
                    got[f"{name}_fp32_logits"] = m32(
                        torch.from_numpy(mj.moe_tokens(cfg.vocab)))[0].full_tensor().numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **got)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def moe_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ref")
    ref = jax_reference("moe", d)
    np.savez(d / "ref.npz", **ref)
    return d, ref


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{d}x{m}" for d, m in SHAPES])
def test_expert_parallel_moe_matches_jax(shape, tmp_path, moe_ref):
    ref_dir, ref = moe_ref
    os.link(ref_dir / "ref.npz", tmp_path / "ref.npz")
    spawn(_worker, shape[0] * shape[1], tmp_path, shape)
    cases = [c for c in mj.MOE_CASES if c[2] == shape]
    for r in range(shape[0] * shape[1]):
        got = np.load(tmp_path / f"rank{r}.npz")
        for name, _, _, switches, _ in cases:
            lg, want = got[f"{name}_logits"], ref[f"{name}_logits"]
            np.testing.assert_allclose(got[f"{name}_aux"], ref[f"{name}_aux"], rtol=1e-5,
                                       atol=1e-5, err_msg=name)
            if not switches.get("moe_psum_bf16"):
                np.testing.assert_allclose(lg, want, rtol=1e-5, atol=1e-5, err_msg=name)
                continue
            fp32 = ref[f"{name.replace('_bf16', '')}_logits"]   # JAX, fp32 partials
            floor = np.abs(want - fp32).max()
            assert floor > 1e-4, (name, floor)                  # bf16 sums round
            assert np.abs(lg - fp32).max() <= FLOOR_FACTOR * floor, (name, floor)
            assert np.abs(lg - got[f"{name}_fp32_logits"]).max() > floor / 10, name
