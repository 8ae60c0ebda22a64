"""The int8 gradient compression (``repro_torch.distributed.compression``) and
``compress_pod`` against the JAX package.

  * ``compress``, ``decompress`` and ``compress_tree`` bit for bit against
    JAX's on seeded fp32 and bf16 gradients, with and without error
    feedback; JAX's two error-feedback tests (``tests/test_distributed.py``)
    on the port's functions;
  * ``psum_compressed`` on 2 and 4 ``gloo`` ranks bit for bit against JAX's
    under ``shard_map`` on as many host devices; on equal copies a
    ``ReplicaGroup`` of that size gives what the group gives;
  * three ``compress_pod`` steps of smollm-360m's smoke config on a (pod 2,
    data 1, model 1) group, parameters as DTensors, against JAX's step on a
    mesh of that shape: losses, parameters and error feedback within the
    tolerance ``test_torch_train_steps.py`` holds an uncompressed step to
    (rtol and atol 1e-4), except where a gradient element sits at a
    rounding tie of the quantisation (the two gradients differ in their
    last bits): there the two residuals must be the two ends of one step,
    and at most three elements of the run may be such.

JAX's references come from one subprocess a fixture (``_torch_mesh_jax.py``
with four host devices); the ranks are ``torch.multiprocessing.spawn``
processes meeting through a ``file://`` rendezvous under the test's
temporary directory, and import no JAX."""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_mesh_jax as mj
from _torch_dist import jax_reference, spawn
from repro_torch.distributed import compression as comp

TOL = dict(rtol=1e-4, atol=1e-4)


# -- compress / decompress ----------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_matches_jax(dtype):
    import jax.numpy as jnp
    from repro.distributed import compression as jcomp

    rng = np.random.default_rng(3)
    for scale in (1e-6, 1.0, 1e3):
        g = (rng.normal(size=(7, 33)) * scale).astype(np.float32)
        g[0, :3] = [0.5, -0.5, 1.5]                # ties for the half-to-even rounding
        ef = (rng.normal(size=(7, 33)) * scale * 0.01).astype(np.float32)
        tg = torch.from_numpy(g).to(getattr(torch, dtype))
        jg = jnp.asarray(g).astype(dtype)
        for e in (None, ef):
            q, s, ne = comp.compress(tg, None if e is None else torch.from_numpy(e))
            jq, js, jne = jcomp.compress(jg, None if e is None else jnp.asarray(e))
            assert q.dtype == torch.int8
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))
            np.testing.assert_array_equal(ne.numpy(), np.asarray(jne))
            np.testing.assert_array_equal(comp.decompress(q, s).numpy(),
                                          np.asarray(jcomp.decompress(jq, js)))
    zero = comp.compress(torch.zeros(5))           # the 1e-12 floor: no division by 0
    assert not zero[0].any() and not zero[2].any()
    tree = {"a": tg, "b": tg[1:3] * 3}
    efs = {"a": torch.from_numpy(ef), "b": torch.from_numpy(ef[1:3])}
    deq, new = comp.compress_tree(tree, efs)
    jdeq, jnew = jcomp.compress_tree({"a": jg, "b": jg[1:3] * 3},
                                     {"a": jnp.asarray(ef), "b": jnp.asarray(ef[1:3])})
    for k in tree:
        np.testing.assert_array_equal(deq[k].numpy(), np.asarray(jdeq[k]))
        np.testing.assert_array_equal(new[k].numpy(), np.asarray(jnew[k]))
    ef0 = comp.init_ef({"w": torch.ones(3, 2, dtype=torch.bfloat16)})
    assert ef0["w"].dtype == torch.float32 and ef0["w"].shape == (3, 2) and not ef0["w"].any()


def test_compression_error_feedback_bounded():
    """JAX's ``test_compression_error_feedback_bounded`` (20 seeds): the
    dequantised value plus the residual gives the gradient back, and the
    residual is at most half a quantisation step."""
    for seed in range(20):
        g = torch.from_numpy(np.random.default_rng(seed).normal(size=(64,)) * 10).float()
        q, scale, ef = comp.compress(g)
        assert (comp.decompress(q, scale) + ef - g).abs().max() < 1e-4
        assert ef.abs().max() <= float(scale) * 0.5 + 1e-6


def test_compression_error_feedback_accumulates_correctly():
    """JAX's test of the same name: the sum of the dequantised gradients plus
    the last residual is the sum of the true ones."""
    rng = np.random.default_rng(0)
    gs = [torch.from_numpy(rng.normal(size=(32,))).float() for _ in range(50)]
    ef = torch.zeros(32)
    total = torch.zeros(32)
    for g in gs:
        q, scale, ef = comp.compress(g, ef)
        total = total + comp.decompress(q, scale)
    torch.testing.assert_close(total + ef, sum(gs), rtol=1e-4, atol=1e-4)


# -- psum_compressed over a group ---------------------------------------------
def _psum_worker(rank, n, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=n, rank=rank)
    try:
        got = {}
        for dt in ("float32", "bfloat16"):
            g, ef = mj.psum_inputs(n, dt)
            tg = torch.from_numpy(g[rank]).to(getattr(torch, dt))
            o, ne = comp.psum_compressed(tg, dist.group.WORLD, torch.from_numpy(ef[rank]))
            got[f"{dt}_out"], got[f"{dt}_ef"] = o.numpy(), ne.numpy()
            # every member on rank 0's copy: what a ReplicaGroup stands for
            o0, ne0 = comp.psum_compressed(torch.from_numpy(g[0]).to(getattr(torch, dt)),
                                           dist.group.WORLD, torch.from_numpy(ef[0]))
            got[f"{dt}_same_out"], got[f"{dt}_same_ef"] = o0.numpy(), ne0.numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **got)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def psum_ref(tmp_path_factory):
    return jax_reference("psum", tmp_path_factory.mktemp("psum_ref"))


@pytest.mark.parametrize("n", mj.PSUM_RANKS)
def test_psum_compressed_matches_jax_on_gloo_ranks(n, tmp_path, psum_ref, monkeypatch):
    spawn(_psum_worker, n, tmp_path)
    for r in range(n):
        got = np.load(tmp_path / f"rank{r}.npz")
        for dt in ("float32", "bfloat16"):
            np.testing.assert_array_equal(got[f"{dt}_out"], psum_ref[f"psum{n}_{dt}_out"][r])
            np.testing.assert_array_equal(got[f"{dt}_ef"], psum_ref[f"psum{n}_{dt}_ef"][r])
            g, ef = mj.psum_inputs(n, dt)
            o, ne = comp.psum_compressed(torch.from_numpy(g[0]).to(getattr(torch, dt)),
                                         comp.ReplicaGroup(n), torch.from_numpy(ef[0]))
            np.testing.assert_array_equal(got[f"{dt}_same_out"], o.numpy())
            np.testing.assert_array_equal(got[f"{dt}_same_ef"], ne.numpy())
            with monkeypatch.context() as m:        # the residual in chunks of 7 elements
                m.setattr(comp, "_CHUNK", 7)
                o7, ne7 = comp.psum_compressed(torch.from_numpy(g[0]).to(getattr(torch, dt)),
                                               comp.ReplicaGroup(n), torch.from_numpy(ef[0]))
            assert torch.equal(o7, o) and torch.equal(ne7, ne)


# -- compress_pod --------------------------------------------------------------
def _pod_worker(rank, n, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=n, rank=rank)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import get_arch
        from repro_torch.configs.lm_common import rules_for
        from repro_torch.convert import lm_params_from_arrays
        from repro_torch.distributed.sharding import mesh_context, shard_params
        from repro_torch.optim import AdamWConfig
        from repro_torch.train import steps

        ref = np.load(os.path.join(out_dir, "pod.npz"))
        arch = get_arch("smollm-360m")
        model = lm_params_from_arrays({k[7:]: ref[k] for k in ref.files
                                       if k.startswith("param0.")}, arch.smoke_cfg,
                                      device="cpu")
        mesh = init_device_mesh("cpu", (2, 1, 1), mesh_dim_names=("pod", "data", "model"))
        got = {}
        with mesh_context(mesh, rules_for(arch, "train")):
            shard_params(model, model.param_axes(), mesh)
            state = steps.init_train_state(dict(model.named_parameters()), compress=True)
            step = steps.make_lm_train_step(model, AdamWConfig(**mj.POD_OPT), compress_pod=True)
            for t in range(mj.POD_STEPS):
                b = {k: torch.from_numpy(v) for k, v in mj.pod_batch(model.cfg.vocab, t).items()}
                state, met = step(state, b)
                got[f"loss{t}"] = met["loss"].full_tensor().numpy()
                for k, p in state.params.items():        # copies: the step works in place
                    got[f"param{t + 1}.{k}"] = p.full_tensor().detach().numpy().copy()
                    got[f"ef{t + 1}.{k}"] = state.ef[k].numpy().copy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **got)
    finally:
        dist.destroy_process_group()


def test_compress_pod_steps_match_jax(tmp_path):
    ref = jax_reference("pod", tmp_path)
    spawn(_pod_worker, 2, tmp_path)
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        keys = [k for k in ref if not k.startswith("param0.")]
        assert sorted(keys) == sorted(got.files)
        flips = 0
        for k in keys:
            bad = ~np.isclose(got[k], ref[k], **TOL)
            if k.startswith("ef") and bad.any():
                # the gradients are sums in another order; an element that
                # sits within their rounding of half a step quantises to the
                # other integer, and its residuals are then the two ends of
                # the step: equal in size, opposite in sign
                np.testing.assert_allclose(got[k][bad], -ref[k][bad], rtol=1e-2, err_msg=k)
                flips += int(bad.sum())
            else:
                np.testing.assert_allclose(got[k], ref[k], err_msg=k, **TOL)
        assert flips <= 3, flips
        # the residual is carried: nonzero after a step, and it changes
        ef1, ef3 = (np.concatenate([got[k].ravel() for k in got.files if k.startswith(p)])
                    for p in ("ef1.", "ef3."))
        assert np.abs(ef1).max() > 0 and not np.array_equal(ef1, ef3)
