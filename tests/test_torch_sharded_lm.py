"""The LM's entry points on a mesh of ``gloo`` ranks against the port's own
single-process route (held to JAX in ``test_torch_lm.py`` and
``test_torch_train_steps.py``), in fp32 within 1e-5:

  * (data 1, model 2), gemma2-2b's smoke config under the default rules
    (heads, d_ff and vocab over ``model``: each rank's attention is
    ``flash_attention`` on its own heads): the forward, ``prefill_step``,
    three ``decode_step``s under ``DECODE_RULES`` (heads replicated; the
    cache holds the rank's rows) and ``loss_fn`` with every gradient; and
    qwen3-moe's smoke config under its decode rules (q heads over
    ``model``, kv heads replicated: each rank reads the kv heads its q heads
    need) for three decode steps, its MoE block on the gathered batch;
  * (data 2, model 1), smollm-360m's smoke config under its own rules (pure
    data parallelism): the same four calls, each rank holding half the
    batch and half the cache's rows.

Each rank also builds ``make_local_mesh`` on its group, and
``make_production_mesh`` must refuse a group of two. No JAX here."""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_dist import spawn

TOL = dict(rtol=1e-5, atol=1e-5)
# (data, model) -> [(arch, rules of the forward / prefill / loss, rules of decode)]
GROUPS = {(1, 2): [("gemma2-2b", "default", "DECODE_RULES"), ("qwen3-moe-235b-a22b", None,
                                                                "decode")],
          (2, 1): [("smollm-360m", "train", "decode")]}
B, S, STEPS = 4, 12, 3


def _rules(arch, which):
    from repro_torch.configs.lm_common import DECODE_RULES, rules_for
    from repro_torch.distributed.sharding import DEFAULT_LM_RULES

    return {"default": DEFAULT_LM_RULES, "DECODE_RULES": DECODE_RULES}.get(which) \
        or rules_for(arch, which)


def _calls(model, tokens, targets, mask, full):
    """The forward's logits, prefill_step's, the loss and every gradient."""
    from repro_torch.distributed.sharding import get_mesh, plain_as_replicated
    from repro_torch.serve.lm import prefill_step

    out = {"forward": full(model(tokens)[0]), "prefill": full(prefill_step(model, tokens))}
    loss = model.loss_fn(tokens, targets, mask)
    with plain_as_replicated():
        grads = torch.autograd.grad(loss, list(model.parameters()))
    out["loss"] = full(loss)
    for (n, _), g in zip(model.named_parameters(), grads):
        out[f"grad.{n}"] = full(g)
    return out, get_mesh()


def _decode(model, tokens, full):
    cache = model.init_cache(B, S + STEPS)
    out = {}
    for t in range(STEPS):
        logits, cache = model.decode_step(cache, tokens[:, t])
        out[f"decode{t}"] = full(logits)
    return out, cache


def _worker(rank, n, init, out_dir, shape):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=n, rank=rank)
    try:
        from repro_torch.configs import get_arch
        from repro_torch.distributed.sharding import mesh_context, shard_params
        from repro_torch.launch.mesh import make_local_mesh, make_production_mesh

        mesh = make_local_mesh(model=shape[1], device="cpu")
        assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == ("data", "model")
        for multi in (False, True):
            try:
                make_production_mesh(multi_pod=multi, device="cpu")
                raise AssertionError("a production mesh on two ranks")
            except ValueError as e:
                assert "ranks" in str(e)
        got = {}
        g = torch.Generator().manual_seed(5)
        for arch_id, rules, dec_rules in GROUPS[shape]:
            arch = get_arch(arch_id)
            tokens = torch.randint(0, arch.smoke_cfg.vocab, (B, S), generator=g)
            targets = torch.randint(0, arch.smoke_cfg.vocab, (B, S), generator=g)
            mask = (torch.rand((B, S), generator=g) < 0.8).float()
            one = arch.smoke_model(device="cpu", seed=1)
            meshed = arch.smoke_model(device="cpu", seed=1)
            if rules is not None:
                want, _ = _calls(one, tokens, targets, mask, lambda t: t.detach())
                with mesh_context(mesh, _rules(arch, rules)):
                    shard_params(meshed, meshed.param_axes(), mesh)
                    have, seen = _calls(meshed, tokens, targets, mask,
                                        lambda t: t.full_tensor().detach())
                assert seen is mesh
                for k in want:
                    got[f"{arch_id}.{k}"] = np.stack([have[k].numpy(), want[k].numpy()])
            want, _ = _decode(one, tokens, lambda t: t)
            with mesh_context(mesh, _rules(arch, dec_rules)):
                shard_params(meshed, meshed.param_axes(), mesh)
                have, cache = _decode(meshed, tokens, lambda t: t.full_tensor())
            rows = B // shape[0]
            assert cache["k"][0].shape[1] == rows and cache["pos"].shape == (B,)
            for k in want:
                got[f"{arch_id}.{k}"] = np.stack([have[k].numpy(), want[k].numpy()])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **got)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shape", sorted(GROUPS), ids=[f"{d}x{m}" for d, m in sorted(GROUPS)])
def test_sharded_lm_calls_equal_one_process(shape, tmp_path):
    spawn(_worker, shape[0] * shape[1], tmp_path, shape)
    for r in range(shape[0] * shape[1]):
        got = np.load(tmp_path / f"rank{r}.npz")
        for arch_id, rules, _ in GROUPS[shape]:
            calls = ["decode0", "decode1", "decode2"]
            if rules is not None:
                calls += ["forward", "prefill", "loss", "grad.embed"]
            for c in calls:
                assert f"{arch_id}.{c}" in got.files, (arch_id, c)
        for k in got.files:
            have, want = got[k]
            np.testing.assert_allclose(have, want, err_msg=k, **TOL)
