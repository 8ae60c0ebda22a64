"""JAX references on a mesh of host devices, for the port's sharded tests.

Run as a script in a fresh process, with ``XLA_FLAGS=
--xla_force_host_platform_device_count=4`` in its environment (JAX reads
the flag when it starts): ``python tests/_torch_mesh_jax.py {psum|moe|pod}
OUT.npz``. Writes numpy arrays into OUT.npz:

  * ``psum``: ``psum_compressed`` under ``shard_map`` over a "pod" axis of 2
    and of 4 devices, on per-rank fp32 and bf16 gradients and error
    feedback drawn from seeds (:func:`psum_inputs`);
  * ``moe``: the MoE smoke configs' meshed forward (logits, aux) for each
    case of :data:`MOE_CASES`, with the parameters they ran on (one set per
    arch and padding);
  * ``pod``: three ``compress_pod`` train steps of smollm-360m's smoke
    config on a (pod 2, data 1, model 1) mesh, the parameters and error
    feedback after each.

No test imports this module in-process; the torch side reads the same
inputs from :func:`psum_inputs`, :func:`moe_tokens` and :func:`pod_batch`
(numpy only)."""
import dataclasses
import sys

import numpy as np

PSUM_RANKS = (2, 4)
# (name, arch, (data, model), config switches, pad_experts_to)
MOE_CASES = (
    ("q2_1x2", "qwen2-moe-a2.7b", (1, 2), dict(moe_shard_map=True), 0),
    ("q2_1x4", "qwen2-moe-a2.7b", (1, 4), dict(moe_shard_map=True), 8),
    ("q2_2x2", "qwen2-moe-a2.7b", (2, 2), dict(moe_shard_map=True), 0),
    ("q2_2x2_bf16", "qwen2-moe-a2.7b", (2, 2), dict(moe_shard_map=True, moe_psum_bf16=True), 0),
    ("q3_1x2", "qwen3-moe-235b-a22b", (1, 2), dict(moe_shard_map=True), 0),
    ("q3_1x4", "qwen3-moe-235b-a22b", (1, 4), dict(moe_shard_map=True), 0),
    ("q3_2x2_fsdp", "qwen3-moe-235b-a22b", (2, 2), dict(moe_shard_map=True, moe_fsdp=True), 0),
    ("q3_2x2_fsdp_bf16", "qwen3-moe-235b-a22b", (2, 2),
     dict(moe_shard_map=True, moe_fsdp=True, moe_psum_bf16=True), 0),
)
MOE_BATCH, MOE_SEQ = 4, 16
POD_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.1, clip_norm=1.0)
POD_STEPS, POD_BATCH, POD_SEQ = 3, 4, 8


def psum_inputs(n: int, dtype: str):
    """Per-rank gradients [n, 6, 40] (a spread of magnitudes, one rank's
    larger) and fp32 error feedback, from a seed."""
    rng = np.random.default_rng(100 + n)
    g = rng.normal(size=(n, 6, 40)).astype(np.float32) * np.float32(3.0)
    g[n - 1] *= np.float32(4.0)
    ef = (rng.normal(size=(n, 6, 40)) * 0.01).astype(np.float32)
    return g, ef


def moe_tokens(vocab: int):
    return np.random.default_rng(7).integers(0, vocab, (MOE_BATCH, MOE_SEQ)).astype(np.int32)


def pod_batch(vocab: int, step: int):
    rng = np.random.default_rng(50 + step)
    toks = rng.integers(0, vocab, (POD_BATCH, POD_SEQ + 1)).astype(np.int32)
    mask = (rng.random((POD_BATCH, POD_SEQ)) < 0.9).astype(np.float32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}


def moe_cfg(arch, switches: dict, pad: int):
    cfg = dataclasses.replace(arch.smoke_cfg, **switches)
    if pad:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, pad_experts_to=pad))
    return cfg


def _mesh(shape, names):
    """A mesh of Auto axes (``with_sharding_constraint`` refuses Explicit ones,
    ``jax.make_mesh``'s default)."""
    import jax
    from jax.sharding import AxisType

    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))


def _flat(params) -> dict:
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path):
            np.asarray(v) for path, v in flat}


def run_psum(out: dict):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.distributed.compression import psum_compressed

    for n in PSUM_RANKS:
        mesh = _mesh((n,), ("pod",))
        for dt in ("float32", "bfloat16"):
            g, ef = psum_inputs(n, dt)

            def f(g_, e_):
                o, ne = psum_compressed(g_[0], "pod", e_[0])
                return o[None], ne[None]

            run = jax.jit(shard_map(f, mesh=mesh, in_specs=(P("pod"), P("pod")),
                                    out_specs=(P("pod"), P("pod")), check_vma=False))
            o, ne = run(jnp.asarray(g).astype(dt), jnp.asarray(ef))
            out[f"psum{n}_{dt}_out"] = np.asarray(o)
            out[f"psum{n}_{dt}_ef"] = np.asarray(ne)


def run_moe(out: dict):
    import jax
    from repro.configs import get_arch
    from repro.distributed.sharding import DEFAULT_LM_RULES, mesh_context
    from repro.models.transformer import TransformerLM

    for name, arch_id, shape, switches, pad in MOE_CASES:
        arch = get_arch(arch_id)
        cfg = moe_cfg(arch, switches, pad)
        model = TransformerLM(cfg)
        params = model.init_params(jax.random.PRNGKey(0))
        rules = dict(DEFAULT_LM_RULES, **(arch.rule_overrides or {}))
        mesh = _mesh(shape, ("data", "model"))
        with mesh_context(mesh, rules):
            logits, aux, _ = jax.jit(model.forward)(params, moe_tokens(cfg.vocab))
        out[f"{name}_logits"] = np.asarray(logits)
        out[f"{name}_aux"] = np.asarray(aux)
        for k, v in _flat(params).items():          # the switches leave them as they are
            out[f"param.{arch_id}.{pad}.{k}"] = v


def run_pod(out: dict):
    import jax
    from repro.configs import get_arch
    from repro.distributed.sharding import DEFAULT_LM_RULES, mesh_context
    from repro.models.transformer import TransformerLM
    from repro.optim.adamw import AdamWConfig
    from repro.train import steps

    arch = get_arch("smollm-360m")
    model = TransformerLM(arch.smoke_cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    for k, v in _flat(params).items():
        out[f"param0.{k}"] = v
    rules = dict(DEFAULT_LM_RULES, **(arch.rule_overrides or {}))
    mesh = _mesh((2, 1, 1), ("pod", "data", "model"))
    state = steps.init_train_state(params, compress=True)
    with mesh_context(mesh, rules):
        step = jax.jit(steps.make_lm_train_step(model, AdamWConfig(**POD_OPT),
                                                compress_pod=True))
        for t in range(POD_STEPS):
            state, met = step(state, pod_batch(model.cfg.vocab, t))
            out[f"loss{t}"] = np.asarray(met["loss"])
            for k, v in _flat(state.params).items():
                out[f"param{t + 1}.{k}"] = v
            for k, v in _flat(state.ef).items():
                out[f"ef{t + 1}.{k}"] = v


if __name__ == "__main__":
    what, path = sys.argv[1], sys.argv[2]
    out: dict = {}
    {"psum": run_psum, "moe": run_moe, "pod": run_pod}[what](out)
    np.savez(path, **out)
