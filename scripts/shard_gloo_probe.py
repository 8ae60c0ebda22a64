#!/usr/bin/env python3
"""Can two processes that share one CUDA card run the port's sharded paths
as a real group? A probe, for a machine with one card.

    PYTHONPATH=src python3 scripts/shard_gloo_probe.py [--out FILE.json]

Starts two processes on the card (``torch.multiprocessing``, a ``file://``
rendezvous in a temporary directory) and tries, each step on its own:
  * ``gloo`` with CUDA tensors: ``all_reduce``, ``all_gather_into_tensor``
    and ``reduce_scatter_tensor`` of a small tensor;
  * ``gloo`` with a (data 1, model 2) ``DeviceMesh`` on ``cuda``: the
    expert-parallel forward of qwen2-moe-a2.7b's smoke config (the
    parameters DTensors), its logits against the one-process forward;
  * ``nccl`` with both ranks on device 0.
Prints one JSON object: each step's outcome, the error's first line where
one was raised, "started" where a rank died in it (each rank writes its
outcomes after every step). Each attempt has its own time limit; the probe
stops every process it starts."""
import argparse
import json
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _first_line(e: BaseException) -> str:
    lines = [ln for ln in str(e).strip().splitlines() if ln.strip()]
    return f"{type(e).__name__}: {lines[0] if lines else ''}"[:400]


def _collectives(rank, out, save):
    t = torch.full((4,), float(rank + 1), device="cuda")
    for name, fn in (
            ("all_reduce", lambda: dist.all_reduce(t.clone())),
            ("all_gather_into_tensor",
             lambda: dist.all_gather_into_tensor(torch.empty(8, device="cuda"), t)),
            ("reduce_scatter_tensor",
             lambda: dist.reduce_scatter_tensor(torch.empty(2, device="cuda"), t))):
        out[name] = "started"          # what a crash leaves
        save()
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:      # the finding is the refusal's own words
            out[name] = _first_line(e)
        save()


def _ep_forward(rank, out, save):
    """The expert-parallel forward on a (1, 2) mesh on ``cuda``, step by
    step: the mesh, one DTensor all-gather, the parameters' DTensors, the
    forward."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import get_arch
    from repro_torch.configs.lm_common import rules_for
    from repro_torch.distributed.sharding import mesh_context, shard_params
    from repro_torch.models.transformer import TransformerLM

    arch = get_arch("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(arch.smoke_cfg, moe_shard_map=True)
    tok = torch.randint(0, cfg.vocab, (4, 16), generator=torch.Generator().manual_seed(0))
    tok = tok.cuda()
    want = TransformerLM(cfg, device="cuda", seed=0)(tok)[0]
    model = TransformerLM(cfg, device="cuda", seed=0)
    state = {}

    def mesh():
        state["mesh"] = init_device_mesh("cuda", (1, 2), mesh_dim_names=("data", "model"))

    def gather():
        x = distribute_tensor(torch.arange(8.0, device="cuda"), state["mesh"],
                              [Replicate(), Shard(0)])
        assert torch.equal(x.full_tensor(), torch.arange(8.0, device="cuda"))

    def forward():
        with mesh_context(state["mesh"], rules_for(arch, "train")):
            shard_params(model, model.param_axes(), state["mesh"])
            got = model(tok)[0].full_tensor()
        return f"ok, max |logit diff| {float((got - want).abs().max()):.3g}"

    for name, fn in (("mesh", mesh), ("dtensor_all_gather", gather), ("ep_forward", forward)):
        out[name] = "started"
        save()
        try:
            out[name] = fn() or "ok"
        except Exception as e:
            out[name] = _first_line(e)
            break
        finally:
            save()


def _worker(rank, backend, init, out_dir):
    torch.cuda.set_device(0)
    out = {}

    def save():                        # after every step: a rank may die in the next
        Path(out_dir, f"{backend}{rank}.json").write_text(json.dumps(out))

    try:
        out["init"] = "started"
        save()
        dist.init_process_group(backend, init_method=init, world_size=2, rank=rank,
                                device_id=torch.device("cuda", 0) if backend == "nccl" else None)
        out["init"] = "ok"
        _collectives(rank, out, save)
        if backend == "gloo":
            _ep_forward(rank, out, save)
    except Exception as e:
        out["init" if out["init"] != "ok" else "error"] = _first_line(e)
        out["trace"] = traceback.format_exc()[-1500:]
    finally:
        save()
        if dist.is_initialized():
            dist.destroy_process_group()


def _attempt(backend, timeout_s):
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.spawn(_worker, args=(backend, f"file://{d}/rendezvous", d), nprocs=2,
                       join=False)
        deadline = time.monotonic() + timeout_s
        timed_out = False
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    timed_out = True
                    break
        except Exception as e:      # a rank that died: its outcome is what it wrote
            print(f"[probe] {backend}: a rank exited: {_first_line(e)}", file=sys.stderr)
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        got = {f"rank{r}": json.loads(Path(d, f"{backend}{r}.json").read_text())
               for r in range(2) if Path(d, f"{backend}{r}.json").exists()}
        if timed_out:
            got["timed_out_after_s"] = timeout_s
        return got


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("shard_gloo_probe: no CUDA device", file=sys.stderr)
        return 2
    res = {"card": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "gloo": _attempt("gloo", 240), "nccl": _attempt("nccl", 90)}
    print(json.dumps(res))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
