"""Training launcher: data -> train step -> checkpoint manager ->
fault-tolerant driver, for any LM (MoE included), GNN or recsys arch at its
smoke config (the JAX package's ``launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 50 [--ckpt-dir DIR] [--ckpt-every 10] [--drill] [--device cpu]

It runs on the card unless ``--device cpu`` asks for the plain PyTorch
versions on the host, and raises without a card. ``--drill`` injects a
fault at step ``steps // 2``; ``TrainDriver`` restores the latest checkpoint and
carries on. The checkpoint directory (default: ``repro_torch_ckpt`` under
the system's temporary directory) is not cleared first: a run restores from
the latest step it finds there, so give each run a directory of its own.
``--arch mace`` trains on random molecular batches (8 molecules of 8 atoms,
16 edges each) for the energy task, as the JAX launcher does.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..backend import resolve_device
from ..ckpt import CheckpointManager
from ..configs import get_arch, list_archs
from ..optim.adamw import AdamWConfig
from ..runtime import FaultInjector, StepMonitor, TrainDriver
from ..train.steps import (init_train_state, make_gnn_train_step, make_lm_train_step,
                           make_recsys_train_step)


def make_lm_setup(arch, steps, device):
    from ..data.lm import TokenStream, lm_batches
    model = arch.smoke_model(device=device)
    stream = TokenStream.synthetic(vocab=model.cfg.vocab, n_docs=50)
    batches = lm_batches(stream, batch=8, seq_len=64)
    step_fn = make_lm_train_step(model, AdamWConfig(
        lr=3e-3, total_steps=steps, warmup_steps=max(steps // 20, 1)))

    def next_batch():
        t, y, m = next(batches)
        return {"tokens": torch.from_numpy(t).to(device),
                "targets": torch.from_numpy(y).to(device),
                "mask": torch.from_numpy(m).to(device)}

    return model, step_fn, next_batch


def make_gnn_setup(arch, steps, device):
    from ..data.graphs import batch_molecules
    model = arch.smoke_model(device=device)
    rng = np.random.default_rng(0)
    step_fn = make_gnn_train_step(model, AdamWConfig(lr=1e-3, total_steps=steps),
                                  task="energy", n_graphs=8)

    def next_batch():
        pos, sp, nm, s, r, em, gi = batch_molecules(rng, 8, 8, 16, 8)
        arrays = {"positions": pos, "node_feat": sp, "node_mask": nm, "senders": s,
                  "receivers": r, "edge_mask": em, "graph_ids": gi,
                  "targets": rng.normal(size=8).astype(np.float32)}
        return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}

    return model, step_fn, next_batch


def make_recsys_setup(arch, steps, device):
    from ..configs.recsys_common import MODEL_CLS
    from ..data.recsys_data import recsys_batch
    cfg = arch.smoke_cfg
    model = MODEL_CLS[cfg.kind](cfg, device=device)
    rng = np.random.default_rng(0)
    step_fn = make_recsys_train_step(model, AdamWConfig(lr=1e-3, total_steps=steps))

    def next_batch():
        feats, labels = recsys_batch(cfg, 64, rng)
        return {"feats": {k: torch.from_numpy(v).to(device) for k, v in feats.items()},
                "labels": torch.from_numpy(labels).to(device)}

    return model, step_fn, next_batch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-360m", choices=list_archs())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--drill", action="store_true",
                    help="inject a fault mid-run and restart from checkpoint")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the plain versions)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    if arch.family == "lm":
        model, step_fn, next_batch = make_lm_setup(arch, args.steps, device)
    elif arch.family == "gnn":
        model, step_fn, next_batch = make_gnn_setup(arch, args.steps, device)
    elif arch.family == "recsys":
        model, step_fn, next_batch = make_recsys_setup(arch, args.steps, device)
    else:
        raise SystemExit("use launch/serve.py for the qac arch")

    state = init_train_state(dict(model.named_parameters()))
    mgr = CheckpointManager(args.ckpt_dir, keep=2, async_save=True)
    inject = FaultInjector([args.steps // 2] if args.drill else [])
    monitor = StepMonitor()
    losses = []

    def step(s, i):
        inject.check(i)
        s, metrics = step_fn(s, next_batch())
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        losses.append(float(metrics["loss"]))
        return s

    def save(s, i):
        mgr.save(i, s)

    def restore():
        got, i = mgr.restore(state)
        print(f"[driver] restored from step {i}")
        return got, i

    driver = TrainDriver(step, save, restore, ckpt_every=args.ckpt_every,
                         monitor=monitor)
    t0 = time.time()
    state, final = driver.run(state, 0, args.steps)
    mgr.wait()
    print(f"done: {final} steps in {time.time()-t0:.1f}s, "
          f"restarts={driver.restarts}, stragglers={len(monitor.stragglers)}, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} on {device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
