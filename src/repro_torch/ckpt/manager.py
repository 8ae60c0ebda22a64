"""Checkpoints in the JAX package's on-disk layout (its ``ckpt/manager.py``),
so that a checkpoint written by either package restores into the other.

Layout per step: ``<dir>/step_<N:08d>.tmp/`` -> ``os.replace`` ->
``<dir>/step_<N:08d>/``, holding
   arrays.npz     every leaf, keyed by its "/"-joined tree path
                  (``params/layers/wq``, ``opt/mu/embed``, ``opt/step``); a
                  2-byte float other than float16 (bfloat16) is stored as
                  its uint16 bits
   manifest.json  step, names, shapes, dtypes (numpy's names) and metadata

A tree is a ``TrainState`` (its fields ``params``, ``opt``, ``ef``) or a dict
of such trees and tensors. A parameter's name is split at its dots, so the
port's ``layers.wq`` is JAX's ``layers/wq`` and ``mlp.0.w`` JAX's
``mlp/0/w``.

Restore differs from JAX's in one way: it copies each array into the
template's own tensor (in place, in that tensor's dtype and on its device)
and returns the template, so a model's parameters stay bound to it; JAX
returns a new tree. The async save snapshots every leaf to host memory *by
copy* before its thread starts: on the CPU ``.cpu()`` would return the
tensor itself, and the next step's in-place update would race the writer.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.float16: "float16", torch.float64: "float64",
               torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}


def _leaves(tree: Any, path: tuple = ()):
    """(name, leaf) in a fixed order; dict keys split at dots."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + tuple(str(k).split(".")))
    else:
        yield "/".join(path), tree


def _snapshot(tree: Any) -> dict[str, tuple[np.ndarray, str]]:
    """{name: (the array as stored, its dtype's name)}, copied to the host."""
    out = {}
    for name, leaf in _leaves(tree):
        t = torch.as_tensor(leaf).detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            out[name] = (t.view(torch.int16).numpy().view(np.uint16), "bfloat16")
        else:
            out[name] = (t.numpy(), DTYPE_NAMES[t.dtype])
    return out


def _write(directory: str, step: int, snap: dict, metadata: Optional[dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **{n: a for n, (a, _) in snap.items()})
    manifest = {"step": step, "names": list(snap),
                "shapes": {n: list(a.shape) for n, (a, _) in snap.items()},
                "dtypes": {n: d for n, (_, d) in snap.items()},
                "metadata": metadata or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                       # atomic publish
    return final


def save_checkpoint(directory: str, step: int, tree: Any,
                    metadata: Optional[dict] = None) -> str:
    return _write(directory, step, _snapshot(tree), metadata)


def _steps(directory: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


@torch.no_grad()
def restore_checkpoint(directory: str, template: Any, step: Optional[int] = None):
    """-> (template, step): every leaf of ``template`` (a tensor) filled in
    place from the checkpoint at ``step`` (default: the latest)."""
    steps = _steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    step = step if step is not None else steps[-1]
    with np.load(os.path.join(directory, f"step_{step:08d}", "arrays.npz")) as data:
        for name, leaf in _leaves(template):
            arr = data[name]
            if arr.dtype == np.uint16 and leaf.dtype == torch.bfloat16:
                src = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                src = torch.as_tensor(arr).to(leaf.dtype)
            if tuple(src.shape) != tuple(leaf.shape):
                raise ValueError(f"{name}: the checkpoint holds {tuple(src.shape)}, the "
                                 f"template {tuple(leaf.shape)}")
            leaf.copy_(src)
    return template, step


class CheckpointManager:
    """Retention and optional async save on a background thread."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None):
        snap = _snapshot(tree)          # by copy, before the thread starts
        if not self.async_save:
            _write(self.directory, step, snap, metadata)
            self._gc()
            return
        self.wait()

        def run():
            try:
                _write(self.directory, step, snap, metadata)
                self._gc()
            except BaseException as e:  # noqa: BLE001 (surfaced by the next wait())
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, template, step=None):
        self.wait()
        return restore_checkpoint(self.directory, template, step)

    def latest_step(self) -> Optional[int]:
        if not os.path.isdir(self.directory):
            return None
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def _gc(self):
        for s in _steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
