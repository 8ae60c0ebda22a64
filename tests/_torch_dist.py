"""Helpers of the sharded tests: ``gloo`` ranks started by
``torch.multiprocessing.spawn`` and meeting through a ``file://`` rendezvous
under the test's temporary directory, and the JAX references of
``_torch_mesh_jax.py`` computed in a process of their own (JAX reads its
host device count when it starts)."""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]


def jax_reference(what: str, out_dir: Path) -> dict:
    """Runs ``_torch_mesh_jax.py what`` in a process with four host devices."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    path = out_dir / f"{what}.npz"
    r = subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_mesh_jax.py"), what,
                        str(path)], env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return dict(np.load(path))


def spawn(worker, n: int, tmp_path: Path, *args, timeout_s: float = 180.0):
    """``worker(rank, n, init_method, out_dir, *args)`` on n gloo ranks."""
    ctx = mp.spawn(worker, args=(n, f"file://{tmp_path}/rendezvous", str(tmp_path), *args),
                   nprocs=n, join=False)
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):       # raises a rank's exception
            assert time.monotonic() < deadline, f"{n} ranks did not finish in {timeout_s} s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
