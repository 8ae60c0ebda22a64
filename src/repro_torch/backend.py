"""Device resolution and the CUDA kernel build (the port's ``compat.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise instead of carrying on silently on the CPU.

The hand-written Hopper kernels live in ``csrc/*.cu``. Each source is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library with a plain
C interface (no PyTorch headers: seconds, not minutes, to build) under
``build/repro_torch/`` at the repository root, at first use. All sources are
compiled in parallel, one ``nvcc`` process each (each on every core).
Libraries are named by a hash of their sources, so an edited kernel is
rebuilt and a stale one is never loaded. The wrappers bind them with ``ctypes``: every pointer and the
stream pass as ``c_void_p``, every size as ``c_int``, and every launcher
returns its ``cudaGetLastError()`` code, which :func:`check` turns into an
exception. A build or launch failure raises; no wrapper falls back to its
plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"
# --split-compile=0: nvcc optimises a source's functions on every core at
# once (the attention sources' dozens of wgmma kernels build in about half
# the time; ptxas reports the same registers and spills)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--split-compile=0", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for CUDA without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def default_use_kernel(device) -> bool:
    """Kernel routing: true exactly when the tensors live on CUDA."""
    return torch.device(device).type == "cuda"


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_kernels(names=None) -> dict[str, str]:
    """Compile every missing kernel library, all ``nvcc`` runs at once.

    Returns ``{name: ptxas resource report}`` for the libraries built now
    (empty for those already on disk). Raises on any compiler error.
    """
    names = kernel_names() if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    reports, errors = {}, []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {n}.cu:\n{log}")
            continue
        os.replace(tmp, _lib_path(n))
        reports[n] = log
    if errors:
        raise RuntimeError("\n".join(errors))
    return reports


def load(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """The launcher ``fn`` of kernel library ``name``, building it if needed."""
    f = _fns.get((name, fn))
    if f is None:
        lib = _libs.get(name)
        if lib is None:
            build_kernels([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.qac_error_string.argtypes = [ctypes.c_int]
            lib.qac_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _fns[(name, fn)] = f
    return f


def check(name: str, err: int) -> None:
    """Raise if a launcher reported a CUDA error."""
    if err:
        msg = _libs[name].qac_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _require_cuda(name: str, dtypes, tensors) -> None:
    dev = None
    for k, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {k} must be a CUDA tensor")
        if t.dtype not in dtypes:
            raise ValueError(f"{name}: {k} must be {' or '.join(map(str, dtypes))}, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors span devices {dev} and {t.device}")
        dev = t.device


def require_cuda_int32(name: str, **tensors) -> None:
    """Validate what a kernel takes: contiguous int32 tensors on one card."""
    _require_cuda(name, (torch.int32,), tensors)


FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}   # the launchers' dtype argument


def require_cuda_float(name: str, **tensors) -> None:
    """Validate what a float kernel takes: contiguous fp32 or bf16 tensors
    on one card (``FLOAT_CODES`` gives the code each launcher takes)."""
    _require_cuda(name, tuple(FLOAT_CODES), tensors)
