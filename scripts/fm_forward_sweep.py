#!/usr/bin/env python3
"""Time ``fm_forward_kernel`` at other launch constants, on one NVIDIA card.

    PYTHONPATH=src python3 scripts/fm_forward_sweep.py [--out FILE]

Builds copies of ``src/repro_torch/csrc/fm_pairwise.cu`` with ``kThreads``
(threads a block), ``kEltsPerLane`` (accumulators a lane; fewer spread a
row's d over more lanes) and ``kFieldsInFlight`` (fields whose loads a lane
issues before it uses any) set to each variant, one ``nvcc`` each, all at
once, under ``build/fm_sweep/``, and prints their registers. Then, on FM at
full width (``configs/fm.py``: 39 fields x 1M rows x 10, random weights
from seed 0), it holds every variant against ``fm_forward_ref`` and times
it with CUDA events over 30 back-to-back launches, the variants in turn and
then in reverse order, at
B = 262,144 (fp32 and bf16 copies of the weights) and 1,048,576 (the ids
of ``recsys_batch``, and uniform ids). The launch shape is
``plan_fm_forward`` with the variant's ``kEltsPerLane``. Prints one
line per case and variant, and the lines as JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = {   # name -> (kThreads, kEltsPerLane, kFieldsInFlight); the first is the source's
    "t128_e16_f2": (128, 16, 2), "t128_e16_f4": (128, 16, 4), "t128_e16_f8": (128, 16, 8),
    "t256_e16_f2": (256, 16, 2), "t128_e4_f4": (128, 4, 4), "t128_e4_f8": (128, 4, 8),
    "t128_e2_f8": (128, 2, 8),
}
CONSTANTS = ("kThreads", "kEltsPerLane", "kFieldsInFlight")


def build(backend, ops):
    """{variant: its launcher}, each library built from a patched copy."""
    src = (ROOT / "src/repro_torch/csrc/fm_pairwise.cu").read_text()
    out_dir = ROOT / "build" / "fm_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, values in VARIANTS.items():
        text = src
        for const, value in zip(CONSTANTS, values):
            text, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                              text)
            if n != 1:
                raise RuntimeError(f"{const} is not set once in fm_pairwise.cu")
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        cmd = [backend.nvcc_path(), *backend.NVCC_FLAGS, "-I", str(backend.CSRC), "-o",
               str(out_dir / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        print(f"[sweep] {name}: registers per instantiation {regs}", flush=True)
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).fm_forward_launch
        fn.argtypes, fn.restype = ops._FORWARD_ARGS, ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the lines as JSON here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("fm_forward_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import backend
    from repro_torch.configs import get_arch
    from repro_torch.data import recsys_batch
    from repro_torch.kernels.fm_pairwise import ops
    from repro_torch.kernels.fm_pairwise.ref import fm_forward_ref
    from repro_torch.models.recsys import FMModel

    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    fns = build(backend, ops)
    cfg = get_arch("fm").cfg
    model = FMModel(cfg, device="cuda", seed=0)
    n_f, V, D = model.tables.shape
    weights = {"fp32": (model.tables, model.linear, model.bias)}
    weights["bf16"] = tuple(t.to(torch.bfloat16) for t in weights["fp32"])
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for B in (262_144, 1_048_576):
        ids = torch.from_numpy(recsys_batch(cfg, B, np.random.default_rng(0))[0]["sparse_ids"])
        cases.append((f"zipf B={B} fp32", ids.cuda(), "fp32"))
        if B == 262_144:
            cases.append((f"zipf B={B} bf16", ids.cuda(), "bf16"))
    cases.append(("uniform B=1048576 fp32", torch.randint(
        0, V, (1 << 20, n_f), generator=g, device="cuda", dtype=torch.int32), "fp32"))
    lines = []
    with torch.inference_mode():
        for case, ids, dt in cases:
            tables, linear, bias = weights[dt]
            B, elt = ids.shape[0], tables.element_size()
            want = fm_forward_ref(ids, tables, linear, bias)
            out = torch.empty(B, device="cuda")
            for rnd, name in enumerate([*VARIANTS, *reversed(VARIANTS)]):
                elts = VARIANTS[name][1]
                p = ops.plan_fm_forward(B, n_f, D, elt, math.gcd(tables.data_ptr(), 16), elts)
                ld, lf = p.lanes_d, p.lanes_f
                call = [backend.ptr(ids), backend.ptr(tables), backend.ptr(linear),
                        backend.ptr(bias), backend.FLOAT_CODES[tables.dtype], backend.ptr(out),
                        B, n_f, V, D, p.vec, ld, lf, backend.stream(ids.device)]

                def run():
                    if fns[name](*call):
                        raise RuntimeError(f"{name}: launch failed")
                run()
                torch.cuda.synchronize()
                tol = 2.0**-6 if dt == "bf16" else 1e-6
                if not torch.allclose(out, want, rtol=1e-5, atol=tol):
                    raise RuntimeError(f"{name} {case}: differs from fm_forward_ref by "
                                       f"{float((out - want).abs().max())}")
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(30):
                    run()
                end.record()
                torch.cuda.synchronize()
                us = start.elapsed_time(end) / 30 * 1e3
                lines.append({"case": case, "variant": name, "round": rnd // len(VARIANTS),
                              "lanes_d": ld, "lanes_f": lf, "us": us, "card": card,
                              "power": smi})
                print(f"[sweep] {case} {name} lanes_d={ld} lanes_f={lf} round "
                      f"{rnd // len(VARIANTS)}: {us:.2f} us per launch on {smi}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
