#!/usr/bin/env python3
"""Time ``flash_attention_bwd``'s bf16 kernels at other design constants, on
one NVIDIA card.

    PYTHONPATH=src python3 scripts/attention_bwd_sweep.py [--out FILE] [--reps N]

Builds copies of ``src/repro_torch/csrc/flash_attention_bwd.cu`` with
``kSoloMaxD`` (the head widths up to which a consumer warpgroup owns 64
resident rows alone; 0: every width as a pair sharing 64 rows) and
``kSoloOverlap`` (a solo warpgroup forms tile i while tile i-1's
accumulations run) set to each variant, one ``nvcc`` each, all at once,
under ``build/attention_bwd_sweep/``, and prints the registers and spills of
their ``fa_bwd_tc_kernel`` instantiations. Then, at phase 11's bf16 cases of
``chip_smoke.py`` (gemma2-2b's heads at S=4,096 causal with the softcap and
scores widened x20, at S=8,192 with the 4,096 window; smollm-360m's and
qwen3-14b's heads at S=4,096), given o and lse from the forward kernel, it
holds every variant's gradients against ``flash_attention_bwd_ref`` (2e-2
of each gradient's norm) and times the three launches with CUDA events over
``--reps`` back-to-back calls, the variants in turn and then in reverse
order, beside SDPA's backward where there is no softcap. Prints one line
per case and variant, and the lines as JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = {   # name -> (kSoloMaxD, kSoloOverlap); the first is the source's
    "solo_overlap": (128, "true"), "solo_serial": (128, "false"), "pair": (0, "true")}
CASES = {      # name -> (H, G, S, D, window, softcap, q scale)
    "gemma2 global": (8, 4, 4096, 256, 0, 50.0, 20.0),
    "gemma2 local S=8192": (8, 4, 8192, 256, 4096, 50.0, 20.0),
    "smollm heads": (15, 5, 4096, 64, 0, 0.0, 1.0),
    "qwen3 heads": (40, 8, 4096, 128, 0, 0.0, 1.0)}
GRAD_TOL = 2e-2


def build(backend, ops):
    """{variant: its launcher}, each library built from a patched copy."""
    src = (ROOT / "src/repro_torch/csrc/flash_attention_bwd.cu").read_text()
    out_dir = ROOT / "build" / "attention_bwd_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (solo_max, overlap) in VARIANTS.items():
        text, n1 = re.subn(r"constexpr int kSoloMaxD = \d+;",
                           f"constexpr int kSoloMaxD = {solo_max};", src)
        text, n2 = re.subn(r"constexpr bool kSoloOverlap = \w+;",
                           f"constexpr bool kSoloOverlap = {overlap};", text)
        if (n1, n2) != (1, 1):
            raise RuntimeError("kSoloMaxD or kSoloOverlap is not set once in flash_attention_bwd.cu")
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
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "fa_bwd_tc_kernel" in entry and ("spill" in line or "C75" in line):
                m = re.search(r"fa_bwd_tc_kernelILi(\d+)ELb(\d)ELb(\d)E", entry)
                print(f"[sweep] {name}: D={m.group(1)} dq={m.group(2)} cap={m.group(3)}: "
                      f"{line.strip()}", flush=True)
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).flash_attention_bwd_launch
        fn.argtypes, fn.restype = ops._BWD_ARGS, ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the lines as JSON here")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch import backend
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    fns = build(backend, ops)
    dev = torch.device("cuda")
    lines = []
    for case, (H, G, S, D, window, softcap, qscale) in CASES.items():
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v, do = (torch.randn(shape, generator=g, device=dev) for shape in
                       ((1, H, S, D), (1, G, S, D), (1, G, S, D), (1, H, S, D)))
        q, k, v, do = (q * qscale).bfloat16(), k.bfloat16(), v.bfloat16(), do.bfloat16()
        kw = dict(causal=True, window=window, softcap=softcap)
        o, lse = ops.flash_attention_fwd(q, k, v, **kw)
        scale = D ** -0.5
        rows = -(-S // ops.STATS_ROWS) * ops.STATS_ROWS
        stats = torch.empty((H, rows, 2), dtype=torch.float32, device=dev)
        outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))

        def call(fn):
            err = fn(*(backend.ptr(t) for t in (q, k, v, o, do, lse, *outs, stats)),
                     backend.FLOAT_CODES[torch.bfloat16], 1, H, G, S, S, D, 1, window, softcap,
                     scale, backend.stream(dev))
            if err:
                raise RuntimeError(f"launch failed ({err})")

        want = flash_attention_bwd_ref(q, k, v, o, do, lse=lse, sm_scale=scale, **kw)
        errs = {}
        for name, fn in fns.items():
            call(fn)
            torch.cuda.synchronize()
            errs[name] = [float((a.double() - b.double()).norm() / b.double().norm())
                          for a, b in zip(outs, want)]
            if max(errs[name]) > GRAD_TOL:
                print(f"[sweep] {case} {name}: gradients off by {errs[name]}", flush=True)
                return 1
        del want
        times = {name: [] for name in fns}
        for name in [*fns, *reversed(list(fns))]:
            call(fns[name])
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                call(fns[name])
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / args.reps)
        sdpa = None
        if not softcap:
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
            torch.autograd.grad(out, leaves, do, retain_graph=True)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                torch.autograd.grad(out, leaves, do, retain_graph=True)
            end.record()
            torch.cuda.synchronize()
            sdpa = start.elapsed_time(end) / args.reps
        for name in fns:
            line = {"case": case, "variant": name, "ms": times[name], "sdpa_ms": sdpa,
                    "grad_rel_err": errs[name], "card": smi}
            lines.append(line)
            print(f"[sweep] {case} {name}: {', '.join(f'{t:.3f}' for t in times[name])} ms "
                  f"(in turn, then reversed){'' if sdpa is None else f'; SDPA {sdpa:.3f} ms'}; "
                  f"dq, dk, dv {', '.join(f'{e:.3g}' for e in errs[name])}; {smi}", flush=True)
        del q, k, v, o, lse, do, outs, stats
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
