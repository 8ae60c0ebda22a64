#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's recsys, LM and QAC serving paths on one NVIDIA card.

    python3 chip_smoke.py [--queries N] [--vocab V] [--batch B] [--seed S]

Phases, each printing its lines before the next starts:
  1. the card, its power limit and the software versions;
  2. the build of every CUDA kernel from ``src/repro_torch/csrc``, one
     ``nvcc`` per source, all at once, with the ``ptxas -v`` report of every
     flash_attention instantiation (a spill in a bf16 one fails);
  3. the recsys path at the full widths of the repo's configs: each model at
     smoke width on the card against the CPU; FM (39 fields x 1M rows x 10)
     at B = 512, 262,144 and 1,048,576 through the fm_pairwise kernel and the
     plain route (logits within rtol 1e-5, atol 1e-6; one launch per kernel
     forward, none on the plain one), its median ms per batch, one traced
     forward, and the kernel held against its plain version at each shape
     (and in bf16 at 262,144); DIN and BST at B=512 and MIND's retrieval of
     one user against 1,048,576 items (k=100), finite and launching no
     kernel; peak device memory per model;
  4. LM serving, gemma2-2b at its full width (26 layers, d_model 2304,
     vocab 256,000) with random weights from the port's generator and tokens
     from ``TokenStream.synthetic``: the flash_attention kernel against its
     plain version at the path's shapes (prefill on a global and a local
     layer, decode against a 32,768-token cache and a local ring, fp32,
     ragged, and the head shapes of smollm-360m and qwen3-14b, and qwen3-14b's
     decode at B=16 against 32,768 tokens, with SDPA's time beside them); in
     fp32 (no TF32) ``prefill_step`` at B=1, S=32,768 and 4 ``decode_step``s
     at B=2 against a filled 32,768-token cache through the kernel and the
     plain route (logits within rtol and atol 1e-3); in bf16 the median ms
     of 3 ``prefill_step``s at B=1, S=32,768, 32 ``decode_step``s at B=16
     against a 32,768-token cache, one step held against the plain route,
     ``greedy_generate`` against the plain route's tokens, one traced call
     of each step (flash_attention's device time in it), peak device memory;
     one flash_attention launch per layer per call, none on the plain route;
  5. a full-width index from the port's own builder at the widths of the
     repo's production configuration (qac-ebay: k=10, MAX_TERMS=8,
     MAX_TERM_CHARS=24, a 1M-term vocabulary, ~10M completions), from a log
     with the distributions of ``SynthLogConfig``, with its postings packed
     as "ef" (the default of ``build_qac_index``) and the same lists packed
     once more as "bitpack", each round-tripped, and their sizes;
  6. each QAC kernel against its plain PyTorch version on the card at the
     main path's shapes (bit-identical), the packed kernels for both codecs;
     the kernel's device time per launch from ``torch.profiler``, and
     CUDA-event times per call of the wrapper (host-inclusive) and of the
     plain version (3 calls only for the plain heap_topk and packed scan,
     which take up to a second each);
  7. the QAC path: parse_queries -> QACFrontend.complete on 256 sampled
     partial queries through the kernel route, the per-pop RMQ route and the
     compressed-postings routes (``postings_codec="ef"`` and ``"bitpack"``),
     all bit-identical, and the plain-PyTorch route on the first 32 of them
     with its multi-term tile loop capped at 256 tiles, bit-identical to the
     kernel route at the same cap on the same 32 queries, plus a per-request-k
     batch on every route but those two, the answers also checked
     against a brute-force host search; each route's kernel launch counts on
     the main batch, counted from 0 just before its call and read just
     after; then one traced call of the kernel route and of the "ef" route
     (``torch.profiler``, CUDA activity) for the device's busy share and the
     kernels that take its time;
  8. one JSON line naming every kernel with its launches, times and bound.
The last line is ``{"ok": true, "device": {...}}``. Any mismatch or failure
exits non-zero; without a card it exits non-zero before printing a result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12             # H100 SXM fp32 rate outside the tensor cores
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor-core rate
INF = 2**31 - 1
DEVICE = "cuda"
CODECS = ("ef", "bitpack")
MAX_PACKED_READ = 12 + 8 + 32      # directory, two payload words, the EF bitmap
PLAIN_QUERIES = 32                 # the plain route's share of the main batch
PLAIN_TILES = 256                  # its multi-term tile cap, and the capped kernel route's
KERNELS = {   # name -> (ops module, its launch counter, CUDA source, the TPU
              #          kernel it replaces, the frontend routes whose
              #          main-batch runs launch it)
    "rmq_query": ("repro_torch.kernels.rmq.ops", "launches",
                  "src/repro_torch/csrc/rmq.cu",
                  "src/repro/kernels/rmq/kernel.py:68", ("per_pop_rmq",)),
    "heap_topk": ("repro_torch.kernels.heap_topk.ops", "launches",
                  "src/repro_torch/csrc/heap_topk.cu",
                  "src/repro/kernels/heap_topk/kernel.py:186", ("kernels",)),
    "conjunctive_scan": ("repro_torch.kernels.intersect.ops", "launches",
                         "src/repro_torch/csrc/intersect.cu",
                         "src/repro/kernels/intersect/kernel.py:137", ("kernels",)),
    "heap_topk_packed": ("repro_torch.kernels.heap_topk.ops", "packed_launches",
                         "src/repro_torch/csrc/heap_topk.cu",
                         "src/repro/kernels/heap_topk/kernel.py:72", CODECS),
    "conjunctive_scan_packed": ("repro_torch.kernels.intersect.ops",
                                "packed_launches",
                                "src/repro_torch/csrc/intersect.cu",
                                "src/repro/kernels/intersect/kernel.py:110", CODECS),
    "fm_pairwise": ("repro_torch.kernels.fm_pairwise.ops", "launches",
                    "src/repro_torch/csrc/fm_pairwise.cu",
                    "src/repro/kernels/fm_pairwise/kernel.py:27", ("recsys",)),
    "flash_attention": ("repro_torch.kernels.flash_attention.ops", "launches",
                        "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:93", ("lm",)),
}
# the kernels each frontend route's main-batch run launches, and no others
ROUTE_KERNELS = {"kernels": ("heap_topk", "conjunctive_scan"),
                 "kernels_capped": ("heap_topk", "conjunctive_scan"),
                 "per_pop_rmq": ("rmq_query", "conjunctive_scan"),
                 "plain": (),
                 "ef": ("heap_topk_packed", "conjunctive_scan_packed"),
                 "bitpack": ("heap_topk_packed", "conjunctive_scan_packed"),
                 "recsys": ("fm_pairwise",),
                 "lm": ("flash_attention",)}
# the __global__ each wrapper launches, as the profiler names it
TRACE_TAGS = {"rmq_query": "rmq_query_kernel(",
              "heap_topk": "heap_topk_kernel<qac::RawLookup>",
              "conjunctive_scan": "conjunctive_scan_kernel<qac::RawLookup>",
              ("heap_topk_packed", "ef"): "heap_topk_kernel<qac::PackedLookup<true>",
              ("heap_topk_packed", "bitpack"): "heap_topk_kernel<qac::PackedLookup<false>",
              ("conjunctive_scan_packed", "ef"):
                  "conjunctive_scan_kernel<qac::PackedLookup<true>",
              ("conjunctive_scan_packed", "bitpack"):
                  "conjunctive_scan_kernel<qac::PackedLookup<false>",
              "fm_pairwise": "fm_pairwise_kernel<",   # <float> or <__nv_bfloat16>
              # flash_attention_kernel<D> (fp32) or flash_attention_tc_kernel<D, decode,
              # softcap> (bf16: prefill, or split-KV decode with its merge in the launch)
              "flash_attention": "flash_attention_"}
FM_TOL = dict(rtol=1e-5, atol=1e-6)        # FM logits, and the kernel vs plain
FLOAT_TOL = dict(rtol=1e-4, atol=1e-5)     # DIN, BST and MIND
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # rtol = atol, tests/test_kernels.py
# The same cases held row by row against the scale of each row's own output:
# ||kernel - plain|| / ||plain|| over D, at most this in every row. With
# thousands of live columns an output row is ~sqrt(e / n), ~0.01, so
# FLASH_TOL alone would pass a kernel that skips a kv tile. On an H100 the
# bf16 cases' worst rows read 3.0e-3 to 4.8e-3 (the rounding of the outputs
# and of P), the fp32 case's 1.2e-6; a kernel that reads FLASH_DROP columns
# too few scored 0.067 to 1.1 (~sqrt(32 / n) at n live columns, more in the
# heavy rows). Each case measures that control and fails unless the check
# sees it.
FLASH_ROW_TOL = {"float32": 1e-4, "bfloat16": 1.25e-2}
FLASH_DROP = 32                            # half a kv tile of the bf16 kernels at D = 256
LM_FP32_TOL = dict(rtol=1e-3, atol=1e-3)   # 26 layers summed in other orders
# one bf16 decode step, kernel vs plain route: the two attentions differ by
# a bf16 rounding here and there, which 26 layers of a bf16 residual stream
# carry to the logits. The phase measures the floor (the plain route in bf16
# against the same weights and cache in fp32) and holds the kernel route in
# bf16 within 1.5 x that floor of the fp32 logits. On an H100: floor 0.146,
# kernel vs plain route 0.164 to 0.176; the control, every attention 32
# cache columns short, 1.33; this limit must reject the control.
LM_BF16_TOL = dict(rtol=5e-2, atol=0.25)


def say(*a):
    print(*a, flush=True)


def fail(msg):
    say(f"FAIL: {msg}")
    sys.exit(1)


def demangle(symbol: str) -> str:
    """A flash_attention instantiation's name, as ptxas reports it, made
    readable: ``flash_attention_tc_kernel<256, decode, softcap>``."""
    m = re.search(r"(flash_attention_(?:tc_)?kernel)ILi(\d+)E(?:Lb(\d)ELb(\d)E)?", symbol)
    if not m:
        return symbol
    flags = ("", "") if m.group(3) is None else (
        ", " + ("decode" if m.group(3) == "1" else "prefill"),
        ", " + ("softcap" if m.group(4) == "1" else "no softcap"))
    return f"{m.group(1)}<{m.group(2)}{flags[0]}{flags[1]}>"


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# --------------------------------------------------------------------------
# phase 5: the query log
# --------------------------------------------------------------------------
def make_log(n_queries: int, vocab_size: int, seed: int):
    """A scored log with the distributions of ``SynthLogConfig`` (Poisson(7)
    term lengths clipped to [2, 16], Zipf s=1.07 over a shuffled vocabulary,
    1+Poisson(2) terms capped at 7, Zipf(1.2) scores), drawing every term id
    in one call: the per-query draw of ``generate_query_log`` costs O(V)."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
    vocab: set[str] = set()
    while len(vocab) < vocab_size:
        n = vocab_size - len(vocab)
        lens = np.clip(rng.poisson(7.0, n), 2, 16)
        chars = alpha[rng.integers(0, 26, int(lens.sum()))].tobytes().decode()
        ends = np.cumsum(lens)
        vocab.update(chars[e - L:e] for e, L in zip(ends.tolist(), lens.tolist()))
    vocab_l = sorted(vocab)
    V = len(vocab_l)
    perm = rng.permutation(V)
    probs = 1.0 / np.arange(1, V + 1) ** 1.07
    probs /= probs.sum()
    n_terms = np.clip(rng.poisson(2.0, n_queries) + 1, 1, 7)
    words = np.asarray(vocab_l, dtype=object)[perm[rng.choice(V, size=int(n_terms.sum()), p=probs)]]
    bounds = np.concatenate([[0], np.cumsum(n_terms)]).tolist()
    words = words.tolist()
    queries = [" ".join(words[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
    scores = rng.zipf(1.2, size=n_queries).astype(np.float64)
    return queries, scores


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------
def cuda_ms(torch, fn, reps: int) -> float:
    """Mean ms per call from CUDA events over ``reps`` calls after warm-up.
    At small sizes this is the host's cost of issuing the call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def traced(torch, fn, reps: int, tag: str, want: int, tries: int = 3):
    """``torch.profiler``'s CUDA activity over ``reps`` calls of ``fn``,
    which launch the ``__global__`` whose traced name holds ``tag`` ``want``
    times. Returns (profile, the launches it holds). The tracer drops
    launch records, a few at a window's edges and, late in a long process
    with many traces, a tenth of a short window. So each trace starts with a
    warm-up step of the profiler (its events are dropped) before the
    recorded one; a trace holding fewer than 90% of the launches is taken
    again, up to ``tries`` times; then the fullest is used if it holds at
    least half of them (and says so), and anything less fails."""
    from torch.profiler import ProfilerActivity, profile, schedule

    best = (None, -1)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for step_reps in (min(reps, 10), reps):
                for _ in range(step_reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        held = sum(e.count for e in prof.key_averages() if tag in e.key)
        if want * 0.9 <= held <= want:
            return prof, held
        if best[1] < held <= want:
            best = (prof, held)
    if best[1] >= want * 0.5:
        say(f"[trace] {tag}: the fullest of {tries} traces holds {best[1]} of {want} "
            f"launches; its figures are over those")
        return best
    fail(f"{tries} traces held {held} launches of {tag}, of {want} made; the last "
         f"names {[e.key[:120] for e in device_times_events(prof)]}")


def device_times_events(prof):
    return [e for e in prof.key_averages() if e.self_device_time_total > 0]


def kernel_device_ms(torch, fn, tag: str, reps: int) -> tuple[float, int]:
    """(mean device ms per launch, launches traced) of the ``__global__``
    whose traced name holds ``tag`` over ``reps`` calls of ``fn`` after
    warm-up, from ``torch.profiler``'s CUDA activity (the kernel's own time,
    without the host's cost of the call), averaged over the launches the
    trace holds."""
    fn()
    torch.cuda.synchronize()
    prof, held = traced(torch, fn, reps, tag, reps)
    hits = [e for e in device_times_events(prof) if tag in e.key]
    return sum(e.self_device_time_total for e in hits) / held / 1e3, held


def median_ms(torch, fn, reps: int) -> float:
    """Median ms of ``reps`` calls after warm-up, each between its own pair
    of CUDA events (host-inclusive at small sizes, as ``cuda_ms``)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_times(prof):
    """(device us, kernel name, launches) per kernel of a trace, largest first."""
    return sorted(((e.self_device_time_total, e.key, e.count)
                   for e in device_times_events(prof)), reverse=True)


def rmq_bytes(torch, n, p, q) -> int:
    """Bytes the RMQ needs for these ranges: (p, q) in and (pos, val) out,
    plus the ib, values and sparse-table reads that the result depends on."""
    p = p.clamp(0, n - 1).long()
    qc = q.clamp(0, n - 1).long()
    same = (p // 128) == (qc // 128)
    mid = (qc // 128 - p // 128 - 1) > 0
    hi1 = torch.maximum(torch.where(same, qc, p // 128 * 128 + 127), p)
    j1 = (hi1 - p) > 0                      # the left window needs ib reads
    j2 = ~same & ((qc % 128) > 0)           # so does the right one
    per = (16 + 4 * (2 + 2 * (~same).long() + 2 * mid.long())
           + 2 * j1.long() + 2 * j2.long() + 8 * mid.long())
    return int(per.sum())


def packed_read_bytes(torch, pk, pos):
    """Bytes one packed lookup at each postings position needs: its block's
    directory (base, meta, wordoff: 12 B); the payload words that hold its
    fixed-width field (none at width 0, one when the field lies in one word,
    else two); and on an EF block the bitmap words up to the one that holds
    its set bit, where the select stops."""
    from repro_torch.core.codecs import EF_BITMAP_WORDS, popcount32

    pos = pos.long()
    b, j = pos // 128, pos % 128
    meta, off = pk.meta[b].long(), pk.wordoff[b].long()
    wf, is_ef = meta & 63, (meta >> 6) & 1
    payload = torch.where(wf == 0, 0, torch.where((j * wf) % 32 + wf <= 32, 4, 8))
    at = off[..., None] + torch.arange(EF_BITMAP_WORDS, device=pos.device)
    bitmap = pk.words[at.clamp(max=pk.words.numel() - 1)].long() & 0xFFFFFFFF
    before = (popcount32(bitmap).cumsum(-1) <= j[..., None]).sum(-1)
    return 12 + payload + 4 * is_ef * (before + 1).clamp(max=EF_BITMAP_WORDS)


def heap_bytes(torch, lo, hi, out, k, offsets, minimal, postings, pk=None):
    """Bytes heap_topk needs for these ranges: the ranges in, out and done
    out, and a read for each docid emitted: 4 B raw; over packed postings
    4 B when the docid heads a list of the lane's range (the RMQ over
    ``minimal`` can give it), else one packed lookup at its cheapest
    position in the range's postings."""
    total = lo.numel() * (8 + 4 * k + 1)
    live = out < INF
    if pk is None:
        return total + 4 * int(live.sum())
    n = offsets.numel() - 1
    for b in range(lo.numel()):
        l, h = int(lo[b].clamp(0, n)), int(hi[b].clamp(0, n))
        if l >= h:
            continue
        docs = out[b][live[b]]                      # ascending
        head = torch.isin(docs, minimal[l:h])
        rest = docs[~head]
        s, e = int(offsets[l]), int(offsets[h])
        pos = s + torch.nonzero(torch.isin(postings[s:e], rest))[:, 0]
        cheapest = torch.full_like(rest, MAX_PACKED_READ, dtype=torch.long).scatter_reduce(
            0, torch.searchsorted(rest, postings[pos]), packed_read_bytes(torch, pk, pos),
            "amin")
        total += 4 * int(head.sum()) + int(cheapest.sum())
    return total


def probe_positions(torch, postings, cands, starts, ends, iters):
    """The insertion point of each candidate [B, T] in each [start, end)
    span [B, P] after ``iters`` halvings -> [B, T, P]: the position whose
    posting every probe must read to decide the hit."""
    n = postings.numel()
    shape = (cands.shape[0], cands.shape[1], starts.shape[1])
    lo, hi = starts[:, None, :].expand(shape), ends[:, None, :].expand(shape)
    c = cands[:, :, None]
    for _ in range(iters):
        mid = (lo + hi) // 2
        go = postings[mid.clamp(0, n - 1)] < c
        valid = lo < hi
        lo, hi = torch.where(valid & go, mid + 1, lo), torch.where(valid & ~go, mid, hi)
    return lo.clamp(0, n - 1)


# --------------------------------------------------------------------------
# brute-force host reference
# --------------------------------------------------------------------------
def brute_force(arrays, plen, pids, tlo, thi, k, scan_cap):
    """Top-k docids of one parsed query straight from the CSR postings and
    the forward index (no RMQ, no probes): the candidates are the prefix
    lists' intersection (or, single-term, the union of the suffix range's
    lists); a candidate counts when its forward row holds a suffix term.
    The engine scans at most ``scan_cap`` postings of the shortest prefix
    list (``max_tiles * tile``), and so does this."""
    offs, post, fwd = arrays
    if tlo >= thi or (plen > 0 and (pids[:plen] == 0).any()):
        docs = np.zeros(0, np.int64)
    elif plen == 0:
        docs = np.unique(post[offs[tlo]:offs[thi]])
    else:
        lists = [post[offs[t]:offs[t + 1]] for t in pids[:plen]]
        driver = int(np.argmin([len(x) for x in lists]))
        docs = lists[driver][:scan_cap]
        for j, lst in enumerate(lists):
            if j != driver:
                docs = np.intersect1d(docs, lst)
        rows = fwd[docs]
        docs = docs[((rows >= tlo) & (rows < thi)).any(axis=1)]
    out = np.full(k, INF, np.int64)
    out[: min(k, len(docs))] = np.sort(docs)[:k]
    return out


def counter(torch, reset_counts, read_counts, kernel, phase, total=None):
    """-> counted_run(fn, want): fn() with every launch count set to 0 just
    before and read just after; the run must launch ``kernel`` ``want`` times
    and nothing else. Adds the counts to ``total`` when one is given."""
    def counted_run(fn, want):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got = read_counts()
        if any(c != (want if name == kernel else 0) for name, c in got.items()):
            fail(f"{phase}: a run launched {got}; it launches {kernel} {want} times only")
        if total is not None:
            for name, c in got.items():
                total[name] = total.get(name, 0) + c
        return out
    return counted_run


# --------------------------------------------------------------------------
# phase 3: recsys serving
# --------------------------------------------------------------------------
def fm_host_logits(torch, model, ids) -> np.ndarray:
    """FM logits in float64 on the host by the explicit pair sum: bias +
    sum_f linear + sum_{i<j} <v_i, v_j>."""
    from repro_torch.models.recsys import clamp_rows

    n_f, V, D = model.tables.shape
    flat = clamp_rows(ids, V) + torch.arange(n_f, device=ids.device) * V
    emb = model.tables.view(n_f * V, D)[flat].double().cpu().numpy()
    lin = model.linear.view(n_f * V)[flat].double().cpu().numpy().sum(-1)
    pair = sum((emb[:, i] * emb[:, j]).sum(-1) for i in range(n_f) for j in range(i + 1, n_f))
    return float(model.bias) + lin + pair


def recsys_phase(torch, dev, seed, smi, hold, reset_counts, read_counts) -> dict:
    """FM at its three inference shapes through the kernel and the plain
    route, the kernel held against its plain version there (and in bf16),
    DIN and BST at serve_p99, MIND's retrieval of one user against 1M items;
    every model also at smoke width on the card against the CPU. Returns the
    launch counts summed over the counted runs."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.recsys_common import MODEL_CLS, RECSYS_SHAPES
    from repro_torch.data import recsys_batch
    from repro_torch.kernels.fm_pairwise import ops as fm_ops
    from repro_torch.kernels.fm_pairwise.ref import fm_pairwise_ref
    from repro_torch.models.recsys import clamp_rows

    total = {}
    counted_run = counter(torch, reset_counts, read_counts, "fm_pairwise", "recsys", total)

    def on_card(feats_np):
        return {k: torch.from_numpy(v).to(dev) for k, v in feats_np.items()}

    def memory(model):
        n = sum(t.numel() * t.element_size() for t in model.state_dict().values())
        return (f"{n / 2**30:.3f} GiB of weights, peak {torch.cuda.max_memory_allocated() / 2**30:.3f} "
                f"GiB allocated")

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    # smoke width: each model on the card against the same weights on the CPU
    for kind, cls in MODEL_CLS.items():
        cfg = get_arch(kind).smoke_cfg
        card_m = cls(cfg, device=dev, seed=seed)
        cpu_m = cls(cfg, device="cpu")
        cpu_m.load_state_dict({k: v.cpu() for k, v in card_m.state_dict().items()})
        feats_np, _ = recsys_batch(cfg, 64, np.random.default_rng(seed))
        with torch.inference_mode():
            got = card_m(on_card(feats_np)).cpu()
            want = cpu_m({k: torch.from_numpy(v) for k, v in feats_np.items()})
        tol = FM_TOL if kind == "fm" else FLOAT_TOL
        if not torch.allclose(got, want, **tol) or not bool(torch.isfinite(got).all()):
            fail(f"recsys {kind} smoke width: the card's logits differ from the CPU's "
                 f"by {float((got - want).abs().max())}")
        say(f"[recsys] {kind} smoke width: the card's logits equal the CPU's within "
            f"{tol}, max |diff| {float((got - want).abs().max()):.3g}")

    # FM at full width, its three inference shapes
    cfg = get_arch("fm").cfg
    torch.cuda.reset_peak_memory_stats()
    model = MODEL_CLS["fm"](cfg, device=dev, seed=seed)
    n_f, V, D = model.tables.shape
    fm_batches = [(name, RECSYS_SHAPES[name]["batch"]) for name in ("serve_p99", "serve_bulk")]
    fm_batches.append(("retrieval_cand", RECSYS_SHAPES["retrieval_cand"]["n_cand"]))
    for shape, B in fm_batches:
        t0 = time.perf_counter()
        feats = on_card(recsys_batch(cfg, B, np.random.default_rng(seed))[0])
        t_data = time.perf_counter() - t0
        with torch.inference_mode():
            model.use_kernel = True
            logits = counted_run(lambda: model(feats), 1)
            model.use_kernel = False
            plain = counted_run(lambda: model(feats), 0)
            if logits.shape != (B,) or not bool(torch.isfinite(logits).all()):
                fail(f"fm {shape}: logits of shape {tuple(logits.shape)}, finite "
                     f"{bool(torch.isfinite(logits).all())}")
            if not torch.allclose(logits, plain, **FM_TOL):
                fail(f"fm {shape}: kernel and plain logits differ by "
                     f"{float((logits - plain).abs().max())}")
            if shape == "serve_p99":
                want = fm_host_logits(torch, model, feats["sparse_ids"][:64])
                if not np.allclose(logits[:64].cpu().numpy(), want, **FM_TOL):
                    fail("fm: logits differ from the explicit pair sum in float64")
            t_plain = median_ms(torch, lambda: model(feats), 20)
            model.use_kernel = True
            t_kernel = median_ms(torch, lambda: model(feats), 20)
            events = device_times(traced(torch, lambda: model(feats), 1,
                                         TRACE_TAGS["fm_pairwise"], 1)[0])
            flat = clamp_rows(feats["sparse_ids"], V) + torch.arange(n_f, device=dev) * V
            emb = model.tables.view(n_f * V, D)[flat]
            cases = [(emb, "fp32")] + ([(emb.to(torch.bfloat16), "bf16")]
                                       if shape == "serve_bulk" else [])
            for e, dt in cases:
                c = hold("fm_pairwise", lambda: fm_ops.fm_pairwise(e), lambda: fm_pairwise_ref(e),
                         lambda g, w: torch.allclose(g, w, **FM_TOL),
                         B * n_f * D * e.element_size() + 4 * B, 200,
                         f"{shape} B={B} F={n_f} D={D} {dt}",
                         ops_needed=B * (3 * n_f * D + 3 * D + 1))
                say(f"[kernel] fm_pairwise {c['case']}: device {c['ms']*1e3:.2f} us/launch, "
                    f"call {c['call_ms']*1e3:.2f} us, plain {c['plain_ms']*1e3:.2f} us, "
                    f"bound {c['bound_ms']*1e3:.4f} us ({c['bound_by']}, {c['bytes']} B), "
                    f"max |kernel - plain| {c['max_abs_err']:.3g} on {smi}")
            del flat, emb, cases
        busy = sum(d for d, _, _ in events)
        say(f"[recsys] fm {shape} B={B}: kernel route {t_kernel:.4f} ms/batch "
            f"({t_kernel / B * 1e3:.5f} us/row), plain route {t_plain:.4f} ms/batch "
            f"({t_plain / B * 1e3:.5f} us/row), median of 20 | logits equal within "
            f"{FM_TOL}, max |diff| {float((logits - plain).abs().max()):.3g} | batch "
            f"made in {t_data:.2f} s on the host | one traced forward: device busy "
            f"{busy / 1e3:.4f} ms on {smi}")
        for d, key, count in events[:6]:
            say(f"[recsys]   {d / 1e3:9.4f} ms  {count:4d} x  {key[:90]}")
        del feats, logits, plain
    say(f"[recsys] fm: {memory(model)}")
    del model
    torch.cuda.empty_cache()

    # DIN and BST at serve_p99, MIND's retrieval against the first 1M items
    B = RECSYS_SHAPES["serve_p99"]["batch"]
    for kind in ("din", "bst", "mind"):
        cfg = get_arch(kind).cfg
        torch.cuda.reset_peak_memory_stats()
        model = MODEL_CLS[kind](cfg, device=dev, seed=seed)
        with torch.inference_mode():
            if kind == "mind":
                n_cand = RECSYS_SHAPES["retrieval_cand"]["n_cand"]
                feats = on_card(recsys_batch(cfg, 1, np.random.default_rng(seed))[0])
                cand = model.item_table[:n_cand]
                run = lambda: model.retrieve(feats, cand, k=100)     # noqa: E731
                vals, idx = counted_run(run, 0)
                caps = model.interests(feats["hist_items"], feats["hist_mask"])
                score = torch.einsum("bkd,nd->bkn", caps, cand).amax(1)
                ok = (vals.shape == (1, 100) and idx.dtype == torch.int32
                      and bool(torch.isfinite(vals).all())
                      and bool(((idx >= 0) & (idx < n_cand)).all())
                      and torch.equal(vals, score.sort(-1, descending=True).values[:, :100])
                      and torch.equal(score.gather(1, idx.long()), vals))
                what = f"retrieve 1 user x {n_cand} items, k=100"
            else:
                feats = on_card(recsys_batch(cfg, B, np.random.default_rng(seed))[0])
                run = lambda: model(feats)                           # noqa: E731
                out = counted_run(run, 0)
                ok = out.shape == (B,) and bool(torch.isfinite(out).all())
                what = f"serve_p99 B={B}"
            if not ok or model.device.type != dev.type:
                fail(f"recsys {kind} {what}: unexpected output")
            t = median_ms(torch, run, 20)
        say(f"[recsys] {kind} {what}: {t:.4f} ms per batch (median of 20), finite, on "
            f"{model.device}, no fm_pairwise launch | {memory(model)} on {smi}")
        del model, feats
        torch.cuda.empty_cache()
    say(f"[recsys] phase took {time.perf_counter() - t_phase:.1f} s; launches on the "
        f"counted runs {total}")
    return total


# --------------------------------------------------------------------------
# phase 4: LM serving
# --------------------------------------------------------------------------
def live_pairs(B, Sq, Skv, causal, window, kv_len=None) -> tuple[int, int]:
    """(live (row, col) pairs over the batch, kv rows any row needs) under
    the flash_attention mask rule for each batch row's kv length."""
    rows = np.arange(Sq, dtype=np.int64) + (Skv - Sq)
    pairs = cols = 0
    for klen in (kv_len if kv_len is not None else [Skv] * B):
        hi = np.minimum(rows + 1 if causal else Skv, min(int(klen), Skv))
        lo = np.maximum(rows - window + 1, 0) if window > 0 else np.zeros_like(rows)
        n = np.maximum(hi - lo, 0)
        pairs += int(n.sum())
        cols += int(hi.max() - lo[n > 0].min()) if n.any() else 0
    return pairs, cols


def row_rel_err(torch, got, want) -> float:
    """The largest ||got - want|| / ||want|| over the rows of the last axis;
    a row of zeros in ``want`` scores 0 if ``got``'s row is zeros too, else
    infinity."""
    d = (got.double() - want.double()).norm(dim=-1)
    n = want.double().norm(dim=-1)
    r = torch.where(n > 0, d / n.clamp(min=1e-300),
                    torch.where(d > 0, float("inf"), 0.0))
    return float(r.max())


def lm_phase(torch, dev, seed, smi, hold, reset_counts, read_counts) -> dict:
    """The flash_attention kernel against its plain version at the LM path's
    shapes; gemma2-2b at full width in fp32 through the kernel and the plain
    route, then served in bf16. Returns the launch counts of the main path:
    one bf16 ``prefill_step`` and one bf16 ``decode_step``."""
    import functools

    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.configs.lm_common import LM_SHAPES
    from repro_torch.data import TokenStream
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serve.lm import greedy_generate, make_decode_step, prefill_step

    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed)
    arch = get_arch("gemma2-2b")
    cfg = arch.cfg
    L, H, G, D = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S = LM_SHAPES["prefill_32k"]["seq"]
    max_len = LM_SHAPES["decode_32k"]["seq"]
    B_dec = 16

    # -- the kernel against its plain version at the path's shapes -------------
    def flash_case(case, B, Hq, Gk, Sq, Skv, Dh, dtype, *, window=0, softcap=0.0,
                   kv_len=None, sdpa=None, reps=20, plain_reps=3, trace_reps=50):
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype) for shape in
                   ((B, Hq, Sq, Dh), (B, Gk, Skv, Dh), (B, Gk, Skv, Dh)))
        kl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=dev)
        kw = dict(causal=True, window=window, softcap=softcap)
        name = str(dtype).split(".")[-1]
        tol, row_tol = FLASH_TOL[name], FLASH_ROW_TOL[name]
        pairs, cols = live_pairs(B, Sq, Skv, True, window, kv_len)
        nbytes = (2 * q.numel() + 2 * Gk * cols * Dh) * q.element_size()
        # SDPA computes the same function where there is no window and no
        # softcap: causal ("causal") or, for one query row against a full
        # cache, unmasked ("full")
        library = (functools.partial(F.scaled_dot_product_attention, q, k, v,
                                     is_causal=sdpa == "causal", enable_gqa=True)
                   if sdpa else None)
        row = {}

        def equal(a, b):
            row["err"] = row_rel_err(torch, a, b)
            return (bool(torch.isfinite(a).all()) and row["err"] <= row_tol and
                    torch.allclose(a.float(), b.float(), rtol=tol, atol=tol))

        c = hold("flash_attention", lambda: fa_ops.flash_attention(q, k, v, kl, **kw),
                 lambda: fa_ops.flash_attention(q, k, v, kl, use_kernel=False, **kw),
                 equal, nbytes, reps, f"{case}: q {list(q.shape)} k/v {list(k.shape)} {name}",
                 plain_reps=plain_reps, ops_needed=4 * Dh * Hq * pairs,
                 ops_per_s=FP32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S,
                 trace_reps=trace_reps, library=library)
        # the control: the kernel reading FLASH_DROP columns too few in every row
        short = np.maximum(np.minimum(kv_len if kv_len is not None else Skv, Skv)
                           - FLASH_DROP, 1) + np.zeros(B, dtype=np.int64)
        control = row_rel_err(
            torch, fa_ops.flash_attention(
                q, k, v, torch.tensor(short, dtype=torch.int32, device=dev), **kw),
            fa_ops.flash_attention(q, k, v, kl, use_kernel=False, **kw))
        if not control > row_tol:
            fail(f"flash_attention {c['case']}: a kernel reading {FLASH_DROP} columns too "
                 f"few scores a row error of {control:.3g}, within the check's {row_tol}")
        c.update(row_err=row["err"], row_tol=row_tol, control_row_err=control)
        lib = (f", SDPA {c['library_ms']*1e3:.2f} us" if sdpa else "")
        say(f"[kernel] flash_attention {c['case']}: device {c['ms']*1e3:.2f} us/launch, call "
            f"{c['call_ms']*1e3:.2f} us, plain {c['plain_ms']*1e3:.2f} us{lib}, bound "
            f"{c['bound_ms']*1e3:.2f} us ({c['bound_by']}: {nbytes} B, {4 * Dh * Hq * pairs} "
            f"ops), max |kernel - plain| {c['max_abs_err']:.3g} within rtol=atol={tol}, row "
            f"error {row['err']:.3g} within {row_tol} (a kernel {FLASH_DROP} columns short "
            f"scores {control:.3g}) on {smi}")
        del q, k, v

    bf16 = torch.bfloat16
    rng = np.random.default_rng(seed)
    dec_pos = rng.integers(24_576, 32_700, B_dec)         # the decode rows' positions
    flash_case("gemma2 prefill, global layer", 1, H, G, S, S, D, bf16, softcap=cfg.attn_softcap,
               reps=5, plain_reps=1, trace_reps=5)
    flash_case("gemma2 prefill, local layer", 1, H, G, S, S, D, bf16, window=cfg.window,
               softcap=cfg.attn_softcap, reps=5, plain_reps=1, trace_reps=5)
    flash_case("gemma2 decode, global layer", B_dec, H, G, 1, max_len, D, bf16,
               softcap=cfg.attn_softcap, kv_len=(dec_pos + 1).tolist())
    flash_case("gemma2 decode, local ring", B_dec, H, G, 1, cfg.window, D, bf16,
               softcap=cfg.attn_softcap,
               kv_len=np.minimum(np.r_[dec_pos[:12] + 1, 1, 77, 2048, 4095], cfg.window).tolist())
    flash_case(f"fp32, D={D}", 1, H, G, 2048, 2048, D, torch.float32, softcap=cfg.attn_softcap,
               reps=5, plain_reps=3, trace_reps=10)
    flash_case("ragged Sq = Skv = 1000", 2, H, G, 1000, 1000, D, bf16, window=300,
               softcap=cfg.attn_softcap)
    flash_case("smollm-360m heads", 4, 15, 5, 2048, 2048, 64, bf16, sdpa="causal")
    flash_case("qwen3-14b heads", 1, 40, 8, 4096, 4096, 128, bf16, sdpa="causal")
    flash_case("qwen3-14b decode", B_dec, 40, 8, 1, max_len, 128, bf16, sdpa="full")
    torch.cuda.empty_cache()

    check_run = counter(torch, reset_counts, read_counts, "flash_attention", "lm")
    main = {}
    main_run = counter(torch, reset_counts, read_counts, "flash_attention", "lm", main)
    stream = TokenStream.synthetic(vocab=cfg.vocab, seed=seed)
    if len(stream.tokens) < S + 16 * 18:
        fail(f"the token stream holds {len(stream.tokens)} tokens")
    toks = torch.from_numpy(stream.tokens[:S].copy()).to(dev)[None]

    def fill(cache, pos):
        """Seeded normal x 0.02 in every cache row; the rows at ``pos``."""
        with torch.inference_mode():
            for t in (*cache["k"], *cache["v"]):
                t.normal_(generator=g).mul_(0.02)
            cache["pos"].copy_(torch.tensor(pos, dtype=torch.int32))
        return cache

    def route_of(model, base):
        def use(flash):
            model.cfg = dataclasses.replace(base, use_flash=flash)
        return use

    def gib(n):
        return f"{n / 2**30:.3f} GiB"

    # -- fp32: the kernel route against the plain route at full width ---------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32)
    model = TransformerLM(cfg32, device=dev, seed=seed)
    use = route_of(model, cfg32)
    use(None)
    t0 = time.perf_counter()
    got = check_run(lambda: prefill_step(model, toks), L)
    t_k = time.perf_counter() - t0
    use(False)
    t0 = time.perf_counter()
    want = check_run(lambda: prefill_step(model, toks), 0)
    t_p = time.perf_counter() - t0
    if got.shape != (1, cfg.vocab) or not bool(torch.isfinite(got).all()):
        fail(f"lm fp32 prefill: logits of shape {tuple(got.shape)}")
    if not torch.allclose(got, want, **LM_FP32_TOL):
        fail(f"lm fp32 prefill: kernel and plain route differ by {float((got - want).abs().max())}")
    say(f"[lm] fp32 prefill_step B=1 S={S}: kernel route {t_k:.2f} s, plain route {t_p:.2f} s, "
        f"last-position logits equal within {LM_FP32_TOL}, max |diff| "
        f"{float((got - want).abs().max()):.3g}; {L} launches on the kernel route, 0 on the plain")
    cache = fill(model.init_cache(2, max_len), [32_700, 5_000])
    with torch.inference_mode():
        plain_cache = {"pos": cache["pos"].clone(), "k": tuple(t.clone() for t in cache["k"]),
                       "v": tuple(t.clone() for t in cache["v"])}
    step_toks = torch.from_numpy(stream.tokens[S:S + 8].reshape(4, 2).copy()).to(dev)
    errs = []
    for t in range(4):
        use(None)
        got, cache = check_run(functools.partial(model.decode_step, cache, step_toks[t]), L)
        use(False)
        want, plain_cache = check_run(
            functools.partial(model.decode_step, plain_cache, step_toks[t]), 0)
        if not bool(torch.isfinite(got).all()) or not torch.allclose(got, want, **LM_FP32_TOL):
            fail(f"lm fp32 decode step {t}: kernel and plain route differ by "
                 f"{float((got - want).abs().max())}")
        errs.append(float((got - want).abs().max()))
    say(f"[lm] fp32 decode_step x4 at B=2 from pos [32700, 5000] of a {max_len}-token cache "
        f"(the local ring wrapped, kv_len < the global cache): logits equal within "
        f"{LM_FP32_TOL} at each step, max |diff| {max(errs):.3g}; {L} launches per kernel-route "
        f"step, 0 on the plain")
    del model, cache, plain_cache, got, want
    torch.cuda.empty_cache()

    # -- bf16: serving ----------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    model = TransformerLM(cfg, device=dev, seed=seed)
    use = route_of(model, cfg)
    use(None)
    w_bytes = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    t_pre = median_ms(torch, lambda: prefill_step(model, toks), 3)
    logits = main_run(lambda: prefill_step(model, toks), L)
    if logits.shape != (1, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        fail(f"lm bf16 prefill: logits of shape {tuple(logits.shape)}")
    say(f"[lm] bf16 prefill_step B=1 S={S}: {t_pre:.2f} ms (median of 3), "
        f"{S / t_pre * 1e3:.0f} tokens/s, {L} flash_attention launches, finite logits on {smi}")

    cache = fill(model.init_cache(B_dec, max_len), dec_pos.tolist())
    c_bytes = sum(t.numel() * t.element_size() for t in (*cache["k"], *cache["v"]))
    tok = torch.from_numpy(stream.tokens[S:S + B_dec].copy()).to(dev)
    first = cache
    got, cache = main_run(functools.partial(model.decode_step, first, tok), L)
    use(False)      # the same step from the same cache: it rewrites the same rows
    want, _ = check_run(functools.partial(model.decode_step, first, tok), 0)
    use(None)
    err, mean_err = float((got - want).abs().max()), float((got - want).abs().mean())
    if not bool(torch.isfinite(got).all()) or not torch.allclose(got, want, **LM_BF16_TOL):
        fail(f"lm bf16 decode: kernel and plain route differ by {err}")
    step = make_decode_step(model)
    nxt = got.argmax(-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(32):
        logits, cache = step(cache, nxt)
        nxt = logits.argmax(-1)
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) / 32 * 1e3
    say(f"[lm] bf16 decode_step B={B_dec} against a {max_len}-token cache (rows at pos "
        f"{int(dec_pos.min())}..{int(dec_pos.max())}): {t_dec:.2f} ms/step over 32 steps, "
        f"{B_dec / t_dec * 1e3:.0f} tokens/s; one step equals the plain route's within "
        f"{LM_BF16_TOL}, max |diff| {err:.3g}, mean {mean_err:.3g}; {L} launches per step "
        f"on {smi}")

    from torch.profiler import ProfilerActivity, profile

    for what, fn, wall in (("prefill_step", lambda: prefill_step(model, toks), t_pre),
                           ("decode_step", lambda: step(cache, nxt), t_dec)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = device_times(prof)
        busy = sum(d for d, _, _ in events) / 1e3
        share = f"{busy / wall:.4f}" if busy else "not measured"
        att = [(d, c) for d, key, c in events if TRACE_TAGS["flash_attention"] in key]
        att_ms = sum(d for d, _ in att) / 1e3
        say(f"[trace] lm {what}: device busy {busy:.2f} ms of {wall:.2f} ms untraced wall, "
            f"busy share {share}; flash_attention {att_ms:.2f} ms in "
            f"{sum(c for _, c in att)} launches on {smi}")
        for d, key, count in events[:6]:
            say(f"[trace]   {d / 1e3:9.3f} ms  {count:5d} x  {key[:90]}")
    del cache, first
    torch.cuda.empty_cache()

    # greedy generation: the plain route's tokens up to each row's first step
    # whose top-2 gap is within 2 x atol (where each logit may move by atol)
    prompt = torch.from_numpy(stream.tokens[S + B_dec:S + B_dec + 256].reshape(16, 16).copy()).to(dev)
    gen = check_run(lambda: greedy_generate(model, prompt, 16, 32), L * 31)
    use(False)
    with torch.inference_mode():
        pc = model.init_cache(16, 32)
        for t in range(16):
            lg, pc = model.decode_step(pc, prompt[:, t])
        plain_toks, gaps = [], []
        for i in range(16):
            if not bool(torch.isfinite(lg).all()):
                fail("lm greedy: the plain route's logits are not finite")
            top2 = lg.topk(2, dim=-1).values
            plain_toks.append(lg.argmax(-1))
            gaps.append(top2[:, 0] - top2[:, 1])
            if i < 15:
                lg, pc = model.decode_step(pc, plain_toks[-1])
    use(None)
    plain_toks, gaps = torch.stack(plain_toks, 1), torch.stack(gaps, 1)
    if gen.shape != (16, 16) or not bool(((gen >= 0) & (gen < cfg.vocab)).all()):
        fail(f"lm greedy: tokens of shape {tuple(gen.shape)} outside the vocabulary")
    near, same = 0, 0
    for r in range(16):
        diff = torch.nonzero(gen[r] != plain_toks[r])
        if diff.numel() == 0:
            same += 1
            continue
        i = int(diff[0])
        if float(gaps[r, i]) > 2 * LM_BF16_TOL["atol"]:
            fail(f"lm greedy: row {r} step {i} takes {int(gen[r, i])}, the plain route "
                 f"{int(plain_toks[r, i])} with a top-2 gap of {float(gaps[r, i]):.3g}")
        near += 1
    say(f"[lm] bf16 greedy_generate B=16, 16-token prompt, 16 new: {same} rows equal the plain "
        f"route's tokens, {near} part at a top-2 gap within {2 * LM_BF16_TOL['atol']}; "
        f"{L * 31} launches")
    say(f"[lm] gemma2-2b bf16: {gib(w_bytes)} of weights, {gib(c_bytes)} of cache at "
        f"B={B_dec} x {max_len}, peak {gib(torch.cuda.max_memory_allocated())} allocated; "
        f"main-path launches {main}")

    # -- the floor of one bf16 decode step, and a control ----------------------
    # One step at B=4 from one cache: both routes in bf16; the plain and the
    # kernel route in fp32 on the same weights and cache values; and, as the
    # control, each dtype's kernel route with every attention reading
    # FLASH_DROP cache columns too few. Each step rewrites the same cache row
    # before reading it, so all start from the same state.
    def step_of(m, use_m, wc, flash, short=False):
        orig = fa_ops.flash_decode
        if short:
            fa_ops.flash_decode = lambda q, k, v, kv_len, **kw: orig(
                q, k, v, torch.clamp(kv_len - FLASH_DROP, min=1), **kw)
        use_m(flash)
        try:
            return m.decode_step(wc, tok[:4])[0]
        finally:
            fa_ops.flash_decode = orig
            use_m(None)

    wc = fill(model.init_cache(4, max_len), dec_pos[:4].tolist())
    k_b, p_b = step_of(model, use, wc, None), step_of(model, use, wc, False)
    f_b = step_of(model, use, wc, None, short=True)
    with torch.inference_mode():
        wc = {"pos": wc["pos"], "k": tuple(t.float() for t in wc["k"]),
              "v": tuple(t.float() for t in wc["v"])}
    model32 = TransformerLM(cfg32, device=dev, seed=seed)
    model32.load_state_dict({n: t.float() for n, t in model.state_dict().items()})
    use32 = route_of(model32, cfg32)
    p_32, k_32 = step_of(model32, use32, wc, False), step_of(model32, use32, wc, None)
    f_32 = step_of(model32, use32, wc, None, short=True)
    del wc, model32

    def gap(a, b):
        return float((a - b).abs().max())

    w = dict(kernel_plain=gap(k_b, p_b), floor=gap(p_b, p_32), kernel_fp32=gap(k_b, p_32),
             fp32_routes=gap(k_32, p_32), control_bf16=gap(f_b, k_b),
             control_fp32=gap(f_32, k_32))
    if not all(bool(torch.isfinite(t).all()) for t in (k_b, p_b, p_32, k_32)):
        fail("lm bf16 floor: logits not finite")
    # the kernel route in bf16 is no further from the fp32 logits than the
    # plain route in bf16 is, but for a margin
    if not (torch.allclose(k_b, p_b, **LM_BF16_TOL) and torch.allclose(k_32, p_32, **LM_FP32_TOL)
            and w["kernel_fp32"] <= 1.5 * w["floor"]):
        fail(f"lm bf16 floor: the kernel route is off: {w}")
    if torch.allclose(f_b, k_b, **LM_BF16_TOL) or torch.allclose(f_32, k_32, **LM_FP32_TOL):
        fail(f"lm bf16 floor: the route checks pass a kernel {FLASH_DROP} columns short: {w}")
    say(f"[lm] bf16 decode_step B=4 floor, max |diff| over 4 x {cfg.vocab} logits: kernel vs "
        f"plain route in bf16 {w['kernel_plain']:.3g}; plain route bf16 vs fp32 (the floor) "
        f"{w['floor']:.3g}; kernel route bf16 vs plain fp32 {w['kernel_fp32']:.3g}; kernel vs "
        f"plain in fp32 {w['fp32_routes']:.3g}. Control, the kernel route {FLASH_DROP} cache "
        f"columns short in every layer vs whole: bf16 {w['control_bf16']:.3g}, fp32 "
        f"{w['control_fp32']:.3g}; phase took {time.perf_counter() - t_phase:.1f} s on {smi}")
    del model
    torch.cuda.empty_cache()
    return main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--queries", type=int, default=13_500_000,
                    help="log size; ~10M completions survive the dedup")
    ap.add_argument("--vocab", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import importlib

    from repro_torch import backend
    from repro_torch.core import build_qac_index, parse_queries
    from repro_torch.core.codecs import pack_postings, unpack_postings
    from repro_torch.kernels.heap_topk.ref import heap_topk_ref
    from repro_torch.kernels.intersect.ref import (conjunctive_scan_packed_ref,
                                                   conjunctive_scan_ref)
    from repro_torch.kernels.rmq.ref import rmq_window_batch
    from repro_torch.serve import QACFrontend

    ops = {name: importlib.import_module(v[0]) for name, v in KERNELS.items()}

    def reset_counts():
        for name, m in ops.items():
            setattr(m, KERNELS[name][1], 0)

    def read_counts():
        return {name: getattr(m, KERNELS[name][1]) for name, m in ops.items()}

    dev = torch.device(DEVICE)

    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(phase):
        now = time.perf_counter()
        say(f"[time] phase {phase}: {now - t_lap[0]:.1f} s ({now - t_start:.1f} s in all)")
        t_lap[0] = now

    # ---- 1. card and versions ---------------------------------------------
    smi = nvidia_smi()
    card = torch.cuda.get_device_name(0)
    nvcc = subprocess.run([backend.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    say(f"[card] {card} x{torch.cuda.device_count()} | nvidia-smi: {smi}")
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} | nvcc {nvcc}")

    lap(1)

    # ---- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    reports = backend.build_kernels()
    say(f"[build] {len(reports)} kernel libraries built in "
        f"{time.perf_counter() - t0:.1f} s ({', '.join(sorted(reports)) or 'cached'})")
    for name, log in sorted(reports.items()):
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:   # the ptxas -v report, per instantiation
                entry = line.split("'")[1]
                if name == "flash_attention":
                    say(f"[build] {name}: {demangle(entry)}")
            elif "Used" in line or "spill" in line or any(
                    w in line for w in ("C7508", "C7512", "C7520")):   # setmaxnreg, wgmma serialised
                say(f"[build] {name}: {line.strip()}")
                if "spill" in line and " 0 bytes spill stores" not in line and "_tc_kernel" in entry:
                    fail(f"ptxas spills in {demangle(entry)}: {line.strip()}")

    lap(2)

    results = {}     # each kernel's cases held against its plain version

    def hold(name, run_kernel, run_plain, equal, bytes_needed, reps, case,
             codec=None, plain_reps=None, ops_needed=0, ops_per_s=FP32_OPS_PER_S,
             trace_reps=200, library=None):
        """Check the kernel against its plain version; time both, and the one
        PyTorch call ``library`` that computes the same function where there
        is one. Returns the case's record: device ms per launch (over a trace
        of ``trace_reps`` calls), ms per wrapper call, plain ms, library ms,
        the bound (the larger of bytes over the memory rate and operations
        over ``ops_per_s``) and the largest absolute difference of a float
        output from the plain version's (0 for the exact ones)."""
        got, want = run_kernel(), run_plain()
        torch.cuda.synchronize()
        if not equal(got, want):
            fail(f"{name} {case}: kernel disagrees with its plain version")
        err = (float((got.double() - want.double()).abs().max()) if
               isinstance(got, torch.Tensor) and got.is_floating_point() and got.numel()
               else 0.0)
        tag = TRACE_TAGS[name if codec is None else (name, codec)]
        t_bytes, t_ops = bytes_needed / HBM_BYTES_PER_S, ops_needed / ops_per_s
        ms, held = kernel_device_ms(torch, run_kernel, tag, trace_reps)
        c = {"case": case, **({"codec": codec} if codec else {}),
             "ms": ms, "traced_launches": held,
             "call_ms": cuda_ms(torch, run_kernel, reps),
             "plain_ms": cuda_ms(torch, run_plain, plain_reps or max(3, reps // 20)),
             "library_ms": cuda_ms(torch, library, reps) if library else None,
             "bound_ms": max(t_bytes, t_ops) * 1e3,
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "bytes": bytes_needed, "max_abs_err": err}
        results.setdefault(name, []).append(c)
        return c

    def timing(c):
        return (f"device {c['ms']*1e3:.2f} us/launch, call {c['call_ms']*1e3:.2f} us, "
                f"plain {c['plain_ms']*1e3:.2f} us, bound {c['bound_ms']*1e3:.4f} us")

    # ---- 3. recsys serving --------------------------------------------------
    counted = {"recsys": recsys_phase(torch, dev, args.seed, smi, hold, reset_counts,
                                      read_counts)}
    lap(3)

    # ---- 4. LM serving ------------------------------------------------------
    counted["lm"] = lm_phase(torch, dev, args.seed, smi, hold, reset_counts, read_counts)
    lap(4)

    # ---- 5. full-width index ------------------------------------------------
    t0 = time.perf_counter()
    queries, scores = make_log(args.queries, args.vocab, args.seed)
    t_log = time.perf_counter() - t0
    t0 = time.perf_counter()
    qidx, kept, _ = build_qac_index(queries, scores, k_default=10,
                                    postings_codec="ef", device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    del queries, scores
    idx, comps, rm = qidx.index, qidx.completions, qidx.rmq_minimal
    offs_h = idx.offsets.cpu().numpy()
    post_h = idx.postings.cpu().numpy()
    t0 = time.perf_counter()
    pk_bp = pack_postings(post_h, "bitpack", device=dev)
    t_pack = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not np.array_equal(unpack_postings(pk_bp), post_h):
        fail("bitpack postings do not round-trip")
    t_unpack = time.perf_counter() - t0
    packs = {"ef": idx.packed, "bitpack": pk_bp}
    qidx_bp = dataclasses.replace(qidx, index=dataclasses.replace(idx, packed=pk_bp))
    dev_bytes = sum(t.numel() * t.element_size() for part in
                    (qidx.dictionary, comps, idx, qidx.rmq_docids, rm)
                    for t in vars(part).values() if isinstance(t, torch.Tensor))
    say(f"[index] {comps.n} completions, {idx.n_terms} terms, {idx.n_postings} "
        f"postings, longest list {int(np.diff(offs_h).max())}, "
        f"{dev_bytes / 2**20:.1f} MiB on the card | log {t_log:.1f} s, "
        f"host build {t_build:.1f} s (queries={args.queries}, vocab={args.vocab})")
    say(f"[index] the host build includes packing the postings as ef and its "
        f"round-trip check; bitpack packing of the same lists {t_pack:.1f} s, "
        f"its round trip {t_unpack:.1f} s")
    for codec, pk in packs.items():
        ef_blocks = int(((pk.meta >> 6) & 1).sum())
        say(f"[index] {codec} postings on the card: {pk.words.numel() * 4 / 2**20:.1f} MiB "
            f"of words + {pk.base.numel() * 12 / 2**20:.1f} MiB of block directory "
            f"= {pk.nbytes() / 2**20:.1f} MiB, {pk.bits_per_int():.2f} bits per posting "
            f"({ef_blocks} of {pk.base.numel()} blocks EF), beside the raw postings' "
            f"{idx.n_postings * 4 / 2**20:.1f} MiB (32 bits per posting) of the "
            f"{dev_bytes / 2**20:.1f} MiB raw index")
    if args.queries != 13_500_000 or args.vocab != 1_000_000:
        say(f"[index] CUT: {args.queries} queries, {args.vocab} vocabulary "
            "(counts only; widths unchanged)")

    # the main path's batch, sampled as launch/serve.py samples it
    rng = np.random.default_rng(0)
    partials = []
    for qi in rng.integers(0, len(kept), args.batch):
        toks = kept[qi].split()
        cut = rng.integers(1, len(toks[-1]) + 1)
        partials.append(" ".join(toks[:-1] + [toks[-1][:cut]]))
    pids, plen, _, suf, slen = parse_queries(qidx.dictionary, partials)
    tl, th = qidx.dictionary.locate_prefix(suf, slen)

    lap(5)

    # ---- 6. QAC kernels against their plain versions -----------------------
    # rmq_query: 512 ranges of the minimal array, inverted and empty included
    n = rm.n
    p = torch.tensor(rng.integers(0, n, 512), dtype=torch.int32, device=dev)
    q = p + torch.tensor(rng.integers(0, 4 * 128, 512), dtype=torch.int32, device=dev)
    q[:128] = torch.tensor(rng.integers(0, n, 128), dtype=torch.int32, device=dev)
    q[128:160] = p[128:160] - 1                             # empty: p = q + 1
    p[160:192] = torch.tensor(rng.integers(n - 300, n, 32), dtype=torch.int32, device=dev)
    q[160:192] = p[160:192] + 1000                          # ragged end
    p, q = p.clamp(0, n - 1), q.clamp(0, n - 1)             # as query_batch clamps

    def rmq_equal(got, want):
        live = want[1] < INF
        return torch.equal(got[1], want[1]) and torch.equal(got[0][live], want[0][live])

    b_rmq = rmq_bytes(torch, n, p, q)
    c = hold("rmq_query",
             lambda: ops["rmq_query"].rmq_query(rm.values, rm.ib, rm.st_pos, p, q, n=n),
             lambda: rmq_window_batch(rm.values, rm.ib, rm.st_pos, p, q, n=n),
             rmq_equal, b_rmq, 2000, "B=512")
    say(f"[kernel] rmq_query B=512: {timing(c)} ({b_rmq} B) | equal")

    # heap_topk: B=256 term ranges of the batch's suffixes (empty ones included)
    hl, hh = tl.clone(), th.clone()
    hh[:16] = hl[:16]                                       # empty ranges
    lo8, hi8 = hl[16:24].clone(), hh[16:24].clone()
    hl[16:24], hh[16:24] = hi8 + 3, lo8                     # inverted ranges
    targs = (rm.values, rm.st_pos, rm.ib, idx.offsets, idx.postings, hl, hh)
    heap_cases = ((10, 12), (10, 20), (64, 66), (64, 128))
    heap_equal = lambda g, w: torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
    heap_out = {}
    for k, trips in heap_cases:
        kw = dict(k=k, trips=trips, n=n, n_terms=idx.n_terms)
        heap_out[k, trips] = out = heap_topk_ref(*targs, **kw)[0]
        b_heap = heap_bytes(torch, hl, hh, out, k, idx.offsets, idx.minimal,
                            idx.postings)
        case = f"B={hl.numel()} k={k} trips={trips}"
        c = hold("heap_topk", lambda: ops["heap_topk"].heap_topk(*targs, **kw),
                 lambda: heap_topk_ref(*targs, **kw), heap_equal, b_heap, 200, case,
                 plain_reps=3)
        say(f"[kernel] heap_topk {case}: {timing(c)} ({b_heap} B) | equal")
    # the packed kernel on the same ranges, for both codecs; its plain version
    # decodes with many small PyTorch ops per read, so it runs a few times only
    for codec, pk in packs.items():
        pargs = (rm.values, rm.st_pos, rm.ib, idx.offsets, pk, hl, hh)
        for k, trips in heap_cases:
            kw = dict(k=k, trips=trips, n=n, n_terms=idx.n_terms)
            b_heap = heap_bytes(torch, hl, hh, heap_out[k, trips], k, idx.offsets,
                                idx.minimal, idx.postings, pk)
            case = f"B={hl.numel()} k={k} trips={trips}"
            c = hold("heap_topk_packed",
                     lambda: ops["heap_topk_packed"].heap_topk_packed(*pargs, **kw),
                     lambda: heap_topk_ref(*targs, **kw, packed=pk), heap_equal,
                     b_heap, 200, case, codec, plain_reps=3)
            say(f"[kernel] heap_topk_packed[{codec}] {case}: {timing(c)} "
                f"({b_heap} B) | equal")

    # conjunctive_scan: the first real tile of 64 multi-term queries
    multi = torch.nonzero(plen > 0)[:64, 0]
    if multi.numel() < 64:
        fail(f"only {multi.numel()} multi-term queries in the batch")
    mp, ml = pids[multi], plen[multi]
    starts, ends = idx.list_bounds(mp)
    valid = torch.arange(mp.shape[1], device=dev)[None, :] < ml[:, None]
    lens = torch.where(valid, ends - starts, INF)
    rows64 = torch.arange(64, device=dev)
    driver = torch.argmin(lens, dim=1)
    need = valid & (torch.arange(mp.shape[1], device=dev)[None, :] != driver[:, None])
    ks, ke = torch.where(need, starts, 0), torch.where(need, ends, 0)
    ds, de = starts[rows64, driver], ends[rows64, driver]
    lane = torch.arange(128, device=dev)
    in_list = (ds[:, None] + lane[None, :]) < de[:, None]
    cands = torch.where(in_list, idx.postings[(ds[:, None] + lane).clamp(max=idx.n_postings - 1)], INF)
    longest = int(torch.where(valid, ends - starts, 0).max())
    iters = (1 << max(1, (max(longest, 1) - 1).bit_length())).bit_length()  # as the frontend
    sargs = (cands, ks, ke, idx.postings, comps.fwd_terms, tl[multi], th[multi])
    live = cands < INF
    fwd_rows = comps.fwd_terms[cands.clamp(0, comps.n - 1)]
    fwd_ok = live & ((fwd_rows >= tl[multi][:, None, None])
                     & (fwd_rows < th[multi][:, None, None])).any(2)
    b_scan = (cands.numel() * 5 + ks.numel() * 8 + 64 * 8 + 32 * int(live.sum())
              + 4 * int((fwd_ok[:, :, None] & (ke > ks)[:, None, :]).sum()))
    case = f"B=64 T=128 P={mp.shape[1]} iters={iters}"
    c = hold("conjunctive_scan",
             lambda: ops["conjunctive_scan"].conjunctive_scan(*sargs, iters=iters),
             lambda: conjunctive_scan_ref(*sargs, iters=iters),
             torch.equal, b_scan, 2000, case)
    say(f"[kernel] conjunctive_scan {case}: {timing(c)} ({b_scan} B) | equal")
    probed = fwd_ok[:, :, None] & (ke > ks)[:, None, :]            # [64, T, P]
    at = probe_positions(torch, idx.postings, cands, ks, ke, iters)
    for codec, pk in packs.items():
        pargs = (cands, ks, ke, pk, comps.fwd_terms, tl[multi], th[multi])
        b_scan = (cands.numel() * 5 + ks.numel() * 8 + 64 * 8 + 32 * int(live.sum())
                  + int((probed * packed_read_bytes(torch, pk, at)).sum()))
        c = hold("conjunctive_scan_packed",
                 lambda: ops["conjunctive_scan_packed"].conjunctive_scan_packed(
                     *pargs, iters=iters),
                 lambda: conjunctive_scan_packed_ref(*pargs, iters=iters),
                 torch.equal, b_scan, 2000, case, codec, plain_reps=3)
        say(f"[kernel] conjunctive_scan_packed[{codec}] {case}: {timing(c)} "
            f"({b_scan} B) | equal")

    lap(6)

    # ---- 7. the QAC path ----------------------------------------------------
    # the per-request-k batch: the first 64 queries, each with its own k. The
    # plain route serves only the first PLAIN_QUERIES of the main batch; the
    # per-k answers are held against the kernel route's main answers by
    # prefix (top-k is prefix-stable) and in full against the brute force
    kmix = np.random.default_rng(1).choice([10, 10, 10, 3, 128], 64)
    kinputs = tuple(x[:64] for x in (pids, plen, suf, slen))
    fes = {"kernels": QACFrontend(qidx), "per_pop_rmq": QACFrontend(qidx, heap_kernel=False),
           "plain": QACFrontend(qidx, use_kernel=False, max_tiles=PLAIN_TILES),
           "kernels_capped": QACFrontend(qidx, max_tiles=PLAIN_TILES),
           "ef": QACFrontend(qidx, postings_codec="ef"),
           "bitpack": QACFrontend(qidx_bp, postings_codec="bitpack")}
    inputs = (pids, plen, suf, slen)
    # the plain route's multi-term tile loop runs to its cap at ~23-32 ms a
    # tile, so it serves the first PLAIN_QUERIES of the batch with the cap at
    # PLAIN_TILES, held against the kernel route at the same cap: the same
    # function, which the full-cap kernel routes and the brute force hold
    capped = ("plain", "kernels_capped")
    served = {route: args.batch for route in fes} | dict.fromkeys(
        capped, min(PLAIN_QUERIES, args.batch))
    answers, per_k, per_query_us = {}, {}, {}
    # phase 5 loaded every kernel and warmed PyTorch's own ones, so each
    # route's first call is timed as it comes. Each route's main-batch run is
    # counted on its own: the counts go to 0 just before it, are read just
    # after, and the per-request-k batch that follows is not counted
    for route, fe in fes.items():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers[route] = fe.complete(*(x[:served[route]] for x in inputs))
        per_query_us[route] = (time.perf_counter() - t0) / served[route] * 1e6
        counted[route] = read_counts()
        t_k = ""
        if route not in capped:
            t0 = time.perf_counter()
            per_k[route] = fe.complete(*kinputs, k=kmix)
            t_k = f" | per-request-k batch of 64: {time.perf_counter() - t0:.2f} s"
        say(f"[path] {route}: single={fe.describe_route('single')} "
            f"multi={fe.describe_route('multi')} | {per_query_us[route]:.1f} us/query "
            f"at B={served[route]} on {smi}{t_k} | stats {fe.stats} | launches on the "
            f"main batch {counted[route]}")
    # the capped kernel route serves the batch's first PLAIN_QUERIES only, and
    # launches heap_topk only if they hold a single-term query
    want_kernels = dict(ROUTE_KERNELS)
    if not fes["kernels_capped"].stats["single_queries"]:
        want_kernels["kernels_capped"] = ("conjunctive_scan",)
    for route, counts in counted.items():
        for name, c in counts.items():
            if bool(c) != (name in want_kernels[route]):
                fail(f"route {route} launched {name} {c} times: it launches exactly "
                     f"{want_kernels[route]} ({counts})")
    a, a_k = answers["kernels"], per_k["kernels"]
    if a.shape != (args.batch, 10) or a.dtype != np.int32 or a_k.shape != (64, int(kmix.max())):
        fail(f"unexpected answer shapes {a.shape} {a.dtype} {a_k.shape}")
    if not np.array_equal(answers["plain"], answers["kernels_capped"]):
        fail(f"the plain route disagrees with the kernel route at max_tiles={PLAIN_TILES} "
             f"on the first {served['plain']} queries")
    for route in ("per_pop_rmq", "ef", "bitpack"):
        if not np.array_equal(answers[route], a):
            fail(f"route {route} disagrees with the raw kernel route")
    for route in ("per_pop_rmq", "ef", "bitpack"):
        if not np.array_equal(per_k[route], a_k):
            fail(f"per-request-k answers of route {route} differ from the kernel route's")
    for i, ki in enumerate(kmix):
        w = min(int(ki), 10)
        if not np.array_equal(a_k[i, :w], a[i, :w]) or (a_k[i, ki:] != INF).any():
            fail(f"per-request-k row {i} (k={ki}) is not a prefix-stable top-k")
    if not ((a >= 0) & ((a < comps.n) | (a == INF))).all():
        fail("answers hold docids outside the index")
    host = (offs_h, idx.postings.cpu().numpy(), comps.fwd_terms.cpu().numpy())
    pids_h, plen_h = pids.cpu().numpy(), plen.cpu().numpy()
    tl_h, th_h = tl.cpu().numpy(), th.cpu().numpy()
    cap = fes["kernels"].max_tiles * fes["kernels"].tile
    checks = [(i, 10, a[i]) for i in range(64, args.batch, 4)]
    checks += [(i, int(ki), a_k[i, :ki]) for i, ki in enumerate(kmix)]
    for i, ki, got in checks:
        want = brute_force(host, int(plen_h[i]), pids_h[i], int(tl_h[i]), int(th_h[i]), ki, cap)
        if not np.array_equal(got, want):
            fail(f"query {partials[i]!r} k={ki}: {got} != brute force {want}")
    say(f"[path] {len(fes) - 2} kernel routes bit-identical on {args.batch} queries; the "
        f"plain route bit-identical to the kernel route at max_tiles={PLAIN_TILES} on the "
        f"first {served['plain']} of them; a per-request-k batch "
        f"of 64 (k up to {int(kmix.max())}) equal on the four kernel routes and "
        f"prefix-equal to the kernel route's main answers; {len(checks)} answers equal "
        f"a brute-force host search")

    # where the time goes: one traced call of the same batch per route
    from torch.profiler import ProfilerActivity, profile

    for route in ("kernels", "ef"):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fes[route].complete(*inputs)
        events = device_times(prof)
        busy_us = sum(d for d, _, _ in events)
        wall_us = per_query_us[route] * args.batch
        share = f"{busy_us / wall_us:.4f}" if busy_us else "not measured"
        say(f"[trace] {route} route B={args.batch}: device busy {busy_us / 1e3:.2f} ms "
            f"of {wall_us / 1e3:.2f} ms untraced wall, busy share {share} on {smi}")
        for d, key, count in events[:6]:
            say(f"[trace]   {d / 1e3:9.2f} ms  {count:7d} x  {key[:90]}")

    lap(7)

    # ---- 8. kernels line ----------------------------------------------------
    launches = {name: sum(counted[r][name] for r in v[4]) for name, v in KERNELS.items()}
    say(f"[launches] on the main paths, each kernel from its routes' runs: {launches}")
    line = []
    for name, (_, _, src, replaces, routes) in KERNELS.items():
        first = {key: v for key, v in results[name][0].items() if key != "case"}
        line.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": launches[name],
                     "launches_by_route": {r: counted[r][name] for r in routes},
                     **first, "max_abs_err": max(c["max_abs_err"] for c in results[name]),
                     "equal": True, "cases": results[name]})
    say(json.dumps({"kernels": line, "card": card, "power": smi}))
    say(nvidia_smi())
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
