#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's recsys, LM, MoE, GNN and QAC paths on one NVIDIA card.

    python3 chip_smoke.py [--queries N] [--vocab V] [--batch B] [--seed S]
                          [--train | --moe | --gnn | --shard | --probe]

Phases, each printing its lines before the next starts:
  1. the card, its power limit and the software versions;
  2. the build of every CUDA kernel from ``src/repro_torch/csrc``, one
     ``nvcc`` per source, all at once, with the ``ptxas -v`` report
     (registers, spills) of every flash_attention, flash_attention_bwd,
     heap_topk, intersect and fm_pairwise instantiation (a spill in a bf16
     flash_attention or flash_attention_bwd one, ``*_tc_kernel``, fails);
  3. the recsys path at the full widths of the repo's configs: each model at
     smoke width on the card against the CPU; FM (39 fields x 1M rows x 10)
     at B = 512, 262,144 and 1,048,576 through its kernel route (one
     fm_forward launch a forward: ids in, logits out), the gather +
     fm_pairwise composition and the plain route (logits within rtol 1e-5,
     atol 1e-6; no launch on the plain one), the median ms per batch of
     each, one traced forward of the first two (device ops, busy time) and
     the bytes each allocates; fm_forward held against its plain version at
     each shape, on bf16 copies of the weights at 262,144 and on uniform ids
     at 1,048,576, with a control (the plain version a field short) that
     the check must reject, and its bound from the distinct rows the ids
     touch; fm_pairwise held against its own at each shape (and in bf16 at
     262,144); DIN and BST at B=512 and MIND's retrieval of one user against
     1,048,576 items (k=100), finite and launching no kernel; peak device
     memory per model;
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
     once more as "bitpack", each round-tripped, and their sizes; the host
     build's time;
  6. each QAC kernel against its plain PyTorch version on the card at the
     main path's shapes (bit-identical), the packed kernels for both codecs;
     the kernel's device time per launch from ``torch.profiler``, and
     CUDA-event times per call of the wrapper (host-inclusive) and of the
     plain version (the one checked call, host-timed, for the plain
     heap_topk, packed scans and top-k, which take up to seconds each;
     3 calls for the raw scan). heap_topk at its four (k, trips)
     cases on every codec, with the most trips any lane ran (the plain
     version counts them) and the kernel's us per trip; the single-term
     routes side by side (the engine through heap_topk and through the
     per-pop RMQ kernel, raw and "ef", on the batch's first B term ranges,
     B = 1, 8, 64, 256, k=10, trips=12; the per-pop route over 4 calls,
     the heap_topk route over 20), device us and wrapper us per call
     each. The per-tile conjunctive_scan kernels
     at B=64 T=128; the one-launch conjunctive_topk kernels on the batch's
     multi-term queries (k=10, tile=128) at the full cap (4,096 tiles) and
     at PLAIN_TILES held against topk_walk, a chunked torch version, and at
     PACKED_PLAIN_TILES against their plain tile loop (and topk_walk there
     too; phase 7 holds the raw loop at PLAIN_TILES), with the longest
     lane's candidate count beside each bound; and the chunk-cutting cases
     (a cap of 16 candidates at k = 1, 10, 128, a dead lane and an empty
     needed span) on every codec;
  7. the QAC path: parse_queries -> QACFrontend.complete on 256 sampled
     partial queries through the kernel route, the per-pop RMQ route and the
     compressed-postings routes (``postings_codec="ef"`` and ``"bitpack"``),
     all bit-identical, and the plain-PyTorch route on the first 32 of them
     with its multi-term tile loop capped at 256 tiles, bit-identical to the
     kernel route at the same cap on the same 32 queries, plus a per-request-k
     batch on every route but those two, the answers also checked
     against a brute-force host search; each route's kernel launch counts on
     the main batch, counted from 0 just before its call and read just
     after: heap_topk (or rmq_query) and one conjunctive_topk launch per
     multi-term dispatch; ``qac_serve_step`` (the fused step, both classes on
     their kernels) bit-identical to the kernel route; then one traced call
     of the kernel route and of the "ef" route (``torch.profiler``, CUDA
     activity) for the device's busy share and the kernels that take its
     time;
 7b. the docid-striped index: phase 5's rows in 4 docid stripes ("ef"
     packed, ``build_striped``), its host build's time and the bytes each
     stripe holds on the card; the main batch through ``qac_serve_striped``
     (a loop over the stripes on the card) on the raw and the "ef" route,
     launching heap_topk and conjunctive_topk (or their packed forms) once a
     stripe, as predicted, bit-identical to phase 7's kernel route on every
     lane that route did not cut at its cap (a cut lane holds its answer as
     a prefix), with µs per query and a traced call's busy share; the
     strided conjunctive_topk (``fwd_stride`` 4) on stripe 0 held against its
     plain version, at the path's cap against ``topk_walk`` with the stride
     and at PACKED_PLAIN_TILES against the plain tile loop, raw and "ef";
  8. the online runtime and the serving cluster on that index: a keystroke
     trace of 256 sessions typing 2 queries each (a keystroke per 150 ms a
     session, ~18,000 requests over ~26 s) prepared at k=10; ``QACOnlineRuntime`` at
     ``QACArch().runtime_config()`` over ``QACArch().frontend`` (the
     arch's routes, ``specialize_list_pad=False``) with a ``JitAuditor``, in the
     measured-replay protocol (warm-up sweep, a full pass, reset, freeze,
     the measured pass): per-request p50, p95, p99 and p99.9 ms, path
     counts, batches, triggers, deadline violations, queue peak, engine
     wall against the trace's span, p99.9 against 50 ms (a report), no
     callable minted after the freeze, and heap_topk and conjunctive_topk
     launches equal to what the dispatch log predicts (no rmq_query); a
     4-replica cluster (``cluster_config()``) on the trace's first quarter
     (a quarter of the sessions bulk) sharing one frontend, replica 0
     killed at that quarter's midpoint
     and back after 2 heartbeat timeouts: per-class p50, p99 and p99.9,
     rejections by reason, re-routed and degraded counts, the share served
     during the outage; every runtime row and every served cluster row
     bit-identical to the uncached frontend at its served k;
  9. the live index (``GenerationalQAC``: a delta tier merged exactly over
     each generation, rebuild-and-swap): (a) a parity drill at small depth,
     a 20,000-query log, ``FreshnessConfig(k=10, delta_capacity=256,
     swap_threshold=32)``, a mutation trace of 32 sessions x 1 query and
     100 mutations: every answer equal to a from-scratch build of its
     visible version on the card, at least 2 swaps, delta hits, one cache
     invalidation per swap, traffic in the first and last generation, and
     the same trace through the plain route giving equal answers; (b) the
     live index serving phase 5's build as generation 0 (no second
     build) at ``QACArch().freshness_config()``
     (capacity 4,096, threshold 1,024) and ``runtime_config()``, a mutation
     trace over its completions with phase 8's sessions and keystroke shape and 1,200
     mutations, one ``run_mutation_trace`` (no warm pass): exactly one
     swap, per-request p50-p99.9 against phase 8's, apply p50 and p99, the
     rebuild wall with its build, "ef" packing, frontend and warm-up parts,
     the swap stall with its drain, absorb, view and install parts, delta
     hits, escalations, truncated-scan fallbacks, traffic per generation,
     the host view's build time, heap_topk and conjunctive_topk launches
     equal to what the dispatch logs of every generation predict (no
     rmq_query), and 256 answers of each generation (every delta hit among
     them, up to that count) equal to ``witness_answers``;
 10. the port's launcher in this process, ``repro_torch.launch.serve.main``
     at its defaults on the card: the fused step, ``--routed``, ``--stripes
     4``, ``--interactive``, and ``--online --observe --check --trace-out``
     (at 32 sessions),
     then ``repro_torch.obs.report --check`` on that trace, each mode's wall;
 11. training (``train_phase``): (a) the backward kernels against their plain
     versions, flash_attention_bwd at gemma2-2b's training shapes (B=1,
     H=8, G=4, D=256, bf16, softcap 50, S=4,096 causal and S=8,192 with
     its 4,096 window, scores widened so the cap bends), smollm-360m's and
     qwen3-14b's heads at S=4,096 (with SDPA's backward timed beside them)
     and an fp32 case, given o and lse from the forward kernel as a train
     step gives them, each gradient norm-relative within 2e-2 (bf16) or
     1e-4 (fp32) of the plain version on the same inputs and of the plain
     version with its own lse (the accurate tanh), two calls bit-identical,
     with two controls (no softcap factor, dK without the group sum) the
     check must reject; fm_pairwise_bwd at FM's train_batch
     (B=65,536, F=39, D=10) in fp32 and bf16; (b) gemma2-2b's train step at
     full width (26 layers, d_model 2304, vocab 256,000, bf16, remat) at
     B=1, S=4,096 (train_4k's sequence, its batch of 256 cut to one): one
     step's loss and gradients against the plain route, the same widths at
     2 layers in fp32 (no TF32) within 1e-4, then 4 AdamW steps on one
     batch (the loss finite and falling), ms per step, tokens/s, a traced
     step's busy share, 52 flash_attention and 26 flash_attention_bwd
     launches a step, peak memory; (c) FM's lazy sparse step at full width
     (39 x 1M x 10, B=65,536, Zipf ids), 3 steps against the plain route
     (losses, tables, linear and their moments within rtol 1e-5), and one
     dense step of DIN, BST and MIND at full width (B=4,096, no kernel);
     (d) ``repro_torch.launch.train.main`` with ``--drill`` (one restart,
     the loss falling);
 12. the MoE archs (``moe_phase``): qwen2-moe-a2.7b at full width (24 layers,
     d_model 2048, 60 experts padded to 64, top-4, the shared expert, vocab
     151,936; random weights from the port's generator) in bf16: the median
     ms of 3 ``prefill_step``s at B=1, S=32,768 and tokens/s, ``decode_step``
     at B=16 against a 4,096-token cache (decode_32k's 32,768 cut: 16 x
     32,768 rows of its cache are 103 GB), ms per step over 32 steps, one
     traced call of each (busy share, flash_attention's ms, one layer's MoE
     block traced alone on its input from the call, launches), peak memory;
     each held against the plain route (``RouteLog``): the expert choices
     that differ between the two routes counted; in fp32 (2 layers, no
     TF32) every logit of the plain route replaying the kernel route's
     choices, and the sequences whose routing agreed, within 1e-3; in bf16
     (prefill B=2 S=4,096, 4 decode steps against the same 4,096-token
     cache, one cache alive at a time) the floor rule: the kernel route
     within 1.5x the bf16 plain route's distance from the fp32-activation
     plain route, both replaying the kernel's choices, and a control 32
     cache columns short rejected by it; the bf16 logits of agreeing
     sequences against atol 0.25 are only reported (no sequence has agreed
     in every layer so far); qwen3-moe-235b-a22b at full width and 4 of 94
     layers (one layer holds 4.98 GB), one prefill at S=4,096 and 8 decode
     steps at B=16, held the same way; the MoE train step, qwen2-moe at 4 of
     24 layers, B=1, S=4,096 (train_4k's sequence), remat and AdamW: loss
     and gradients against the plain route on the kernel's routing (1e-2,
     5e-2 of each gradient's norm), two passes and one step twice from one
     start bit-identical, ms per step, tokens/s, the aux term's share of the
     loss, a traced step; one flash_attention launch a layer a call (and
     one flash_attention_bwd in training), none on the plain route;
 13. MACE (``mace_phase``): its base config (2 layers, C = 128) trained in
     fp32 at GNN_SHAPES' molecule (128 molecules of 30 atoms), full_graph_sm
     (a 2,708-node graph, 1,433 features) and minibatch_lg (1,024 seeds of a
     232,965-node / 114,615,892-edge graph at fanout (15, 10), padded to
     172,032 nodes and 169,984 edges), data from the port's
     ``data/graphs.py``: ms per step, peak memory, a traced step's busy
     share, one step twice from one start bit-identical, loss, gradients
     and parameters after a step within 1e-4 (norm-relative) of the same
     step on the CPU at the two small shapes, the energy unchanged by a
     rotation at molecule (rtol 2e-4); ogb_products reported as waiting for
     a machine with several cards;
 14. sharded execution (``shard_phase``; one card, so no group of more
     than one rank): (a) qwen2-moe-a2.7b at full width in bf16 on a one-rank
     NCCL group (``file://`` rendezvous) and a (1, 1) ``DeviceMesh`` on the
     card, its parameters DTensors (``shard_params``) under its prefill and
     decode rules: ``prefill_step`` at B=1, S=4,096 and 4 ``decode_step``s at
     B=16 against a 4,096-token cache, logits bit-identical to the unsharded
     route on the same weights and tokens, one flash_attention launch a
     layer a call (counted: the phase's main path), and a control (the first
     decode step 32 cache columns short) the check must reject; (b) the
     expert-parallel MoE block rank by rank (``EPRankByRank``): each rank's
     body (its expert slots, ``moe_ep_partial``) run on the card in turn and
     the partials summed in rank order, at every MoE block of a prefill:
     qwen2-moe at model 2 and 4 (fp32 at 2 layers within 1e-5; bf16 at full
     width by the floor rule) and qwen3-moe-235b-a22b at (data 2, model 4)
     with moe_fsdp (fp32 at 2 layers, bf16 at 4 of 94), each data shard with
     its own capacity, each with a control (rank 0's partial left out) the
     check must reject; (c) ``compress_pod`` at pod 2, the pod
     played by a ``ReplicaGroup`` on gemma2-2b's full-width bf16 train step
     (B=1, S=4,096): ms a step with and without it, peak memory, and on one
     step's gradients over 3 rounds the residual within half a step, the
     error feedback carried (what was sent plus the residual is what was
     meant), two runs bit-identical, and a control (a common scale half too
     small) the check must reject;
 15. one JSON line naming every kernel with its launches, times and bound.
The last line is ``{"ok": true, "device": {...}}``. Any mismatch or failure
exits non-zero; without a card it exits non-zero before printing a result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time
import types
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
PACKED_PLAIN_TILES = 9             # the plain top-k tile loop's cap in phases 6 and 7b (~0.8 s
                                   # a tile "ef"): 1,152 candidates cross the kernel's first
                                   # 1,024-candidate chunk
KERNELS = {   # name -> (ops module, its launch counter, CUDA source, the TPU
              #          kernel it replaces, the counted runs that launch
              #          it: frontend routes' main batches, the recsys and
              #          LM phases, the striped index's two routes, the
              #          online runtime's measured pass, the
              #          live index's run at scale)
    "rmq_query": ("repro_torch.kernels.rmq.ops", "launches",
                  "src/repro_torch/csrc/rmq.cu",
                  "src/repro/kernels/rmq/kernel.py:68", ("per_pop_rmq",)),
    "heap_topk": ("repro_torch.kernels.heap_topk.ops", "launches",
                  "src/repro_torch/csrc/heap_topk.cu",
                  "src/repro/kernels/heap_topk/kernel.py:186",
                  ("kernels", "striped", "online", "fresh")),
    "conjunctive_scan": ("repro_torch.kernels.intersect.ops", "launches",
                         "src/repro_torch/csrc/intersect.cu",
                         "src/repro/kernels/intersect/kernel.py:137", ()),
    "conjunctive_topk": ("repro_torch.kernels.intersect.ops", "topk_launches",
                         "src/repro_torch/csrc/intersect.cu",
                         "src/repro/kernels/intersect/kernel.py:137",
                         ("kernels", "striped", "online", "fresh")),
    "heap_topk_packed": ("repro_torch.kernels.heap_topk.ops", "packed_launches",
                         "src/repro_torch/csrc/heap_topk.cu",
                         "src/repro/kernels/heap_topk/kernel.py:72",
                         (*CODECS, "striped")),
    "conjunctive_scan_packed": ("repro_torch.kernels.intersect.ops",
                                "packed_launches",
                                "src/repro_torch/csrc/intersect.cu",
                                "src/repro/kernels/intersect/kernel.py:110", ()),
    "conjunctive_topk_packed": ("repro_torch.kernels.intersect.ops",
                                "topk_packed_launches",
                                "src/repro_torch/csrc/intersect.cu",
                                "src/repro/kernels/intersect/kernel.py:110",
                                (*CODECS, "striped")),
    "fm_pairwise": ("repro_torch.kernels.fm_pairwise.ops", "launches",
                    "src/repro_torch/csrc/fm_pairwise.cu",
                    "src/repro/kernels/fm_pairwise/kernel.py:27", ("train",)),
    "fm_forward": ("repro_torch.kernels.fm_pairwise.ops", "forward_launches",
                   "src/repro_torch/csrc/fm_pairwise.cu",
                   "src/repro/kernels/fm_pairwise/kernel.py:27", ("recsys",)),
    "flash_attention": ("repro_torch.kernels.flash_attention.ops", "launches",
                        "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:93",
                        ("lm", "train", "moe", "moe_train", "shard")),
    # the gradients of the two TPU kernels on the training path (the JAX
    # package differentiates their references by autodiff)
    "flash_attention_bwd": ("repro_torch.kernels.flash_attention.ops", "bwd_launches",
                            "src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention/kernel.py:93",
                            ("train", "moe_train")),
    "fm_pairwise_bwd": ("repro_torch.kernels.fm_pairwise.ops", "bwd_launches",
                        "src/repro_torch/csrc/fm_pairwise.cu",
                        "src/repro/kernels/fm_pairwise/kernel.py:27", ("train",)),
}
# what a kernel replaces beside its TPU kernel: fm_forward also takes the
# gathers of FMModel.forward around fm_pairwise
ALSO_REPLACES = {"fm_forward": "src/repro/models/recsys.py:109-111",
                 "flash_attention_bwd": "jax.vjp of src/repro/kernels/flash_attention/ref.py:18",
                 "fm_pairwise_bwd": "jax.grad of src/repro/kernels/fm_pairwise/ref.py"}
# the kernels each frontend route's main-batch run launches, and no others
# (the per-tile conjunctive_scan kernels are held in phase 6, off the path)
ROUTE_KERNELS = {"kernels": ("heap_topk", "conjunctive_topk"),
                 "kernels_capped": ("heap_topk", "conjunctive_topk"),
                 "per_pop_rmq": ("rmq_query", "conjunctive_topk"),
                 "plain": (),
                 "ef": ("heap_topk_packed", "conjunctive_topk_packed"),
                 "bitpack": ("heap_topk_packed", "conjunctive_topk_packed"),
                 "recsys": ("fm_forward",),
                 "lm": ("flash_attention",),
                 "train": ("flash_attention", "flash_attention_bwd", "fm_pairwise",
                           "fm_pairwise_bwd"),
                 "moe": ("flash_attention",),
                 "moe_train": ("flash_attention", "flash_attention_bwd"),
                 "shard": ("flash_attention",)}
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
              "conjunctive_topk": "conjunctive_topk_kernel<qac::RawLookup>",
              ("conjunctive_topk_packed", "ef"):
                  "conjunctive_topk_kernel<qac::PackedLookup<true>",
              ("conjunctive_topk_packed", "bitpack"):
                  "conjunctive_topk_kernel<qac::PackedLookup<false>",
              "fm_pairwise": "fm_pairwise_kernel<",   # <float> or <__nv_bfloat16>
              "fm_forward": "fm_forward_kernel<",     # <T, kVec>
              # flash_attention_kernel<D> (fp32) or flash_attention_tc_kernel<D, decode,
              # softcap, lse> (bf16: prefill, or split-KV decode with its merge in the launch)
              "flash_attention": "flash_attention_",
              # fa_bwd_delta_kernel<T, D>, then fa_bwd_tc_kernel<D, dq, softcap> twice
              # (bf16: dk dv, then dq) or fa_bwd_dkdv_kernel<D> and fa_bwd_dq_kernel<D>
              "flash_attention_bwd": "fa_bwd_",
              "fm_pairwise_bwd": "fm_pairwise_bwd_kernel<"}
FM_TOL = dict(rtol=1e-5, atol=1e-6)        # FM logits, and the kernel vs plain
FWD_TRACE_REPS = 10                        # forwards in phase 3's traced-forward breakdowns
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
    """A kernel instantiation's name, as ptxas reports it, made readable:
    ``flash_attention_tc_kernel<256, decode, softcap>``,
    ``heap_topk_kernel<qac::PackedLookup<true>>``."""
    m = re.search(r"(heap_topk_kernel|conjunctive_(?:scan|topk)_kernel)IN3qac"
                  r"(?:9RawLookup|12PackedLookupILb([01])E)", symbol)
    if m:
        lookup = ("qac::RawLookup" if m.group(2) is None else
                  f"qac::PackedLookup<{'true' if m.group(2) == '1' else 'false'}>")
        return f"{m.group(1)}<{lookup}>"
    m = re.search(r"(fa_bwd_tc_kernel)ILi(\d+)ELb(\d)ELb(\d)E", symbol)
    if m:
        return (f"{m.group(1)}<{m.group(2)}, {'dq' if m.group(3) == '1' else 'dk dv'}, "
                f"{'softcap' if m.group(4) == '1' else 'no softcap'}>")
    m = re.search(r"(fa_bwd_\w+?_kernel)I(f|13__nv_bfloat16)?Li(\d+)E", symbol)
    if m:
        dtype = {"f": "float, ", "13__nv_bfloat16": "bf16, "}.get(m.group(2), "")
        return f"{m.group(1)}<{dtype}{m.group(3)}>"
    m = re.search(r"(flash_attention_(?:tc_)?kernel)ILi(\d+)E(?:Lb(\d)ELb(\d)ELb(\d)E)?", symbol)
    if not m:
        return symbol
    flags = "" if m.group(3) is None else (
        ", " + ("decode" if m.group(3) == "1" else "prefill") +
        ", " + ("softcap" if m.group(4) == "1" else "no softcap") +
        (", lse" if m.group(5) == "1" else ""))
    return f"{m.group(1)}<{m.group(2)}{flags}>"


def demangle_key(key: str) -> str:
    """A kernel as the profiler names it, cut to its name and template
    arguments: ``fa_bwd_tc_kernel<128, true, false>``."""
    m = re.search(r"(\w+_kernel(?:<[^()]*>)?)\(", key)
    return m.group(1) if m else key[:60]


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


def kernel_device_ms(torch, fn, tag: str, reps: int,
                     per_call: int = 1) -> tuple[float, int, dict]:
    """(mean device ms per launch, launches traced, {kernel: ms per launch})
    of the ``__global__`` whose traced name holds ``tag`` over ``reps``
    calls of ``fn`` after warm-up, from ``torch.profiler``'s CUDA activity
    (the kernel's own time, without the host's cost of the call), averaged
    over the launches the trace holds. A wrapper whose one launch is
    ``per_call`` kernels (the attention backward's three) is timed per
    wrapper launch: the kernels' sum, each kernel in the dict."""
    fn()
    torch.cuda.synchronize()
    prof, held = traced(torch, fn, reps, tag, reps * per_call)
    hits = [e for e in device_times_events(prof) if tag in e.key]
    parts = {demangle_key(e.key): e.self_device_time_total / e.count / 1e3 for e in hits}
    return sum(e.self_device_time_total for e in hits) / held * per_call / 1e3, held, parts


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


def call_device_us(torch, fn, reps: int) -> tuple[float, float]:
    """(device us per call, launches per call), summed over every kernel and
    copy that ``reps`` calls of ``fn`` put on the card, from
    ``torch.profiler``'s CUDA activity after a warm-up step."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for step_reps in (min(reps, 5), reps):
            for _ in range(step_reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    events = device_times_events(prof)
    return (sum(e.self_device_time_total for e in events) / reps,
            sum(e.count for e in events) / reps)


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


def topk_walk(torch, postings, lanes, fwd_terms, tl, th, k, cap, iters, pk=None,
              count=True, chunk=8192, stride=1):
    """The multi-term engine's answer at cap ``cap``, worked out with torch
    over each lane's candidates in chunks, all lanes at once: (int32[B, k],
    bytes conjunctive_topk needs on these lanes, the longest lane's candidate
    count); with ``count`` False only the answer, the bytes 0. A live lane
    reads its inputs (5 + 2P ints) and its candidates up to ``stop``, the
    position after its k-th hit, else min(d_len, cap): 4 B each, the forward
    row (4·M B) of each in [0, N), and, for each forward-passing candidate,
    the posting at its insertion point (4 B raw, else its packed read) in
    each needed span until the first that misses; a dead lane reads its flag
    alone; 4·B·k of output. ``stride`` S > 1 reads a docid stripe's forward
    rows: docid d is row d // S, valid while d < N·S."""
    d_start, d_end, starts, ends, dead = lanes
    B, P = starts.shape
    n, (N, M) = postings.numel(), fwd_terms.shape
    dev = postings.device
    limit = torch.where(dead, 0, (d_end - d_start).clamp(0, cap)).long()
    need = (ends > starts)[:, None, :]                              # [B, 1, P]
    found = torch.zeros(B, dtype=torch.long, device=dev)
    stop = limit.clone()
    out = torch.full((B, k + 1), INF, dtype=torch.int32, device=dev)   # column k: the misses
    n_dead = int(dead.sum())
    total = 4 * n_dead + (4 * 5 + 8 * P) * (B - n_dead) + 4 * B * k if count else 0
    for c0 in range(0, int(limit.max()), chunk):
        pos = c0 + torch.arange(chunk, device=dev)
        inr = pos[None, :] < limit[:, None]                         # [B, C]
        cand = torch.where(inr, postings[(d_start.long()[:, None] + pos).clamp(max=n - 1)], INF)
        in_fwd = inr & (cand >= 0) & (cand.long() < N * stride)
        rows = torch.where(in_fwd[..., None], fwd_terms[(cand // stride).clamp(0, N - 1)], 0)
        fwd_ok = inr & ((rows >= tl[:, None, None]) & (rows < th[:, None, None])).any(2)
        at = probe_positions(torch, postings, cand, starts, ends, iters)   # [B, C, P]
        holds = ((at < ends[:, None, :]) & (postings[at] == cand[..., None])) | ~need
        hit = (fwd_ok & holds.all(2)).long()
        before = found[:, None] + hit.cumsum(1) - hit               # hits ahead of each
        counted = inr & (before < k)
        keep = counted & (hit == 1)
        out.scatter_(1, torch.where(keep, before, k), torch.where(keep, cand, INF))
        if count:
            # a span is probed while every needed span before it holds
            first = torch.ones_like(holds[..., :1])
            reached = torch.cat([first, holds[..., :-1]], 2).int().cumprod(2) > 0
            probed = (counted & fwd_ok)[..., None] & need & reached
            total += 4 * int(counted.sum()) + 4 * M * int((counted & in_fwd).sum()) + (
                4 * int(probed.sum()) if pk is None else
                int(packed_read_bytes(torch, pk, at[probed]).sum()))
        kth = keep & (before == k - 1)
        stop = torch.where(kth.any(1), c0 + kth.long().argmax(1) + 1, stop)
        found += hit.sum(1)
        if bool(((found >= k) | (limit <= c0 + chunk)).all()):
            break
    return out[:, :k], total, int(stop.max())


# --------------------------------------------------------------------------
# brute-force host reference
# --------------------------------------------------------------------------
def ascending_lists(offs, post) -> bool:
    """Whether every CSR list is strictly ascending, as ``brute_force``
    takes it."""
    ends = offs[(offs > 0) & (offs < post.size)].astype(np.int64)
    step = np.diff(post.astype(np.int64)) > 0
    step[ends - 1] = True                      # a list boundary may step down
    return bool(step.all())


def brute_force(arrays, plen, pids, tlo, thi, k, scan_cap):
    """Top-k docids of one parsed query straight from the CSR postings and
    the forward index (no RMQ, no probes): the candidates are the prefix
    lists' intersection (or, single-term, the union of the suffix range's
    lists); a candidate counts when its forward row holds a suffix term.
    The engine scans at most ``scan_cap`` postings of the shortest prefix
    list (``max_tiles * tile``), and so does this. Every list is strictly
    ascending (``ascending_lists``): the k smallest of a union lie among
    each list's first k, and a candidate is in a list where a binary
    search finds it."""
    offs, post, fwd = arrays
    if tlo >= thi or (plen > 0 and (pids[:plen] == 0).any()):
        docs = np.zeros(0, np.int64)
    elif plen == 0:
        s, e = offs[tlo:thi].astype(np.int64), offs[tlo + 1:thi + 1].astype(np.int64)
        docs = np.unique(np.concatenate([post[s[s + j < e] + j] for j in range(k)]))
    else:
        lists = [post[offs[t]:offs[t + 1]] for t in pids[:plen]]
        driver = int(np.argmin([len(x) for x in lists]))
        docs = lists[driver][:scan_cap]
        for j, lst in enumerate(lists):
            if j != driver:
                at = np.minimum(np.searchsorted(lst, docs), max(len(lst) - 1, 0))
                docs = docs[(lst[at] == docs) if len(lst) else np.zeros(len(docs), bool)]
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


def counted_exact(torch, reset_counts, read_counts, phase):
    """-> run(fn, want, total=None): fn() with every launch count set to 0
    just before and read just after; the run must launch exactly ``want``
    (kernel -> count) and nothing else. Adds the counts to ``total`` when
    one is given."""
    def run(fn, want: dict, total=None):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got = read_counts()
        if any(c != want.get(name, 0) for name, c in got.items()):
            fail(f"{phase}: a run launched {got}; it launches {want} only")
        if total is not None:
            for name, c in got.items():
                total[name] = total.get(name, 0) + c
        return out
    return run


def fill_cache(torch, g, cache, pos):
    """Seeded normal x 0.02 in every row of a KV cache; its rows at ``pos``."""
    with torch.inference_mode():
        for t in (*cache["k"], *cache["v"]):
            t.normal_(generator=g).mul_(0.02)
        cache["pos"].copy_(torch.tensor(pos, dtype=torch.int32))
    return cache


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
    """FM at its three inference shapes through the kernel route (one
    fm_forward launch), the gather + fm_pairwise composition and the plain
    route; fm_forward held against its plain version there (and on bf16
    copies of the weights, and on uniform ids), fm_pairwise against its own;
    DIN and BST at serve_p99, MIND's retrieval of one user against 1M items;
    every model also at smoke width on the card against the CPU. Returns the
    launch counts summed over the counted runs."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.recsys_common import MODEL_CLS, RECSYS_SHAPES
    from repro_torch.data import recsys_batch
    from repro_torch.kernels.fm_pairwise import ops as fm_ops
    from repro_torch.kernels.fm_pairwise.ref import fm_forward_ref, fm_pairwise_ref
    from repro_torch.models.recsys import clamp_rows

    total = {}
    counted_run = counter(torch, reset_counts, read_counts, "fm_forward", "recsys", total)

    def on_card(feats_np):
        return {k: torch.from_numpy(v).to(dev) for k, v in feats_np.items()}

    seen = [0]    # the peak before peak_bytes resets it

    def memory(model):
        n = sum(t.numel() * t.element_size() for t in model.state_dict().values())
        peak = max(seen[0], torch.cuda.max_memory_allocated())
        return f"{n / 2**30:.3f} GiB of weights, peak {peak / 2**30:.3f} GiB allocated"

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
    fields = torch.arange(n_f, device=dev)

    def composed(ids):
        """FM's kernel route before fm_forward: torch gathers write an int64
        index and the [B, F, D] embeddings, the fm_pairwise kernel reads them."""
        flat = clamp_rows(ids, V) + fields * V
        emb = model.tables.view(n_f * V, D)[flat]
        lin = model.linear.view(n_f * V)[flat].sum(-1)
        return model.bias + lin + fm_ops.fm_pairwise(emb)

    def peak_bytes(fn):
        """Device bytes allocated above what was live before one call."""
        torch.cuda.synchronize()
        seen[0] = max(seen[0], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    def hold_forward(case, ids, tables, linear, bias):
        """fm_forward against fm_forward_ref within FM_TOL, plus in bf16 one
        unit in the last place for each of the two bf16 roundings (the
        linear sum, then bias + lin: 2**-6 * (|lin| + |bias|)), which the two
        may take to neighbouring values as their fp32 sums run in other
        orders; the plain version with the last field dropped must fail the
        same check. The bound's bytes: the ids, each distinct (field, row)
        of tables and linear once, and 4 B a row out."""
        B, elt = ids.shape[0], tables.element_size()
        flat = clamp_rows(ids, V) + fields * V
        distinct = int(torch.unique(flat).numel())
        extra = 0.0
        if tables.dtype == torch.bfloat16:
            lin = linear.view(n_f * V)[flat].double().sum(-1)
            extra = 2.0**-6 * (lin.abs() + bias.double().abs())
        del flat

        def close(g, w):
            w = w.double()
            return bool(((g.double() - w).abs()
                         <= FM_TOL["rtol"] * w.abs() + FM_TOL["atol"] + extra).all())

        dropped = fm_forward_ref(ids[:, :-1].contiguous(), tables[:-1], linear[:-1], bias)
        if close(fm_ops.fm_forward(ids, tables, linear, bias), dropped):
            fail(f"fm_forward {case}: the check passes the plain version with a field dropped")
        del dropped
        gathered = B * n_f * (D + 1) * elt
        c = hold("fm_forward", lambda: fm_ops.fm_forward(ids, tables, linear, bias),
                 lambda: fm_forward_ref(ids, tables, linear, bias), close,
                 B * n_f * 4 + distinct * (D + 1) * elt + 4 * B, 200, case,
                 ops_needed=B * (n_f * (3 * D + 1) + 3 * D + 3))
        c.update(distinct_rows=distinct, gathered_bytes=gathered)
        say(f"[kernel] fm_forward {case}: device {c['ms']*1e3:.2f} us/launch, call "
            f"{c['call_ms']*1e3:.2f} us, plain {c['plain_ms']*1e3:.2f} us, bound "
            f"{c['bound_ms']*1e3:.4f} us ({c['bound_by']}, {c['bytes']} B, {distinct} distinct "
            f"(field, row) of {B * n_f}), every gathered row {gathered} B "
            f"({gathered / HBM_BYTES_PER_S * 1e6:.2f} us), max |kernel - plain| "
            f"{c['max_abs_err']:.3g}, the dropped-field control rejected, on {smi}")

    fm_batches = [(name, RECSYS_SHAPES[name]["batch"]) for name in ("serve_p99", "serve_bulk")]
    fm_batches.append(("retrieval_cand", RECSYS_SHAPES["retrieval_cand"]["n_cand"]))
    for shape, B in fm_batches:
        t0 = time.perf_counter()
        feats = on_card(recsys_batch(cfg, B, np.random.default_rng(seed))[0])
        t_data = time.perf_counter() - t0
        ids = feats["sparse_ids"]
        with torch.inference_mode():
            model.use_kernel = True
            logits = counted_run(lambda: model(feats), 1)
            model.use_kernel = False
            plain = counted_run(lambda: model(feats), 0)
            comp = composed(ids)
            if logits.shape != (B,) or not bool(torch.isfinite(logits).all()):
                fail(f"fm {shape}: logits of shape {tuple(logits.shape)}, finite "
                     f"{bool(torch.isfinite(logits).all())}")
            for name, other in (("kernel", logits), ("composition", comp)):
                if not torch.allclose(other, plain, **FM_TOL):
                    fail(f"fm {shape}: {name} and plain logits differ by "
                         f"{float((other - plain).abs().max())}")
            if shape == "serve_p99":
                want = fm_host_logits(torch, model, ids[:64])
                if not np.allclose(logits[:64].cpu().numpy(), want, **FM_TOL):
                    fail("fm: logits differ from the explicit pair sum in float64")
            t_plain = median_ms(torch, lambda: model(feats), 20)
            t_comp = median_ms(torch, lambda: composed(ids), 20)
            model.use_kernel = True
            t_kernel = median_ms(torch, lambda: model(feats), 20)
            # per forward, over FWD_TRACE_REPS of them: a window holding one
            # launch of a few us came back empty three times in one run
            n = FWD_TRACE_REPS
            events, comp_events = (
                [(d / n, key, round(c / n)) for d, key, c in
                 device_times(traced(torch, fn, n, TRACE_TAGS[tag], n)[0])]
                for fn, tag in ((lambda: model(feats), "fm_forward"),
                                (lambda: composed(ids), "fm_pairwise")))
            mem = {"fused": peak_bytes(lambda: model(feats)),
                   "composition": peak_bytes(lambda: composed(ids))}
            hold_forward(f"{shape} B={B} F={n_f} D={D} fp32", ids, model.tables,
                         model.linear, model.bias)
            if shape == "serve_bulk":
                half = [t.to(torch.bfloat16) for t in (model.tables, model.linear, model.bias)]
                hold_forward(f"{shape} B={B} F={n_f} D={D} bf16", ids, *half)
                del half
            if shape == "retrieval_cand":
                g = torch.Generator(device=dev).manual_seed(seed)
                uniform = torch.randint(0, V, (B, n_f), generator=g, device=dev,
                                        dtype=torch.int32)
                hold_forward(f"{shape} B={B} F={n_f} D={D} fp32 uniform ids", uniform,
                             model.tables, model.linear, model.bias)
                del uniform
            # the TPU kernel's own contract, off the model's path
            flat = clamp_rows(ids, V) + fields * V
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
        say(f"[recsys] fm {shape} B={B}: fused route (one fm_forward) {t_kernel:.4f} ms/batch "
            f"({t_kernel / B * 1e3:.5f} us/row), gather + fm_pairwise composition "
            f"{t_comp:.4f} ms, plain route {t_plain:.4f} ms, median of 20 each | logits "
            f"equal within {FM_TOL}, max |kernel - plain| "
            f"{float((logits - plain).abs().max()):.3g}, |composition - plain| "
            f"{float((comp - plain).abs().max()):.3g} | batch made in {t_data:.2f} s on "
            f"the host | peak bytes above the weights: fused {mem['fused']}, composition "
            f"{mem['composition']} on {smi}")
        for what, evs in (("fused", events), ("composition", comp_events)):
            say(f"[recsys]   traced {what} forward: {sum(n for _, _, n in evs)} device ops, "
                f"busy {sum(d for d, _, _ in evs) / 1e3:.4f} ms")
            for d, key, count in evs[:6]:
                say(f"[recsys]   {d / 1e3:9.4f} ms  {count:4d} x  {key[:90]}")
        del feats, ids, logits, plain, comp
    say(f"[recsys] fm: {memory(model)}")
    seen[0] = 0
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
            f"{model.device}, no FM kernel launch | {memory(model)} on {smi}")
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

    fill = functools.partial(fill_cache, torch, g)

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


# --------------------------------------------------------------------------
# phase 7b: the docid-striped index
# --------------------------------------------------------------------------
STRIPES = 4


def striped_phase(torch, dev, qidx, inputs, tl, th, want, kernel_us, smi, hold,
                  reset_counts, read_counts) -> dict:
    """The index's own rows in STRIPES docid stripes ("ef" packed) on the
    card, built on the host; the main batch through ``qac_serve_striped``'s
    loop over the stripes on the raw and the "ef" route, each launching
    heap_topk and conjunctive_topk (or their packed forms) once a stripe,
    equal to phase 7's unstriped kernel route ``want`` on every lane its
    engine did not cut at the cap (a lane whose driver list is longer than
    the cap and which found fewer than k hits: each stripe walks the cap of
    its own quarter of that list, so such a lane holds ``want`` as a prefix
    and may find more, as in the JAX package); the strided conjunctive_topk
    on stripe 0 held against its plain version with the stride, at the
    path's cap against ``topk_walk`` and at the plain tile loop's caps.
    Returns the two routes' launch counts, summed."""
    from repro_torch.core.search import conjunctive_lanes
    from repro_torch.core.striped import build_striped, local_index
    from repro_torch.kernels.intersect import ops as isect_ops
    from repro_torch.kernels.intersect.ref import (conjunctive_topk_packed_ref,
                                                   conjunctive_topk_ref)
    from repro_torch.serve import qac_serve_striped
    from torch.profiler import ProfilerActivity, profile

    comps, idx = qidx.completions, qidx.index
    S = STRIPES
    t0 = time.perf_counter()
    fwd = comps.fwd_terms.cpu().numpy()
    striped = build_striped(fwd, np.arange(len(fwd), dtype=np.int32), idx.n_terms, S,
                            "ef", device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    del fwd
    per = [striped.stripe_nbytes(s) / 2**20 for s in range(S)]
    packed_mib = striped.pp_words[0].numel() * 4 / 2**20 + striped.pp_base[0].numel() * 12 / 2**20
    say(f"[striped] {S} docid stripes of the {comps.n} completions (\"ef\" packed) built "
        f"on the host in {t_build:.1f} s: {striped.n_local_docs} forward rows and "
        f"{striped.postings_pad} postings a stripe (padded); on the card "
        f"{', '.join(f'{m:.1f}' for m in per)} MiB a stripe, of it {packed_mib:.1f} MiB "
        f"of \"ef\" postings, beside the unstriped raw index; on {smi}")

    pids, plen, suf, slen = inputs
    B = plen.numel()
    k, cap = 10, 4096 * 128
    d_start, d_end, _, _, dead = conjunctive_lanes(idx, pids, plen, tl, th)
    cut = ((~dead & ((d_end - d_start) > cap)).cpu().numpy()
           & ((want < INF).sum(1) < k))
    whole = ~cut
    classes = (int(bool((plen == 0).any())), int(bool((plen > 0).any())))
    predict = {None: {"heap_topk": S * classes[0], "conjunctive_topk": S * classes[1]},
               "ef": {"heap_topk_packed": S * classes[0],
                      "conjunctive_topk_packed": S * classes[1]}}
    counted, answers = {}, {}
    for codec in (None, "ef"):
        route = codec or "raw"

        def serve():
            return qac_serve_striped(striped, qidx.dictionary, pids, plen, suf, slen, k=k,
                                     postings_codec=codec)
        reset_counts()
        torch.cuda.synchronize()
        out = serve()
        torch.cuda.synchronize()
        counts = read_counts()
        for name, c in counts.items():
            if c != predict[codec].get(name, 0):
                fail(f"striped {route}: launched {name} {c} times; {S} stripes with both "
                     f"classes predict {predict[codec]} ({counts})")
            counted[name] = counted.get(name, 0) + c
        got = answers[route] = out.cpu().numpy()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"striped {route}: answers {got.shape} {got.dtype}, the unstriped "
                 f"{want.shape} {want.dtype}")
        if not np.array_equal(got[whole], want[whole]):
            bad = int((got[whole] != want[whole]).any(1).sum())
            fail(f"striped {route}: {bad} of {int(whole.sum())} uncut lanes differ from "
                 "phase 7's kernel route")
        n_found = (want < INF).sum(1)
        for i in np.flatnonzero(cut):
            if not np.array_equal(got[i, :n_found[i]], want[i, :n_found[i]]):
                fail(f"striped {route}: cut lane {i} does not hold the unstriped answer "
                     "as a prefix")
        ms = median_ms(torch, serve, 5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            serve()
            torch.cuda.synchronize()
        events = device_times(prof)
        busy_us = sum(d for d, _, _ in events)
        more = int(((got < INF).sum(1) > n_found)[cut].sum())
        say(f"[striped] {route} route, B={B}, k={k}: launches {counts} (predicted "
            f"{predict[codec]}); {int(whole.sum())} lanes bit-identical to phase 7's "
            f"kernel route, {int(cut.sum())} lanes cut at the cap ({cap} candidates) hold "
            f"its answer as a prefix ({more} of them find more hits); "
            f"{ms * 1e3 / B:.1f} us/query (median of 5 calls) against phase 7's kernel "
            f"route {kernel_us:.1f}; one traced call: device busy {busy_us / 1e3:.2f} ms "
            f"of {ms:.2f} ms, busy share {busy_us / 1e3 / ms:.4f}; on {smi}")
        for d, key, count in events[:4]:
            say(f"[striped]   {d / 1e3:9.2f} ms  {count:7d} x  {key[:90]}")
    if not np.array_equal(answers["raw"], answers["ef"]):
        fail("striped: the raw and \"ef\" routes differ")

    # the strided conjunctive_topk on stripe 0 against its plain version
    idx0, fwd0, _ = local_index(striped, 0)
    mq = torch.nonzero(plen > 0)[:, 0]
    tlm, thm = tl[mq], th[mq]
    lanes = conjunctive_lanes(idx0, pids[mq], plen[mq], tlm, thm)
    longest = int(torch.where(lanes[3] > lanes[2], lanes[3] - lanes[2], 0).max())
    iters = (1 << max(1, (max(longest, 1) - 1).bit_length())).bit_length()  # as the frontend
    fargs = (*lanes, fwd0.fwd_terms, tlm, thm)
    pk = idx0.packed
    for codec in (None, "ef"):
        name = "conjunctive_topk" if codec is None else "conjunctive_topk_packed"
        kernel = (isect_ops.conjunctive_topk if codec is None else
                  functools.partial(isect_ops.conjunctive_topk_packed, idx0.postings, pk))
        loop = (conjunctive_topk_ref if codec is None else
                functools.partial(conjunctive_topk_packed_ref, idx0.postings, pk))
        base = (idx0.postings,) if codec is None else ()
        loop_tiles = PACKED_PLAIN_TILES
        for max_tiles in (4096, loop_tiles):
            kw = dict(k=k, tile=128, max_tiles=max_tiles, iters=iters, fwd_stride=S)
            walk = functools.partial(topk_walk, torch, idx0.postings, lanes, fwd0.fwd_terms,
                                     tlm, thm, k, 128 * max_tiles, iters, stride=S)
            answer, b_topk, stop = walk(pk if codec else None)
            if max_tiles == loop_tiles:
                plain, held_by = (lambda: loop(*base, *fargs, **kw)), "tile loop"
            else:
                plain, held_by = (lambda: walk(count=False)[0]), "topk_walk"
            case = (f"stripe 0 of {S}, fwd_stride {S}, B={mq.numel()} k={k} tile=128 "
                    f"max_tiles={max_tiles} iters={iters}")
            c = hold(name, lambda: kernel(*base, *fargs, **kw), plain, torch.equal, b_topk,
                     20, case, codec, plain_reps=0, trace_reps=50)
            c["longest_lane"], c["plain"] = stop, held_by
            if not torch.equal(answer, kernel(*base, *fargs, **kw)):
                fail(f"{name} {case}: topk_walk disagrees with the kernel")
            say(f"[striped] {name}[{codec or 'raw'}] {case}: device {c['ms'] * 1e3:.2f} "
                f"us/launch, call {c['call_ms'] * 1e3:.2f} us, plain ({held_by}, one call) "
                f"{c['plain_ms'] * 1e3:.2f} us, bound {c['bound_ms'] * 1e3:.4f} us "
                f"({b_topk} B; longest lane {stop} candidates) | equal; on {smi}")
    return counted


# --------------------------------------------------------------------------
# phase 10: the port's launcher
# --------------------------------------------------------------------------
LAUNCH_SESSIONS = 32     # the online check's sessions (its one-request-per-dispatch
                         # reference grows with them; the default 64 took 26 s)


def launcher_phase(smi):
    """``repro_torch.launch.serve.main`` in this process at its defaults
    (--queries 20000, --batch 256) on the card: the fused step, --routed,
    --stripes 4, --interactive on a partial from the launcher's log, and
    --online --observe --check --trace-out, whose trace
    ``repro_torch.obs.report`` then checks. An exception fails the script."""
    import tempfile

    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch.serve import sample_partials
    from repro_torch.obs import report
    from repro_torch.text import SynthLogConfig, generate_query_log

    qs, _ = generate_query_log(SynthLogConfig(n_queries=20_000))
    partial = sample_partials([q for q in qs if q.split()], 1, seed=3)[0]
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.jsonl")
        modes = {"fused": [], "routed": ["--routed"], "stripes 4": ["--stripes", "4"],
                 "interactive": ["--interactive", partial],
                 "online observe check": ["--online", "--observe", "--check",
                                          "--sessions", str(LAUNCH_SESSIONS),
                                          "--trace-out", trace]}
        for mode, argv in modes.items():
            t0 = time.perf_counter()
            if launch_serve.main(argv) != 0:
                fail(f"launcher {mode}: non-zero return")
            walls[mode] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if report.main([trace, "--check"]) != 0:
            fail("obs.report --check: non-zero return")
        walls["obs.report --check"] = time.perf_counter() - t0
    say("[launch] python -m repro_torch.launch.serve in process, wall s: " + ", ".join(
        f"{m} {w:.1f}" for m, w in walls.items()) + f"; on {smi}")


# --------------------------------------------------------------------------
# phase 11: training
# --------------------------------------------------------------------------
# The backward kernels against their plain versions, norm-relative over
# each gradient: ||kernel - plain|| / ||plain|| within 1e-4 in fp32 (fp32
# sums in other orders) and 2e-2 in bf16 (the gradients' own rounding).
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FM_GRAD_TOL = {"float32": 1e-6, "bfloat16": 1e-2}
# gemma2's attention cases widen the scores (q x BWD_QSCALE, x ~ 20 N(0, 1))
# so that its softcap of 50 bends them: at N(0, 1) scores the cap's factor
# changes dS by ~3e-3 and no check could see it dropped.
BWD_QSCALE = 20.0
# one gemma2-2b step in bf16, kernel route vs plain route: the loss within
# LM_TRAIN_LOSS_TOL, every parameter's gradient norm-relative within
# LM_TRAIN_GRAD_TOL (the two attentions round o and P to bf16 at other
# places, and 26 layers carry it); in fp32 (2 layers, no TF32) both within
# LM_TRAIN_FP32_TOL.
LM_TRAIN_LOSS_TOL = 1e-2
LM_TRAIN_GRAD_TOL = 5e-2
LM_TRAIN_FP32_TOL = 1e-4
FM_TRAIN_TOL = 1e-5      # rtol; atol 1e-5 x the largest |value| of the tensor
TRAIN_STEPS, FM_TRAIN_STEPS = 4, 3


def rel_norm(torch, a, b) -> float:
    """||a - b|| / ||b|| in float64 (0 when both are zero)."""
    d, n = (a.double() - b.double()).norm(), b.double().norm()
    return float(d / n) if float(n) > 0 else float(d > 0) * float("inf")


def train_phase(torch, dev, seed, smi, hold, reset_counts, read_counts) -> dict:
    """(a) flash_attention_bwd and fm_pairwise_bwd against their plain
    versions at the training shapes, with controls the check must reject;
    (b) gemma2-2b's train step at full width (B=1, S=4,096) through the
    attention kernels, held against the plain route in bf16 and, at 2
    layers, in fp32; (c) FM's lazy sparse step at full width through
    fm_pairwise and its backward, held against the plain route, and one
    dense step of DIN, BST and MIND; (d) the training launcher's drill.
    Returns the launch counts of the main path: the LM's and FM's train
    steps."""
    import io
    import tempfile

    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.configs.lm_common import LM_SHAPES
    from repro_torch.configs.recsys_common import MODEL_CLS, RECSYS_SHAPES
    from repro_torch.data import TokenStream, recsys_batch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fm_pairwise import ops as fm_ops
    from repro_torch.kernels.fm_pairwise.ref import fm_pairwise_bwd_ref
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (init_train_state, make_fm_sparse_train_step,
                                   make_lm_train_step, make_recsys_train_step)

    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed)
    cfg = get_arch("gemma2-2b").cfg
    L, H, G, D = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S = LM_SHAPES["train_4k"]["seq"]
    bf16 = torch.bfloat16

    counted = counted_exact(torch, reset_counts, read_counts, "training")

    # -- (a) the backward kernels against their plain versions -----------------
    def bwd_case(case, Hq, Gk, Sq, Dh, dtype, *, window=0, softcap=0.0, qscale=1.0,
                 sdpa=False, controls=False, reps=3):
        q, k, v, do = (torch.randn(shape, generator=g, device=dev) for shape in
                       ((1, Hq, Sq, Dh), (1, Gk, Sq, Dh), (1, Gk, Sq, Dh), (1, Hq, Sq, Dh)))
        q, k, v, do = (q * qscale).to(dtype), k.to(dtype), v.to(dtype), do.to(dtype)
        kw = dict(causal=True, window=window, softcap=softcap)
        o, lse = fa_ops.flash_attention_fwd(q, k, v, **kw)   # as the train step's forward
        name = str(dtype).split(".")[-1]
        tol = GRAD_TOL[name]
        pairs, _ = live_pairs(1, Sq, Sq, True, window)
        nbytes = 4 * (q.numel() + k.numel()) * q.element_size()
        ops_needed = 10 * Dh * Hq * pairs           # five products of 2 * Dh a live pair
        library = None
        if sdpa:    # SDPA's backward: the same gradient where there is no softcap
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
            library = functools.partial(torch.autograd.grad, out, leaves, do,
                                        retain_graph=True)
        errs = {}

        def equal(a, b):
            errs["rel"] = [rel_norm(torch, x, y) for x, y in zip(a, b)]
            return all(bool(torch.isfinite(x).all()) for x in a) and max(errs["rel"]) <= tol

        c = hold("flash_attention_bwd",
                 lambda: fa_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw),
                 lambda: fa_ops.flash_attention_bwd_ref(q, k, v, o, do, lse=lse, **kw),
                 equal, nbytes, reps, f"{case}: q {list(q.shape)} k/v {list(k.shape)} {name}",
                 plain_reps=0, ops_needed=ops_needed,
                 ops_per_s=FP32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S,
                 trace_reps=reps, library=library, per_call=3)
        c.update(grad_rel_err=errs["rel"], grad_tol=tol, launches_per_step=L)
        # two calls give the same bytes (no float atomics), and the plain
        # version with its own lse (the accurate tanh) agrees too
        first = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        second = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            fail(f"flash_attention_bwd {case}: two calls give different gradients")
        own = [rel_norm(torch, a, b) for a, b in zip(
            first, fa_ops.flash_attention_bwd_ref(q, k, v, o, do, **kw))]
        if max(own) > tol:
            fail(f"flash_attention_bwd {case}: against the plain version with its own lse "
                 f"dq, dk, dv score {own}, beyond {tol}")
        c.update(grad_rel_err_own_lse=own, bit_identical_calls=True)
        del first, second
        ctl = ""
        if controls:    # a backward without the softcap's factor; dK without the group sum
            want = fa_ops.flash_attention_bwd_ref(q, k, v, o, do, lse=lse, **kw)
            no_cap = rel_norm(torch, fa_ops.flash_attention_bwd_ref(
                q, k, v, o, do, lse=lse, cap_grad=False, **kw)[0], want[0])
            no_sum = rel_norm(torch, fa_ops.flash_attention_bwd_ref(
                q, k, v, o, do, lse=lse, group_sum=False, **kw)[1], want[1])
            if not (no_cap > tol and no_sum > tol):
                fail(f"flash_attention_bwd {case}: the check passes a wrong gradient: without "
                     f"the softcap factor dq scores {no_cap:.3g}, dk without the group sum "
                     f"{no_sum:.3g}, within {tol}")
            c.update(control_no_cap_dq=no_cap, control_no_group_sum_dk=no_sum)
            ctl = (f"; controls: dq without the softcap factor {no_cap:.3g}, dk without "
                   f"the group sum {no_sum:.3g}, both rejected")
        lib = f", SDPA backward {c['library_ms']:.3f} ms" if sdpa else ""
        say(f"[train] flash_attention_bwd {c['case']}: device {c['ms']:.3f} ms/launch (3 "
            f"kernels: {', '.join(f'{n} {t:.3f}' for n, t in c['kernel_ms'].items())}), call {c['call_ms']:.3f} ms, plain {c['plain_ms']:.1f} ms{lib}, bound "
            f"{c['bound_ms']:.3f} ms ({c['bound_by']}: {ops_needed} ops, {nbytes} B); "
            f"||kernel - plain|| / ||plain|| dq, dk, dv "
            f"{', '.join(f'{e:.3g}' for e in errs['rel'])} within {tol} (against the plain "
            f"version with its own lse {', '.join(f'{e:.3g}' for e in own)}); two calls "
            f"bit-identical{ctl} on {smi}")
        del q, k, v, o, lse, do

    bwd_case("gemma2 global layer", H, G, S, D, bf16, softcap=cfg.attn_softcap,
             qscale=BWD_QSCALE, controls=True)
    bwd_case(f"gemma2 local layer, S={2 * S}", H, G, 2 * S, D, bf16, window=cfg.window,
             softcap=cfg.attn_softcap, qscale=BWD_QSCALE)
    bwd_case("smollm-360m heads", 15, 5, S, 64, bf16, sdpa=True)
    bwd_case("qwen3-14b heads", 40, 8, S, 128, bf16, sdpa=True)
    bwd_case(f"fp32, D={D}", H, G, 2048, D, torch.float32, softcap=cfg.attn_softcap,
             qscale=BWD_QSCALE, controls=True)
    torch.cuda.empty_cache()

    fm_cfg = get_arch("fm").cfg
    B_fm = RECSYS_SHAPES["train_batch"]["batch"]
    for dtype in (torch.float32, bf16):
        e = (torch.randn((B_fm, fm_cfg.n_sparse, fm_cfg.embed_dim), generator=g, device=dev)
             * 0.02).to(dtype)
        cot = torch.randn(B_fm, generator=g, device=dev)
        name = str(dtype).split(".")[-1]
        nbytes = B_fm * (2 * fm_cfg.n_sparse * fm_cfg.embed_dim * e.element_size() + 4)
        errs = {}

        def equal(a, b, tol=FM_GRAD_TOL[name]):
            errs["rel"] = rel_norm(torch, a, b)
            return a.dtype == b.dtype and bool(torch.isfinite(a).all()) and errs["rel"] <= tol

        c = hold("fm_pairwise_bwd", lambda: fm_ops.fm_pairwise_bwd(e, cot),
                 lambda: fm_pairwise_bwd_ref(e, cot), equal, nbytes, 50,
                 f"B={B_fm} F={fm_cfg.n_sparse} D={fm_cfg.embed_dim} {name}", trace_reps=50)
        c.update(grad_rel_err=errs["rel"], grad_tol=FM_GRAD_TOL[name], launches_per_step=1)
        say(f"[train] fm_pairwise_bwd {c['case']}: device {c['ms']*1e3:.2f} us/launch, call "
            f"{c['call_ms']*1e3:.2f} us, plain {c['plain_ms']*1e3:.2f} us, bound "
            f"{c['bound_ms']*1e3:.2f} us ({nbytes} B); ||kernel - plain|| / ||plain|| "
            f"{errs['rel']:.3g} within {FM_GRAD_TOL[name]} on {smi}")
        del e, cot

    # -- (b) gemma2-2b's train step at full width -------------------------------
    main = {}
    stream = TokenStream.synthetic(vocab=cfg.vocab, seed=seed)
    toks = torch.from_numpy(stream.tokens[:S + 1].copy()).to(dev)
    batch = {"tokens": toks[None, :S], "targets": toks[None, 1:],
             "mask": torch.ones((1, S), device=dev)}

    def route_grads(model, base, flash):
        model.cfg = dataclasses.replace(base, use_flash=flash)
        try:
            loss = model.loss_fn(batch["tokens"], batch["targets"], batch["mask"])
            return loss.detach(), torch.autograd.grad(loss, list(model.parameters()))
        finally:
            model.cfg = base

    def hold_routes(model, base, layers, loss_tol, grad_tol, what):
        per_step = {"flash_attention": 2 * layers if base.remat else layers,
                    "flash_attention_bwd": layers}
        t0 = time.perf_counter()
        lk, gk = counted(lambda: route_grads(model, base, None), per_step)
        t_k = time.perf_counter() - t0
        t0 = time.perf_counter()
        lp, gp = counted(lambda: route_grads(model, base, False), {})
        t_p = time.perf_counter() - t0
        names = [n for n, _ in model.named_parameters()]
        errs = {n: rel_norm(torch, a, b) for n, a, b in zip(names, gk, gp)}
        worst = max(errs, key=errs.get)
        dl = abs(float(lk) - float(lp))
        if not (math.isfinite(float(lk)) and dl <= loss_tol * max(1.0, abs(float(lp)))
                and errs[worst] <= grad_tol
                and all(bool(torch.isfinite(x).all()) for x in gk)):
            fail(f"lm train {what}: kernel route loss {float(lk)} vs plain {float(lp)}, worst "
                 f"gradient {worst} at {errs[worst]:.3g} (tolerance {grad_tol})")
        say(f"[train] gemma2-2b {what} loss and gradients, kernel route ({t_k:.2f} s, "
            f"{per_step} launches) vs plain route ({t_p:.2f} s, none): loss {float(lk):.6f} vs "
            f"{float(lp):.6f}; ||g_kernel - g_plain|| / ||g_plain|| at most {errs[worst]:.3g} "
            f"({worst}) within {grad_tol}, median {float(np.median(list(errs.values()))):.3g} "
            f"on {smi}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32, param_dtype=torch.float32)
    model = TransformerLM(cfg32, device=dev, seed=seed)
    hold_routes(model, cfg32, 2, LM_TRAIN_FP32_TOL, LM_TRAIN_FP32_TOL,
                "fp32 at 2 layers (one local/global pair, no TF32)")
    del model
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    model = TransformerLM(cfg, device=dev, seed=seed)
    hold_routes(model, cfg, L, LM_TRAIN_LOSS_TOL, LM_TRAIN_GRAD_TOL, "bf16 one step")
    torch.cuda.empty_cache()
    state = init_train_state(dict(model.named_parameters()))
    step = make_lm_train_step(model, AdamWConfig(lr=3e-3, warmup_steps=1,
                                                 total_steps=TRAIN_STEPS))
    per_step = {"flash_attention": 2 * L, "flash_attention_bwd": L}
    losses, walls = [], []

    def train_steps():
        nonlocal state
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))     # synchronises
            walls.append(time.perf_counter() - t0)

    counted(train_steps, {k: TRAIN_STEPS * c for k, c in per_step.items()}, main)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"lm train: losses {losses} are not finite and falling")
    step_ms = float(np.median(walls[1:])) * 1e3
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    events = device_times(prof)
    busy = sum(d for d, _, _ in events) / 1e3
    fwd = [(d, c) for d, key, c in events
           if TRACE_TAGS["flash_attention"] in key and "fa_bwd_" not in key]
    bwd = [(d, c) for d, key, c in events if TRACE_TAGS["flash_attention_bwd"] in key]
    peak = torch.cuda.max_memory_allocated()
    say(f"[train] gemma2-2b bf16 train step B=1 S={S} ({L} layers, remat, AdamW): losses "
        f"{', '.join(f'{x:.4f}' for x in losses)} over {TRAIN_STEPS} steps on one batch; "
        f"{step_ms:.1f} ms/step (median of steps 2-{TRAIN_STEPS}), {S / step_ms * 1e3:.0f} "
        f"tokens/s; {per_step} launches a step; peak {peak / 2**30:.2f} GiB allocated on {smi}")
    share = f"{busy / step_ms:.4f}" if busy else "not measured"
    say(f"[trace] gemma2-2b train step: device busy {busy:.1f} ms of {step_ms:.1f} ms untraced "
        f"wall, busy share {share}; flash_attention forward {sum(d for d, _ in fwd) / 1e3:.1f} "
        f"ms in {sum(c for _, c in fwd)} launches, backward "
        f"{sum(d for d, _ in bwd) / 1e3:.1f} ms in {sum(c for _, c in bwd)} kernels")
    for d, key, count in events[:8]:
        say(f"[trace]   {d / 1e3:9.3f} ms  {count:5d} x  {key[:90]}")
    del model, state, step, prof
    torch.cuda.empty_cache()

    # -- (c) FM's sparse step at full width; DIN, BST and MIND ------------------
    rng = np.random.default_rng(seed)
    fm_batches = []
    for _ in range(FM_TRAIN_STEPS):
        feats, labels = recsys_batch(fm_cfg, B_fm, rng)
        fm_batches.append({"feats": {k: torch.from_numpy(v).to(dev) for k, v in feats.items()},
                           "labels": torch.from_numpy(labels).to(dev)})
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=FM_TRAIN_STEPS)
    routes = {}
    for route, use_kernel in (("kernel", None), ("plain", False)):
        fm = MODEL_CLS["fm"](dataclasses.replace(fm_cfg, use_kernel=use_kernel), device=dev,
                             seed=seed)
        st = init_train_state(dict(fm.named_parameters()))
        fm_step = make_fm_sparse_train_step(fm, opt)
        rec = {"losses": [], "walls": []}

        def run(fm_step=fm_step, st=st, rec=rec):
            for b in fm_batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, m = fm_step(st, b)
                rec["losses"].append(float(m["loss"]))
                rec["walls"].append(time.perf_counter() - t0)
            return st

        want = ({"fm_pairwise": FM_TRAIN_STEPS, "fm_pairwise_bwd": FM_TRAIN_STEPS}
                if route == "kernel" else {})
        rec["state"] = counted(run, want, main if route == "kernel" else None)
        routes[route] = rec
        del fm
    ks, ps = routes["kernel"]["state"], routes["plain"]["state"]
    worst = {}
    for what, a, b in (("tables", ks.params["tables"], ps.params["tables"]),
                       ("linear", ks.params["linear"], ps.params["linear"]),
                       ("mu tables", ks.opt["mu"]["tables"], ps.opt["mu"]["tables"]),
                       ("nu tables", ks.opt["nu"]["tables"], ps.opt["nu"]["tables"]),
                       ("mu linear", ks.opt["mu"]["linear"], ps.opt["mu"]["linear"]),
                       ("nu linear", ks.opt["nu"]["linear"], ps.opt["nu"]["linear"])):
        a, b = a.detach(), b.detach()
        atol = FM_TRAIN_TOL * float(b.abs().max())
        worst[what] = float(((a - b).abs() / (atol + FM_TRAIN_TOL * b.abs())).max())
        if worst[what] > 1.0:
            fail(f"fm sparse train: {what} differ from the plain route beyond rtol "
                 f"{FM_TRAIN_TOL} (worst element at {worst[what]:.3g} of the tolerance)")
    kl, pl = routes["kernel"]["losses"], routes["plain"]["losses"]
    if not all(math.isfinite(x) and abs(x - y) <= FM_TRAIN_TOL * abs(y) for x, y in zip(kl, pl)):
        fail(f"fm sparse train: losses {kl} vs the plain route's {pl}")
    fm_ms = {r: float(np.median(routes[r]["walls"])) * 1e3 for r in routes}
    say(f"[train] fm sparse step B={B_fm} ({fm_cfg.n_sparse} x {fm_cfg.field_vocab} x "
        f"{fm_cfg.embed_dim}, "
        f"Zipf ids), {FM_TRAIN_STEPS} steps: kernel route {fm_ms['kernel']:.2f} ms/step "
        f"(one fm_pairwise and one fm_pairwise_bwd a step), plain route {fm_ms['plain']:.2f} "
        f"ms/step; losses {', '.join(f'{x:.6f}' for x in kl)} equal the plain route's within "
        f"rtol {FM_TRAIN_TOL}; tables, linear and their moments within rtol {FM_TRAIN_TOL} "
        f"(worst element at {max(worst.values()):.3g} of the tolerance) on {smi}")
    del routes, ks, ps
    torch.cuda.empty_cache()
    for kind in ("din", "bst", "mind"):
        rcfg = get_arch(kind).cfg
        m = MODEL_CLS[kind](rcfg, device=dev, seed=seed)
        st = init_train_state(dict(m.named_parameters()))
        feats, labels = recsys_batch(rcfg, 4096, rng)
        b = {"feats": {k: torch.from_numpy(v).to(dev) for k, v in feats.items()},
             "labels": torch.from_numpy(labels).to(dev)}
        rstep = make_recsys_train_step(m, AdamWConfig(lr=1e-3))
        t0 = time.perf_counter()
        _, met = counted(lambda: rstep(st, b), {})
        loss = float(met["loss"])
        if not math.isfinite(loss):
            fail(f"{kind} train step: loss {loss}")
        say(f"[train] {kind} dense step B=4096 at full width: loss {loss:.6f}, "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms (the first), no kernel launched")
        del m, st, rstep
        torch.cuda.empty_cache()

    # -- (d) the training launcher's drill ---------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = launch_train.main(["--arch", "smollm-360m", "--steps", "30", "--drill",
                                    "--ckpt-dir", tmp])
        wall = time.perf_counter() - t0
    done = [ln for ln in buf.getvalue().splitlines() if ln.startswith("done: ")]
    m = re.search(r"restarts=(\d+),.* loss ([\d.]+) -> ([\d.]+) on (\w+)", done[0]) if done else None
    if rc != 0 or not m or int(m.group(1)) != 1 or not float(m.group(3)) < float(m.group(2)) \
            or m.group(4) != dev.type:
        fail(f"launch.train --drill: {buf.getvalue()[-600:]}")
    say(f"[train] python -m repro_torch.launch.train --arch smollm-360m --steps 30 --drill in "
        f"process: {done[0]} ({wall:.1f} s wall); phase took "
        f"{time.perf_counter() - t_phase:.1f} s on {smi}")
    return main


# --------------------------------------------------------------------------
# phase 12: the MoE archs
# --------------------------------------------------------------------------
# Routing flips: a bf16 (or fp32) rounding difference between the kernel
# route and the plain route can flip a near-tie expert choice, and through
# the experts' capacity that moves other tokens too. So each parity check
# runs three routes: the kernel route (its routing recorded), the plain
# route routing itself (the choices that differ are counted, and the
# logits held only on the sequences whose routing agreed in every layer,
# with no drop in a layer where any choice differed), and the plain route
# replaying the kernel route's expert choices (gates from its own router):
# there every logit is held, so a flip neither hides a fault nor fails a
# sound kernel.
MOE_BF16_TOL = dict(rtol=5e-2, atol=0.25)   # LM_BF16_TOL, gemma2's bf16 floor x 1.5: reported
MOE_FP32_TOL = dict(rtol=1e-3, atol=1e-3)   # LM_FP32_TOL
# In bf16 the check is lm_phase's floor rule, measured on each call: the
# plain route with fp32 activations on the same bf16 weights, routed by the
# kernel route's choices, is the reference; the kernel route must be within
# MOE_FLOOR_X x the bf16 plain route's own distance from it (the floor), and
# a control reading FLASH_DROP cache columns too few in every decode
# attention must not be. qwen2-moe's 24 bf16 layers carry more rounding to
# the logits than gemma2's did: a sound decode step read 0.336 against the
# replayed plain route, beyond MOE_BF16_TOL's atol.
MOE_FLOOR_X = 1.5
MOE_CACHE = 4096            # decode's cache: 16 x 32,768 rows of qwen2-moe's is 103 GB
MOE_PAR_SEQ = 4096          # the parity prefills' and qwen3-moe's sequence
MOE_B_DEC = 16
MOE_DEC_STEPS = 32          # timed decode steps
QWEN3_MOE_LAYERS = 4        # of 94: one layer holds 4.98 GB of bf16 weights
MOE_TRAIN_LAYERS = 4        # of qwen2-moe's 24 in the train step (AdamW's fp32 moments)
MOE_TRAIN_STEPS = 3


class RouteLog:
    """Wraps ``model._route`` while open: records each layer's (idx, gates,
    aux), keyed by the layer's router storage (a recompute under remat
    writes the same layer again); with ``replay``, routes every layer by
    that log's idx, its gates taken from this route's own router."""

    def __init__(self, torch, model, replay=None):
        self.torch, self.model, self.replay, self.seen = torch, model, replay, {}

    def __enter__(self):
        torch, orig, m = self.torch, self.model._route, self.model.cfg.moe

        def route(lp, h2d):
            key = lp["router"].data_ptr()
            idx, gates, aux = orig(lp, h2d)
            if self.replay is not None:
                idx = self.replay.seen[key][0]
                probs = torch.softmax(h2d.float() @ lp["router"], dim=-1)
                gates = probs.gather(1, idx)
                if m.norm_topk:
                    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
            self.seen[key] = (idx.detach(), gates, aux.detach())
            return idx, gates, aux

        self.model._route = route
        return self

    def __exit__(self, *exc):
        del self.model._route

    def aux(self):
        return sum(float(a) for _, _, a in self.seen.values())


def route_agreement(torch, a, b, rows, capacity, n_experts):
    """(choices that differ, [sequence b agreed in every layer]) between two
    RouteLogs of one call; ``rows`` [(lo, hi)] are each sequence's token rows.
    A layer where any choice differs and either route dropped a token breaks
    every sequence (capacity couples them)."""
    diff, ok = 0, [True] * len(rows)
    for key, (ia, _, _) in a.seen.items():
        ib = b.seen[key][0]
        bad = ia != ib
        n = int(bad.sum())
        diff += n
        drops = any(int(torch.bincount(i.reshape(-1), minlength=n_experts).max()) > capacity
                    for i in (ia, ib))
        for s, (lo, hi) in enumerate(rows):
            if (n and drops) or bool(bad[lo:hi].any()):
                ok[s] = False
    return diff, ok


def moe_phase(torch, dev, seed, smi, reset_counts, read_counts) -> dict:
    """qwen2-moe-a2.7b at full width (24 layers, 60 experts padded to 64,
    top-4, the shared expert) served in bf16: prefill at B=1, S=32,768,
    decode at B=16 against a 4,096-token cache, each held against the plain
    route (``RouteLog``), traced, with peak memory; the fp32 check at 2
    layers; qwen3-moe-235b-a22b at full width and 4 of 94 layers; the MoE
    train step at 4 layers. Returns the launch counts of the main paths:
    {"moe": one bf16 prefill_step and one decode_step of qwen2-moe,
    "moe_train": its counted train steps}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.configs.lm_common import LM_SHAPES
    from repro_torch.data import TokenStream
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.transformer import TransformerLM, moe_capacity
    from repro_torch.optim import AdamWConfig
    from repro_torch.serve.lm import prefill_step
    from repro_torch.train import init_train_state, make_lm_train_step

    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed)
    S = LM_SHAPES["prefill_32k"]["seq"]
    S_train = LM_SHAPES["train_4k"]["seq"]
    B = MOE_B_DEC
    base = get_arch("qwen2-moe-a2.7b").cfg
    stream = TokenStream.synthetic(vocab=base.vocab, n_docs=400, seed=seed)
    if len(stream.tokens) < 4 * S + S_train + 1:
        fail(f"the token stream holds {len(stream.tokens)} tokens")
    counts = {"moe": {}, "moe_train": {}}
    main_run = counter(torch, reset_counts, read_counts, "flash_attention", "moe",
                       counts["moe"])
    check_run = counter(torch, reset_counts, read_counts, "flash_attention", "moe")
    rng = np.random.default_rng(seed)

    def gib(n):
        return f"{n / 2**30:.2f} GiB"

    def toks_of(B_, S_, off=0):
        n = B_ * S_
        return torch.from_numpy(stream.tokens[off:off + n].reshape(B_, S_).copy()).to(dev)

    fill = functools.partial(fill_cache, torch, g)

    def use(model, base, flash):
        model.cfg = dataclasses.replace(base, use_flash=flash)

    def route_cfg(base, route):
        """The config of a parity route: the kernel route, or the plain one
        (``floor``: fp32 activations on the same bf16 weights)."""
        flash = None if route in ("kernel", "short") else False
        cfg = dataclasses.replace(base, use_flash=flash)
        return dataclasses.replace(cfg, dtype=torch.float32) if route == "floor" else cfg

    def judge(base, outs, rk, diff, ok, what):
        """Holds one call's routes (see MOE_BF16_TOL); ``ok``: the sequences
        whose routing agreed. Returns its record."""
        held = [s for s, k in enumerate(ok) if k]
        k, p, r = outs["kernel"], outs["plain"], outs["replay"]
        if not bool(torch.isfinite(k).all()):
            fail(f"moe {what}: the kernel route's logits are not finite")
        rec = {"choices_differing": diff, "choices": sum(i.numel() for i, _, _ in
                                                         rk.seen.values()),
               "agreeing": len(held), "sequences": len(ok),
               "kernel_vs_replay": float((k - r).abs().max()),
               "kernel_vs_plain_agreeing": float((k[held] - p[held]).abs().max())
               if held else None}
        if base.dtype == torch.float32:
            if not torch.allclose(k, r, **MOE_FP32_TOL) or (
                    held and not torch.allclose(k[held], p[held], **MOE_FP32_TOL)):
                fail(f"moe {what}: the kernel and the plain route differ: {rec}")
            verdict = f"within {MOE_FP32_TOL} on the replay and the agreeing sequences"
        else:
            f = outs["floor"]
            rec.update(floor=float((r - f).abs().max()), kernel_vs_floor=float((k - f).abs().max()))
            if "short" in outs:
                rec["control"] = float((outs["short"] - f).abs().max())
                if not rec["control"] > MOE_FLOOR_X * rec["floor"]:
                    fail(f"moe {what}: the check passes a kernel {FLASH_DROP} columns short: {rec}")
            if not rec["kernel_vs_floor"] <= MOE_FLOOR_X * rec["floor"]:
                fail(f"moe {what}: the kernel route is {rec['kernel_vs_floor']:.3g} from the "
                     f"fp32-activation plain route, beyond {MOE_FLOOR_X} x the bf16 plain "
                     f"route's {rec['floor']:.3g}: {rec}")
            rec["agreeing_within_atol_0.25"] = bool(
                held and torch.allclose(k[held], p[held], **MOE_BF16_TOL)) if held else None
            verdict = (f"kernel route {rec['kernel_vs_floor']:.3g} from the fp32-activation "
                       f"plain route (the kernel's choices), within {MOE_FLOOR_X} x the bf16 "
                       f"plain route's floor {rec['floor']:.3g}"
                       + (f"; control ({FLASH_DROP} cache columns short) {rec['control']:.3g}, "
                          f"rejected" if "control" in rec else "")
                       + f"; kernel vs bf16 plain on the agreeing sequences within "
                       f"{MOE_BF16_TOL}: {rec['agreeing_within_atol_0.25']}")
        say(f"[moe] {what}: {diff} of {rec['choices']} expert choices differ between the "
            f"kernel and the plain route; {len(held)} of {len(ok)} sequences agreed in every "
            f"layer; max |logit diff|: kernel vs plain on the kernel's choices "
            f"{rec['kernel_vs_replay']:.3g}, on the agreeing sequences "
            f"{'n/a' if not held else format(rec['kernel_vs_plain_agreeing'], '.3g')}; "
            f"{verdict}")
        return rec

    def prefill_parity(model, base, toks, L, what):
        """One ``prefill_step`` through every parity route (RouteLog)."""
        routes = ("kernel", "plain", "replay") + (("floor",) if base.dtype != torch.float32
                                                  else ())
        outs, logs = {}, {}
        for route in routes:
            model.cfg = route_cfg(base, route)
            replay = logs["kernel"] if route in ("replay", "floor") else None
            with RouteLog(torch, model, replay=replay) as log:
                outs[route] = check_run(lambda: prefill_step(model, toks),
                                        L if route == "kernel" else 0)
            logs[route] = log
        model.cfg = base
        B_, S_ = toks.shape
        diff, ok = route_agreement(torch, logs["kernel"], logs["plain"],
                                   [(b * S_, (b + 1) * S_) for b in range(B_)],
                                   moe_capacity(B_ * S_, base.moe), base.moe.n_experts)
        return judge(base, outs, logs["kernel"], diff, ok, what)

    def trace(fn, wall, what, L, layer_fn=None):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = device_times(prof)
        busy = sum(d for d, _, _ in events) / 1e3
        launches = sum(c for _, _, c in events)
        att = [(d, c) for d, key, c in events if TRACE_TAGS["flash_attention"] in key]
        moe_ms = moe_launches = None
        if layer_fn is not None:    # one layer's MoE block alone, on its input from the call
            with torch.inference_mode():
                us, moe_launches = call_device_us(torch, layer_fn, 5)
            moe_ms = us / 1e3 * L
        share = f"{busy / wall:.4f}" if busy else "not measured"
        say(f"[trace] moe {what}: device busy {busy:.2f} ms of {wall:.2f} ms untraced wall, "
            f"busy share {share}; {launches} device launches; flash_attention "
            f"{sum(d for d, _ in att) / 1e3:.2f} ms in {sum(c for _, c in att)} launches"
            + (f"; the MoE block (router, experts, shared expert) {moe_ms:.2f} ms "
               f"({moe_launches:.0f} launches a layer x {L} layers; one layer traced alone "
               f"over 5 calls after a warm-up step)"
               if moe_ms is not None else "") + f" on {smi}")
        for d, key, count in events[:8]:
            say(f"[trace]   {d / 1e3:9.3f} ms  {count:5d} x  {key[:90]}")
        return {"busy_ms": busy, "share": busy / wall if busy else None, "launches": launches,
                "flash_ms": sum(d for d, _ in att) / 1e3, "moe_block_ms": moe_ms,
                "moe_block_launches_per_layer": moe_launches}

    def capture_mlp_input(model):
        """The first MoE block's (lp, x) of the next call."""
        got, orig = {}, model._moe_mlp

        def grab(lp, x):
            if "args" not in got:
                got["args"] = (lp, x.clone())
            return orig(lp, x)
        model._moe_mlp = grab
        return got

    def seeded_cache(model, n, pos, cache_seed, dtype):
        """``model.init_cache(len(pos), n)`` in the model's current dtype,
        every row drawn as ``fill_cache`` draws it in ``dtype`` from a
        generator seeded with ``cache_seed`` (a wider cache holds the same
        values), its rows at ``pos``: each call gives the same cache."""
        cache = model.init_cache(len(pos), n)
        gen = torch.Generator(device=dev).manual_seed(cache_seed)
        with torch.inference_mode():
            for t in (*cache["k"], *cache["v"]):
                if t.dtype == dtype:
                    t.normal_(generator=gen).mul_(0.02)
                else:
                    t.copy_(torch.empty(t.shape, dtype=dtype, device=dev)
                            .normal_(generator=gen).mul_(0.02))
            cache["pos"].copy_(torch.tensor(pos, dtype=torch.int32))
        return cache

    def decode_parity(model, base, n, pos, cache_seed, tok, steps, L, what):
        """``steps`` decode steps of the kernel route from a ``seeded_cache``
        of ``n`` tokens, its expert choices, logits and tokens kept; then
        each other route in turn over the same steps, on the same cache made
        anew (fp32 for the floor route), fed the kernel route's tokens; the
        control (bf16: every attention FLASH_DROP cache columns short) at
        the first step. One cache is alive at a time. A row whose routing
        differed once leaves the agreeing rows (its cache then differs)."""
        bf16 = base.dtype != torch.float32
        routes = ("kernel", "plain", "replay") + (("floor", "short") if bf16 else ())
        Bd = tok.shape[0]
        toks, outs, logs = [tok], [{} for _ in range(steps)], [{} for _ in range(steps)]
        orig = fa_ops.flash_decode
        for route in routes:
            model.cfg = route_cfg(base, route)
            cache = seeded_cache(model, n, pos, cache_seed, base.dtype)
            if route == "short":
                fa_ops.flash_decode = lambda q, k, v, kv_len, **kw: orig(
                    q, k, v, torch.clamp(kv_len - FLASH_DROP, min=1), **kw)
            try:
                for step in range(1 if route == "short" else steps):
                    replay = (logs[step]["kernel"] if route in ("replay", "floor", "short")
                              else None)
                    with RouteLog(torch, model, replay=replay) as log:
                        outs[step][route], cache = check_run(
                            functools.partial(model.decode_step, cache, toks[step]),
                            L if route in ("kernel", "short") else 0)
                    logs[step][route] = log
                    if route == "kernel":
                        toks.append(outs[step]["kernel"].argmax(-1))
            finally:
                fa_ops.flash_decode = orig
                model.cfg = base
            del cache
            torch.cuda.empty_cache()
        alive, recs = list(range(Bd)), []
        for step in range(steps):
            diff, ok = route_agreement(torch, logs[step]["kernel"], logs[step]["plain"],
                                       [(b, b + 1) for b in range(Bd)],
                                       moe_capacity(Bd, base.moe), base.moe.n_experts)
            alive = [b for b in alive if ok[b]]
            recs.append(judge(base, outs[step], logs[step]["kernel"], diff,
                              [b in alive for b in range(Bd)],
                              f"{what} decode step {step} at B={Bd}"))
        return recs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- qwen2-moe, fp32 at 2 layers: kernel route vs plain route -------------------
    cfg32 = dataclasses.replace(base, n_layers=2, dtype=torch.float32, param_dtype=torch.float32)
    model = TransformerLM(cfg32, device=dev, seed=seed)
    S32 = MOE_PAR_SEQ
    t = toks_of(2, S32)
    prefill_parity(model, cfg32, t, 2, f"qwen2-moe fp32 (2 layers, no TF32) prefill_step "
                   f"B=2 S={S32}")
    pos32 = [S32 - 8, S32 // 4]
    decode_parity(model, cfg32, S32, pos32, seed + 1, toks_of(1, 2, off=10_000)[0], 4, 2,
                  f"qwen2-moe fp32 (2 layers) from pos {pos32} of a {S32}-token cache,")
    del model
    torch.cuda.empty_cache()

    # -- qwen2-moe at full width in bf16 ---------------------------------------------
    cfg = base
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    model = TransformerLM(cfg, device=dev, seed=seed)
    w_bytes = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    n_params = sum(t.numel() for t in model.state_dict().values())
    toks = toks_of(1, S)
    t_pre = median_ms(torch, lambda: prefill_step(model, toks), 3)
    logits = main_run(lambda: prefill_step(model, toks), L)
    if logits.shape != (1, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        fail(f"moe prefill: logits of shape {tuple(logits.shape)}")
    say(f"[moe] qwen2-moe-a2.7b bf16 at full width ({L} layers, d_model {cfg.d_model}, "
        f"{cfg.moe.n_experts} experts padded to {cfg.moe.e_padded}, top-{cfg.moe.top_k}, shared "
        f"expert {cfg.moe.shared_d_ff}, vocab {cfg.vocab}): {n_params / 1e9:.2f}B parameters, "
        f"{gib(w_bytes)}; prefill_step B=1 S={S}: {t_pre:.2f} ms "
        f"(median of 3), {S / t_pre * 1e3:.0f} tokens/s, {L} flash_attention launches, "
        f"capacity {moe_capacity(S, cfg.moe)} a expert, on {smi}")
    grab = capture_mlp_input(model)
    pre_trace = trace(lambda: prefill_step(model, toks), t_pre, f"prefill_step B=1 S={S}", L,
                      lambda: model._moe_mlp(*grab["args"]))
    del model._moe_mlp
    S_par = MOE_PAR_SEQ
    tp = toks_of(2, S_par, off=S)
    pre_rec = prefill_parity(model, cfg, tp, L, f"qwen2-moe bf16 prefill_step B=2 S={S_par}")
    del grab, toks
    torch.cuda.empty_cache()

    tok = toks_of(1, B, off=S + 2 * S_par)[0]
    dec_pos = rng.integers(MOE_CACHE // 2, MOE_CACHE - MOE_CACHE // 64, B)
    dec_recs = decode_parity(model, cfg, MOE_CACHE, dec_pos.tolist(), seed + 2, tok, 4, L,
                             f"qwen2-moe bf16 against a {MOE_CACHE}-token cache,")
    cache = fill(model.init_cache(B, MOE_CACHE), dec_pos.tolist())
    c_bytes = sum(t.numel() * t.element_size() for t in (*cache["k"], *cache["v"]))
    got, cache = main_run(functools.partial(model.decode_step, cache, tok), L)
    nxt = got.argmax(-1)
    torch.cuda.synchronize()
    walls = []
    for _ in range(MOE_DEC_STEPS):
        t0 = time.perf_counter()
        logits, cache = model.decode_step(cache, nxt)
        nxt = logits.argmax(-1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    t_dec = float(np.median(walls)) * 1e3
    say(f"[moe] qwen2-moe bf16 decode_step B={B} against a {MOE_CACHE}-token cache (rows at "
        f"pos {int(dec_pos.min())}..{int(dec_pos.max())}; decode_32k's 32,768 cut: 16 x 32,768 "
        f"rows are 103 GB): {t_dec:.2f} ms/step (median of {MOE_DEC_STEPS}), "
        f"{B / t_dec * 1e3:.0f} tokens/s, capacity {moe_capacity(B, cfg.moe)} a expert, "
        f"{L} flash_attention launches a step, on {smi}")
    grab = capture_mlp_input(model)
    dec_trace = trace(lambda: model.decode_step(cache, nxt), t_dec,
                      f"decode_step B={B} against {MOE_CACHE}", L,
                      lambda: model._moe_mlp(*grab["args"]))
    del model._moe_mlp, grab
    peak = torch.cuda.max_memory_allocated()
    say(f"[moe] qwen2-moe bf16: {gib(w_bytes)} of weights, {gib(c_bytes)} of cache at "
        f"B={B} x {MOE_CACHE}, peak {gib(peak)} allocated; main-path launches {counts['moe']}")
    del model, cache, logits
    torch.cuda.empty_cache()

    # -- qwen3-moe-235b-a22b at full width, 4 of 94 layers ----------------------------
    cfg3 = dataclasses.replace(get_arch("qwen3-moe-235b-a22b").cfg, n_layers=QWEN3_MOE_LAYERS)
    L3 = cfg3.n_layers
    torch.cuda.reset_peak_memory_stats()
    model = TransformerLM(cfg3, device=dev, seed=seed)
    w3 = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    t3 = toks_of(1, MOE_PAR_SEQ, off=3 * S)
    t_pre3 = median_ms(torch, lambda: prefill_step(model, t3), 3)
    q3_pre = prefill_parity(model, cfg3, t3, L3, f"qwen3-moe bf16 ({L3} of 94 layers) "
                            f"prefill_step B=1 S={MOE_PAR_SEQ}")
    q3_dec = decode_parity(model, cfg3, MOE_CACHE, dec_pos.tolist(), seed + 3, tok, 8, L3,
                           f"qwen3-moe bf16 ({L3} of 94 layers)")
    cache3 = fill(model.init_cache(B, MOE_CACHE), dec_pos.tolist())
    t_dec3 = median_ms(torch, lambda: model.decode_step(cache3, tok), 8)
    say(f"[moe] qwen3-moe-235b-a22b bf16 at full width, {L3} of 94 layers (one layer holds "
        f"4.98 GB; all 94 ~468 GB), 128 experts top-8 norm_topk, qk-norm, GQA 64/4 (rep 16 in "
        f"the decode kernel): {gib(w3)} of weights; prefill_step B=1 S={MOE_PAR_SEQ} {t_pre3:.2f} ms "
        f"(median of 3), decode_step B={B} against {MOE_CACHE} {t_dec3:.2f} ms (median of 8), "
        f"peak {gib(torch.cuda.max_memory_allocated())} on {smi}")
    del model, cache3
    torch.cuda.empty_cache()

    # -- the MoE train step: qwen2-moe at full width, 4 of 24 layers ----------------------
    counted = counted_exact(torch, reset_counts, read_counts, "moe train")

    def grads(model, base, flash, replay=None):
        model.cfg = dataclasses.replace(base, use_flash=flash)
        try:
            with RouteLog(torch, model, replay=replay) as log:
                loss = model.loss_fn(batch["tokens"], batch["targets"], batch["mask"])
                gr = torch.autograd.grad(loss, list(model.parameters()))
            return loss.detach(), gr, log
        finally:
            model.cfg = base

    def hold_grads(model, base, loss_tol, grad_tol, what):
        """Loss and gradients, kernel route vs the plain route on the
        kernel's routing; the kernel route twice, bit for bit."""
        per = {"flash_attention": 2 * base.n_layers, "flash_attention_bwd": base.n_layers}
        lk, gk, logk = counted(lambda: grads(model, base, None), per)
        lp, gp, _ = counted(lambda: grads(model, base, False, logk), {})
        names = [n for n, _ in model.named_parameters()]
        errs = {n: rel_norm(torch, a, b) for n, a, b in zip(names, gk, gp)}
        worst = max(errs, key=errs.get)
        if not (math.isfinite(float(lk)) and abs(float(lk) - float(lp)) <= loss_tol
                * max(1.0, abs(float(lp))) and errs[worst] <= grad_tol):
            fail(f"moe train {what}: kernel route loss {float(lk)} vs plain {float(lp)} on "
                 f"the kernel's routing, worst gradient {worst} at {errs[worst]:.3g}")
        del gp
        lk2, gk2, _ = counted(lambda: grads(model, base, None), per)
        if not (torch.equal(lk, lk2) and all(torch.equal(a, b) for a, b in zip(gk, gk2))):
            fail(f"moe train {what}: two loss-and-gradient passes differ")
        aux_term = base.moe.aux_coef * logk.aux() / base.n_layers
        say(f"[train] qwen2-moe {what} B=1 S={S_train} (full width, remat): loss "
            f"{float(lk):.6f} (the aux term {aux_term:.6f}, {aux_term / float(lk):.4%} of "
            f"it) vs the plain route on the kernel's routing {float(lp):.6f}; ||g_kernel - "
            f"g_plain|| / ||g_plain|| at most {errs[worst]:.3g} ({worst}) within {grad_tol}, "
            f"median {float(np.median(list(errs.values()))):.3g}; two passes bit-identical; "
            f"{per} launches a pass, on {smi}")
        return float(lk), aux_term

    tt = toks_of(1, S_train + 1, off=4 * S)[0]
    batch = {"tokens": tt[None, :S_train], "targets": tt[None, 1:],
             "mask": torch.ones((1, S_train), device=dev)}
    cfg_t32 = dataclasses.replace(base, n_layers=2, dtype=torch.float32,
                                  param_dtype=torch.float32)
    model = TransformerLM(cfg_t32, device=dev, seed=seed)
    hold_grads(model, cfg_t32, LM_TRAIN_FP32_TOL, LM_TRAIN_FP32_TOL, "fp32 (2 layers, no TF32)")
    del model
    torch.cuda.empty_cache()
    cfg_t = dataclasses.replace(base, n_layers=MOE_TRAIN_LAYERS)
    Lt = cfg_t.n_layers
    torch.cuda.reset_peak_memory_stats()
    model = TransformerLM(cfg_t, device=dev, seed=seed)
    per_step = {"flash_attention": 2 * Lt, "flash_attention_bwd": Lt}   # remat: twice forward
    loss0, aux_term = hold_grads(model, cfg_t, LM_TRAIN_LOSS_TOL, LM_TRAIN_GRAD_TOL,
                                 f"bf16 ({Lt} of 24 layers)")
    torch.cuda.empty_cache()
    opt = AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=MOE_TRAIN_STEPS + 2)
    start = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
    after = []
    state = None
    for _ in range(2):      # one step twice from the same start: the same bytes
        state = None        # the fp32 moments are 24 GB: free the last ones first
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])
        state = init_train_state(dict(model.named_parameters()))
        step = make_lm_train_step(model, opt)
        _, met = step(state, batch)
        after.append((float(met["loss"]), {n: p.detach().to("cpu", copy=True)
                                           for n, p in model.named_parameters()}))
    if after[0][0] != after[1][0] or not all(torch.equal(after[0][1][n], after[1][1][n])
                                             for n in start):
        fail("moe train: one AdamW step from the same start gives other parameters twice")
    del start, after
    losses, walls = [], []

    def train_steps():
        nonlocal state
        for _ in range(MOE_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            walls.append(time.perf_counter() - t0)

    counted(train_steps, {k: MOE_TRAIN_STEPS * c for k, c in per_step.items()},
            counts["moe_train"])
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"moe train: losses {losses} are not finite and falling")
    step_ms = float(np.median(walls[1:])) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    events = device_times(prof)
    busy = sum(d for d, _, _ in events) / 1e3
    fwd = sum(d for d, key, _ in events if TRACE_TAGS["flash_attention"] in key
              and "fa_bwd_" not in key) / 1e3
    bwd = sum(d for d, key, _ in events if TRACE_TAGS["flash_attention_bwd"] in key) / 1e3
    peak_t = torch.cuda.max_memory_allocated()
    say(f"[train] qwen2-moe bf16 train step ({Lt} of 24 layers, AdamW, remat) B=1 S={S_train}: "
        f"losses {', '.join(f'{x:.4f}' for x in losses)} over {MOE_TRAIN_STEPS} steps on one "
        f"batch, one step twice from one start bit-identical; {step_ms:.1f} ms/step (median "
        f"of steps 2-{MOE_TRAIN_STEPS}), {S_train / step_ms * 1e3:.0f} tokens/s; {per_step} "
        f"launches a step; peak {gib(peak_t)}; traced step: busy {busy:.1f} ms (share "
        f"{f'{busy / step_ms:.4f}' if busy else 'not measured'}), flash_attention forward "
        f"{fwd:.1f} ms, backward {bwd:.1f} ms, "
        f"{sum(c for _, _, c in events)} device launches, on {smi}")
    for d, key, count in events[:8]:
        say(f"[trace]   {d / 1e3:9.3f} ms  {count:5d} x  {key[:90]}")
    del model, state, step, prof
    torch.cuda.empty_cache()
    say(f"[moe] summary: {json.dumps({'prefill_ms': t_pre, 'prefill_tokens_per_s': S / t_pre * 1e3, 'decode_ms': t_dec, 'decode_tokens_per_s': B / t_dec * 1e3, 'prefill_parity': pre_rec, 'decode_parity': dec_recs, 'qwen3_prefill_parity': q3_pre, 'qwen3_decode_parity': q3_dec, 'prefill_trace': pre_trace, 'decode_trace': dec_trace, 'peak_gib': peak / 2**30, 'qwen3_prefill_ms': t_pre3, 'qwen3_decode_ms': t_dec3, 'train_step_ms': step_ms, 'train_tokens_per_s': S_train / step_ms * 1e3, 'train_aux_share': aux_term / loss0, 'train_peak_gib': peak_t / 2**30})}; phase took "
        f"{time.perf_counter() - t_phase:.1f} s on {smi}")
    return counts


# --------------------------------------------------------------------------
# phase 13: MACE
# --------------------------------------------------------------------------
MACE_SHAPES = ("molecule", "full_graph_sm", "minibatch_lg")
MACE_CPU_SHAPES = ("molecule", "full_graph_sm")    # also stepped on the host's CPU
MACE_TOL = 1e-4             # loss, and each gradient and parameter norm-relative
MACE_STEPS = 4
# minibatch_lg's source graph: GNN_SHAPES' 114,615,892 edges took 40.2 s to
# build on the card's host (``random_graph`` and ``build_csr``), past the 40 s
# allowed, so it is cut to half; the padded shape (172,032 nodes, 169,984
# edges) stays, and the sample from 1,024 seeds at fanout (15, 10) fills it
# as sparsely either way (the Zipf in-degrees leave most seeds a few edges).
MACE_LG_EDGES = 57_307_946


def mace_batch(torch, shape, seed, dev):
    """A padded batch of GNN_SHAPES' ``shape`` from the port's
    ``data/graphs.py``, as tensors on ``dev``, and a note on its source."""
    from repro_torch.configs.gnn_common import GNN_SHAPES
    from repro_torch.data.graphs import (batch_molecules, build_csr, neighbor_sample,
                                         pad_subgraph, random_graph, synth_positions)

    s = GNN_SHAPES[shape]
    rng = np.random.default_rng(seed)
    N, E = s["pad_nodes"], s["pad_edges"]
    if shape == "molecule":
        pos, sp, nm, snd, rcv, em, gi = batch_molecules(rng, s["batch"], s["n_nodes"],
                                                        s["n_edges"], 16)
        arrays = {"positions": pos, "node_feat": sp, "node_mask": nm, "senders": snd,
                  "receivers": rcv, "edge_mask": em, "graph_ids": gi,
                  "targets": rng.normal(size=s["n_graphs"]).astype(np.float32)}
        note = (f"{s['batch']} molecules of {s['n_nodes']} atoms, {int(em.sum())} of {E} "
                f"edges real")
        return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}, note
    t0 = time.perf_counter()
    n_edges = s["n_edges"] if shape != "minibatch_lg" or MACE_LG_EDGES is None else MACE_LG_EDGES
    src, dst = random_graph(s["n_nodes"], n_edges, seed=seed)
    if shape == "full_graph_sm":
        nodes, snd, rcv = np.arange(s["n_nodes"], dtype=np.int32), src, dst
        t_src, t_sample = time.perf_counter() - t0, 0.0
        label_rows = 140                                # Cora's labelled training nodes
    else:
        indptr, indices = build_csr(src, dst, s["n_nodes"])
        t_src = time.perf_counter() - t0
        del src, dst
        t0 = time.perf_counter()
        seeds = rng.choice(s["n_nodes"], s["batch_nodes"], replace=False)
        nodes, snd, rcv = neighbor_sample(indptr, indices, seeds, s["fanout"], rng)
        t_sample = time.perf_counter() - t0
        del indptr, indices
        label_rows = s["batch_nodes"]                   # the seeds
    nodes_p, snd, rcv, em, nm = pad_subgraph(nodes, snd, rcv, N, E)
    words = rng.random((N, s["d_feat"]), dtype=np.float32) < 18 / s["d_feat"]  # ~18 a node
    arrays = {"positions": synth_positions(nodes_p), "node_feat": words.astype(np.float32)
              * nm[:, None], "node_mask": nm, "senders": snd, "receivers": rcv,
              "edge_mask": em, "graph_ids": np.zeros(N, np.int32),
              "labels": rng.integers(0, s["n_classes"], N).astype(np.int32),
              "label_mask": (np.arange(N) < label_rows).astype(np.float32)}
    note = (f"a {s['n_nodes']:,}-node / {n_edges:,}-edge source graph (host build {t_src:.1f} s"
            + (f", sampled from {s['batch_nodes']} seeds at fanout {s['fanout']} in "
               f"{t_sample:.1f} s" if t_sample else "")
            + f"): {len(nodes):,} nodes, {int(em.sum()):,} edges, padded {N:,} / {E:,}")
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}, note


def mace_phase(torch, dev, seed, smi, reset_counts, read_counts) -> dict:
    """MACE's base config (2 layers, C = 128, l_max 2, correlation 3) train
    steps at GNN_SHAPES' molecule, full_graph_sm and minibatch_lg in fp32
    (no TF32): ms per step, peak memory, busy share, one step twice from one
    start bit-identical, the loss and gradients (and the parameters after the
    step) against the same step on the CPU at the two small shapes; the
    energy's rotation invariance at molecule. No kernel of the port runs on
    this path (its products are library calls): every count stays 0."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_common import GNN_SHAPES
    from repro_torch.models.mace import GraphBatch, MACEModel
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, make_gnn_train_step

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = get_arch("mace")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=MACE_STEPS + 2)
    out = {}
    for shape in MACE_SHAPES:
        s = GNN_SHAPES[shape]
        cfg = arch.cfg_for(shape)
        t0 = time.perf_counter()
        batch, note = mace_batch(torch, shape, seed, dev)
        t_data = time.perf_counter() - t0
        host = MACEModel(cfg, device="cpu", seed=seed)     # one draw for the card and the CPU
        start = {n: p.detach().clone() for n, p in host.named_parameters()}
        model = MACEModel(cfg, device="cpu", seed=seed).to(dev)
        torch.cuda.reset_peak_memory_stats()

        def one_step(m, b):
            st = init_train_state(dict(m.named_parameters()))
            stp = make_gnn_train_step(m, opt, task=s["task"], n_graphs=s["n_graphs"])
            st, met = stp(st, b)
            return st, stp, met

        def grads_of(m, b):
            gb = GraphBatch(**{k: b[k] for k in ("positions", "node_feat", "node_mask",
                                                 "senders", "receivers", "edge_mask",
                                                 "graph_ids")}, n_graphs=s["n_graphs"])
            loss = (m.energy_force_loss(gb, b["targets"]) if s["task"] == "energy"
                    else m.node_class_loss(gb, b["labels"], b["label_mask"]))
            return loss.detach(), torch.autograd.grad(loss, list(m.parameters()))

        reset_counts()
        lk, gk = grads_of(model, batch)
        runs = []
        for _ in range(2):
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(start[n])
            state, step, met = one_step(model, batch)
            runs.append((float(met["loss"]), {n: p.detach().clone()
                                              for n, p in model.named_parameters()}))
        if runs[0][0] != runs[1][0] or not all(torch.equal(runs[0][1][n], runs[1][1][n])
                                               for n in start):
            fail(f"mace {shape}: one step twice from one start gives other bytes")
        walls = []
        for _ in range(MACE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, batch)
            float(met["loss"])
            walls.append(time.perf_counter() - t0)
        if any(c for c in read_counts().values()):
            fail(f"mace {shape}: launched {read_counts()}; its path has no kernel of the port")
        step_ms = float(np.median(walls)) * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state, met = step(state, batch)
            torch.cuda.synchronize()
        events = device_times(prof)
        busy = sum(d for d, _, _ in events) / 1e3
        peak = torch.cuda.max_memory_allocated()
        rec = {"ms": step_ms, "busy_ms": busy, "share": busy / step_ms if busy else None,
               "peak_gib": peak / 2**30, "loss": runs[0][0], "data_s": t_data,
               "launches": sum(c for _, _, c in events)}
        cpu_note = ""
        if shape in MACE_CPU_SHAPES:
            t0 = time.perf_counter()
            hb = {k: v.cpu() for k, v in batch.items()}
            lc, gc = grads_of(host, hb)
            _, _, met_c = one_step(host, hb)
            t_cpu = time.perf_counter() - t0
            names = [n for n, _ in host.named_parameters()]
            g_err = max(rel_norm(torch, a.cpu(), b) for a, b in zip(gk, gc))
            p_err = max(rel_norm(torch, runs[0][1][n].cpu(), p.detach())
                        for n, p in host.named_parameters())
            l_err = abs(float(lk) - float(lc)) / max(abs(float(lc)), 1e-30)
            if not (l_err <= MACE_TOL and g_err <= MACE_TOL and p_err <= MACE_TOL
                    and abs(runs[0][0] - float(met_c["loss"])) <= MACE_TOL * abs(float(lc))):
                fail(f"mace {shape}: card vs CPU: loss {float(lk)} vs {float(lc)}, gradients "
                     f"{g_err:.3g}, parameters after a step {p_err:.3g} (tolerance {MACE_TOL})")
            rec.update(cpu_loss_rel=l_err, cpu_grad_rel=g_err, cpu_param_rel=p_err, cpu_s=t_cpu)
            cpu_note = (f"; against the same step on the CPU ({t_cpu:.1f} s): loss {l_err:.3g}, "
                        f"gradients {g_err:.3g}, parameters after it {p_err:.3g}, norm-relative, "
                        f"within {MACE_TOL} ({len(names)} tensors)")
        if shape == "molecule":        # E(3): the energy does not turn with the molecule
            q, _ = np.linalg.qr(np.random.default_rng(seed + 1).normal(size=(3, 3)))
            R = torch.tensor(q * np.sign(np.linalg.det(q)), dtype=torch.float32, device=dev)
            fields = ("positions", "node_feat", "node_mask", "senders", "receivers",
                      "edge_mask", "graph_ids")
            gb = GraphBatch(**{k: batch[k] for k in fields}, n_graphs=s["n_graphs"])
            with torch.no_grad():
                e0 = model(gb)
                e1 = model(dataclasses.replace(gb, positions=batch["positions"] @ R.T))
            if not torch.allclose(e1, e0, rtol=2e-4, atol=1e-6):
                fail(f"mace molecule: a rotation moves the energy by "
                     f"{float((e1 - e0).abs().max())}")
            rec["rotation_max_diff"] = float((e1 - e0).abs().max())
            cpu_note += (f"; energies of {s['n_graphs']} molecules unchanged by a rotation "
                         f"within rtol 2e-4 (max |diff| {rec['rotation_max_diff']:.3g})")
        say(f"[mace] {shape} ({s['task']}; {note}; data {t_data:.1f} s): {step_ms:.2f} ms/step "
            f"(median of {MACE_STEPS}), traced step busy {busy:.2f} ms (share "
            f"{f'{busy / step_ms:.4f}' if busy else 'not measured'}) in {rec['launches']} "
            f"device launches, peak "
            f"{peak / 2**30:.2f} GiB; loss {runs[0][0]:.6f}; one step twice from one start "
            f"bit-identical{cpu_note}; on {smi}")
        for d, key, count in events[:5]:
            say(f"[trace]   {d / 1e3:9.3f} ms  {count:5d} x  {key[:90]}")
        out[shape] = rec
        del model, host, batch, state, step, runs, gk, start
        torch.cuda.empty_cache()
    o = GNN_SHAPES["ogb_products"]
    say(f"[mace] ogb_products ({o['n_nodes']:,} nodes, {o['n_edges']:,} edges, padded "
        f"{o['pad_nodes']:,} / {o['pad_edges']:,}) waits for a machine with several cards "
        f"(ROADMAP Queue A item 6c): its [E, C, 9] fp32 messages alone are "
        f"{o['pad_edges'] * 128 * 9 * 4 / 1e9:.0f} GB, more than one card's 80 GB, so it needs "
        f"edges sharded over cards; it is not cut")
    say(f"[mace] summary: {json.dumps(out)}; phase took {time.perf_counter() - t_phase:.1f} s "
        f"on {smi}")
    return out


# --------------------------------------------------------------------------
# phase 14: sharded execution
# --------------------------------------------------------------------------
# (a) a one-rank NCCL group on a (1, 1) mesh: the DTensor path at full
# width must give the unsharded logits bit for bit; (b) the expert-parallel
# bodies, rank by rank on the card; (c) compress_pod at pod 2, emulated.
SHARD_SEQ = 4096            # (a)'s prefill, and its decode cache
SHARD_FP32_SEQ = 1024       # (b)'s fp32 prefills at 2 layers
QWEN3_EP_SEQ = 2048         # (b)'s qwen3-moe prefills, B=2 (a sequence a data shard)
SHARD_B_DEC = 16
SHARD_DEC_STEPS = 4
SHARD_FP32_TOL = 1e-5       # (b) in fp32: the EP block within this of the one-process block
SHARD_FLOOR_X = 1.5         # (b) in bf16: within this many floors (MOE_FLOOR_X)
SHARD_EP = ((2, 1), (4, 1))     # qwen2-moe's (model, data)
QWEN3_EP = (4, 2)               # qwen3-moe-235b-a22b's (model, data), with moe_fsdp
POD = 2                     # (c): the pod members a ReplicaGroup plays
POD_ROUNDS = 3
POD_TRAIN_STEPS = 3
# the residual of a round is within half a quantisation step, up to the
# rounding of g / scale before its rounding to an integer (|q| <= 127 ulps)
POD_HALF_STEP_X = 1 + 1e-4


class EPRankByRank:
    """Replaces ``model._routed_experts`` (the MoE block's routed experts on
    one device) while open by the expert-parallel block run rank by rank:
    for each of ``dp`` data shards, the router on the shard's tokens, then
    each of the ``ep`` model ranks' body (``moe_ep_partial`` on its slice
    of the expert slots, the ff dim gathered from its ``fsdp`` data shards
    by concatenation) and the partials summed in rank order (in bf16 under
    ``psum_bf16`` or a bf16 model), the sum cast to the activations' dtype.
    Each block's output is held against the one-process block on the same
    choices (``experts_apply`` over every expert, the shard's own capacity),
    and in bf16 against that block with fp32 activations and weights (the
    floor rule): ``records`` gets one (distance, floor or None) a block.
    ``drop`` leaves out rank 0's partial (the control; a rank of padded
    slots alone would change nothing)."""

    def __init__(self, torch, model, ep, dp, fsdp=1, psum_bf16=False, drop=False):
        self.torch, self.model, self.ep, self.dp = torch, model, ep, dp
        self.fsdp, self.psum_bf16, self.drop, self.records = fsdp, psum_bf16, drop, []

    def __enter__(self):
        from repro_torch.models.transformer import (experts_apply, load_balance_aux,
                                                    moe_capacity, moe_ep_partial)

        torch, model, ep, dp = self.torch, self.model, self.ep, self.dp
        cfg, m = model.cfg, model.cfg.moe
        names = ("we_gate", "we_up", "we_down")
        el = m.e_padded // ep

        def block(lp, h):
            B, S, d = h.shape
            cap = moe_capacity((B // dp) * S, m)
            outs, counts, probs = [], 0, 0
            for s in range(dp):
                hs = h[s * B // dp:(s + 1) * B // dp].reshape(-1, d)
                idx, gates, (cnt, ps) = model._route(lp, hs, stats=True)
                counts, probs = counts + cnt, probs + ps
                total = None
                for r in range(1 if self.drop else 0, ep):
                    ws = [lp[n][r * el:(r + 1) * el] for n in names]
                    if self.fsdp > 1:     # the all_gather of the ff shards, written out
                        ws = [torch.cat(w.chunk(self.fsdp, dim=ff), dim=ff)
                              for w, ff in zip(ws, (2, 2, 1))]
                    part = moe_ep_partial(hs, idx, gates, *ws, rank=r, ep=ep, m=m,
                                          capacity=cap, act=cfg.act, psum_bf16=self.psum_bf16)
                    total = part if total is None else total + part
                out = total.to(h.dtype)
                E = m.n_experts
                ref = experts_apply(hs, idx, gates, *(lp[n][:E] for n in names), cap, cfg.act)
                if h.dtype == torch.float32 and not self.psum_bf16:
                    self.records.append((float((out - ref).abs().max()), None))
                else:
                    r32 = experts_apply(hs.float(), idx, gates, *(lp[n][:E].float() for n in names),
                                        cap, cfg.act)
                    self.records.append((float((out.float() - r32).abs().max()),
                                         float((ref.float() - r32).abs().max())))
                outs.append(out)
            aux = load_balance_aux(counts, probs, B * S, m)
            return torch.cat(outs).reshape(B, S, d), aux

        model._routed_experts = block
        return self

    def __exit__(self, *exc):
        del self.model._routed_experts

    def verdict(self):
        """(worst distance, its limit, whether every block passed)."""
        worst, limit, ok = 0.0, 0.0, True
        for dist_, floor in self.records:
            lim = SHARD_FP32_TOL if floor is None else SHARD_FLOOR_X * floor
            ok &= dist_ <= lim
            if dist_ / max(lim, 1e-30) >= worst / max(limit, 1e-30):
                worst, limit = dist_, lim
        return worst, limit, ok and bool(self.records)


def unshard(torch, model):
    """Each DTensor parameter of ``model`` back to a plain one (its local
    tensor: the whole of it on a one-rank mesh)."""
    for name, p in list(model.named_parameters()):
        if hasattr(p, "to_local"):
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            setattr(mod, leaf, torch.nn.Parameter(p.to_local(), requires_grad=p.requires_grad))


def shard_phase(torch, dev, seed, smi, reset_counts, read_counts) -> dict:
    """(a) qwen2-moe-a2.7b at full width on a one-rank NCCL group and a
    (1, 1) ``DeviceMesh``, its parameters DTensors (``shard_params``):
    prefill at B=1, S=4,096 and 4 decode steps at B=16 against a
    4,096-token cache, logits bit-identical to the unsharded route on the
    same weights and tokens, one flash_attention a layer a call, and a
    control (the first decode step's attentions 32 cache columns short)
    that the check must reject; (b) the expert-parallel block rank by rank
    (``EPRankByRank``): qwen2-moe at model 2 and 4, qwen3-moe-235b-a22b's
    4 layers at (data 2, model 4) with moe_fsdp, fp32 at 2 layers within
    1e-5 and bf16 at full width by the floor rule, each with the control
    of rank 0 left out; (c) ``compress_pod`` at pod 2 emulated by a
    ``ReplicaGroup`` on gemma2-2b's full-width train step: ms per step with
    and without it, peak memory, the residual within half a step, the error
    feedback carried over 3 rounds, two runs bit-identical and a control (a
    wrong common scale) rejected. Returns {"shard": the launch counts of
    (a)'s counted calls}."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch
    from repro_torch.configs.lm_common import LM_SHAPES, rules_for
    from repro_torch.data import TokenStream
    from repro_torch.distributed import compression as comp
    from repro_torch.distributed.sharding import mesh_context, shard_params
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.transformer import TransformerLM, expert_parallel
    from repro_torch.optim import AdamWConfig
    from repro_torch.serve.lm import prefill_step
    from repro_torch.train import init_train_state, make_lm_train_step
    from repro_torch.train import steps as train_steps

    t_phase = time.perf_counter()
    counts = {}
    main_run = counter(torch, reset_counts, read_counts, "flash_attention", "shard", counts)
    check_run = counter(torch, reset_counts, read_counts, "flash_attention", "shard")
    arch = get_arch("qwen2-moe-a2.7b")
    cfg = arch.cfg
    L = cfg.n_layers
    stream = TokenStream.synthetic(vocab=cfg.vocab, n_docs=400, seed=seed)
    toks = torch.from_numpy(stream.tokens[:SHARD_SEQ].reshape(1, SHARD_SEQ).copy()).to(dev)
    dec_toks = torch.from_numpy(stream.tokens[SHARD_SEQ:SHARD_SEQ + SHARD_B_DEC * SHARD_DEC_STEPS]
                                .reshape(SHARD_DEC_STEPS, SHARD_B_DEC).copy()).to(dev)
    pos = [SHARD_SEQ - 1 - (97 * b) % (SHARD_SEQ // 2) for b in range(SHARD_B_DEC)]

    def seeded(cache, cache_seed):
        gen = torch.Generator(device=dev).manual_seed(cache_seed)
        with torch.inference_mode():
            for t in (*cache["k"], *cache["v"]):
                t.normal_(generator=gen).mul_(0.02)
            cache["pos"].copy_(torch.tensor(pos, dtype=torch.int32))
        return cache

    def decode(model, short=False):
        cache = seeded(model.init_cache(SHARD_B_DEC, SHARD_SEQ), seed + 7)
        outs, orig = [], fa_ops.flash_decode
        if short:
            fa_ops.flash_decode = lambda q, k, v, kv_len, **kw: orig(
                q, k, v, torch.clamp(kv_len - FLASH_DROP, min=1), **kw)
        try:
            for t in range(1 if short else SHARD_DEC_STEPS):
                logits, cache = model.decode_step(cache, dec_toks[t])
                outs.append(logits)
        finally:
            fa_ops.flash_decode = orig
        return outs

    def step_ms(model):
        """ms a decode step (host clock to a synchronise), the median of
        steps 2-4 on one seeded cache."""
        cache, walls = seeded(model.init_cache(SHARD_B_DEC, SHARD_SEQ), seed + 7), []
        for t in range(SHARD_DEC_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, cache = model.decode_step(cache, dec_toks[t])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return float(np.median(walls[1:])) * 1e3

    # -- (a) the DTensor path on a one-rank NCCL group ---------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    model = TransformerLM(cfg, device=dev, seed=seed)
    want_pre = check_run(lambda: prefill_step(model, toks), L)
    want_dec = check_run(lambda: decode(model), L * SHARD_DEC_STEPS)
    plain_pre, plain_dec = median_ms(torch, lambda: prefill_step(model, toks), 3), step_ms(model)
    rdv = tempfile.mkdtemp(prefix="shard_phase_")
    dist.init_process_group("nccl", init_method=f"file://{rdv}/rendezvous", world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        with mesh_context(mesh, rules_for(arch, "prefill")):
            shard_params(model, model.param_axes(), mesh)
            n_dt = sum(hasattr(p, "to_local") for p in model.parameters())
            got_pre = main_run(lambda: prefill_step(model, toks), L)
            t_pre = median_ms(torch, lambda: prefill_step(model, toks), 3)
        with mesh_context(mesh, rules_for(arch, "decode")):
            shard_params(model, model.param_axes(), mesh)
            got_dec = main_run(lambda: decode(model), L * SHARD_DEC_STEPS)
            t_dec = step_ms(model)
            short = check_run(lambda: decode(model, short=True), L)
        got = [got_pre.full_tensor()] + [x.full_tensor() for x in got_dec]
        want = [want_pre] + want_dec
        diffs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
        ctl = float((short[0].full_tensor() - want_dec[0]).abs().max())
        if not all(same):
            fail(f"shard (a): the DTensor route's logits differ from the unsharded route's: "
                 f"max |diff| {diffs} (prefill, then each decode step)")
        if torch.equal(short[0].full_tensor(), want_dec[0]):
            fail("shard (a): the bit-identity check passes a route 32 cache columns short")
        say(f"[shard] (a) qwen2-moe-a2.7b bf16 at full width on a one-rank NCCL group, (1, 1) "
            f"mesh, {n_dt} DTensor parameters: prefill_step B=1 S={SHARD_SEQ} and "
            f"{SHARD_DEC_STEPS} decode steps at B={SHARD_B_DEC} against {SHARD_SEQ} tokens give "
            f"the unsharded route's logits bit for bit; {L} flash_attention launches a call; "
            f"prefill {t_pre:.2f} ms (unsharded {plain_pre:.2f}; medians of 3), decode "
            f"{t_dec:.2f} ms a step (unsharded {plain_dec:.2f}; medians of steps 2-"
            f"{SHARD_DEC_STEPS}); control (the first decode step {FLASH_DROP} cache columns "
            f"short) differs by {ctl:.3g}, rejected; on {smi}")
    finally:
        dist.destroy_process_group()
        for f in Path(rdv).glob("*"):
            f.unlink()
        os.rmdir(rdv)
    unshard(torch, model)

    # -- (b) the expert-parallel bodies rank by rank ------------------------------
    def ep_case(model, ep, dp, fsdp, toks_, what, want_launches):
        c = model.cfg
        if not expert_parallel(dataclasses.replace(c, moe_shard_map=True), {"model": ep}):
            fail(f"shard (b) {what}: {c.moe.e_padded} expert slots do not split over {ep} ranks")
        with EPRankByRank(torch, model, ep, dp, fsdp=fsdp, psum_bf16=c.moe_psum_bf16) as run:
            logits = check_run(lambda: prefill_step(model, toks_), want_launches)
        with EPRankByRank(torch, model, ep, dp, fsdp=fsdp, psum_bf16=c.moe_psum_bf16,
                          drop=True) as ctl:
            check_run(lambda: prefill_step(model, toks_), want_launches)
        worst, limit, ok = run.verdict()
        cworst, _, cok = ctl.verdict()
        if not ok or not bool(torch.isfinite(logits).all()):
            fail(f"shard (b) {what}: a block is {worst:.3g} from the one-process block, "
                 f"beyond {limit:.3g}")
        if cok:
            fail(f"shard (b) {what}: the check passes the block with rank 0's partial left "
                 f"out ({cworst:.3g})")
        rule = ("fp32, within " + str(SHARD_FP32_TOL) if limit == SHARD_FP32_TOL
                else f"bf16, the floor rule ({SHARD_FLOOR_X} x the one-process bf16 block's "
                     f"distance from its fp32 form)")
        say(f"[shard] (b) {what}: {len(run.records)} MoE blocks, each the ranks' partials summed "
            f"in rank order; worst block {worst:.3g} against a limit of {limit:.3g} ({rule}); "
            f"control (rank 0 left out) {cworst:.3g}, rejected; {want_launches} "
            f"flash_attention launches; on {smi}")
        return {"worst": worst, "limit": limit, "control": cworst}

    ep_rec = {}
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32, param_dtype=torch.float32)
    m32 = TransformerLM(cfg32, device=dev, seed=seed)
    t2 = toks[:, :SHARD_FP32_SEQ]
    for ep, dp in SHARD_EP:
        ep_rec[f"qwen2-moe fp32 ep={ep}"] = ep_case(
            m32, ep, dp, 1, t2, f"qwen2-moe fp32 (2 layers, no TF32) model={ep}, B=1 "
            f"S={SHARD_FP32_SEQ}", 2)
    del m32
    for ep, dp in SHARD_EP:
        ep_rec[f"qwen2-moe bf16 ep={ep}"] = ep_case(
            model, ep, dp, 1, toks, f"qwen2-moe bf16 full width ({L} layers) model={ep}, "
            f"B=1 S={SHARD_SEQ}", L)
    del model
    torch.cuda.empty_cache()
    q3 = get_arch("qwen3-moe-235b-a22b").cfg
    ep, dp = QWEN3_EP
    q3t = torch.from_numpy(stream.tokens[:2 * QWEN3_EP_SEQ].reshape(2, QWEN3_EP_SEQ).copy()
                           % q3.vocab).to(dev)
    for what, c in (("fp32 (2 layers, no TF32)", dataclasses.replace(
            q3, n_layers=2, dtype=torch.float32, param_dtype=torch.float32)),
                    (f"bf16 ({QWEN3_MOE_LAYERS} of {q3.n_layers} layers)",
                     dataclasses.replace(q3, n_layers=QWEN3_MOE_LAYERS))):
        m = TransformerLM(c, device=dev, seed=seed)
        ep_rec[f"qwen3-moe {what.split()[0]}"] = ep_case(
            m, ep, dp, dp, q3t, f"qwen3-moe-235b-a22b {what} (data {dp}, model {ep}) moe_fsdp, "
            f"B=2 S={QWEN3_EP_SEQ}", c.n_layers)
        del m
        torch.cuda.empty_cache()

    # -- (c) compress_pod at pod 2 on gemma2-2b's train step -----------------------
    g2 = get_arch("gemma2-2b").cfg
    S = LM_SHAPES["train_4k"]["seq"]
    gt = torch.from_numpy(TokenStream.synthetic(vocab=g2.vocab, seed=seed).tokens[:S + 1]
                          .copy()).to(dev)
    batch = {"tokens": gt[None, :S], "targets": gt[None, 1:],
             "mask": torch.ones((1, S), device=dev)}
    model = TransformerLM(g2, device=dev, seed=seed)
    opt = AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=POD_TRAIN_STEPS)
    pod = comp.ReplicaGroup(POD)
    train_ms, peaks = {}, {}
    for name, kw in (("plain", {}), ("compress_pod", dict(compress_pod=True, pod_group=pod))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(dict(model.named_parameters()), compress=bool(kw))
        step = make_lm_train_step(model, opt, **kw)
        walls = []
        for _ in range(POD_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, batch)
            if not math.isfinite(float(met["loss"])):
                fail(f"shard (c) {name}: loss {float(met['loss'])}")
            walls.append(time.perf_counter() - t0)
        train_ms[name] = float(np.median(walls[1:])) * 1e3
        peaks[name] = torch.cuda.max_memory_allocated()
        del state, step
    torch.cuda.empty_cache()
    loss = model.loss_fn(batch["tokens"], batch["targets"], batch["mask"])
    grads = dict(zip([n for n, _ in model.named_parameters()],
                     torch.autograd.grad(loss, list(model.parameters()))))
    del loss

    class WrongScale(comp.ReplicaGroup):          # the control: a common max half too small
        def all_reduce(self, t, op):
            return t.mul_(0.5) if op == dist.ReduceOp.MAX else super().all_reduce(t, op)

    def rounds(g, group):
        """POD_ROUNDS rounds of the step's compression on g x (1 + round)
        from a zero residual: (worst |residual| / half a step, the carry's
        worst relative gap, the last sum and residual)."""
        ef = torch.zeros(g.shape, dtype=torch.float32, device=dev)
        sent = torch.zeros_like(ef)
        true = torch.zeros_like(ef)
        bound = 0.0
        for r in range(POD_ROUNDS):
            gr = g.float() * (1 + r)
            g32 = gr / POD + ef
            scale = torch.clamp(g32.abs().max(), min=1e-12) * comp._INV_127
            out, ef_new = train_steps._maybe_compress_pod({"g": gr}, {"g": ef}, None, group)
            ef = ef_new["g"]
            bound = max(bound, float(ef.abs().max() / (scale / 2)))
            sent += out["g"]
            true += gr
        # error feedback: what was sent plus pod x the residual left is what was meant
        gap = float((sent + POD * ef - true).abs().max() / true.abs().max().clamp(min=1e-30))
        return bound, gap, out["g"], ef

    worst_bound, worst_gap, same, n_t = 0.0, 0.0, True, 0
    for n, g in grads.items():
        b1, gap, o1, e1 = rounds(g, pod)
        _, _, o2, e2 = rounds(g, pod)
        same &= bool(torch.equal(o1, o2) and torch.equal(e1, e2))
        worst_bound, worst_gap, n_t = max(worst_bound, b1), max(worst_gap, gap), n_t + 1
    cb, _, _, _ = rounds(grads["embed"], WrongScale(POD))
    if not (worst_bound <= POD_HALF_STEP_X and worst_gap <= 1e-5 and same):
        fail(f"shard (c): residual at {worst_bound:.6g} of half a step, carry gap "
             f"{worst_gap:.3g}, two runs bit-identical: {same}")
    if cb <= POD_HALF_STEP_X:
        fail(f"shard (c): the residual check passes a wrong common scale ({cb:.3g})")
    ef_bytes = sum(g.numel() * 4 for g in grads.values())
    say(f"[shard] (c) compress_pod at pod {POD} (a ReplicaGroup plays the pod on one card) on "
        f"gemma2-2b's bf16 train step B=1 S={S} at full width: {train_ms['plain']:.1f} ms a step "
        f"without it, {train_ms['compress_pod']:.1f} ms with it (median of steps 2-"
        f"{POD_TRAIN_STEPS}); peak {peaks['plain'] / 2**30:.2f} -> "
        f"{peaks['compress_pod'] / 2**30:.2f} GiB (the fp32 residuals {ef_bytes / 1e9:.2f} GB); "
        f"over {n_t} tensors x {POD_ROUNDS} rounds the residual is at most "
        f"{worst_bound:.6f} of half a step, sent + {POD} x residual equals the gradients' sum "
        f"within {worst_gap:.3g} of its largest element, two runs bit-identical; control (a "
        f"common scale half too small) {cb:.3g} of half a step, rejected; on {smi}")
    del model, grads
    torch.cuda.empty_cache()
    summary = {"dtensor_ms": {"prefill": t_pre, "decode": t_dec},
               "plain_ms": {"prefill": plain_pre, "decode": plain_dec}, "ep": ep_rec,
               "train_ms": train_ms, "peak_bytes": peaks}
    say(f"[shard] summary: {json.dumps(summary)}; phase took "
        f"{time.perf_counter() - t_phase:.1f} s on {smi}")
    return {"shard": counts}


# --------------------------------------------------------------------------
# phase 8: the online runtime and the serving cluster
# --------------------------------------------------------------------------
def uncached_rows(fe, reqs, pairs):
    """{(parsed key, k): row} of the uncached frontend ``fe`` for every pair,
    the requests grouped by k and run through ``complete`` 256 at a time."""
    first = {}
    for r in reqs:
        first.setdefault(r.key, r)
    want = {}
    for k in sorted({k for _, k in pairs}):
        todo = [first[key] for key, kk in pairs if kk == k]
        for i in range(0, len(todo), 256):
            b = todo[i:i + 256]
            out = fe.complete(np.stack([r.pids for r in b]),
                              np.asarray([r.plen for r in b], np.int32),
                              np.stack([r.suf for r in b]),
                              np.asarray([r.slen for r in b], np.int32), k=k)
            want.update(((r.key, k), out[j, :k]) for j, r in enumerate(b))
    return want


ONLINE_SESSIONS = 256    # phase 8's and phase 9 (b)'s traces; 512 took the script past
                         # 1,000 s of its 1,200


def online_phase(torch, qidx, kept, seed, smi, reset_counts, read_counts):
    """The online runtime and the serving cluster over the full-width index:
    a keystroke trace of ONLINE_SESSIONS sessions, the runtime's measured replay with
    the callable audit, a 4-replica cluster's kill drill, every row held to
    the uncached frontend. Returns the kernel counts of the runtime's
    measured pass and its latency percentiles in ms."""
    from repro_torch.configs import get_arch
    from repro_torch.obs import JitAuditor, ObsConfig, fmt, percentiles
    from repro_torch.runtime import FaultInjector, ReplicaFault
    from repro_torch.serve import (QACFrontend, QACOnlineRuntime, QACServingCluster,
                                   assign_sla, prepare_requests)
    from repro_torch.text import KeystrokeTraceConfig, generate_keystroke_trace

    arch = get_arch("qac-ebay")
    t0 = time.perf_counter()
    tcfg = KeystrokeTraceConfig(n_sessions=ONLINE_SESSIONS, queries_per_session=2,
                                mean_keystroke_ms=150, seed=seed)
    reqs = prepare_requests(qidx, generate_keystroke_trace(kept, tcfg), k=10)
    span_s = (reqs[-1].t_us - reqs[0].t_us) / 1e6
    say(f"[online] trace: {len(reqs)} requests from {tcfg.n_sessions} sessions typing "
        f"{tcfg.queries_per_session} queries each (one keystroke per "
        f"{tcfg.mean_keystroke_ms:g} ms), offered {(len(reqs) - 1) / span_s:.1f} "
        f"requests/s over {span_s:.2f} s; made and parsed in "
        f"{time.perf_counter() - t0:.1f} s")

    # the runtime: warm up, one full pass, reset, freeze the audit, measure
    auditor = JitAuditor()
    fe = arch.frontend(qidx, auditor=auditor)
    rt = QACOnlineRuntime(fe, arch.runtime_config())
    t0 = time.perf_counter()
    rt.warmup(reqs)
    rt.run_trace(reqs)
    rt.reset()
    auditor.freeze()
    t_warm = time.perf_counter() - t0
    fallbacks = fe.stats["single_fallbacks"]
    reset_counts()
    torch.cuda.synchronize()
    fe.begin_dispatch_log()
    t0 = time.perf_counter()
    rows = rt.run_trace(reqs)
    t_pass = time.perf_counter() - t0
    counts = read_counts()
    log = fe.end_dispatch_log()
    if auditor.violations:
        fail(f"online: {len(auditor.violations)} callables minted after freeze(): "
             f"{[c['key'] for c in auditor.violations[:5]]}")
    engines = [key[0] for key, _ in log]
    want = {"heap_topk": engines.count("single") + engines.count("single_full"),
            "conjunctive_topk": engines.count("multi")}
    if engines.count("single_full") != fe.stats["single_fallbacks"] - fallbacks:
        fail(f"online: {engines.count('single_full')} full-budget dispatches for "
             f"{fe.stats['single_fallbacks'] - fallbacks} fallbacks")
    for name, c in counts.items():
        if c != want.get(name, 0):
            fail(f"online: the measured pass launched {name} {c} times; its dispatch "
                 f"log predicts {want.get(name, 0)} ({counts})")
    snap = rt.telemetry.snapshot()
    lat = percentiles(rt.telemetry.lat_us, (50, 95, 99, 99.9), suffix="", mean=True,
                      vmax=True)
    ms = {k: v / 1e3 for k, v in lat.items()}
    say(f"[online] runtime {arch.runtime_config()}: warm-up (sweep, a full pass, reset) "
        f"{t_warm:.1f} s, measured pass {t_pass:.1f} s; {len(auditor.compiles)} "
        f"callables minted in warm-up, 0 after freeze() (audit closed)")
    say(f"[online] per-request latency ms: p50 {ms['p50']:.3f} p95 {ms['p95']:.3f} "
        f"p99 {ms['p99']:.3f} p99.9 {ms['p99.9']:.3f} mean {ms['mean']:.3f} max "
        f"{ms['max']:.3f} over {snap['n_requests']} requests on {smi}")
    say(f"[online] paths {snap['paths']}; {snap['n_batches']} batches, mean size "
        f"{snap['mean_batch_size']:.1f}, max {max(snap['batch_hist'])}; triggers "
        f"{snap['triggers']}; deadline violations {snap['deadline_violations']}, queue "
        f"peak {snap['queue_peak']}; engine wall {snap['engine_wall_us'] / 1e6:.3f} s of "
        f"the trace's {span_s:.3f} s ({snap['engine_wall_us'] / 1e6 / span_s:.3f})")
    slo_ms = ObsConfig().slo_target_us / 1e3
    say(f"[online] p99.9 {ms['p99.9']:.3f} ms against the {slo_ms:g} ms objective: "
        f"{'holds' if ms['p99.9'] <= slo_ms else 'missed'} (a report, not a gate)")
    say(f"[online] launches in the measured pass {counts}: heap_topk = "
        f"{engines.count('single')} single-term dispatches + "
        f"{engines.count('single_full')} full-budget fallbacks, conjunctive_topk = "
        f"{engines.count('multi')} multi-term dispatches, as the dispatch log predicts")

    # the cluster: the trace's first quarter (its replay costs ~5x the
    # runtime's), a kill drill on replica 0 at that quarter's midpoint, back
    # after 2 heartbeat timeouts; one warm frontend shared by every replica
    cl_cfg = arch.cluster_config()
    creqs = reqs[:len(reqs) // 4]
    sla = assign_sla(creqs, bulk_fraction=0.25)
    t_kill = creqs[len(creqs) // 2].t_us
    t_up = t_kill + 2 * cl_cfg.heartbeat_timeout_us
    shared = arch.frontend(qidx)
    cluster = QACServingCluster(qidx, cl_cfg, arch.runtime_config(),
                                frontends=[shared] * cl_cfg.n_replicas,
                                injector=FaultInjector([], replica_faults=[
                                    ReplicaFault(0, t_kill, t_up)]))
    t0 = time.perf_counter()
    res = cluster.replay(creqs, sla)
    t_cluster = time.perf_counter() - t0
    cs = cluster.telemetry.snapshot()
    say(f"[online] cluster {cl_cfg}: the trace's first {len(creqs)} requests, "
        f"{sum(s == 'bulk' for s in sla)} of them bulk; "
        f"replica 0 down {t_kill / 1e6:.3f}-{t_up / 1e6:.3f} s; replay (warm pass, "
        f"reset, measured pass) {t_cluster:.1f} s")
    for cls in ("interactive", "bulk"):
        p = percentiles(cluster.telemetry.lat_us[cls], (50, 99, 99.9), suffix="")
        say(f"[online] cluster {cls}: {cs[f'{cls}_served']} served, ms p50 "
            f"{fmt(p['p50'], 1e3, 3)} p99 {fmt(p['p99'], 1e3, 3)} p99.9 "
            f"{fmt(p['p99.9'], 1e3, 3)} on {smi}")
    during = [r for q, r in zip(creqs, res) if t_kill <= q.t_us < t_up]
    say(f"[online] cluster: rejected {cs['rejected']} by reason {cs['shed']}, re-routed "
        f"{cs['rerouted']}, degraded {sum(r.degraded for r in res)}; deaths "
        f"{cs['deaths']}, readmissions {cs['readmissions']}, per replica "
        f"{cs['per_replica']}; served during the outage "
        f"{sum(r.status == 'ok' for r in during)} of {len(during)}")
    if not cs["deaths"] or not cs["readmissions"]:
        fail("online: the kill drill saw no death or no readmission")

    # every runtime row and every served cluster row against the uncached
    # frontend at the k it was served with
    t0 = time.perf_counter()
    served = [(q, r) for q, r in zip(creqs, res) if r.status == "ok"]
    pairs = {(q.key, q.k) for q in reqs} | {(q.key, r.k_served) for q, r in served}
    want_rows = uncached_rows(QACFrontend(qidx, k=10), reqs, pairs)
    for q, row in zip(reqs, rows):
        if row.dtype != np.int32 or not np.array_equal(row, want_rows[q.key, q.k]):
            fail(f"online: runtime row of {q.query!r} differs from the uncached frontend")
    for q, r in served:
        if not np.array_equal(r.row, want_rows[q.key, r.k_served]):
            fail(f"online: cluster row of {q.query!r} (replica {r.replica}, k "
                 f"{r.k_served}) differs from the uncached frontend")
    say(f"[online] {len(rows)} runtime rows and {len(served)} served cluster rows "
        f"bit-identical to the uncached frontend ({len(pairs)} distinct (query, k) "
        f"in {time.perf_counter() - t0:.1f} s)")
    return counts, ms


# --------------------------------------------------------------------------
# phase 9: the live index
# --------------------------------------------------------------------------
FRESH_SAMPLE = 256       # answers of each generation held against the witness
DRILL_SESSIONS = 32      # the drill's sessions: each distinct version its answers
                         # saw is built from scratch (~0.45 s each on an H100's host)


def mutation_trace(kept, scores, sessions, queries_per_session, keystroke_ms,
                   n_mutations, seed):
    from repro_torch.text import (KeystrokeTraceConfig, MutationTraceConfig,
                                  generate_mutation_trace)
    return generate_mutation_trace(kept, scores, MutationTraceConfig(
        keystrokes=KeystrokeTraceConfig(
            n_sessions=sessions, queries_per_session=queries_per_session,
            mean_keystroke_ms=keystroke_ms, seed=seed),
        n_mutations=n_mutations, follower_sessions=8, seed=seed))


def check_fresh_launches(phase, counts, log):
    """The run launched heap_topk once per single-term dispatch (with the
    full-budget fallbacks) and conjunctive_topk once per multi-term
    dispatch of every generation's frontend, and nothing else."""
    engines = [key[0] for key, _ in log]
    want = {"heap_topk": engines.count("single") + engines.count("single_full"),
            "conjunctive_topk": engines.count("multi")}
    for name, c in counts.items():
        if c != want.get(name, 0):
            fail(f"{phase}: launched {name} {c} times; the dispatch logs predict "
                 f"{want.get(name, 0)} ({counts})")
    return engines


def fresh_gates(phase, gq, results, min_swaps):
    """The snapshot gates of the JAX package's freshness tests."""
    s = gq.snapshot()
    inv = s["runtime"]["invalidations"]
    per_gen = s["runtime"]["per_generation"]
    if s["n_swaps"] < min_swaps:
        fail(f"{phase}: {s['n_swaps']} swaps, wanted at least {min_swaps}")
    if not s["delta_hit_answers"]:
        fail(f"{phase}: no answer was served from the delta")
    if len(inv) != s["n_swaps"] or any(v["count"] != 1 for v in inv.values()):
        fail(f"{phase}: invalidations {inv} for {s['n_swaps']} swaps")
    if 0 not in per_gen or s["generation"] not in per_gen:
        fail(f"{phase}: traffic by generation {sorted(per_gen)}, last {s['generation']}")
    if len(results) != s["runtime"]["n_requests"]:
        fail(f"{phase}: {len(results)} answers for {s['runtime']['n_requests']} requests")
    return s


@contextlib.contextmanager
def fixed_service_clock(step_s: float):
    """The runtime's wall clock, read afresh, ``step_s`` after its previous
    reading: every dispatch and cache hit costs the same on every route, so
    two routes batch, cache and absorb a trace alike."""
    import repro_torch.serve.runtime as runtime_mod

    real, tick = runtime_mod.time, itertools.count()
    runtime_mod.time = types.SimpleNamespace(perf_counter=lambda: next(tick) * step_s)
    try:
        yield
    finally:
        runtime_mod.time = real


FRESH_FIELDS = ("idx", "strings", "scores", "gen", "seq", "n_delta", "escalations")


def route_diffs(rk, rp) -> str:
    """'' when two routes' answers agree on every FRESH_FIELDS field, else
    how many differ, by field, and the first one's differing fields."""
    if len(rk) != len(rp):
        return f"{len(rk)} answers on the kernel route, {len(rp)} on the plain route"
    diffs = [(a, b, [f for f in FRESH_FIELDS if getattr(a, f) != getattr(b, f)])
             for a, b in zip(rk, rp)]
    diffs = [d for d in diffs if d[2]]
    if not diffs:
        return ""
    a, b, fs = diffs[0]
    by_field = {f: sum(f in d[2] for d in diffs) for f in FRESH_FIELDS}
    first = "; ".join(f"{f} kernels {getattr(a, f)!r} plain {getattr(b, f)!r}" for f in fs)
    return (f"{len(diffs)} of {len(rk)} answers differ, by field {by_field}; the first, "
            f"answer {a.idx} ({a.query!r}): {first}")


def fresh_drill(torch, seed, smi, reset_counts, read_counts, clock_step_s=2.0 ** -9):
    """(a) Every answer of a small live index on the card against a
    from-scratch build of its own visible version, across >= 2 swaps; the
    same trace through the plain route gives equal answers. Which request a
    mutation's absorb finds answered follows the runtime's measured service
    times, so both routes run on a fixed service clock (``clock_step_s`` a
    reading). With ``clock_step_s=None`` (``--probe``) both run on the real
    clock: the answers that differ are counted by field, not failed, and
    every answer of each route is held against a build of its own version."""
    from repro_torch.serve import FreshnessConfig, GenerationalQAC, RuntimeConfig
    from repro_torch.text import SynthLogConfig, generate_query_log

    t0 = time.perf_counter()
    qs, sc = generate_query_log(SynthLogConfig(n_queries=20_000, seed=seed))
    events = mutation_trace(qs, sc, DRILL_SESSIONS, 1, 2.0, 100, seed)
    n_req = sum(e.kind == "request" for e in events)
    say(f"[fresh] drill: a 20,000-query log ({SynthLogConfig.vocab_size} terms), "
        f"{n_req} requests and {len(events) - n_req} mutations, made in "
        f"{time.perf_counter() - t0:.1f} s")
    kw = dict(cfg=FreshnessConfig(k=10, delta_capacity=256, swap_threshold=32),
              rt_cfg=RuntimeConfig(max_batch=8, slack_us=2_000.0), device=DEVICE)
    runs = {}
    for route, fe_kw in (("kernels", {}), ("plain", {"use_kernel": False})):
        gq = GenerationalQAC(qs, sc, frontend_kwargs=fe_kw, **kw)
        reset_counts()
        torch.cuda.synchronize()
        gq.begin_dispatch_log()
        t0 = time.perf_counter()
        with (fixed_service_clock(clock_step_s) if clock_step_s
              else contextlib.nullcontext()):
            res = gq.run_mutation_trace(events)
        t_run = time.perf_counter() - t0
        counts, log = read_counts(), gq.end_dispatch_log()
        if route == "kernels":
            check_fresh_launches("fresh drill", counts, log)
        elif any(counts.values()):
            fail(f"fresh drill: the plain route launched {counts}")
        runs[route] = (gq, res)
        s = fresh_gates(f"fresh drill, {route}", gq, res, 2)
        say(f"[fresh] drill {route} route: {len(res)} answers in {t_run:.1f} s, "
            f"{s['n_swaps']} swaps, outcomes {s['mutation_outcomes']}, "
            f"{s['delta_hit_answers']} delta-hit answers, {s['escalations']} "
            f"escalations, {s['truncated_scans']} truncated scans; launches {counts}")
    (gk, rk), (gp, rp) = runs["kernels"], runs["plain"]
    diff = route_diffs(rk, rp)
    if clock_step_s and diff:
        fail(f"fresh drill: the kernel route's answers differ from the plain route's: {diff}")
    if not clock_step_s:
        say(f"[fresh] drill on the real clock: {diff or 'the routes agree on every field'}")
        t0 = time.perf_counter()
        checked = gp.check_parity(rp)
        say(f"[fresh] drill on the real clock: the plain route's {checked} answers equal "
            f"a from-scratch build of their version ({len(gp._oracle_cache)} builds in "
            f"{time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    checked = gk.check_parity(rk)
    say(f"[fresh] drill: {checked} answers equal a from-scratch build of their "
        f"version on the card ({len(gk._oracle_cache)} builds in "
        f"{time.perf_counter() - t0:.1f} s) on {smi}" + ("" if diff else
        "; the plain route's answers equal the kernel route's (strings, scores, gen, "
        "seq, n_delta, escalations)"))


def view_paths(torch, queries, scores, smi):
    """``MainCorpusView``'s two ways to the same maps, at the log's scale
    (``--probe``): over the builder's ``kept``, strictly ascending (scores
    scattered by lexicographic position, ``docid_of_string`` a binary
    search), and over ``kept`` reversed (the JAX package's two dicts). Both
    built on one index, their maps held equal, ``lookup`` timed on strings
    the index holds and strings it lacks."""
    from repro_torch.core import build_qac_index
    from repro_torch.core.delta import MainCorpusView

    t0 = time.perf_counter()
    qidx, kept, sc = build_qac_index(queries, scores, k_default=10, postings_codec=None,
                                     device=DEVICE)
    fwd = qidx.completions.fwd_terms.cpu().numpy()
    say(f"[probe] index of {len(kept)} completions built in "
        f"{time.perf_counter() - t0:.1f} s")
    views, build_s = {}, {}
    for path, (kk, ss) in (("sorted", (kept, sc)),
                           ("dicts", (kept[::-1], np.asarray(sc)[::-1]))):
        t0 = time.perf_counter()
        views[path] = MainCorpusView(qidx, kk, ss, fwd=fwd)
        build_s[path] = time.perf_counter() - t0
    vs, vd = views["sorted"], views["dicts"]
    if isinstance(vs.docid_of_string, dict) or not isinstance(vd.docid_of_string, dict):
        fail("probe: the views did not take the sorted and the dict paths")
    if (vs.string_of_docid != vd.string_of_docid
            or not np.array_equal(vs.score_of_docid, vd.score_of_docid)):
        fail("probe: the two views' maps differ")
    rng = np.random.default_rng(0)
    held = [kept[i] for i in rng.integers(0, len(kept), 200_000).tolist()]
    probe = held + [q + " zzzz" for q in held]
    looked, lookup_us = {}, {}
    for path, v in views.items():
        t0 = time.perf_counter()
        looked[path] = [v.lookup(q) for q in probe]
        lookup_us[path] = (time.perf_counter() - t0) / len(probe) * 1e6
    if looked["sorted"] != looked["dicts"]:
        fail("probe: the two views' lookups differ")
    say(f"[probe] MainCorpusView over {len(kept)} completions: sorted path "
        f"{build_s['sorted']:.2f} s, dict path {build_s['dicts']:.2f} s to build; "
        f"lookup {lookup_us['sorted']:.3f} and {lookup_us['dicts']:.3f} us each over "
        f"{len(probe)} strings (half held); maps and lookups equal; on {smi}")


def fresh_sample(results):
    """Up to FRESH_SAMPLE answers of each generation: its delta hits first,
    then answers spread evenly over the rest."""
    by_gen = {}
    for r in results:
        by_gen.setdefault(r.gen, []).append(r)
    out = []
    for rs in by_gen.values():
        hits = [r for r in rs if r.n_delta > 0][:FRESH_SAMPLE]
        rest = [r for r in rs if r.n_delta == 0]
        n = min(FRESH_SAMPLE - len(hits), len(rest))
        out += hits + [rest[int(i)] for i in np.linspace(0, len(rest) - 1, n)]
    return out


def live_index_phase(torch, qidx, kept, sc_kept, seed, smi, online_ms,
                     reset_counts, read_counts) -> dict:
    """(b) The live index at qac-ebay scale: one run of a mutation trace
    with phase 8's keystroke shape through ``GenerationalQAC`` serving
    phase 5's build as generation 0 (no second build), exactly one swap.
    Returns the run's kernel counts."""
    from repro_torch.configs import get_arch
    from repro_torch.obs import percentiles
    from repro_torch.serve import GenerationalQAC, witness_answers

    arch = get_arch("qac-ebay")
    t0 = time.perf_counter()
    events = mutation_trace(kept, sc_kept, ONLINE_SESSIONS, 2, 150.0, 1200, seed)
    n_req = sum(e.kind == "request" for e in events)
    span_s = (events[-1].t_us - events[0].t_us) / 1e6
    say(f"[fresh] trace over the {len(kept)} completions: {n_req} requests and "
        f"{len(events) - n_req} mutations over {span_s:.2f} s, made in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gq = GenerationalQAC(None, None, cfg=arch.freshness_config(),
                         rt_cfg=arch.runtime_config(), device=DEVICE,
                         built=(qidx, kept, sc_kept))
    torch.cuda.synchronize()
    say(f"[fresh] GenerationalQAC({arch.freshness_config()}, {arch.runtime_config()}) "
        f"over phase 5's build of {len(kept)} completions (no second build): "
        f"{time.perf_counter() - t0:.1f} s, of it the host view "
        f"{gq.history[0].view_us / 1e6:.2f} s")
    reset_counts()
    torch.cuda.synchronize()
    gq.begin_dispatch_log()
    t0 = time.perf_counter()
    res = gq.run_mutation_trace(events)
    t_run = time.perf_counter() - t0
    counts, log = read_counts(), gq.end_dispatch_log()
    engines = check_fresh_launches("fresh", counts, log)
    s = fresh_gates("fresh", gq, res, 1)
    if s["n_swaps"] != 1:
        fail(f"fresh: {s['n_swaps']} swaps at this scale, wanted exactly 1")
    lat = percentiles([r.lat_us for r in res], (50, 95, 99, 99.9), suffix="",
                      mean=True, vmax=True)
    ms = {k: v / 1e3 for k, v in lat.items()}
    say(f"[fresh] run: {len(res)} answers in {t_run:.1f} s; mutations "
        f"{s['mutation_outcomes']}; per-request latency ms: p50 {ms['p50']:.3f} p95 "
        f"{ms['p95']:.3f} p99 {ms['p99']:.3f} p99.9 {ms['p99.9']:.3f} mean "
        f"{ms['mean']:.3f} max {ms['max']:.3f}; phase 8's runtime on the same index: "
        f"p50 {online_ms['p50']:.3f} p95 {online_ms['p95']:.3f} p99 "
        f"{online_ms['p99']:.3f} p99.9 {online_ms['p99.9']:.3f} on {smi}")
    say(f"[fresh] apply p50 {s['apply_p50_us']:.1f} us p99 {s['apply_p99_us']:.1f} us; "
        f"{s['delta_hit_answers']} delta-hit answers, {s['escalations']} escalations "
        f"(one B=1 dispatch each), {s['truncated_scans']} truncated-scan fallbacks "
        f"({s['truncated_scan_us'] / 1e3 / max(s['truncated_scans'], 1):.3f} ms each, "
        f"{s['truncated_scan_us'] / 1e6:.2f} s in all); "
        f"paths {s['runtime']['paths']}; traffic by generation "
        f"{s['runtime']['per_generation']}; invalidations {s['runtime']['invalidations']}")
    sw = gq.swap_log[0]
    us = lambda key: sw[key] / 1e6
    say(f"[fresh] swap to generation {sw['gen']} at {sw['t_us'] / 1e6:.3f} s of the trace "
        f"({sw['folded']} entries, seq {sw['folded_seq']}, {sw['deferred']} deferred): "
        f"rebuild wall {us('rebuild_wall_us'):.2f} s = build {us('build_us'):.2f} s (of it "
        f"the \"ef\" packing {us('pack_us'):.2f} s) + frontend {us('frontend_us'):.3f} s + "
        f"warm-up {us('warm_us'):.3f} s; swap stall {us('swap_stall_us'):.3f} s = drain "
        f"{us('drain_us'):.4f} + absorb {us('absorb_us'):.4f} + view {us('view_us'):.3f} + "
        f"install {us('install_us'):.4f} s")
    say(f"[fresh] launches in the run {counts}: heap_topk = {engines.count('single')} "
        f"single-term dispatches + {engines.count('single_full')} full-budget "
        f"fallbacks, conjunctive_topk = {engines.count('multi')} multi-term dispatches "
        f"over both generations (the warm-up sweep and escalations included), as the "
        f"dispatch logs predict")
    t0 = time.perf_counter()
    sample = fresh_sample(res)
    for r, want in zip(sample, witness_answers(gq, sample)):
        if r.strings != want:
            fail(f"fresh: answer {r.idx} ({r.query!r}, gen {r.gen}, seq {r.seq}) "
                 f"{r.strings[:3]}... != witness {want[:3]}...")
    hits = sum(r.n_delta > 0 for r in sample)
    say(f"[fresh] {len(sample)} answers ({hits} of the {s['delta_hit_answers']} delta "
        f"hits) equal the witness, {FRESH_SAMPLE} a generation at most, in "
        f"{time.perf_counter() - t0:.1f} s")
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--queries", type=int, default=13_500_000,
                    help="log size; ~10M completions survive the dedup")
    ap.add_argument("--vocab", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train", action="store_true",
                    help="only the training phase after the build; prints no result line")
    ap.add_argument("--moe", action="store_true",
                    help="only the MoE phase (12) after the build; prints no result line")
    ap.add_argument("--gnn", action="store_true",
                    help="only the MACE phase (13) after the build; prints no result line")
    ap.add_argument("--shard", action="store_true",
                    help="only the sharded-execution phase (14) after the build; prints no "
                         "result line")
    ap.add_argument("--probe", action="store_true",
                    help="only the live index's probes after the build: the drill on "
                         "the real clock, and MainCorpusView's two paths at the log's "
                         "scale; prints no result line")
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
    from repro_torch.core.search import (conjunctive_lanes,
                                         single_term_topk_bounded_batch)
    from repro_torch.kernels.intersect.ref import (conjunctive_scan_packed_ref,
                                                   conjunctive_scan_ref,
                                                   conjunctive_topk_packed_ref,
                                                   conjunctive_topk_ref)
    from repro_torch.kernels.rmq.ref import rmq_window_batch
    from repro_torch.serve import QACFrontend, qac_serve_step

    ops = {name: importlib.import_module(v[0]) for name, v in KERNELS.items()}

    def reset_counts():
        for name, m in ops.items():
            setattr(m, KERNELS[name][1], 0)

    def read_counts():
        return {name: getattr(m, KERNELS[name][1]) for name, m in ops.items()}

    dev = torch.device(DEVICE)

    t_start = time.perf_counter()
    t_lap = [t_start]

    t_part = [t_start]

    def lap(phase):
        now = time.perf_counter()
        say(f"[time] phase {phase}: {now - t_lap[0]:.1f} s ({now - t_start:.1f} s in all)")
        t_lap[0] = t_part[0] = now

    def part(label):
        """The time since the phase's start or its previous part."""
        now = time.perf_counter()
        say(f"[time]   {label}: {now - t_part[0]:.1f} s")
        t_part[0] = now

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
                if name in ("flash_attention", "flash_attention_bwd", "heap_topk", "intersect",
                            "fm_pairwise"):
                    say(f"[build] {name}: {demangle(entry)}")
            elif "Used" in line or "spill" in line or any(
                    w in line for w in ("C7508", "C7512", "C7520")):   # setmaxnreg, wgmma serialised
                say(f"[build] {name}: {line.strip()}")
                if "spill" in line and " 0 bytes spill stores" not in line and "_tc_kernel" in entry:
                    fail(f"ptxas spills in {demangle(entry)}: {line.strip()}")

    lap(2)

    if args.probe:
        fresh_drill(torch, args.seed, smi, reset_counts, read_counts, clock_step_s=None)
        lap("probe drill")
        queries, scores = make_log(args.queries, args.vocab, args.seed)
        view_paths(torch, queries, scores, smi)
        lap("probe view")
        return 0

    results = {}     # each kernel's cases held against its plain version

    def hold(name, run_kernel, run_plain, equal, bytes_needed, reps, case,
             codec=None, plain_reps=None, ops_needed=0, ops_per_s=FP32_OPS_PER_S,
             trace_reps=200, library=None, per_call=1):
        """Check the kernel against its plain version; time both, and the one
        PyTorch call ``library`` that computes the same function where there
        is one. Returns the case's record: device ms per launch (over a trace
        of ``trace_reps`` calls), ms per wrapper call, plain ms (with
        ``plain_reps=0`` the one checked call, host-timed to a synchronise,
        for plain versions that take seconds), library ms,
        the bound (the larger of bytes over the memory rate and operations
        over ``ops_per_s``) and the largest absolute difference of a float
        output from the plain version's (0 for the exact ones; over every
        float output of a tuple). ``per_call``: kernels a wrapper launch
        runs (timed as one launch)."""
        got = run_kernel()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = run_plain()
        torch.cuda.synchronize()
        plain_once_ms = (time.perf_counter() - t0) * 1e3
        if not equal(got, want):
            fail(f"{name} {case}: kernel disagrees with its plain version")
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        err = max([float((a.double() - b.double()).abs().max()) for a, b in pairs
                   if isinstance(a, torch.Tensor) and a.is_floating_point() and a.numel()],
                  default=0.0)
        tag = TRACE_TAGS[name if codec is None else (name, codec)]
        t_bytes, t_ops = bytes_needed / HBM_BYTES_PER_S, ops_needed / ops_per_s
        ms, held, parts = kernel_device_ms(torch, run_kernel, tag, trace_reps, per_call)
        c = {"case": case, **({"codec": codec} if codec else {}),
             "ms": ms, "traced_launches": held, **({"kernel_ms": parts} if per_call > 1 else {}),
             "call_ms": cuda_ms(torch, run_kernel, reps),
             "plain_ms": plain_once_ms if plain_reps == 0 else
                         cuda_ms(torch, run_plain, plain_reps or max(3, reps // 20)),
             "library_ms": cuda_ms(torch, library, reps) if library else None,
             "bound_ms": max(t_bytes, t_ops) * 1e3,
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "bytes": bytes_needed, "max_abs_err": err}
        results.setdefault(name, []).append(c)
        return c

    def timing(c):
        return (f"device {c['ms']*1e3:.2f} us/launch, call {c['call_ms']*1e3:.2f} us, "
                f"plain {c['plain_ms']*1e3:.2f} us, bound {c['bound_ms']*1e3:.4f} us")

    if args.train:
        train_phase(torch, dev, args.seed, smi, hold, reset_counts, read_counts)
        lap("train")
        say(json.dumps({name: cases for name, cases in results.items()}))
        return 0
    if args.moe or args.gnn or args.shard:
        if args.moe:
            say(json.dumps(moe_phase(torch, dev, args.seed, smi, reset_counts, read_counts)))
            lap(12)
        if args.gnn:
            mace_phase(torch, dev, args.seed, smi, reset_counts, read_counts)
            lap(13)
        if args.shard:
            say(json.dumps(shard_phase(torch, dev, args.seed, smi, reset_counts, read_counts)))
            lap(14)
        return 0

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
    qidx, kept, sc_kept = build_qac_index(queries, scores, k_default=10,
                                          postings_codec="ef", device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    part("log and host build")
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
    part("bitpack packing and its round trip")
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
    del queries, scores        # phase 9 (b) serves this build: the log is done

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
    heap_trips = {}      # the most trips any lane runs, as the kernel's loop does

    def per_trip(c, k, trips):
        c["most_trips"] = most = heap_trips[k, trips]
        c["us_per_trip"] = c["ms"] * 1e3 / max(most, 1)
        return f"most trips of a lane {most}, {c['us_per_trip']:.3f} us/trip"

    for k, trips in heap_cases:
        kw = dict(k=k, trips=trips, n=n, n_terms=idx.n_terms)
        out, _, ran = heap_topk_ref(*targs, **kw, count_trips=True)
        heap_out[k, trips], heap_trips[k, trips] = out, int(ran.max())
        b_heap = heap_bytes(torch, hl, hh, out, k, idx.offsets, idx.minimal,
                            idx.postings)
        case = f"B={hl.numel()} k={k} trips={trips}"
        c = hold("heap_topk", lambda: ops["heap_topk"].heap_topk(*targs, **kw),
                 lambda: heap_topk_ref(*targs, **kw), heap_equal, b_heap, 200, case,
                 plain_reps=0)
        say(f"[kernel] heap_topk {case}: {timing(c)} ({b_heap} B; "
            f"{per_trip(c, k, trips)}) | equal")
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
                     b_heap, 200, case, codec, plain_reps=0)
            say(f"[kernel] heap_topk_packed[{codec}] {case}: {timing(c)} "
                f"({b_heap} B; {per_trip(c, k, trips)}) | equal")
    part("heap_topk and heap_topk_packed against their plain versions")

    # heap_topk's lanes a block: the plan's MAX_WARPS against its neighbours
    # (B=256: 256, 128, 64 and 32 blocks), raw and "ef" at (10, 12)
    heap_mod = ops["heap_topk"]
    kw = dict(k=10, trips=12, n=n, n_terms=idx.n_terms)
    chosen, sweep = heap_mod.MAX_WARPS, {}
    for warps in (1, 2, 4, 8):
        heap_mod.MAX_WARPS = warps
        for codec in (None, "ef"):
            run = (lambda: heap_mod.heap_topk(*targs, **kw)) if codec is None else (
                lambda: heap_mod.heap_topk_packed(*targs[:4], packs["ef"], hl, hh, **kw))
            if not heap_equal(run(), heap_topk_ref(*targs, **kw)):
                fail(f"heap_topk[{codec or 'raw'}] at {warps} warps a block disagrees")
            tag = TRACE_TAGS["heap_topk" if codec is None else ("heap_topk_packed", codec)]
            sweep[warps, codec or "raw"] = kernel_device_ms(torch, run, tag, 200)[0] * 1e3
    heap_mod.MAX_WARPS = chosen
    part("heap_topk by warps a block")
    say(f"[kernel] heap_topk B={hl.numel()} k=10 trips=12 by lanes (warps) a block, "
        f"device us/launch (the plan takes {chosen}): " + ", ".join(
            f"{w} {c} {us:.2f}" for (w, c), us in sweep.items()))

    # the single-term routes side by side, for a route rule: the engine
    # through heap_topk and through the per-pop RMQ kernel (which reads raw
    # postings on every codec), on the batch's first B term ranges
    route_grid = []
    for B in (1, 8, 64, 256):
        for codec in (None, "ef"):
            for heap_kernel in (True, False):
                def engine():
                    return single_term_topk_bounded_batch(
                        idx, rm, tl[:B], th[:B], 10, 12, use_kernel=True,
                        heap_kernel=heap_kernel, postings_codec=codec)
                # the per-pop route launches ~1,200 kernels a call; a trace
                # of 20 calls takes seconds to read, so it runs 4
                reps = 20 if heap_kernel else 4
                dev_us, per_call = call_device_us(torch, engine, reps)
                g = {"B": B, "codec": codec or "raw",
                     "route": "heap_topk" if heap_kernel else "per_pop_rmq",
                     "device_us": dev_us, "launches_per_call": per_call,
                     "call_us": cuda_ms(torch, engine, reps) * 1e3}
                route_grid.append(g)
                say(f"[route] single-term B={B} {g['codec']} {g['route']}: device "
                    f"{dev_us:.2f} us/call ({per_call:.1f} launches), wrapper "
                    f"{g['call_us']:.2f} us/call, k=10 trips=12 on {smi}")
    say("[route] " + json.dumps({"single_term_routes": route_grid}))
    part("single-term routes")

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
             torch.equal, b_scan, 2000, case, plain_reps=3)
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
                 torch.equal, b_scan, 2000, case, codec, plain_reps=0)
        say(f"[kernel] conjunctive_scan_packed[{codec}] {case}: {timing(c)} "
            f"({b_scan} B) | equal")
    part("conjunctive_scan and conjunctive_scan_packed")

    # conjunctive_topk: the multi-term engine in one launch, on the batch's
    # multi-term queries (k=10, tile=128), the path's cap (4,096 tiles) first.
    # Its plain version, the host-synced tile loop, runs at max_tiles=
    # PACKED_PLAIN_TILES (the packed plain scan takes up to ~0.8 s a tile;
    # 9 tiles cross the kernel's first chunk; phase 7's plain route runs
    # the raw loop at PLAIN_TILES); at the longer caps the plain version is
    # topk_walk, held equal to the tile loop at the tile loop's cap
    mq = torch.nonzero(plen > 0)[:, 0]
    lanes = conjunctive_lanes(idx, pids[mq], plen[mq], tl[mq], th[mq])
    longest = int(torch.where(lanes[3] > lanes[2], lanes[3] - lanes[2], 0).max())
    iters = (1 << max(1, (max(longest, 1) - 1).bit_length())).bit_length()  # as the frontend
    kargs = (*lanes, comps.fwd_terms, tl[mq], th[mq])

    def topk(codec, fn_args, plain=False, **kw):
        if codec is None:
            fn = conjunctive_topk_ref if plain else ops["conjunctive_topk"].conjunctive_topk
            return fn(idx.postings, *fn_args, **kw)
        fn = (conjunctive_topk_packed_ref if plain
              else ops["conjunctive_topk_packed"].conjunctive_topk_packed)
        return fn(idx.postings, packs[codec], *fn_args, **kw)

    for codec in (None, *CODECS):
        name = "conjunctive_topk" if codec is None else "conjunctive_topk_packed"
        loop_tiles = PACKED_PLAIN_TILES
        for max_tiles in dict.fromkeys((4096, PLAIN_TILES, loop_tiles)):
            kw = dict(k=10, tile=128, max_tiles=max_tiles, iters=iters)
            walk = functools.partial(topk_walk, torch, idx.postings, lanes, comps.fwd_terms,
                                     tl[mq], th[mq], 10, 128 * max_tiles, iters)
            answer, b_topk, stop = walk(None if codec is None else packs[codec])
            if max_tiles == loop_tiles:
                plain, held_by = (lambda: topk(codec, kargs, plain=True, **kw)), "tile loop"
            else:
                plain, held_by = (lambda: walk(count=False)[0]), "topk_walk"
            case = f"B={mq.numel()} k=10 tile=128 max_tiles={max_tiles} iters={iters}"
            c = hold(name, lambda: topk(codec, kargs, **kw), plain, torch.equal, b_topk, 20,
                     case, codec, plain_reps=0, trace_reps=50)
            c["longest_lane"], c["plain"] = stop, held_by
            if held_by == "tile loop" and not torch.equal(answer, topk(codec, kargs, **kw)):
                fail(f"{name}[{codec or 'raw'}] {case}: topk_walk disagrees with the tile loop")
            say(f"[kernel] {name}[{codec or 'raw'}] {case}: {timing(c)} ({b_topk} B; "
                f"longest lane {stop} candidates) | equal to its plain version, {held_by}")
    part("conjunctive_topk and conjunctive_topk_packed")
    # the cases that stress the chunking: a cap of 16 candidates (inside the
    # kernel's first chunk) at k = 1, 10, 128, with a lane that needs an
    # empty list (dead, as conjunctive_lanes marks it) and one whose empty
    # needed span is only skipped, both over the longest driver list
    d_start, d_end, starts, ends, dead = lanes
    top = int(torch.argmax(torch.where(dead, 0, d_end - d_start)))
    slot = int(torch.argmax((ends[top] > starts[top]).int()))
    empty_ends = ends[top:top + 1].clone()
    empty_ends[0, slot] = starts[top, slot]
    two = lambda t: torch.cat([t, t[top:top + 1], t[top:top + 1]])
    xargs = (two(d_start), two(d_end), two(starts), torch.cat([ends, empty_ends, empty_ends]),
             torch.cat([dead, torch.tensor([True, False], device=dev)]), comps.fwd_terms,
             two(tl[mq]), two(th[mq]))
    n_cases = 0
    for codec in (None, *CODECS):
        for k in (1, 10, 128):
            kw = dict(k=k, tile=8, max_tiles=2, iters=iters)
            got, want = topk(codec, xargs, **kw), topk(codec, xargs, plain=True, **kw)
            if not torch.equal(got, want) or not bool((got[-2] == INF).all()):
                fail(f"conjunctive_topk[{codec or 'raw'}] k={k} tile=8 max_tiles=2: kernel "
                     "disagrees with its plain version")
            n_cases += 1
    say(f"[kernel] conjunctive_topk raw/ef/bitpack at tile=8 max_tiles=2 (cap 16), k = 1, "
        f"10, 128, B={mq.numel() + 2} with a dead and an empty-span lane: {n_cases} cases "
        "equal to the plain version")

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
    answers, per_k, per_query_us, multi_dispatches = {}, {}, {}, {}
    # phase 5 loaded every kernel and warmed PyTorch's own ones, so each
    # route's first call is timed as it comes. Each route's main-batch run is
    # counted on its own: the counts go to 0 just before it, are read just
    # after, and the per-request-k batch that follows is not counted
    for route, fe in fes.items():
        reset_counts()
        torch.cuda.synchronize()
        fe.begin_dispatch_log()
        t0 = time.perf_counter()
        answers[route] = fe.complete(*(x[:served[route]] for x in inputs))
        per_query_us[route] = (time.perf_counter() - t0) / served[route] * 1e6
        counted[route] = read_counts()
        multi_dispatches[route] = sum(key[0] == "multi" for key, _ in fe.end_dispatch_log())
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
        want_kernels["kernels_capped"] = ("conjunctive_topk",)
    for route, counts in counted.items():
        for name, c in counts.items():
            if bool(c) != (name in want_kernels[route]):
                fail(f"route {route} launched {name} {c} times: it launches exactly "
                     f"{want_kernels[route]} ({counts})")
            if (name.startswith("conjunctive_topk") and name in want_kernels[route]
                    and c != multi_dispatches.get(route, c)):
                fail(f"route {route} launched {name} {c} times for "
                     f"{multi_dispatches[route]} multi-term dispatches")
    part("the routes' main and per-request-k batches")
    say(f"[path] multi-term dispatches on the main batch {multi_dispatches}: one "
        "conjunctive_topk launch each on every kernel route")
    t0 = time.perf_counter()
    fused = qac_serve_step(qidx, pids, plen, suf, slen, k=10)
    torch.cuda.synchronize()
    if not np.array_equal(fused.cpu().numpy(), answers["kernels"]):
        fail("qac_serve_step on the kernels differs from the kernel route's frontend")
    say(f"[path] qac_serve_step (heap_topk and one conjunctive_topk over the whole "
        f"batch) bit-identical to the kernel route on {args.batch} queries, "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
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
    if not ascending_lists(*host[:2]):
        fail("a postings list is not strictly ascending")
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

    part("the fused step and the brute-force checks")
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

    # ---- 7b. the docid-striped index ----------------------------------------
    counted["striped"] = striped_phase(torch, dev, qidx, inputs, tl, th, answers["kernels"],
                                       per_query_us["kernels"], smi, hold, reset_counts,
                                       read_counts)
    lap("7b")

    # ---- 8. the online runtime and the cluster ------------------------------
    counted["online"], online_ms = online_phase(torch, qidx, kept, args.seed, smi,
                                                reset_counts, read_counts)
    lap(8)

    # ---- 9. the live index --------------------------------------------------
    fresh_drill(torch, args.seed, smi, reset_counts, read_counts)
    part("the drill")
    counted["fresh"] = live_index_phase(torch, qidx, kept, sc_kept, args.seed, smi,
                                        online_ms, reset_counts, read_counts)
    lap(9)

    # ---- 10. the port's launcher ---------------------------------------------
    launcher_phase(smi)
    lap(10)

    # ---- 11. training -------------------------------------------------------
    counted["train"] = train_phase(torch, dev, args.seed, smi, hold, reset_counts, read_counts)
    lap(11)

    # ---- 12. the MoE archs ----------------------------------------------------
    counted.update(moe_phase(torch, dev, args.seed, smi, reset_counts, read_counts))
    lap(12)

    # ---- 13. MACE -------------------------------------------------------------
    mace_phase(torch, dev, args.seed, smi, reset_counts, read_counts)
    lap(13)

    # ---- 14. sharded execution -------------------------------------------------
    counted.update(shard_phase(torch, dev, args.seed, smi, reset_counts, read_counts))
    lap(14)

    # ---- 15. kernels line ---------------------------------------------------
    launches = {name: sum(counted[r][name] for r in v[4]) for name, v in KERNELS.items()}
    say(f"[launches] on the main paths, each kernel from its routes' runs: {launches}")
    line = []
    for name, (_, _, src, replaces, routes) in KERNELS.items():
        first = results[name][0]      # the headline: its first case, which names it
        line.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     **({"also_replaces": ALSO_REPLACES[name]} if name in ALSO_REPLACES
                        else {}),
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
