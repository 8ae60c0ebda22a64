// Device bodies shared by the QAC kernels, each written once.
//
//  * qac::rmq_window — the batched two-level RMQ of the JAX package's
//    kernels/rmq/ref.py::rmq_window_batch (two overlapping in-block windows
//    per partial block, two overlapping sparse-table windows for the middle
//    blocks), with its candidate order and tie rule: each window pair takes
//    its left window on ties, then (c1, c2), then (c3, c4), and the middle
//    wins only when strictly smaller. That is not "leftmost overall".
//    Written as three parts (qac::rmq_part: c1, c2, c3/c4) and their merge,
//    so that a warp can run one range's parts, or two ranges', on different
//    lanes (qac::rmq_warp_merge); rmq_window runs them on one thread.
//  * qac::raw_lookup — the raw postings lookup postings[min(ptr, n_post-1)].
//  * qac::packed_lookup<kEf> — the same lookup decoded from the compressed
//    postings (the JAX package's core/codecs.py::packed_lookup), in uint32_t
//    so that every shift is logical; kEf=false never reads the EF bitmap.
//  * qac::RawLookup / qac::PackedLookup<kEf> — the two as functors, the
//    template argument of the kernels that read postings.
//
// All read straight from device memory; the caller passes tables by pointer.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define QAC_INF 2147483647

namespace qac {

constexpr int kBlock = 128;  // RMQ block width (core/rmq.py BLOCK)

// The RangeMin arrays: values int32[n_pad] (INF padded to a kBlock multiple),
// ib int8[7, n_pad] in-block window argmin offsets, st_pos int32[levels,
// n_blocks] sparse table of global argmin positions over the block minima.
struct RmqTables {
  const int* __restrict__ values;
  const int8_t* __restrict__ ib;
  const int* __restrict__ st_pos;
  int n, n_pad, levels, n_blocks;
};

__device__ __forceinline__ int floor_log2(int x) { return 31 - __clz(x); }  // x >= 1

// (pos, val) of one candidate window.
struct RmqCand {
  int pos, val;
};

// One of rmq_window's three candidates over values[p..q] inclusive, after
// clamping p and q to [0, n-1]: part 0 the left partial block (c1), part 1
// the right partial block (c2; INF when both ends share a block), part 2 the
// whole blocks between (c3 and c4 merged; INF when there are none). Each
// part is two dependent rounds of two loads: the argmins of two overlapping
// windows (in-block offsets from ib, or global positions from the sparse
// table), then their two values; the pair takes its left window on ties.
// Every part of an inverted range is INF. The loads sit in load-only
// branches, so lanes of a warp that take different parts (or ranges) issue
// each round together and wait once.
__device__ __forceinline__ RmqCand rmq_part(const RmqTables& t, int p, int q,
                                            int part) {
  const int top = t.n > 0 ? t.n - 1 : 0;
  p = min(max(p, 0), top);
  const int qc = min(max(q, 0), top);
  const bool invalid = (p > qc) || (t.n == 0);
  const int bp = p / kBlock, bq = qc / kBlock;
  const bool same = bp == bq;
  const int cnt = bq - bp - 1;
  const bool live = part == 0 || (part == 1 ? !same : cnt > 0);
  // the partial block's window [wlo, whi]: [p, hi1] left, [bq*kBlock, qc] right
  const int wlo = part == 0 ? p : bq * kBlock;
  const int whi = part == 0 ? max(same ? qc : bp * kBlock + (kBlock - 1), p) : qc;
  const int j = floor_log2(max(whi - wlo + 1, 1));
  int pa = part == 2 ? 0 : wlo;
  int pb = part == 2 ? 0 : whi - (1 << j) + 1;
  int da = 0, db = 0;
  if (part < 2 && live && j > 0) {
    const int8_t* row = t.ib + (size_t)(j - 1) * t.n_pad;
    da = row[pa];
    db = row[pb];
  }
  if (part == 2 && live) {
    const int jc = min(floor_log2(cnt), t.levels - 1);
    const int lo_b = min(bp + 1, t.n_blocks - 1);
    const int hi_b = min(max(bq - (1 << jc), 0), t.n_blocks - 1);
    const int* row = t.st_pos + (size_t)jc * t.n_blocks;
    da = row[lo_b];
    db = row[hi_b];
  }
  pa += da;
  pb += db;
  int va = QAC_INF, vb = QAC_INF;
  if (live) {
    va = t.values[pa];
    vb = t.values[pb];
  }
  return {vb < va ? pb : pa, invalid ? QAC_INF : min(va, vb)};
}

// rmq_window's answer from its three parts: (c1, c2), then (c3, c4) only
// when strictly smaller.
__device__ __forceinline__ RmqCand rmq_merge(RmqCand c1, RmqCand c2, RmqCand c34) {
  const RmqCand c12{c2.val < c1.val ? c2.pos : c1.pos, min(c1.val, c2.val)};
  return {c34.val < c12.val ? c34.pos : c12.pos, min(c12.val, c34.val)};
}

// (pos, val) of the argmin over values[p..q] inclusive after clamping p and q
// to [0, n-1]; val is INF for an inverted range. Bit-identical to the plain
// version in val everywhere and in pos wherever val < INF. Reads that the
// plain version masks away (the right window when both ends share a block,
// the sparse table when no whole block lies between them) are skipped: they
// cannot change the result. One thread runs the three parts.
__device__ __forceinline__ void rmq_window(const RmqTables& t, int p, int q,
                                           int& out_pos, int& out_val) {
  const RmqCand c = rmq_merge(rmq_part(t, p, q, 0), rmq_part(t, p, q, 1),
                              rmq_part(t, p, q, 2));
  out_pos = c.pos;
  out_val = c.val;
}

// rmq_window over a warp: lanes first, first+1, first+2 hold parts 0, 1, 2
// of one range (rmq_part); every lane gets the merged answer. All 32 lanes
// must call it.
__device__ __forceinline__ RmqCand rmq_warp_merge(RmqCand c, int first) {
  const unsigned all = 0xFFFFFFFFu;
  const RmqCand c1{__shfl_sync(all, c.pos, first), __shfl_sync(all, c.val, first)};
  const RmqCand c2{__shfl_sync(all, c.pos, first + 1), __shfl_sync(all, c.val, first + 1)};
  const RmqCand c3{__shfl_sync(all, c.pos, first + 2), __shfl_sync(all, c.val, first + 2)};
  return rmq_merge(c1, c2, c3);
}

__device__ __forceinline__ int raw_lookup(const int* __restrict__ postings,
                                          int n_post, int ptr) {
  return postings[min(ptr, n_post - 1)];
}

constexpr int kPackBlock = 128;      // postings per block (core/codecs.py)
constexpr int kEfBitmapWords = 8;    // 256-bit EF upper-bits bitmap
constexpr int kMetaEfBit = 6;        // meta = width | (is_ef << kMetaEfBit)

// The PackedPostings arrays: words int32[W] payload stream; base, meta and
// wordoff int32[NB], the block directory. W >= 1 and NB >= 1 always.
struct PackedView {
  const int* __restrict__ words;
  const int* __restrict__ base;
  const int* __restrict__ meta;
  const int* __restrict__ wordoff;
  int W, n_post;
};

// postings[min(max(ptr, 0), n_post-1)] decoded from the packed stream. Every
// read is clamped as in the JAX package: the pointer to [0, max(n_post-1, 0)]
// (an empty index reads block 0 and the caller masks the result), both
// payload words and each bitmap word to W-1. Both shift-by-32 guards are
// kept: a field at bit offset 0 takes no straddle word, a width of 0 gives a
// mask of 0. Two dependent rounds: the block's directory, then its payload
// words and, on an EF block, all 8 bitmap words at once (no early exit, so
// no load waits on another's __popc). An EF block then selects the j-th set
// bit in registers: a __popc prefix over the words, then the 5-step binary
// strip inside the word that holds it. A bitpack block of an EF index reads
// no bitmap word (the JAX version computes the select and throws it away).
template <bool kEf>
__device__ __forceinline__ int packed_lookup(const PackedView& v, int ptr) {
  const int p = min(max(ptr, 0), max(v.n_post - 1, 0));
  const int b = p / kPackBlock;
  const uint32_t j = static_cast<uint32_t>(p % kPackBlock);
  const uint32_t bb = static_cast<uint32_t>(v.base[b]);
  const uint32_t mm = static_cast<uint32_t>(v.meta[b]);
  const int off = v.wordoff[b];
  const uint32_t wf = mm & ((1u << kMetaEfBit) - 1u);
  const uint32_t is_ef = (mm >> kMetaEfBit) & 1u;
  // fixed-width field j of the low/bitpack payload
  const uint32_t bit = j * wf;
  const int wi = off + static_cast<int>(is_ef << 3) + static_cast<int>(bit >> 5);
  const uint32_t bo = bit & 31u;
  const uint32_t w0 = static_cast<uint32_t>(v.words[min(wi, v.W - 1)]);
  const uint32_t w1 = static_cast<uint32_t>(v.words[min(wi + 1, v.W - 1)]);
  uint32_t bm[kEfBitmapWords];
#pragma unroll
  for (int t = 0; t < kEfBitmapWords; ++t) bm[t] = 0u;
  if (kEf && is_ef) {
#pragma unroll
    for (int t = 0; t < kEfBitmapWords; ++t)
      bm[t] = static_cast<uint32_t>(v.words[min(off + t, v.W - 1)]);
  }
  const uint32_t straddle = bo == 0 ? 0u : w1 << ((32u - bo) & 31u);
  const uint32_t mask = wf == 0 ? 0u : 0xFFFFFFFFu >> (32u - min(wf, 32u));
  const uint32_t low = ((w0 >> bo) | straddle) & mask;
  if (!kEf || !is_ef) return static_cast<int>(bb + low);
  // EF upper bits: the first word whose running count passes j holds the
  // j-th set bit, and r is j less the set bits before it (when no word
  // holds it, word 0 is taken as zero and the strip below gives 31)
  uint32_t r = j, sel_word = 0, sel_base = 0, before = 0;
  bool found = false;
#pragma unroll
  for (int t = 0; t < kEfBitmapWords; ++t) {
    const uint32_t c = __popc(bm[t]);
    const bool here = !found && j < before + c;
    sel_word = here ? bm[t] : sel_word;
    sel_base = here ? static_cast<uint32_t>(t) << 5 : sel_base;
    r = here ? j - before : r;
    found = found || here;
    before += c;
  }
  uint32_t pos = 0, cur = sel_word;
  for (uint32_t s = 16; s >= 1; s >>= 1) {
    const uint32_t part = cur & ((1u << s) - 1u);
    const uint32_t c = __popc(part);
    if (c <= r) {
      r -= c;
      pos += s;
      cur >>= s;
    } else {
      cur = part;
    }
  }
  const uint32_t high = sel_base + pos - j;
  return static_cast<int>(bb + ((high << wf) | low));
}

struct RawLookup {
  const int* __restrict__ postings;
  int n_post;
  __device__ __forceinline__ int operator()(int ptr) const {
    return raw_lookup(postings, n_post, ptr);
  }
};

template <bool kEf>
struct PackedLookup {
  PackedView v;
  __device__ __forceinline__ int operator()(int ptr) const {
    return packed_lookup<kEf>(v, ptr);
  }
};

}  // namespace qac

extern "C" __attribute__((visibility("default"))) const char* qac_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
