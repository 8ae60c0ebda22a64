// Device bodies shared by the QAC kernels, each written once.
//
//  * qac::rmq_window — the batched two-level RMQ of the JAX package's
//    kernels/rmq/ref.py::rmq_window_batch (two overlapping in-block windows
//    per partial block, two overlapping sparse-table windows for the middle
//    blocks), with its candidate order and tie rule: each window pair takes
//    its left window on ties, then (c1, c2), then (c3, c4), and the middle
//    wins only when strictly smaller. That is not "leftmost overall".
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

// (pos, val) of the argmin over values[p..q] inclusive after clamping p and q
// to [0, n-1]; val is INF for an inverted range. Bit-identical to the plain
// version in val everywhere and in pos wherever val < INF. Reads that the
// plain version masks away (the right window when both ends share a block,
// the sparse table when no whole block lies between them) are skipped: they
// cannot change the result.
__device__ __forceinline__ void rmq_window(const RmqTables& t, int p, int q,
                                           int& out_pos, int& out_val) {
  const int top = t.n > 0 ? t.n - 1 : 0;
  p = min(max(p, 0), top);
  const int qc = min(max(q, 0), top);
  const bool invalid = (p > qc) || (t.n == 0);
  const int bp = p / kBlock, bq = qc / kBlock;
  const bool same = bp == bq;
  // left partial block [p, hi1]
  const int hi1 = max(same ? qc : bp * kBlock + (kBlock - 1), p);
  const int j1 = floor_log2(hi1 - p + 1);
  const int s1 = hi1 - (1 << j1) + 1;
  int p1a = p, p1b = s1;
  if (j1 > 0) {
    const int8_t* row = t.ib + (size_t)(j1 - 1) * t.n_pad;
    p1a += row[p];
    p1b += row[s1];
  }
  const int v1a = t.values[p1a], v1b = t.values[p1b];
  const int c1_pos = v1b < v1a ? p1b : p1a;
  const int c1_val = min(v1a, v1b);
  // right partial block [bq*kBlock, qc]
  int c2_pos = 0, c2_val = QAC_INF;
  if (!same) {
    const int lo2 = bq * kBlock;
    const int j2 = floor_log2(qc - lo2 + 1);
    const int s2 = qc - (1 << j2) + 1;
    int p2a = lo2, p2b = s2;
    if (j2 > 0) {
      const int8_t* row = t.ib + (size_t)(j2 - 1) * t.n_pad;
      p2a += row[lo2];
      p2b += row[s2];
    }
    const int v2a = t.values[p2a], v2b = t.values[p2b];
    c2_pos = v2b < v2a ? p2b : p2a;
    c2_val = min(v2a, v2b);
  }
  // whole blocks between: two overlapping sparse-table windows
  int c3_pos = 0, c3_val = QAC_INF, c4_pos = 0, c4_val = QAC_INF;
  const int cnt = bq - bp - 1;
  if (cnt > 0) {
    const int jc = min(floor_log2(cnt), t.levels - 1);
    const int lo_b = min(bp + 1, t.n_blocks - 1);
    const int hi_b = min(max(bq - (1 << jc), 0), t.n_blocks - 1);
    const int* row = t.st_pos + (size_t)jc * t.n_blocks;
    c3_pos = row[lo_b];
    c4_pos = row[hi_b];
    c3_val = t.values[c3_pos];
    c4_val = t.values[c4_pos];
  }
  const int p12 = c2_val < c1_val ? c2_pos : c1_pos;
  const int v12 = min(c1_val, c2_val);
  const int p34 = c4_val < c3_val ? c4_pos : c3_pos;
  const int v34 = min(c3_val, c4_val);
  out_pos = v34 < v12 ? p34 : p12;
  out_val = invalid ? QAC_INF : min(v12, v34);
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
// mask of 0. An EF block selects the j-th set bit of its bitmap with __popc
// over the words and the 5-step binary strip inside the word; a bitpack
// block of an EF index skips the select (the JAX version computes it and
// throws it away).
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
  const uint32_t straddle = bo == 0 ? 0u : w1 << ((32u - bo) & 31u);
  const uint32_t mask = wf == 0 ? 0u : 0xFFFFFFFFu >> (32u - min(wf, 32u));
  const uint32_t low = ((w0 >> bo) | straddle) & mask;
  if (!kEf || !is_ef) return static_cast<int>(bb + low);
  // EF upper bits: the word that holds the j-th set bit, then its position
  uint32_t r = j, sel_word = 0, sel_base = 0;
  for (int t = 0; t < kEfBitmapWords; ++t) {
    const uint32_t wt = static_cast<uint32_t>(v.words[min(off + t, v.W - 1)]);
    const uint32_t c = __popc(wt);
    if (r < c) {
      sel_word = wt;
      sel_base = static_cast<uint32_t>(t) << 5;
      break;
    }
    r -= c;
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
