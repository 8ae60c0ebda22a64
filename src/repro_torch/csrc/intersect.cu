// Fused conjunctive probe + forward-range check (paper Fig 5 inner loop) for
// Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package:
// kernels/intersect/kernel.py::_kernel / conjunctive_scan_kernel (raw
// postings) and ::_kernel_packed / conjunctive_scan_packed_kernel (packed
// postings, decoded in kernel by codecs.packed_lookup). The raw TPU kernel
// searched [B, P, L] probe lists that the caller had gathered into VMEM,
// which capped the longest list at a power-of-two pad; the packed one pinned
// the whole compressed index in VMEM and searched spans. Here each thread
// owns one (row, candidate) and binary-searches each needed slot's
// [start, end) span of the postings in device memory directly, with `iters`
// valid-guarded halvings (the packed TPU kernel's loop). No gather, no
// list-length bound. The one __global__ is templated on its postings lookup:
// qac::RawLookup, or qac::PackedLookup<true> ("ef") / <false> ("bitpack"),
// the packed launcher picking one from its `ef` flag.
// It then reads the candidate's forward-index row itself (zeros for a docid
// outside [0, N), as Completions.extract gives) and tests the suffix term
// range.
//
// Bound: dependent gathers. A live candidate reads one 32-byte forward row
// and, for each needed slot, ceil(log2(span + 1)) + 1 postings words, one
// dependent load per halving. The design checks the forward row first and
// stops probing at the first slot that misses, so dead candidates cost
// one row read; neighbouring threads search the same spans, so the first
// halvings of a warp hit the same lines. A packed probe is a chain of
// dependent reads in place of one: the block's directory (12 B), two payload
// words (8 B) and, on an EF block, up to 8 bitmap words (32 B).
#include "qac_common.cuh"

namespace {

template <class Lookup>
__global__ void conjunctive_scan_kernel(
    const int* __restrict__ cands, const int* __restrict__ starts,
    const int* __restrict__ ends, Lookup lookup,
    const int* __restrict__ fwd_terms, int n_docs, int M,
    const int* __restrict__ term_lo, const int* __restrict__ term_hi,
    unsigned char* __restrict__ out, int B, int T, int P, int iters) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * T) return;
  const int b = idx / T;
  const int cand = cands[idx];
  bool ok = cand != QAC_INF;
  if (ok) {
    const int tlo = term_lo[b], thi = term_hi[b];
    bool fwd_ok = false;
    if (cand >= 0 && cand < n_docs) {
      const int* row = fwd_terms + (size_t)cand * M;
      for (int m = 0; m < M; ++m) {
        const int v = row[m];
        fwd_ok |= (v >= tlo) && (v < thi);
      }
    } else {
      fwd_ok = M > 0 && tlo <= 0 && 0 < thi;  // a row of zeros
    }
    ok = fwd_ok;
  }
  for (int p = 0; p < P && ok; ++p) {
    const int s = starts[b * P + p], e = ends[b * P + p];
    if (e <= s) continue;  // unused slot, or an empty list the caller handles
    int lo = s, hi = e;
    for (int it = 0; it < iters && lo < hi; ++it) {
      const int mid = lo + ((hi - lo) >> 1);
      if (lookup(mid) < cand) lo = mid + 1;
      else hi = mid;
    }
    ok = lo < e && lookup(lo) == cand;
  }
  out[idx] = ok;
}

template <class Lookup>
int launch(const int* cands, const int* starts, const int* ends, Lookup lookup,
           const int* fwd_terms, int n_docs, int M, const int* term_lo,
           const int* term_hi, unsigned char* out, int B, int T, int P,
           int iters, void* stream) {
  const int threads = 128;
  const int total = B * T;
  conjunctive_scan_kernel<Lookup><<<(total + threads - 1) / threads, threads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      cands, starts, ends, lookup, fwd_terms, n_docs, M, term_lo, term_hi, out,
      B, T, P, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" __attribute__((visibility("default"))) int conjunctive_scan_launch(
    const int* cands, const int* starts, const int* ends, const int* postings,
    int n_post, const int* fwd_terms, int n_docs, int M, const int* term_lo,
    const int* term_hi, unsigned char* out, int B, int T, int P, int iters,
    void* stream) {
  return launch(cands, starts, ends, qac::RawLookup{postings, n_post},
                fwd_terms, n_docs, M, term_lo, term_hi, out, B, T, P, iters,
                stream);
}

extern "C" __attribute__((visibility("default"))) int conjunctive_scan_packed_launch(
    const int* cands, const int* starts, const int* ends, const int* words,
    const int* base, const int* meta, const int* wordoff, int W, int n_post,
    int ef, const int* fwd_terms, int n_docs, int M, const int* term_lo,
    const int* term_hi, unsigned char* out, int B, int T, int P, int iters,
    void* stream) {
  const qac::PackedView v{words, base, meta, wordoff, W, n_post};
  if (ef)
    return launch(cands, starts, ends, qac::PackedLookup<true>{v}, fwd_terms,
                  n_docs, M, term_lo, term_hi, out, B, T, P, iters, stream);
  return launch(cands, starts, ends, qac::PackedLookup<false>{v}, fwd_terms,
                n_docs, M, term_lo, term_hi, out, B, T, P, iters, stream);
}
