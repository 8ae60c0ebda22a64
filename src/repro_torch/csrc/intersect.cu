// Fused conjunctive probe + forward-range check (paper Fig 5 inner loop) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/intersect/kernel.py::_kernel /
// conjunctive_scan_kernel (JAX package, raw postings). The TPU kernel
// searched [B, P, L] probe lists that the caller had gathered into VMEM,
// which capped the longest list at a power-of-two pad. Here each thread owns
// one (row, candidate) and binary-searches each needed slot's [start, end)
// span of the raw postings in device memory directly, with `iters`
// valid-guarded halvings (the loop of the packed TPU kernel
// kernels/intersect/kernel.py::_kernel_packed, with a raw lookup). No gather,
// no list-length bound. It then reads the candidate's forward-index row
// itself (zeros for a docid outside [0, N), as Completions.extract gives)
// and tests the suffix term range.
//
// Bound: dependent gathers. A live candidate reads one 32-byte forward row
// and, for each needed slot, ceil(log2(span + 1)) + 1 postings words, one
// dependent load per halving. The design checks the forward row first and
// stops probing at the first slot that misses, so dead candidates cost
// one row read; neighbouring threads search the same spans, so the first
// halvings of a warp hit the same lines.
#include "qac_common.cuh"

namespace {

__global__ void conjunctive_scan_kernel(
    const int* __restrict__ cands, const int* __restrict__ starts,
    const int* __restrict__ ends, const int* __restrict__ postings, int n_post,
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
      if (qac::raw_lookup(postings, n_post, mid) < cand) lo = mid + 1;
      else hi = mid;
    }
    ok = lo < e && qac::raw_lookup(postings, n_post, lo) == cand;
  }
  out[idx] = ok;
}

}  // namespace

extern "C" __attribute__((visibility("default"))) int conjunctive_scan_launch(
    const int* cands, const int* starts, const int* ends, const int* postings,
    int n_post, const int* fwd_terms, int n_docs, int M, const int* term_lo,
    const int* term_hi, unsigned char* out, int B, int T, int P, int iters,
    void* stream) {
  const int threads = 128;
  const int total = B * T;
  conjunctive_scan_kernel<<<(total + threads - 1) / threads, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      cands, starts, ends, postings, n_post, fwd_terms, n_docs, M, term_lo,
      term_hi, out, B, T, P, iters);
  return static_cast<int>(cudaGetLastError());
}
