// The conjunctive probe + forward-range check (paper Fig 5 inner loop), and
// the whole multi-term engine around it, for Hopper (sm_90a).
//
// Two __global__s share one device body, conjunctive_hit<Lookup>: the
// candidate's forward-index row first (zeros for a docid outside [0, N), as
// Completions.extract gives; the suffix term range test), then, for each
// needed slot, `iters` valid-guarded halvings over its [start, end) span of
// the postings in device memory, stopping at the first slot that misses.
// Both are templated on the postings lookup: qac::RawLookup, or
// qac::PackedLookup<true> ("ef") / <false> ("bitpack"), each packed launcher
// picking one from its `ef` flag.
//
// conjunctive_scan_kernel: one thread per (row, candidate) of a [B, T] tile.
// Replaces the TPU kernels kernels/intersect/kernel.py::_kernel /
// conjunctive_scan_kernel (raw postings) and ::_kernel_packed /
// conjunctive_scan_packed_kernel (packed postings, decoded in kernel by
// codecs.packed_lookup). The raw TPU kernel searched [B, P, L] probe lists
// that the caller had gathered into VMEM, which capped the longest list at
// a power-of-two pad; the packed one pinned the whole compressed index in
// VMEM and searched spans. Here there is no gather and no list-length bound.
// It reads an unstriped forward index (row d = docid d): it is held against
// its plain version off the serving path and takes no stride.
//
// conjunctive_topk_kernel: the multi-term engine's whole candidate loop in
// one launch. Replaces those two kernels together with the lax.while_loop
// of the JAX package's core/search.py::conjunctive_multi_batch around them
// (one tile a step). A lane's answer is the first k hits, in driver-list
// order, among the first min(d_len, cap) candidates of its driver list
// (cap = max_tiles * tile), INF-padded; a dead lane's is all INF. Its
// forward rows may be a docid stripe's (fwd_stride = the stripe count, row
// d / stride), so the striped index's stripes serve through it; the JAX
// package's Pallas kernel never reads rows, LocalFwd.extract gathers them
// before it. The tile
// width enters the answer only through the cap, so one block per lane walks
// its candidates in chunks of kTopkThreads * kTopkPerThread and is
// bit-identical to the tile loop: each thread probes kTopkPerThread
// candidates (their loads and forward rows in flight together), a warp
// __ballot_sync and __popc rank the hits inside a warp, a prefix over the
// warps' counts in shared memory ranks them in the chunk, hits ranked below
// k store, and the block leaves at k hits, at the cap or at d_end. It never
// reads past d_end, syncs nothing with the host and writes only `out`.
//
// Bound: dependent gathers. A live candidate reads one 32-byte forward row
// and, for each needed slot, ceil(log2(span + 1)) + 1 postings words, one
// dependent load per halving. The forward row comes first and probing stops
// at the first slot that misses, so most candidates cost one row read;
// neighbouring threads search the same spans, so the first halvings of a
// warp hit the same lines. A packed probe is a chain of dependent reads in
// place of one: the block's directory (12 B), two payload words (8 B) and,
// on an EF block, up to 8 bitmap words (32 B). In the top-k kernel the
// longest lane sets the time: one block walks up to `cap` candidates in
// order. Splitting such a lane over several blocks, each finding its own
// first k, with a merge in segment order, is the lever if it dominates.
#include "qac_common.cuh"

namespace {

// The forward-index test: does the candidate's row hold a term in
// [tlo, thi)? With stride 1 row d is docid d, and a docid outside
// [0, n_rows) reads a row of zeros (Completions.extract). A docid stripe's
// rows hold every stride-th docid (core/striped.py::LocalFwd.extract): row
// d / stride, and a docid outside [0, n_rows * stride) reads zeros. The
// branch on the stride is uniform over a launch, so the unstriped path pays
// no integer divide.
__device__ __forceinline__ bool fwd_row_hits(const int* __restrict__ fwd_terms,
                                             int n_rows, int stride, int M,
                                             int cand, int tlo, int thi) {
  int r = cand;
  if (stride == 1) {
    if (cand < 0 || cand >= n_rows) return M > 0 && tlo <= 0 && 0 < thi;
  } else {
    if (cand < 0 || static_cast<long long>(cand) >=
                        static_cast<long long>(n_rows) * stride)
      return M > 0 && tlo <= 0 && 0 < thi;
    r = cand / stride;
  }
  const int* row = fwd_terms + (size_t)r * M;
  bool ok = false;
  for (int m = 0; m < M; ++m) {
    const int v = row[m];
    ok |= (v >= tlo) && (v < thi);
  }
  return ok;
}

// The span probes: is the candidate in every [starts[p], ends[p]) span? A
// slot with end <= start is skipped (unused, or an empty list whose lane the
// caller kills). `iters` guarded halvings a span; stops at the first miss.
template <class Lookup>
__device__ __forceinline__ bool spans_hold(const int* starts, const int* ends,
                                           int P, Lookup lookup, int cand,
                                           int iters) {
  for (int p = 0; p < P; ++p) {
    const int s = starts[p], e = ends[p];
    if (e <= s) continue;
    int lo = s, hi = e;
    for (int it = 0; it < iters && lo < hi; ++it) {
      const int mid = lo + ((hi - lo) >> 1);
      if (lookup(mid) < cand) lo = mid + 1;
      else hi = mid;
    }
    if (!(lo < e && lookup(lo) == cand)) return false;
  }
  return true;
}

// The device body both kernels share: the forward row, then the spans.
template <class Lookup>
__device__ __forceinline__ bool conjunctive_hit(
    int cand, const int* starts, const int* ends, int P, Lookup lookup,
    const int* __restrict__ fwd_terms, int n_docs, int M, int tlo, int thi,
    int iters) {
  return cand != QAC_INF && fwd_row_hits(fwd_terms, n_docs, 1, M, cand, tlo, thi)
         && spans_hold(starts, ends, P, lookup, cand, iters);
}

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
  out[idx] = conjunctive_hit(cands[idx], starts + b * P, ends + b * P, P,
                             lookup, fwd_terms, n_docs, M, term_lo[b],
                             term_hi[b], iters);
}

constexpr int kTopkThreads = 256;
constexpr int kTopkPerThread = 4;
constexpr int kTopkWarps = kTopkThreads / 32;
constexpr int kTopkChunk = kTopkThreads * kTopkPerThread;

// One block per lane b. Chunk c holds the lane's candidates
// [c * kTopkChunk, (c + 1) * kTopkChunk), candidate r * kTopkThreads + tid
// of it on thread tid: each r-slice of a chunk is in thread order and the
// slices are in r order, which is the rank order. `found` is the same in
// every thread (each sums the same counts), so the loop's exit is uniform.
// The warps' counts are double-buffered: one __syncthreads a chunk.
// conjunctive_hit runs in its two steps, so that the forward rows of a
// thread's candidates are in flight together before any span is searched.
template <class Lookup>
__global__ void __launch_bounds__(kTopkThreads) conjunctive_topk_kernel(
    const int* __restrict__ postings, int n_post,
    const int* __restrict__ d_start, const int* __restrict__ d_end,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ dead, Lookup lookup,
    const int* __restrict__ fwd_terms, int n_docs, int fwd_stride, int M,
    const int* __restrict__ term_lo, const int* __restrict__ term_hi,
    int* __restrict__ out, int k, long long cap, int P, int iters) {
  extern __shared__ int span[];   // [2P]: the lane's starts, then its ends
  __shared__ int counts[2][kTopkPerThread][kTopkWarps];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  int* row_out = out + (size_t)b * k;
  int found = 0;
  if (!dead[b]) {
    for (int p = tid; p < P; p += kTopkThreads) {
      span[p] = starts[(size_t)b * P + p];
      span[P + p] = ends[(size_t)b * P + p];
    }
    __syncthreads();
    const int s = d_start[b];
    const long long len = static_cast<long long>(d_end[b]) - s;
    const int limit = static_cast<int>(max(0LL, min(len, cap)));
    const int tlo = term_lo[b], thi = term_hi[b];
    int buf = 0;
    for (int base = 0; base < limit && found < k; base += kTopkChunk, buf ^= 1) {
      int cand[kTopkPerThread], rank[kTopkPerThread];
      bool hit[kTopkPerThread];
#pragma unroll
      for (int r = 0; r < kTopkPerThread; ++r) {
        const int pos = base + r * kTopkThreads + tid;
        cand[r] = pos < limit ? postings[min(s + pos, n_post - 1)] : QAC_INF;
      }
#pragma unroll
      for (int r = 0; r < kTopkPerThread; ++r)
        hit[r] = cand[r] != QAC_INF &&
                 fwd_row_hits(fwd_terms, n_docs, fwd_stride, M, cand[r], tlo,
                              thi);
#pragma unroll
      for (int r = 0; r < kTopkPerThread; ++r) {
        hit[r] = hit[r] && spans_hold(span, span + P, P, lookup, cand[r], iters);
        const unsigned m = __ballot_sync(0xFFFFFFFFu, hit[r]);
        rank[r] = __popc(m & below);
        if (lane == 0) counts[buf][r][warp] = __popc(m);
      }
      __syncthreads();
      int run = found;
#pragma unroll
      for (int r = 0; r < kTopkPerThread; ++r) {
        for (int w = 0; w < kTopkWarps; ++w) {
          if (w == warp) rank[r] += run;
          run += counts[buf][r][w];
        }
        if (hit[r] && rank[r] < k) row_out[rank[r]] = cand[r];
      }
      found = min(run, k);
    }
  }
  for (int i = found + tid; i < k; i += kTopkThreads) row_out[i] = QAC_INF;
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

template <class Lookup>
int launch_topk(const int* postings, int n_post, const int* d_start,
                const int* d_end, const int* starts, const int* ends,
                const int* dead, Lookup lookup, const int* fwd_terms,
                int n_docs, int fwd_stride, int M, const int* term_lo,
                const int* term_hi, int* out, int B, int k, long long cap,
                int P, int iters, void* stream) {
  conjunctive_topk_kernel<Lookup><<<B, kTopkThreads, 2 * P * sizeof(int),
                                    static_cast<cudaStream_t>(stream)>>>(
      postings, n_post, d_start, d_end, starts, ends, dead, lookup, fwd_terms,
      n_docs, fwd_stride, M, term_lo, term_hi, out, k, cap, P, iters);
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

extern "C" __attribute__((visibility("default"))) int conjunctive_topk_launch(
    const int* postings, int n_post, const int* d_start, const int* d_end,
    const int* starts, const int* ends, const int* dead, const int* fwd_terms,
    int n_docs, int fwd_stride, int M, const int* term_lo, const int* term_hi,
    int* out, int B, int k, long long cap, int P, int iters, void* stream) {
  return launch_topk(postings, n_post, d_start, d_end, starts, ends, dead,
                     qac::RawLookup{postings, n_post}, fwd_terms, n_docs,
                     fwd_stride, M, term_lo, term_hi, out, B, k, cap, P, iters,
                     stream);
}

extern "C" __attribute__((visibility("default"))) int conjunctive_topk_packed_launch(
    const int* postings, int n_post, const int* d_start, const int* d_end,
    const int* starts, const int* ends, const int* dead, const int* words,
    const int* base, const int* meta, const int* wordoff, int W, int ef,
    const int* fwd_terms, int n_docs, int fwd_stride, int M,
    const int* term_lo, const int* term_hi, int* out, int B, int k,
    long long cap, int P, int iters, void* stream) {
  const qac::PackedView v{words, base, meta, wordoff, W, n_post};
  if (ef)
    return launch_topk(postings, n_post, d_start, d_end, starts, ends, dead,
                       qac::PackedLookup<true>{v}, fwd_terms, n_docs,
                       fwd_stride, M, term_lo, term_hi, out, B, k, cap, P,
                       iters, stream);
  return launch_topk(postings, n_post, d_start, d_end, starts, ends, dead,
                     qac::PackedLookup<false>{v}, fwd_terms, n_docs,
                     fwd_stride, M, term_lo, term_hi, out, B, k, cap, P, iters,
                     stream);
}
