// The whole bounded-trip single-term engine (paper §3.3) in one launch, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/heap_topk/kernel.py::_kernel /
// heap_topk_kernel (JAX package), both its variants: raw postings, and
// packed postings (packed_ef not None, decoded in kernel by
// codecs.packed_lookup). The TPU kernel kept the five dense-slot heap arrays
// of a 128-lane tile in VMEM scratch and pinned the whole index (RMQ tables,
// offsets, raw or packed postings) in VMEM. On Hopper the index stays in
// device memory and L2; only the heap state is on chip. The one __global__
// is templated on its postings lookup: qac::RawLookup, or
// qac::PackedLookup<true> (an "ef" index) / <false> (a "bitpack" index).
// heap_topk_launch takes raw postings; heap_topk_packed_launch takes the
// packed ones and picks the instantiation from its `ef` flag.
//
// One thread per query lane. Its slots (kind/lo/hi/pos/val, cap = 2*trips+1
// each) live in dynamic shared memory laid out [5][cap][lanes], so a warp's
// accesses to one slot hit 32 distinct banks. Lanes per block shrink as cap
// grows so that the frontend's largest budget (k = 128, trips = 2k,
// cap = 513) still fits; the launch is checked and a refusal is raised.
//
// Each trip: the argmin over the slots written so far (first minimum wins,
// as jnp.argmin does: equal docids sit in range and iterator slots at once,
// so the lowest slot index decides emission order and `done`); emit unless
// the docid repeats the previous one, writing only while fewer than k were
// emitted (the plain version's drop sink); both split-subrange RMQs
// (qac::rmq_window) for a range pop, or the advance of an iterator; the
// offsets and postings reads that create or advance lazy iterators.
//
// Exits: once the popped minimum is INF, or k docids were emitted, no later
// trip can change `out` or `done`, so the loop stops there. Slots the plain
// version writes with INF after such a pop need no writes here.
//
// Bound: dependent gathers. A lane that emits k docids reads on the order of
// k pops x (2 RMQs of < 64 bytes + 3 offsets + 1 posting), a few KB, from a
// ~1 GB index: latency-bound, not bandwidth-bound, at any batch the frontend
// forms. A packed lookup is a chain of dependent reads in place of one: the
// block's directory (12 B), two payload words (8 B) and, on an EF block, up
// to 8 bitmap words (32 B). The design keeps the whole loop in one launch with the heap on chip
// (no per-pop launches or device-memory round trips of the heap state).
#include "qac_common.cuh"

namespace {

constexpr int kSmemBudget = 200 * 1024;  // of the 227 KB a block may use

template <class Lookup>
__global__ void heap_topk_kernel(qac::RmqTables t, const int* __restrict__ offsets,
                                 Lookup lookup, int n_terms,
                                 const int* __restrict__ term_lo,
                                 const int* __restrict__ term_hi,
                                 int* __restrict__ out,
                                 unsigned char* __restrict__ done, int B, int k,
                                 int trips) {
  extern __shared__ int smem[];
  const int L = blockDim.x;
  const int cap = 2 * trips + 1;
  const int b = blockIdx.x * L + threadIdx.x;
  if (b >= B) return;  // no block-wide barrier below
  int* kind = smem + threadIdx.x;  // slot s of this lane at kind[s * L]
  int* lo_a = kind + cap * L;
  int* hi_a = lo_a + cap * L;
  int* pos_a = hi_a + cap * L;
  int* val_a = pos_a + cap * L;

  const int tl = term_lo[b];
  const int hi_incl = term_hi[b] - 1;
  int pos0, val0;
  qac::rmq_window(t, tl, hi_incl, pos0, val0);
  kind[0] = 0;
  lo_a[0] = tl;
  hi_a[0] = hi_incl;
  pos_a[0] = pos0;
  val_a[0] = tl <= hi_incl ? val0 : QAC_INF;
  int used = 1;  // slots [0, used) are written; the rest are INF
  int* orow = out + (size_t)b * k;
  for (int c = 0; c < k; ++c) orow[c] = QAC_INF;
  int n_out = 0, prev = -1;

  for (int i = 0; i < trips && n_out < k; ++i) {
    int best = 0, bval = val_a[0];
    for (int s = 1; s < used; ++s) {
      const int v = val_a[s * L];
      if (v < bval) { bval = v; best = s; }
    }
    if (bval == QAC_INF) break;  // heap exhausted
    if (bval != prev) orow[n_out++] = bval;
    prev = bval;
    const int tstar = pos_a[best * L], lo = lo_a[best * L], hi = hi_a[best * L];
    const int nf = 1 + 2 * i;
    if (kind[best * L] == 0) {
      // range pop: keep the left part, open the right part and the
      // iterator of term tstar (its minimum was postings[start])
      int lpos = 0, lval = QAC_INF, rpos = 0, rval = QAC_INF;
      if (lo <= tstar - 1) qac::rmq_window(t, lo, tstar - 1, lpos, lval);
      if (tstar + 1 <= hi) qac::rmq_window(t, tstar + 1, hi, rpos, rval);
      const int ct = min(max(tstar, 0), n_terms);
      const int it_ptr = offsets[ct] + 1;
      const int it_val = it_ptr < offsets[ct + 1] ? lookup(it_ptr) : QAC_INF;
      hi_a[best * L] = tstar - 1;
      pos_a[best * L] = lpos;
      val_a[best * L] = lval;
      kind[nf * L] = 0;
      lo_a[nf * L] = tstar + 1;
      hi_a[nf * L] = hi;
      pos_a[nf * L] = rpos;
      val_a[nf * L] = rval;
      kind[(nf + 1) * L] = 1;
      lo_a[(nf + 1) * L] = tstar;  // an iterator keeps its term in lo
      hi_a[(nf + 1) * L] = -1;
      pos_a[(nf + 1) * L] = it_ptr;
      val_a[(nf + 1) * L] = it_val;
    } else {
      // iterator pop: advance it; the two fresh slots stay dead
      const int cl = min(max(lo, 0), n_terms);
      const int adv_ptr = tstar + 1;
      pos_a[best * L] = adv_ptr;
      val_a[best * L] = adv_ptr < offsets[cl + 1] ? lookup(adv_ptr) : QAC_INF;
      val_a[nf * L] = QAC_INF;
      val_a[(nf + 1) * L] = QAC_INF;
    }
    used = nf + 2;
  }
  int mn = QAC_INF;
  for (int s = 0; s < used; ++s) mn = min(mn, val_a[s * L]);
  done[b] = (n_out >= k) || (mn == QAC_INF);
}

template <class Lookup>
int launch(const qac::RmqTables& t, const int* offsets, Lookup lookup,
           int n_terms, const int* term_lo, const int* term_hi, int* out,
           unsigned char* done, int B, int k, int trips, void* stream) {
  const size_t lane_bytes = 5 * sizeof(int) * (size_t)(2 * trips + 1);
  int lanes = static_cast<int>(kSmemBudget / lane_bytes);
  lanes = lanes >= 32 ? 32 : (lanes < 1 ? 1 : lanes);
  const size_t smem = lane_bytes * lanes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        heap_topk_kernel<Lookup>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  heap_topk_kernel<Lookup><<<(B + lanes - 1) / lanes, lanes, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      t, offsets, lookup, n_terms, term_lo, term_hi, out, done, B, k, trips);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" __attribute__((visibility("default"))) int heap_topk_launch(
    const int* values, const int8_t* ib, const int* st_pos, int n, int n_pad,
    int levels, int n_blocks, const int* offsets, const int* postings,
    int n_post, int n_terms, const int* term_lo, const int* term_hi, int* out,
    unsigned char* done, int B, int k, int trips, void* stream) {
  const qac::RmqTables t{values, ib, st_pos, n, n_pad, levels, n_blocks};
  return launch(t, offsets, qac::RawLookup{postings, n_post}, n_terms, term_lo,
                term_hi, out, done, B, k, trips, stream);
}

extern "C" __attribute__((visibility("default"))) int heap_topk_packed_launch(
    const int* values, const int8_t* ib, const int* st_pos, int n, int n_pad,
    int levels, int n_blocks, const int* offsets, const int* words,
    const int* base, const int* meta, const int* wordoff, int W, int n_post,
    int ef, int n_terms, const int* term_lo, const int* term_hi, int* out,
    unsigned char* done, int B, int k, int trips, void* stream) {
  const qac::RmqTables t{values, ib, st_pos, n, n_pad, levels, n_blocks};
  const qac::PackedView v{words, base, meta, wordoff, W, n_post};
  if (ef)
    return launch(t, offsets, qac::PackedLookup<true>{v}, n_terms, term_lo,
                  term_hi, out, done, B, k, trips, stream);
  return launch(t, offsets, qac::PackedLookup<false>{v}, n_terms, term_lo,
                term_hi, out, done, B, k, trips, stream);
}
