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
// One warp per query lane, `warps` lanes a block (ops.py::plan_heap_launch
// picks them and the shared bytes; B=256 fills 64 blocks). A lane's slots
// (kind/lo/hi/pos/val, cap = 2*trips+1 each) sit in its warp's share of
// dynamic shared memory, [5][cap]; slot s belongs to thread s % 32, and only
// that thread ever reads or writes it (the warp trades values by shuffles),
// so the slots need no warp barrier. The launch is checked and a shared
// memory plan the card cannot run is refused.
//
// Each trip:
//  * the pop: each thread keeps the minimum (val, slot) of its own slots; the
//    warp's argmin is two redux.sync minima, the value and then the lowest
//    slot holding it. That is jnp.argmin's first minimum, which decides
//    emission order and `done` when one docid sits in a range slot and an
//    iterator slot at once. A trip changes at most 3 slots (best, nf,
//    nf + 1): the owner of best rescans its own slots, the owners of nf and
//    nf + 1 compare their new value;
//  * emit unless the docid repeats the previous one;
//  * a range pop's reads, in flight together: lanes 0-2 run the three parts
//    of the left split-subrange RMQ (qac::rmq_part), lanes 3-5 the right one
//    (the other lanes repeat them at the same addresses), and every lane
//    reads offsets[ct], offsets[ct+1] and then the new iterator's posting.
//    Two dependent rounds raw (the RMQ windows and the offsets, then the
//    values and the posting), three packed (the block directory comes
//    between). An iterator pop reads offsets[cl+1] and its next posting
//    together: one round raw, two packed. Every such read is clamped, so a
//    posting past the list's end is read and dropped, not skipped.
//
// Exits: once the popped minimum is INF, or k docids were emitted, no later
// trip can change `out` or `done`, so the loop stops there; `done` is
// n_out >= k || min == INF, and the row is INF-padded past n_out.
//
// Bound: dependent gathers. A lane that emits k docids reads on the order of
// k pops x (2 RMQs of < 64 bytes + 3 offsets + 1 posting), a few KB, from a
// ~1 GB index: latency-bound, not bandwidth-bound, at any batch the frontend
// forms. So the design shortens the chain a trip waits on: 2 dependent
// rounds of reads where one thread running both RMQs and the iterator in
// turn waits on 5-6, and two warp reductions where it scans up to
// 2*trips+1 slots. On an H100 a raw trip takes ~1.0-1.2 us (PERF.md).
#include "qac_common.cuh"

namespace {

constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kNoSlot = 0x7FFFFFFF;

template <class Lookup>
__global__ void heap_topk_kernel(qac::RmqTables t, const int* __restrict__ offsets,
                                 Lookup lookup, int n_terms,
                                 const int* __restrict__ term_lo,
                                 const int* __restrict__ term_hi,
                                 int* __restrict__ out,
                                 unsigned char* __restrict__ done, int B, int k,
                                 int trips) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + w;
  if (b >= B) return;  // the whole warp; no block-wide barrier below
  const int cap = 2 * trips + 1;
  int* kind = smem + (size_t)w * 5 * cap;
  int* lo_a = kind + cap;
  int* hi_a = lo_a + cap;
  int* pos_a = hi_a + cap;
  int* val_a = pos_a + cap;
  for (int s = lane; s < cap; s += 32) val_a[s] = QAC_INF;

  // slot 0: the lane's whole term range, its RMQ parts on lanes 0-2
  const int tl = term_lo[b];
  const int hi_incl = term_hi[b] - 1;
  const qac::RmqCand r0 =
      qac::rmq_warp_merge(qac::rmq_part(t, tl, hi_incl, lane % 3), 0);
  int mval = QAC_INF, mslot = kNoSlot;  // this thread's (val, slot) minimum
  if (lane == 0) {
    kind[0] = 0;
    lo_a[0] = tl;
    hi_a[0] = hi_incl;
    pos_a[0] = r0.pos;
    val_a[0] = tl <= hi_incl ? r0.val : QAC_INF;
    mval = val_a[0];
    mslot = 0;
  }
  int* orow = out + (size_t)b * k;
  int n_out = 0, prev = -1, used = 1;  // slots [0, used) may be live
  int bval = __reduce_min_sync(kAll, mval);

  for (int i = 0; i < trips && n_out < k && bval != QAC_INF; ++i) {
    const int best = __reduce_min_sync(kAll, mval == bval ? mslot : kNoSlot);
    if (bval != prev) {
      if (lane == 0) orow[n_out] = bval;
      ++n_out;
    }
    prev = bval;
    const int owner = best & 31;
    int f_kind = 0, f_lo = 0, f_hi = 0, f_pos = 0;
    if (lane == owner) {
      f_kind = kind[best];
      f_lo = lo_a[best];
      f_hi = hi_a[best];
      f_pos = pos_a[best];
    }
    const int kd = __shfl_sync(kAll, f_kind, owner);
    const int lo = __shfl_sync(kAll, f_lo, owner);
    const int hi = __shfl_sync(kAll, f_hi, owner);
    const int tstar = __shfl_sync(kAll, f_pos, owner);
    const int nf = 1 + 2 * i;
    used = nf + 2;
    if (kd == 0) {
      // range pop: keep the left part, open the right part and the
      // iterator of term tstar (its minimum was postings[start])
      const int g = lane % 6;
      const bool right = g >= 3;
      const qac::RmqCand part = qac::rmq_part(t, right ? tstar + 1 : lo,
                                              right ? hi : tstar - 1, right ? g - 3 : g);
      const int ct = min(max(tstar, 0), n_terms);
      const int it_ptr = offsets[ct] + 1;
      const int it_end = offsets[ct + 1];
      const int it_look = lookup(it_ptr);
      const qac::RmqCand left = qac::rmq_warp_merge(part, 0);
      const qac::RmqCand rgt = qac::rmq_warp_merge(part, 3);
      const int lval = lo <= tstar - 1 ? left.val : QAC_INF;
      const int rval = tstar + 1 <= hi ? rgt.val : QAC_INF;
      const int it_val = it_ptr < it_end ? it_look : QAC_INF;
      if (lane == owner) {
        hi_a[best] = tstar - 1;
        pos_a[best] = left.pos;
        val_a[best] = lval;
      }
      if (lane == (nf & 31)) {
        kind[nf] = 0;
        lo_a[nf] = tstar + 1;
        hi_a[nf] = hi;
        pos_a[nf] = rgt.pos;
        val_a[nf] = rval;
        if (lane != owner && rval < mval) {
          mval = rval;
          mslot = nf;
        }
      }
      if (lane == ((nf + 1) & 31)) {
        kind[nf + 1] = 1;
        lo_a[nf + 1] = tstar;  // an iterator keeps its term in lo
        hi_a[nf + 1] = -1;
        pos_a[nf + 1] = it_ptr;
        val_a[nf + 1] = it_val;
        if (lane != owner && it_val < mval) {
          mval = it_val;
          mslot = nf + 1;
        }
      }
    } else {
      // iterator pop: advance it; the two fresh slots stay INF
      const int cl = min(max(lo, 0), n_terms);
      const int adv_ptr = tstar + 1;
      const int adv_end = offsets[cl + 1];
      const int adv_look = lookup(adv_ptr);
      if (lane == owner) {
        pos_a[best] = adv_ptr;
        val_a[best] = adv_ptr < adv_end ? adv_look : QAC_INF;
      }
    }
    if (lane == owner) {  // best's value rose: rescan this thread's slots
      mval = QAC_INF;
      mslot = kNoSlot;
      for (int s = lane; s < used; s += 32) {
        const int v = val_a[s];
        if (v < mval) {
          mval = v;
          mslot = s;
        }
      }
    }
    bval = __reduce_min_sync(kAll, mval);
  }
  for (int c = n_out + lane; c < k; c += 32) orow[c] = QAC_INF;
  if (lane == 0) done[b] = (n_out >= k) || (bval == QAC_INF);
}

template <class Lookup>
int launch(const qac::RmqTables& t, const int* offsets, Lookup lookup,
           int n_terms, const int* term_lo, const int* term_hi, int* out,
           unsigned char* done, int B, int k, int trips, int blocks, int warps,
           int smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        heap_topk_kernel<Lookup>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  heap_topk_kernel<Lookup><<<blocks, warps * 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      t, offsets, lookup, n_terms, term_lo, term_hi, out, done, B, k, trips);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" __attribute__((visibility("default"))) int heap_topk_launch(
    const int* values, const int8_t* ib, const int* st_pos, int n, int n_pad,
    int levels, int n_blocks, const int* offsets, const int* postings,
    int n_post, int n_terms, const int* term_lo, const int* term_hi, int* out,
    unsigned char* done, int B, int k, int trips, int blocks, int warps,
    int smem, void* stream) {
  const qac::RmqTables t{values, ib, st_pos, n, n_pad, levels, n_blocks};
  return launch(t, offsets, qac::RawLookup{postings, n_post}, n_terms, term_lo,
                term_hi, out, done, B, k, trips, blocks, warps, smem, stream);
}

extern "C" __attribute__((visibility("default"))) int heap_topk_packed_launch(
    const int* values, const int8_t* ib, const int* st_pos, int n, int n_pad,
    int levels, int n_blocks, const int* offsets, const int* words,
    const int* base, const int* meta, const int* wordoff, int W, int n_post,
    int ef, int n_terms, const int* term_lo, const int* term_hi, int* out,
    unsigned char* done, int B, int k, int trips, int blocks, int warps,
    int smem, void* stream) {
  const qac::RmqTables t{values, ib, st_pos, n, n_pad, levels, n_blocks};
  const qac::PackedView v{words, base, meta, wordoff, W, n_post};
  if (ef)
    return launch(t, offsets, qac::PackedLookup<true>{v}, n_terms, term_lo,
                  term_hi, out, done, B, k, trips, blocks, warps, smem, stream);
  return launch(t, offsets, qac::PackedLookup<false>{v}, n_terms, term_lo,
                term_hi, out, done, B, k, trips, blocks, warps, smem, stream);
}
