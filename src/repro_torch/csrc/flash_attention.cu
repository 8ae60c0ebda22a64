// Flash attention for Hopper (sm_90a): prefill and KV-cache decode.
//
// Replaces the TPU kernel kernels/flash_attention/kernel.py::_kernel /
// flash_attention_kernel (JAX package): q [B, H, Sq, D] against k, v
// [B, G, Skv, D] -> o [B, H, Sq, D] in q's dtype, with the online softmax in
// fp32 and every variant of the LM archs: causal with the decode offset
// (row i sees col j iff j <= i + Skv - Sq), a sliding window (j > that row
// - window), the tanh softcap, GQA (head h reads kv head h / rep) and a
// per-row kv length. Masked scores are filled with -1e30 and their weights
// set to 0, and the denominator is clamped at 1e-30, as in the reference, so
// a fully masked row gives 0. Any Sq and Skv: the ragged edges are masked,
// not asserted away.
//
// The TPU kernel walks a grid (B, H, q tiles, kv tiles) whose last axis runs
// in order on one core and carries (acc, m, l) across it in VMEM. Blocks on
// the card run in no order, so here a block loops over its kv tiles itself,
// holding the softmax state in registers, and visits only the tiles in
// [lo, hi) that hold a live pair (the TPU kernel's skip rule plus
// col < kv_len[b]).
//
// Bound: at gemma2-2b's prefill (Sq = Skv = 32768, D = 256) the work is
// 4 * D operations per live (row, col) pair per head, some 900 operations
// per byte of q, k, v and o: the tensor cores' bf16 rate bounds it. At
// decode (Sq = 1 against a 32768-token cache) each K and V row serves the
// rep query rows of its kv head once: bytes bound it, the cache read once.
//
// Three kernels behind one launcher, each templated on D (32, 64, 128 or
// 256, the head widths of the LM archs):
//  * bf16 prefill, flash_attention_tc_kernel<D, false, kCap, false>, FA3's shape,
//    for the operations bound: every product on the tensor cores through
//    wgmma, fed by TMA so that no thread spends an instruction on a copy.
//    Three warpgroups: one thread of the producer's keeps TMA loads of K
//    and V tiles in flight through two rings in dynamic shared memory (2 to
//    4 stages, as many as fit; an mbarrier per stage for "full" and one for
//    "empty"), and two consumer warpgroups own 64 query rows each;
//    setmaxnreg moves the producer's registers to them (240 a thread, so the
//    m64n256 output accumulator of D = 256 stays in registers).
//    S = Q K^T is wgmma m64nBKk16 with Q and K both read from 128-byte
//    swizzled shared memory (64-byte at D = 32), K-major. The online softmax
//    runs on the fp32 accumulator fragments in registers, in the log2 domain
//    with one FFMA and one ex2 per score, the mask applied only on the
//    tiles at its edges. P is rounded to bf16 into the A-operand registers
//    of the next wgmma (the m64nN accumulator layout is the A fragment's),
//    and O += P V reads V from shared memory as a transposed (MN-major) B
//    operand, so V needs no transpose. A warpgroup issues S_i and P_{i-1}
//    V_{i-1} together and runs the softmax of tile i while the tensor cores
//    finish the second (FA3's intra-warpgroup overlap); the two warpgroups
//    overlap each other's softmax too. The softcap (a template flag) takes
//    tanh.approx.f32. A block per SM takes (q tile, head, batch row) items
//    from a queue, the last q tile of every head (the most work under a
//    causal mask) first, and loads the next item's tiles while it finishes
//    the last, so no block's start waits on a copy; a warpgroup skips the
//    products of a tile none of its rows reaches. Tiles: 128 query rows by
//    64 kv rows at D = 256 (64 KB of Q, 2 stages of 32 KB of K and 32 KB of
//    V), by 128 below. Under training, flash_attention_tc_kernel<D, false,
//    kCap, true> also writes each row's natural-log log-sum-exp in its
//    epilogue, for the backward (a template flag, so the serving
//    instantiations compile as they did without it).
//  * bf16 decode (up to 8 query rows per head, rep * Sq <= 64; ops.py::
//    plan_splits), flash_attention_tc_kernel<D, true, kCap, false>, split-KV, for
//    the bytes bound: every cache byte read once, by enough blocks to keep
//    the card's memory busy. A block owns one (b, kv head, split of the
//    cache) and serves all rep query heads of its kv head in one wgmma tile
//    of 64 rows, so each K and V row is read once, not rep times. The split
//    count fills the 132 SMs from B * G and Skv; a split past a row's kv_len
//    or before its window writes an empty partial. Each split keeps fp32
//    (m, l, acc) as the TPU kernel's scratch does and writes it to a scratch
//    buffer of the wrapper's; the last block of a (b, kv head) to arrive (a
//    ticket counter the wrapper zeroes) merges every split in split order,
//    in the same launch, so the result is the same from run to run (no
//    float atomics). The producer and consumer code of prefill, with one
//    consumer warpgroup, kv tiles of 64 rows and 3 (D = 256) or 4 stages of
//    K and V in flight.
//  * fp32 (the parity path): flash_attention_kernel, scalar FMAs over 32 x 32
//    tiles in shared memory (rows padded by one float against bank
//    conflicts), four threads to a query row, each holding D / 4 output
//    accumulators in registers; tanhf for the softcap; each row's lse too
//    when the caller passes a buffer for it (training).
// The bf16 kernels round P to bf16 before P V, where the TPU kernel keeps P
// and V in fp32: a relative error of at most 2^-8 in each weight. The TMA
// maps are 3-D, {D, rows, heads}, so the rows of a box past Sq or Skv are
// zero-filled within their own head and never read from the next one.
#include <cuda_bf16.h>

#include "hopper.cuh"     // mbarriers, TMA, wgmma, the tensor-map encoder
#include "qac_common.cuh"  // qac_error_string, which every kernel library exports

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const int* kv_len;  // [B] or null: every row has Skv
  int H, Sq, Skv, rep, off;  // off = Skv - Sq, the causal offset
  int causal, window;
  float softcap, scale;
  int G;
  int R;           // query rows of a tile's view: Sq (prefill) or rep * Sq (decode)
  int splits;      // decode: the cache's splits (1: no merge)
  int split_cols;  // decode: columns per split, a multiple of the kv tile
  int B;           // batch rows: the prefill work queue spans B * H * q tiles
  float* lse;      // [B, H, Sq] or null: each row's natural-log log-sum-exp (training)
};

__device__ __forceinline__ int kv_len_of(const Params& p, int b) {
  return p.kv_len ? min(p.kv_len[b], p.Skv) : p.Skv;
}

// [lo, hi): the columns that may hold a live pair for query rows [r0, r1).
__device__ __forceinline__ void col_range(const Params& p, int r0, int r1, int klen,
                                          int& lo, int& hi) {
  hi = klen;
  if (p.causal) hi = min(hi, r1 + p.off);  // the last row's col <= row + off
  lo = p.window > 0 ? max(0, r0 + p.off - p.window + 1) : 0;
}

__device__ __forceinline__ bool is_live(const Params& p, int row_abs, int col, int klen) {
  bool ok = col < klen;
  if (p.causal) ok = ok && col <= row_abs;
  if (p.window > 0) ok = ok && col > row_abs - p.window;
  return ok;
}

__device__ __forceinline__ float score(float dot, const Params& p) {
  float s = dot * p.scale;
  if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
  return s;
}

// ---------------------------------------------------------------------------
// fp32: scalar FMAs
// ---------------------------------------------------------------------------
constexpr int kScalarBQ = 32, kScalarBK = 32, kThreads = 128;

template <int D>
constexpr size_t scalar_smem_bytes() {
  return sizeof(float) * (kScalarBQ * (D + 1) + kScalarBK * (D + 1) + kScalarBK * D +
                          kScalarBQ * (kScalarBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, Params p) {
  constexpr int BQ = kScalarBQ, BK = kScalarBK, LQ = D + 1, LS = BK + 1;
  constexpr int NS = BK / 4, NO = D / 4;  // scores and outputs per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // [BQ][LQ]
  float* sK = sQ + BQ * LQ;    // [BK][LQ]
  float* sV = sK + BK * LQ;    // [BK][D]
  float* sP = sV + BK * D;     // [BQ][LS]

  const int tid = threadIdx.x, r = tid >> 2, sub = tid & 3;
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int r0 = qt * BQ, r1 = min(r0 + BQ, p.Sq);
  const size_t q_base = ((size_t)b * p.H + h) * p.Sq * D;
  const size_t kv_base = ((size_t)b * (p.H / p.rep) + h / p.rep) * p.Skv * D;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    sQ[rr * LQ + d] = r0 + rr < p.Sq ? q[q_base + (size_t)(r0 + rr) * D + d] : 0.f;
  }
  const int klen = kv_len_of(p, b);
  int lo, hi;
  col_range(p, r0, r1, klen, lo, hi);
  const int row = r0 + r, row_abs = row + p.off;
  const bool row_ok = row < p.Sq;
  float m = kNeg, l = 0.f, o[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j] = 0.f;

  for (int c0 = lo / BK * BK; c0 < hi; c0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are read
    for (int i = tid; i < BK * D; i += kThreads) {
      const int cc = i / D, d = i % D, col = c0 + cc;
      float kx = 0.f, vx = 0.f;
      if (col < p.Skv) {
        const size_t at = kv_base + (size_t)col * D + d;
        kx = k[at];
        vx = v[at];
      }
      sK[cc * LQ + d] = kx;
      sV[cc * D + d] = vx;
    }
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = sQ[r * LQ + d];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] += qv * sK[(sub + 4 * i) * LQ + d];
    }
    unsigned live = 0;
    float mx = kNeg;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const bool ok = row_ok && is_live(p, row_abs, c0 + sub + 4 * i, klen);
      s[i] = ok ? score(s[i], p) : kNeg;
      live |= (unsigned)ok << i;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m, mx), alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float e = (live >> i) & 1u ? expf(s[i] - m_new) : 0.f;
      sP[r * LS + sub + 4 * i] = e;
      sum += e;
    }
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    l = l * alpha + sum;
    m = m_new;
    __syncwarp();  // a row's four threads, one warp, read each other's P
#pragma unroll
    for (int j = 0; j < NO; ++j) o[j] *= alpha;
    for (int c = 0; c < BK; ++c) {
      const float pc = sP[r * LS + c];
#pragma unroll
      for (int j = 0; j < NO; ++j) o[j] += pc * sV[c * D + sub + 4 * j];
    }
  }
  if (row_ok) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < NO; ++j) out[q_base + (size_t)row * D + sub + 4 * j] = o[j] / den;
    if (p.lse != nullptr && sub == 0)  // no live column: +inf, so the backward's P is 0
      p.lse[((size_t)b * p.H + h) * p.Sq + row] = l > 0.f ? m + logf(l) : INFINITY;
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma on a TMA-fed ring
// ---------------------------------------------------------------------------
constexpr int kMaxSplits = 64;  // ops.py::MAX_SPLITS: the merge's weights fit the idle ring
constexpr int kDecodeRows = 64;  // ops.py::DECODE_ROWS: one wgmma tile of query rows

template <int D, bool kDecode>
struct Tc : Swz<D> {  // SW, CC, NCH, KPC and LAYOUT: the swizzle of a [rows, D] tile
  static constexpr int NC = kDecode ? 1 : 2;     // consumer warpgroups
  static constexpr int BQ = 64 * NC;             // query rows per block
  static constexpr int BK = kDecode || D == 256 ? 64 : 128;
  // The consumer warpgroups, then the producer's. setmaxnreg hands the
  // producer's registers to the consumers: 24 + NC * CONSUMER_REGS fits the
  // (NC + 1) * (65536 / THREADS) the launch bound leaves each thread.
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
  static constexpr uint32_t Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr uint32_t FIXED = 1024 + Q_BYTES + 8 * 18 + 16;  // alignment, Q, barriers, 2 ints
  static constexpr int STAGES = (232448 - FIXED) / (2 * KV_BYTES) < 4
                                    ? (232448 - FIXED) / (2 * KV_BYTES) : 4;
  static constexpr uint32_t RING = STAGES * 2 * KV_BYTES;  // the K and V rings
  static constexpr size_t SMEM = FIXED + RING;
  static_assert(STAGES >= 2, "shared memory");
  static_assert(!kDecode || RING >= kMaxSplits * kDecodeRows * 4, "merge weights");
};

__device__ __forceinline__ void named_sync_128() { asm volatile("bar.sync 1, 128;" ::: "memory"); }


// Shared memory: Q [NCH chunks][BQ rows][SW bytes], then the K ring and the
// V ring, stage s of each holding a tile as [NCH][BK][SW], then the barriers
// full_k[STAGES], full_v[STAGES], empty_k[STAGES], empty_v[STAGES], q_full,
// q_empty, then the merge's flag and the producer's current item. Every
// region starts on 1024 bytes, the period of the 128-byte swizzle.
//
// The accumulators' fragment layout, and how P's becomes the A registers of
// P V: hopper.cuh.
//
// A prefill block is persistent, one per SM: its producer takes work items
// (q tile, head, batch row) from a queue, a counter in device memory that
// the wrapper zeroes, in the order j = 0, 1, ... that puts the last q tile
// (the most work under a causal mask) of every head first, passes each to
// the consumers through shared memory, and starts the next item's Q, K and
// V loads while they finish the last one. The rings' stages and phases run
// on over the items. A decode block has one item. A consumer warpgroup runs its
// live tiles [a, z) of an item as FA3 does: in step i it issues
// S_i = Q K_i^T and O += P_{i-1} V_{i-1}, waits for S_i only, runs the
// softmax of tile i while the tensor cores finish P_{i-1} V_{i-1}, then
// rescales O and rounds P_i into the A registers. K and V have rings of
// their own, so K_i's stage is free as soon as S_i is done.
template <int D, bool kDecode, bool kCap, bool kLse>
__global__ void __launch_bounds__(Tc<D, kDecode>::THREADS, 1)
    flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                              float* __restrict__ part, int* __restrict__ counters,
                              const Params p) {
  using T = Tc<D, kDecode>;
  constexpr int BK = T::BK, SW = T::SW, STAGES = T::STAGES, CC = T::CC;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);  // the same bytes, generic
  const uint32_t sQ = base, k_ring = base + T::Q_BYTES, v_ring = k_ring + STAGES * T::KV_BYTES;
  const uint32_t bars = v_ring + STAGES * T::KV_BYTES;
  const uint32_t full_k = bars, full_v = bars + 8 * STAGES;    // + 8 * stage
  const uint32_t empty_k = bars + 16 * STAGES, empty_v = bars + 24 * STAGES;
  const uint32_t q_full = bars + 32 * STAGES, q_empty = q_full + 8;
  int* const flag = reinterpret_cast<int*>(gbase + (bars - base) + 32 * STAGES + 16);
  volatile int* const item_slot = flag + 1;  // the item the producer took, for the consumers

  // Work item j: the kv head it reads, the rows of its Q box, and the kv
  // tiles [t0, t0 + nt) that hold a live pair for some of its rows.
  const int n_qt = (p.Sq + T::BQ - 1) / T::BQ;
  const int n_items = kDecode ? 1 : n_qt * p.H * p.B;
  struct Item {
    int klen, kvh, q_head, q_row0, lo, hi, t0, nt;
  };
  auto item = [&](int j) {
    Item w;
    int b;
    if (kDecode) {
      b = blockIdx.z;
      w.klen = kv_len_of(p, b);
      w.kvh = b * p.G + blockIdx.y;
      w.q_head = w.kvh;  // q viewed as [B * G, rep * Sq, D]: every head of kv head g
      w.q_row0 = 0;
      col_range(p, 0, p.Sq, w.klen, w.lo, w.hi);
      w.lo = max(w.lo, static_cast<int>(blockIdx.x) * p.split_cols);
      w.hi = min(w.hi, static_cast<int>(blockIdx.x + 1) * p.split_cols);
    } else {
      const int hb = j % (p.H * p.B), h = hb % p.H;  // every head's last q tile first
      b = hb / p.H;
      w.klen = kv_len_of(p, b);
      w.kvh = b * p.G + h / p.rep;
      w.q_head = b * p.H + h;  // q viewed as [B * H, Sq, D]
      w.q_row0 = (n_qt - 1 - j / (p.H * p.B)) * T::BQ;
      col_range(p, w.q_row0, min(w.q_row0 + T::BQ, p.Sq), w.klen, w.lo, w.hi);
    }
    w.t0 = w.lo / BK;
    w.nt = w.hi > w.lo ? (w.hi + BK - 1) / BK - w.t0 : 0;
    return w;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);  // the producer's expect_tx
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, T::NC * 128);  // every consumer thread
      mbar_init(empty_v + 8 * s, T::NC * 128);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, T::NC * 128);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The warpgroup index, read through a shuffle so that the compiler knows it
  // is the same in every thread of a warp: the wgmmas below then lie on no
  // path it must treat as divergent, which would serialise them.
  const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == T::NC) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(T::PRODUCER_REGS));
    if (threadIdx.x == T::NC * 128) {
      int g = 0;  // tiles issued so far: their ring stage and phase
      int j = kDecode ? 0 : atomicAdd(counters, 1);
      for (int n = 0;; ++n) {
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);  // every S of the last item is done
        *item_slot = j < n_items ? j : -1;
        if (j >= n_items) {  // no work left: tell the consumers
          mbar_arrive(q_full);
          break;
        }
        const Item w = item(j);
        j = kDecode ? n_items : atomicAdd(counters, 1);  // the next item, taken early
        mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
        for (int c = 0; c < T::NCH; ++c)
          tma_load(sQ + c * T::BQ * SW, &tq, q_full, c * CC, w.q_row0, w.q_head);
        for (int i = 0; i < w.nt; ++i, ++g) {
          const int s = g % STAGES, c0 = (w.t0 + i) * BK;
          const uint32_t parity = (g / STAGES - 1) & 1;
          if (g >= STAGES) mbar_wait(empty_k + 8 * s, parity);
          mbar_expect_tx(full_k + 8 * s, T::KV_BYTES);
#pragma unroll
          for (int c = 0; c < T::NCH; ++c)
            tma_load(k_ring + s * T::KV_BYTES + c * BK * SW, &tk, full_k + 8 * s, c * CC, c0,
                     w.kvh);
          if (g >= STAGES) mbar_wait(empty_v + 8 * s, parity);
          mbar_expect_tx(full_v + 8 * s, T::KV_BYTES);
#pragma unroll
          for (int c = 0; c < T::NCH; ++c)
            tma_load(v_ring + s * T::KV_BYTES + c * BK * SW, &tv, full_v + 8 * s, c * CC, c0,
                     w.kvh);
        }
        if (kDecode) break;
      }
    }
  } else {  // the consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(T::CONSUMER_REGS));
    const int cw = wg, t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32, quad = lane % 4;
    // The softmax works on u = s (or tanh(s * scale / c) with the softcap c)
    // and weighs each by 2^(k * (u - max u)): k = scale * log2(e), or
    // c * log2(e). m holds max u.
    const float k_in = kCap ? p.scale / p.softcap : 0.f;
    const float k2 = (kCap ? p.softcap : p.scale) * kLog2e;
    const uint32_t q_base = sQ + 64 * cw * SW;

    Item w;
    int g0 = 0;  // tiles consumed before this item: the ring stage and phase of its first
    // This thread's two rows of the Q box, h = 0, 1: their query row, whether
    // they are real, and the columns [col_lo, col_hi) each row sees; the
    // absolute positions of this warpgroup's first and last query rows.
    int box_row[2], q_row[2], col_lo[2], col_hi[2], abs_first, abs_last;
    bool real[2];
    float o[D / 2], sc[BK / 2], m[2], l[2];
    uint32_t pa[BK / 16][4];

    auto pass = [&](int i) {  // a tile none of this warpgroup's rows reaches
      const int s = (g0 + i) % STAGES;
      const uint32_t parity = ((g0 + i) / STAGES) & 1;
      mbar_wait(full_k + 8 * s, parity);
      mbar_arrive(empty_k + 8 * s);
      mbar_wait(full_v + 8 * s, parity);
      mbar_arrive(empty_v + 8 * s);
    };
    auto wait_k = [&](int i) {
      mbar_wait(full_k + 8 * ((g0 + i) % STAGES), ((g0 + i) / STAGES) & 1);
    };
    auto wait_v = [&](int i) {
      mbar_wait(full_v + 8 * ((g0 + i) % STAGES), ((g0 + i) / STAGES) & 1);
    };
    auto free_k = [&](int i) { mbar_arrive(empty_k + 8 * ((g0 + i) % STAGES)); };
    auto free_v = [&](int i) { mbar_arrive(empty_v + 8 * ((g0 + i) % STAGES)); };
    auto issue_s = [&](int i) {  // S_i = Q K_i^T, committed as one group
      const uint32_t ks = k_ring + ((g0 + i) % STAGES) * T::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int ch = kk / T::KPC, in = kk % T::KPC;
        wgmma_ss<BK>(sc, smem_desc(q_base + ch * T::BQ * SW + in * 32, 16, 8 * SW, T::LAYOUT),
                     smem_desc(ks + ch * BK * SW + in * 32, 16, 8 * SW, T::LAYOUT), kk > 0);
      }
      wg_commit();
    };
    auto issue_pv = [&](int i) {  // O += P_i V_i, committed as one group
      const uint32_t vs = v_ring + ((g0 + i) % STAGES) * T::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D>(o, pa[kk], smem_desc(vs + kk * 16 * SW, BK * SW, 8 * SW, T::LAYOUT));
      wg_commit();
    };
    // The masked online softmax of tile i on sc, in place: the weights in
    // fp32, the row sums in l; returns each row's factor for O in alpha.
    auto softmax = [&](int i, float (&alpha)[2]) {
      const int c0 = (w.t0 + i) * BK;
      if (kCap) {
#pragma unroll
        for (int idx = 0; idx < BK / 2; ++idx) sc[idx] = tanh_approx(sc[idx] * k_in);
      }
      if (c0 + BK > w.klen || (p.causal && c0 + BK - 1 > abs_first) ||
          (p.window > 0 && c0 <= abs_last - p.window)) {  // a tile on an edge of the mask
#pragma unroll
        for (int idx = 0; idx < BK / 2; ++idx) {
          const int h = (idx / 2) % 2, col = c0 + 8 * (idx / 4) + 2 * quad + idx % 2;
          if (static_cast<unsigned>(col - col_lo[h]) >=
              static_cast<unsigned>(col_hi[h] - col_lo[h]))
            sc[idx] = kNeg;
        }
      }
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int idx = 0; idx < BK / 2; ++idx) mx[(idx / 2) % 2] = fmaxf(mx[(idx / 2) % 2], sc[idx]);
      float bias[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        const float mu = m_new == kNeg ? 0.f : m_new;  // no live column yet: every weight 0
        alpha[h] = exp2_approx((m[h] - mu) * k2);
        bias[h] = -mu * k2;
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int idx = 0; idx < BK / 2; ++idx) {
        const float e = exp2_approx(fmaf(sc[idx], k2, bias[(idx / 2) % 2]));
        l[(idx / 2) % 2] += e;
        sc[idx] = e;
      }
    };
    auto rescale_and_round = [&](const float (&alpha)[2]) {  // O *= alpha; P_i -> pa
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 0] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    };

    for (int n = 0;; ++n, g0 += w.nt) {
      mbar_wait(q_full, n & 1);
      const int j = kDecode ? 0 : *item_slot;
      if (j < 0) break;
      w = item(j);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        box_row[h] = 64 * cw + 16 * warp + lane / 4 + 8 * h;
        q_row[h] = kDecode ? box_row[h] % p.Sq : w.q_row0 + box_row[h];
        real[h] = kDecode ? box_row[h] < p.R : q_row[h] < p.Sq;
        const int row_abs = q_row[h] + p.off;
        col_lo[h] = p.window > 0 ? max(row_abs - p.window + 1, 0) : 0;
        col_hi[h] = max(p.causal ? min(w.klen, row_abs + 1) : w.klen, col_lo[h]);
        m[h] = kNeg;
        l[h] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      // This warpgroup's query rows [w_first, w_last], and its live tiles
      // [a, z) of the item's [0, nt): the others it only lets pass.
      const int w_first = kDecode ? 0 : w.q_row0 + 64 * cw;
      const int w_last = kDecode ? p.Sq - 1 : min(w_first + 63, p.Sq - 1);
      int lo_w = w.lo, hi_w = w.hi;
      if (w_first > w_last) {
        hi_w = lo_w;
      } else if (!kDecode) {
        int x, y;
        col_range(p, w_first, w_last + 1, w.klen, x, y);
        lo_w = max(lo_w, x);
        hi_w = min(hi_w, y);
      }
      const int a = hi_w > lo_w ? lo_w / BK - w.t0 : 0;
      const int z = hi_w > lo_w ? (hi_w + BK - 1) / BK - w.t0 : 0;
      abs_first = w_first + p.off;
      abs_last = w_last + p.off;

      for (int i = 0; i < a; ++i) pass(i);
      if (a < z) {
        float alpha[2];
        wait_k(a);
        wg_fence();
        issue_s(a);
        wg_wait<0>();
        fence_regs(sc);
        free_k(a);
        softmax(a, alpha);
        rescale_and_round(alpha);
        for (int i = a + 1; i < z; ++i) {
          wait_k(i);
          fence_regs(o);
          fence_regs(pa);
          wg_fence();
          issue_s(i);
          wait_v(i - 1);
          issue_pv(i - 1);
          wg_wait<1>();  // S_i is done; P_{i-1} V_{i-1} may still run
          fence_regs(sc);
          free_k(i);
          softmax(i, alpha);
          wg_wait<0>();
          fence_regs(o);
          fence_regs(pa);
          free_v(i - 1);
          rescale_and_round(alpha);
        }
        mbar_arrive(q_empty);  // every S of the item is done: the next Q may come
        wait_v(z - 1);
        fence_regs(o);
        fence_regs(pa);
        wg_fence();
        issue_pv(z - 1);
        wg_wait<0>();
        fence_regs(o);
        free_v(z - 1);
      } else {
        mbar_arrive(q_empty);
      }
      for (int i = max(z, a); i < w.nt; ++i) pass(i);

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(kFull, l[h], 1);
        l[h] += __shfl_xor_sync(kFull, l[h], 2);
      }
      if (!kDecode || p.splits == 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!real[h]) continue;
          const float inv = 1.f / fmaxf(l[h], 1e-30f);
          if (kLse && quad == 0)  // ln(sum 2^(k2 u)) = ln 2 (k2 m + log2 l); +inf on an empty row
            p.lse[static_cast<size_t>(w.q_head) * p.Sq + q_row[h]] =
                l[h] > 0.f ? kLn2 * fmaf(k2, m[h], log2f(l[h])) : INFINITY;
          bf16* orow = out + (static_cast<size_t>(w.q_head) * p.R +
                              (kDecode ? box_row[h] : q_row[h])) * D;
#pragma unroll
          for (int jj = 0; jj < D / 8; ++jj)
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj + 2 * quad) =
                __floats2bfloat162_rn(o[4 * jj + 2 * h] * inv, o[4 * jj + 2 * h + 1] * inv);
        }
        if (kDecode) break;
        continue;
      }

      // Split-KV: this split's (m, l, acc) to the scratch, acc as [B * G,
      // splits, R, D] and (m, l) as [B * G, splits, R, 2] after it; the last
      // block of the kv head to take a ticket merges every split in split
      // order.
      const int S = p.splits, R = p.R;
      float* const acc_all = part;
      float* const ml_all = part + static_cast<size_t>(p.B) * p.G * S * R * D;
      const size_t slot = (static_cast<size_t>(w.kvh) * S + blockIdx.x) * R;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!real[h]) continue;
        float* acc = acc_all + (slot + box_row[h]) * D;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
          *reinterpret_cast<float2*>(acc + 8 * jj + 2 * quad) =
              make_float2(o[4 * jj + 2 * h], o[4 * jj + 2 * h + 1]);
        if (quad == 0)
          *reinterpret_cast<float2*>(ml_all + (slot + box_row[h]) * 2) =
              make_float2(m[h] * k2, l[h]);
      }
      __threadfence();
      named_sync_128();
      if (t == 0) *flag = atomicAdd(counters + w.kvh, 1) == S - 1;
      named_sync_128();
      if (!*flag) return;
      __threadfence();

      float* const wts = reinterpret_cast<float*>(gbase + T::Q_BYTES);  // [S][R]: the rings are idle
      const size_t head0 = static_cast<size_t>(w.kvh) * S * R;
      for (int r = t; r < R; r += 128) {  // each split's weight in each row
        float M = kNeg, L = 0.f;
        for (int s = 0; s < S; ++s) {
          const float2 ml =
              __ldcg(reinterpret_cast<const float2*>(ml_all + (head0 + s * R + r) * 2));
          if (ml.y > 0.f) M = fmaxf(M, ml.x);
        }
        for (int s = 0; s < S; ++s) {
          const float2 ml =
              __ldcg(reinterpret_cast<const float2*>(ml_all + (head0 + s * R + r) * 2));
          if (ml.y > 0.f) L += ml.y * exp2_approx(ml.x - M);
        }
        const float inv = 1.f / fmaxf(L, 1e-30f);
        for (int s = 0; s < S; ++s) {
          const float2 ml =
              __ldcg(reinterpret_cast<const float2*>(ml_all + (head0 + s * R + r) * 2));
          wts[s * R + r] = ml.y > 0.f ? exp2_approx(ml.x - M) * inv : 0.f;
        }
      }
      named_sync_128();
      for (int e = t; e < R * (D / 4); e += 128) {
        const int r = e / (D / 4), d4 = e % (D / 4);
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int s = 0; s < S; ++s) {
          const float wt = wts[s * R + r];
          if (wt == 0.f) continue;
          const float4 x =
              __ldcg(reinterpret_cast<const float4*>(acc_all + (head0 + s * R + r) * D) + d4);
          acc.x += wt * x.x;
          acc.y += wt * x.y;
          acc.z += wt * x.z;
          acc.w += wt * x.w;
        }
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
            out + (static_cast<size_t>(w.kvh) * R + r) * D + 4 * d4);
        dst[0] = __floats2bfloat162_rn(acc.x, acc.y);
        dst[1] = __floats2bfloat162_rn(acc.z, acc.w);
      }
      break;  // a decode block has one item
    }
  }
}


template <int D, bool kDecode, bool kCap, bool kLse = false>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, void* part,
                      void* counters, int B, const Params& p, cudaStream_t stream) {
  using T = Tc<D, kDecode>;
  const bool bad_plan =
      kDecode ? p.R > kDecodeRows || p.splits < 1 || p.splits > kMaxSplits ||
                    p.split_cols % T::BK != 0 ||
                    static_cast<long long>(p.splits) * p.split_cols < p.Skv ||
                    (p.splits > 1 && (part == nullptr || counters == nullptr))
              : counters == nullptr;  // prefill: the work queue's counter
  if (bad_plan) return cudaErrorInvalidValue;
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  const int q_rows = kDecode ? p.R : p.Sq, q_heads = kDecode ? B * p.G : B * p.H;
  if (!tensor_map<D>(encode, &tq, q, q_rows, q_heads, T::BQ) ||
      !tensor_map<D>(encode, &tk, k, p.Skv, B * p.G, T::BK) ||
      !tensor_map<D>(encode, &tv, v, p.Skv, B * p.G, T::BK))
    return cudaErrorInvalidValue;
  const auto kernel = flash_attention_tc_kernel<D, kDecode, kCap, kLse>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return err;
  dim3 grid(p.splits, p.G, B);  // decode: a block per split and kv head
  if (!kDecode) {  // prefill: persistent, a block per SM (its shared memory and threads fill one)
    int dev, sms;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return cudaGetLastError();
    const long long items = static_cast<long long>((p.Sq + T::BQ - 1) / T::BQ) * p.H * B;
    grid = dim3(static_cast<unsigned>(items < sms ? items : sms));
  }
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(tq, tk, tv, static_cast<bf16*>(out),
                                                  static_cast<float*>(part),
                                                  static_cast<int*>(counters), p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* part,
                   void* counters, int dtype, int B, const Params& p, cudaStream_t stream) {
  if (dtype == 1) {
    const bool cap = p.softcap > 0.f;
    if (p.splits > 0)
      return p.lse != nullptr ? cudaErrorInvalidValue  // the decode kernel writes no lse
             : cap ? launch_tc<D, true, true>(q, k, v, out, part, counters, B, p, stream)
                   : launch_tc<D, true, false>(q, k, v, out, part, counters, B, p, stream);
    if (p.lse != nullptr)  // training: the same prefill kernel, writing each row's lse
      return cap ? launch_tc<D, false, true, true>(q, k, v, out, part, counters, B, p, stream)
                 : launch_tc<D, false, false, true>(q, k, v, out, part, counters, B, p, stream);
    return cap ? launch_tc<D, false, true>(q, k, v, out, part, counters, B, p, stream)
               : launch_tc<D, false, false>(q, k, v, out, part, counters, B, p, stream);
  }
  constexpr size_t smem = scalar_smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kScalarBQ - 1) / kScalarBQ, p.H, B);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (backend.FLOAT_CODES); kv_len may be null.
// splits > 0 asks for the bf16 split-KV decode kernel with that many splits
// of split_cols columns (ops.py::plan_splits; part and counters, the merge's
// scratch and a zeroed ticket per kv head, are needed when splits > 1); 0
// for the prefill kernel, whose counters is one zeroed int, its work queue.
// The fp32 kernel takes every call alike. lse, fp32 [B, H, Sq] or null,
// asks for each row's natural-log log-sum-exp beside o (+inf on a row with no
// live column), for the backward: the fp32 kernel or the bf16 prefill kernel
// (not with splits > 0). The wrapper checks the shapes
// (H % G == 0, D in {32, 64, 128, 256}), that every tensor is contiguous on
// one card with 16-byte aligned rows, and that B, H, Sq and Skv are at
// least 1.
extern "C" __attribute__((visibility("default"))) int flash_attention_launch(
    const void* q, const void* k, const void* v, const int* kv_len, void* out, int dtype,
    int B, int H, int G, int Sq, int Skv, int D, int causal, int window, float softcap,
    float scale, int splits, int split_cols, void* part, void* counters, float* lse,
    void* stream) {
  if ((dtype != 0 && dtype != 1) || G < 1 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rep = H / G;
  const Params p{kv_len, H,     Sq, Skv, rep, Skv - Sq, causal, window, softcap, scale, G,
                 splits > 0 ? rep * Sq : Sq, splits, split_cols, B, lse};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch<32>(q, k, v, out, part, counters, dtype, B, p, s); break;
    case 64: err = launch<64>(q, k, v, out, part, counters, dtype, B, p, s); break;
    case 128: err = launch<128>(q, k, v, out, part, counters, dtype, B, p, s); break;
    case 256: err = launch<256>(q, k, v, out, part, counters, dtype, B, p, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
