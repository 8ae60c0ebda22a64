// Flash attention's backward for Hopper (sm_90a): dQ, dK and dV.
//
// Replaces no TPU kernel: the TPU package has no backward kernel, its
// trainers differentiate the reference attention (kernels/flash_attention/
// ref.py::flash_attention_ref, JAX package) by autodiff. This file computes
// exactly that gradient, so the port can train through its forward kernel
// (csrc/flash_attention.cu, which replaces kernels/flash_attention/kernel.py::
// flash_attention_kernel): given q [B, H, Sq, D], k, v [B, G, Skv, D], the
// forward's output o, its row log-sum-exp lse [B, H, Sq] (fp32, natural log,
// +inf on a row with no live column) and the cotangent dO [B, H, Sq, D], it
// writes dQ [B, H, Sq, D] and dK, dV [B, G, Skv, D] in the inputs' dtype
// (fp32 or bf16), accumulating in fp32.
//
// The function, per head h (kv head g = h / rep, rep = H / G), with
// x = scale * q.k and, under a softcap c, s = c * tanh(x / c) (else s = x):
//   P = exp(s - lse) on the live columns, 0 elsewhere; O = P V;
//   D_i = sum_d dO_id O_id;  dP = dO V^T;  dS = P * (dP - D_i);
//   dX = dS * (1 - tanh^2(x / c)) (1 without a softcap);
//   dQ = scale * dX K;  dK = scale * dX^T Q (summed over the rep heads of g);
//   dV = P^T dO (summed over the rep heads of g).
// The masks are the reference's: with off = Skv - Sq, row i sees column j
// iff (not causal or j <= i + off) and (window <= 0 or j > i + off - window).
// A row with no live column has lse = +inf, so P = 0 and a zero gradient, as
// the reference's where() gives. lse comes from the forward kernel, which
// writes it in its epilogue (it had each row's max and sum in registers), so
// no pass here recomputes it.
//
// Bound: operations. The gradient needs five products over the live pairs
// (S = Q K^T, dP = dO V^T, dV, dK, dQ: 10 D operations a live pair a head),
// above the card's 295 operations a byte in bf16 at any training length.
//
// Three launches on the stream:
//  1. fa_bwd_delta_kernel<T, D>, a warp a row: D_i from o and dO (bytes
//     bound: o and dO read once), written with the row's lse as one float2
//     (lse, D_i) into a [B * H, Sq_pad] scratch whose rows past Sq hold
//     (+inf, 0): every tile's slice of it is whole, 16-byte aligned, and can
//     be fetched by one bulk copy.
//  2. dK and dV, a block per (kv tile, kv head, batch row), the heaviest
//     tiles under a causal mask (the first) launched first;
//  3. dQ, a block per (q tile, head, batch row), the last q tiles first.
// bf16, fa_bwd_tc_kernel<D, kDQ, kCap> for both 2 and 3 (FA3's shape, for
// the operations bound): every product on the tensor cores through wgmma,
// every tile fed by TMA. A block keeps BR "resident" rows in 128-byte
// swizzled shared memory (64-byte at D = 32): K and V for dK and dV, Q and
// dO for dQ. One thread of the producer warpgroup loads them once, then
// streams the other side's 64-row tiles (Q and dO with their rows' (lse,
// D_i) slice, or K and V) through a ring of 2 (D = 256) to 4 stages, an
// mbarrier per stage for "full" and one for "empty", as the forward's
// producer does. Per 64 resident rows and streamed tile, X = R1 C1^T
// (S^T = K Q^T, or S = Q K^T) and Y = R2 C2^T (dP^T = V dO^T, or dP = dO
// V^T) run as wgmma m64n64 with A and B both from shared memory (K-major);
// P and dS are formed from the fp32 accumulator fragments (the softcap's
// tanh.approx.f32 and ex2, as the forward), rounded to bf16 into A
// registers (the m64nN accumulator layout is the A fragment's), and dV +=
// P^T dO, dK += dS^T Q or dQ += dS K run with B read from shared memory
// MN-major, as the forward's P V reads V. Two consumer warpgroups:
//  * solo (D <= 128): each owns 64 resident rows of its own (BR = 128) and
//    takes all the products of them; dK and dV fit its registers. The
//    streamed tiles serve 128 rows, so a block reads half the bytes a flop
//    that 64 would: the streaming from L2, not the tensor cores, set the
//    time at 64 (qwen3-14b's heads at S = 4,096 on an H100 at 700 W, by
//    scripts/attention_bwd_sweep.py: 2.2-2.3 ms as a pair, 1.5 alone).
//  * pair (D = 256, where an m64n256 accumulator is 128 registers a thread
//    and a warpgroup holds one): the two share 64 resident rows (BR = 64);
//    warpgroup 0 takes X, P and dV and hands P (1 - t^2) scale to warpgroup
//    1 through shared memory in fragment order (two slots, a full and an
//    empty mbarrier each); warpgroup 1 takes Y, dS and dK or dQ.
// Each warpgroup issues step i's products and step i-1's accumulations
// together and forms tile i while the tensor cores finish the second (the
// forward's overlap), but for solo dK and dV at D = 128, whose registers it
// would spill. dK and dV sum over the group's heads in registers (a
// block loops over the rep heads of its kv head), and dQ over its kv tiles,
// so no float atomic is taken and a gradient is bit-identical from call to
// call. The mask is applied only on the tiles at its edges; a tile with no
// live pair for the block is never visited. setmaxnreg moves the
// producer's registers to the consumers.
// The cost of that choice: seven products a live pair (S and dP in both
// kernels, then dV, dK, dQ) against the bound's five. FA3 saves two by
// computing dQ in the dK/dV kernel with float atomics into an fp32 buffer;
// this port keeps its kernels deterministic instead, as the forward's
// split-KV merge does.
// The softcap's t is tanh.approx.f32, as in the bf16 forward that wrote lse,
// so that P = exp(s - lse) sums to 1 over a row; 1 - t^2 comes from the same t.
//
// fp32 (the parity path): fa_bwd_dkdv_kernel<D> and fa_bwd_dq_kernel<D>,
// fp32 FMAs on 32 x 32 shared tiles (rows padded by 4 floats, P and dS tiles
// by 8), 256 threads: for a score tile, thread t owns row t / 8 and columns
// t % 8 + 8c (c < 4); for an accumulator, row t / 8 and the float4 columns
// 4 (t % 8) + 32c of D. tanhf for the softcap, as the fp32 forward.
#include <cuda_bf16.h>

#include <type_traits>

#include "hopper.cuh"      // mbarriers, TMA, wgmma, the tensor-map encoder
#include "qac_common.cuh"  // qac_error_string, which every kernel library exports

namespace {

constexpr int kThreads = 256;      // the delta pass and the fp32 kernels
constexpr int kBQ = 32;            // fp32: query rows a tile
constexpr int kBK = 32;            // fp32: kv columns a tile
constexpr int kPad = 4;            // fp32: floats of padding per shared row of a [rows, D] tile
constexpr int kPS = kBK + 8;       // fp32: row stride of the shared P and dS tiles
constexpr int kRowPad = 128;       // ops.py::STATS_ROWS: the stats scratch's rows, a multiple

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [B, H, Sq], the forward's
  void* dq;
  void* dk;
  void* dv;
  float2* stats;     // [B * H, Sq_pad]: (lse, D_i) a row, (+inf, 0) past Sq
  int B, H, G, Sq, Skv, off, causal, window, Sq_pad;
  float softcap, scale;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a, b;
  a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void fma4(float4& acc, float a, float4 x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

__device__ __forceinline__ bool live(const Params& p, int row, int col) {
  if (row >= p.Sq || col >= p.Skv) return false;
  const int r = row + p.off;
  return (!p.causal || col <= r) && (p.window <= 0 || col > r - p.window);
}

// Every pair of query rows [qa, qb] and kv columns [ka, kb] is live.
__device__ __forceinline__ bool all_live(const Params& p, int qa, int qb, int ka, int kb) {
  return qb < p.Sq && kb < p.Skv && (!p.causal || kb <= qa + p.off) &&
         (p.window <= 0 || ka > qb + p.off - p.window);
}

// The kv columns [lo, hi) that query rows [r0, r1] (inclusive) reach.
__device__ __forceinline__ void col_range(const Params& p, int r0, int r1, int& lo, int& hi) {
  hi = p.causal ? min(p.Skv, r1 + p.off + 1) : p.Skv;
  lo = p.window > 0 ? max(0, r0 + p.off - p.window + 1) : 0;
}

// The query rows [lo, hi) that reach kv columns [c0, c1] (inclusive).
__device__ __forceinline__ void row_range(const Params& p, int c0, int c1, int& lo, int& hi) {
  lo = p.causal ? max(0, c0 - p.off) : 0;
  hi = p.window > 0 ? min(p.Sq, c1 + p.window - p.off) : p.Sq;
}

// ---------------------------------------------------------------------------
// The delta pass: (lse, D_i) a row
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fa_bwd_delta_kernel(Params p) {
  const int lane = threadIdx.x % 32;
  const long long r = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (r >= static_cast<long long>(p.B) * p.H * p.Sq_pad) return;
  const long long head = r / p.Sq_pad;
  const int row = static_cast<int>(r % p.Sq_pad);
  float2 st = make_float2(INFINITY, 0.f);
  if (row < p.Sq) {
    const long long at = (head * p.Sq + row) * D;
    const T* o = static_cast<const T*>(p.o) + at;
    const T* dout = static_cast<const T*>(p.dout) + at;
    float dl = 0.f;
    for (int d = 4 * lane; d < D; d += 128) {
      const float4 a = load4(o + d), c = load4(dout + d);
      dl += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
    }
#pragma unroll
    for (int m = 16; m > 0; m /= 2) dl += __shfl_xor_sync(0xffffffffu, dl, m);
    st = make_float2(p.lse[head * p.Sq + row], dl);
  }
  if (lane == 0) p.stats[r] = st;
}

// ---------------------------------------------------------------------------
// fp32: scalar FMAs (the parity path)
// ---------------------------------------------------------------------------

// Rows [row0, row0 + kRows) of a [n_rows, D] matrix into a padded tile,
// zeros past n_rows.
template <int D, int kRows>
__device__ void load_tile(float* dst, const float* src, int row0, int n_rows) {
  constexpr int kV = D / 4;
  for (int idx = threadIdx.x; idx < kRows * kV; idx += kThreads) {
    const int r = idx / kV, c = (idx % kV) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) x = load4(src + static_cast<long long>(row0 + r) * D + c);
    store4(dst + r * (D + kPad) + c, x);
  }
}

// out[c] = A[ti] . Bm[tj + 8c] over D, for c < 4 (a score tile's share).
template <int D>
__device__ __forceinline__ void dot_tile(const float* A, const float* Bm, int ti, int tj,
                                         float out[4]) {
  constexpr int S = D + kPad;
#pragma unroll
  for (int c = 0; c < 4; ++c) out[c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 a = load4(A + ti * S + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 b = load4(Bm + (tj + 8 * c) * S + d);
      out[c] = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, out[c]))));
    }
  }
}

// The P and dS of one score tile: rows q0 + ti, columns k0 + tj + 8c.
// lse and delta are the rows' own; dS carries the softcap factor and scale.
template <int D>
__device__ __forceinline__ void p_ds_tile(const Params& p, const float* Qs, const float* dOs,
                                          const float* Ks, const float* Vs, int q0, int k0,
                                          int ti, int tj, float lse, float delta, float pr[4],
                                          float ds[4]) {
  float s[4], dp[4];
  dot_tile<D>(Qs, Ks, ti, tj, s);
  dot_tile<D>(dOs, Vs, ti, tj, dp);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float x = s[c] * p.scale, dcap = 1.f;
    if (p.softcap > 0.f) {
      const float t = tanhf(x / p.softcap);
      dcap = 1.f - t * t;
      x = p.softcap * t;
    }
    pr[c] = live(p, q0 + ti, k0 + tj + 8 * c) ? expf(x - lse) : 0.f;
    ds[c] = pr[c] * (dp[c] - delta) * dcap * p.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) fa_bwd_dkdv_kernel(Params p) {
  constexpr int S = D + kPad, kC = D / 32;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kBK * S;
  float* Qs = Vs + kBK * S;
  float* dOs = Qs + kBQ * S;
  float* Ps = dOs + kBQ * S;
  float* dSs = Ps + kBQ * kPS;
  float2* st_s = reinterpret_cast<float2*>(dSs + kBQ * kPS);
  const int k0 = blockIdx.x * kBK, g = blockIdx.y, b = blockIdx.z;
  const int rep = p.H / p.G;
  const int ti = threadIdx.x / 8, tj = threadIdx.x % 8;
  const long long kv = (static_cast<long long>(b) * p.G + g) * p.Skv * D;
  load_tile<D, kBK>(Ks, static_cast<const float*>(p.k) + kv, k0, p.Skv);
  load_tile<D, kBK>(Vs, static_cast<const float*>(p.v) + kv, k0, p.Skv);
  float4 acc_k[kC], acc_v[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    acc_k[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    acc_v[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  int lo, hi;
  row_range(p, k0, min(k0 + kBK, p.Skv) - 1, lo, hi);
  for (int r = 0; r < rep; ++r) {
    const long long head = static_cast<long long>(b) * p.H + g * rep + r;
    const float* q = static_cast<const float*>(p.q) + head * p.Sq * D;
    const float* dout = static_cast<const float*>(p.dout) + head * p.Sq * D;
    for (int q0 = (lo / kBQ) * kBQ; q0 < hi; q0 += kBQ) {
      __syncthreads();
      load_tile<D, kBQ>(Qs, q, q0, p.Sq);
      load_tile<D, kBQ>(dOs, dout, q0, p.Sq);
      if (threadIdx.x < kBQ) st_s[threadIdx.x] = p.stats[head * p.Sq_pad + q0 + threadIdx.x];
      __syncthreads();
      float pr[4], ds[4];
      p_ds_tile<D>(p, Qs, dOs, Ks, Vs, q0, k0, ti, tj, st_s[ti].x, st_s[ti].y, pr, ds);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        Ps[ti * kPS + tj + 8 * c] = pr[c];
        dSs[ti * kPS + tj + 8 * c] = ds[c];
      }
      __syncthreads();
      // dV[j] += sum_i P[i, j] dO[i];  dK[j] += sum_i dS[i, j] Q[i]  (j = ti here)
      for (int i = 0; i < kBQ; ++i) {
        const float pij = Ps[i * kPS + ti], dsij = dSs[i * kPS + ti];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int d = tj * 4 + 32 * c;
          fma4(acc_v[c], pij, load4(dOs + i * S + d));
          fma4(acc_k[c], dsij, load4(Qs + i * S + d));
        }
      }
    }
  }
  const int col = k0 + ti;
  if (col < p.Skv) {
    float* dk = static_cast<float*>(p.dk) + kv + static_cast<long long>(col) * D;
    float* dv = static_cast<float*>(p.dv) + kv + static_cast<long long>(col) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      store4(dk + tj * 4 + 32 * c, acc_k[c]);
      store4(dv + tj * 4 + 32 * c, acc_v[c]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) fa_bwd_dq_kernel(Params p) {
  constexpr int S = D + kPad, kC = D / 32;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kBQ * S;
  float* Ks = dOs + kBQ * S;
  float* Vs = Ks + kBK * S;
  float* dSs = Vs + kBK * S;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int ti = threadIdx.x / 8, tj = threadIdx.x % 8;
  const long long head = static_cast<long long>(b) * p.H + h;
  const long long kv = (static_cast<long long>(b) * p.G + g) * p.Skv * D;
  load_tile<D, kBQ>(Qs, static_cast<const float*>(p.q) + head * p.Sq * D, q0, p.Sq);
  load_tile<D, kBQ>(dOs, static_cast<const float*>(p.dout) + head * p.Sq * D, q0, p.Sq);
  const int row = q0 + ti;
  const float2 st = p.stats[head * p.Sq_pad + row];
  float4 acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  int lo, hi;
  col_range(p, q0, min(q0 + kBQ, p.Sq) - 1, lo, hi);
  for (int k0 = (lo / kBK) * kBK; k0 < hi; k0 += kBK) {
    __syncthreads();
    load_tile<D, kBK>(Ks, static_cast<const float*>(p.k) + kv, k0, p.Skv);
    load_tile<D, kBK>(Vs, static_cast<const float*>(p.v) + kv, k0, p.Skv);
    __syncthreads();
    float pr[4], ds[4];
    p_ds_tile<D>(p, Qs, dOs, Ks, Vs, q0, k0, ti, tj, st.x, st.y, pr, ds);
#pragma unroll
    for (int c = 0; c < 4; ++c) dSs[ti * kPS + tj + 8 * c] = ds[c];
    __syncthreads();
    // dQ[i] += sum_j dS[i, j] K[j]  (i = ti)
    for (int j = 0; j < kBK; ++j) {
      const float dsij = dSs[ti * kPS + j];
#pragma unroll
      for (int c = 0; c < kC; ++c) fma4(acc[c], dsij, load4(Ks + j * S + tj * 4 + 32 * c));
    }
  }
  if (row < p.Sq) {
    float* dq = static_cast<float*>(p.dq) + (head * p.Sq + row) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) store4(dq + tj * 4 + 32 * c, acc[c]);
  }
}

template <int D>
constexpr int dkdv_smem() {
  return (2 * kBK + 2 * kBQ) * (D + kPad) * 4 + 2 * kBQ * kPS * 4 + kBQ * 8;
}
template <int D>
constexpr int dq_smem() { return (2 * kBK + 2 * kBQ) * (D + kPad) * 4 + kBQ * kPS * 4; }

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-fed tiles
// ---------------------------------------------------------------------------
constexpr int kSoloMaxD = 128;      // head widths up to which a warpgroup works alone
constexpr bool kSoloOverlap = true;  // solo: form tile i while tile i-1's accumulations run

template <int D>
struct Bw : Swz<D> {  // SW, CC, NCH, KPC and LAYOUT: the swizzle of a [rows, D] tile
  // solo: each consumer warpgroup owns 64 resident rows of its own and takes
  // every product of them (dK and dV together fit its registers up to D =
  // 128); else the two share 64 rows and split the products (D = 256)
  static constexpr bool SOLO = D <= kSoloMaxD;
  static constexpr int BR = SOLO ? 128 : 64;  // resident rows a block
  static constexpr int BN = 64;               // streamed rows a step
  static constexpr int THREADS = 384;  // two consumer warpgroups, then the producer's
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
  static constexpr uint32_t R_BYTES = BR * D * 2, C_BYTES = BN * D * 2;
  static constexpr uint32_t PD_BYTES = 64 * BN * 4;  // one slot of warpgroup 0's tile
  static constexpr int SLOTS = SOLO ? 0 : 2;
  static constexpr uint32_t ST_BYTES = BN * 8;       // a stage's (lse, D_i) slice
  static constexpr uint32_t STAGE = 2 * C_BYTES + ST_BYTES;
  // alignment, R1, R2, the slots, barriers
  static constexpr uint32_t FIXED = 1024 + 2 * R_BYTES + SLOTS * PD_BYTES + 128;
  static constexpr int STAGES = (232448 - FIXED) / STAGE < 4 ? (232448 - FIXED) / STAGE : 4;
  static constexpr size_t SMEM = FIXED + STAGES * STAGE;
  static_assert(STAGES >= 2, "shared memory");
  static_assert(8 * (1 + 2 * STAGES + 2 * SLOTS) <= 128, "barriers");
};

// One bulk copy of `bytes` (a multiple of 16) from global memory into
// shared memory; its bytes count against the barrier's expected transactions.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared memory: R1 and R2 (the resident tiles, [NCH][BR][SW] each), the C1
// ring and the C2 ring (stage s of each a streamed tile, [NCH][BN][SW]), the
// pair's two slots of warpgroup 0's tile for warpgroup 1 ([BN / 2][128]
// floats, fragment index major, so a warp's 32 threads touch 32 consecutive
// words), the stages' (lse, D_i) slices, then the barriers: r_full,
// full[STAGES], empty[STAGES], p_full[SLOTS], p_empty[SLOTS]. Every tile
// starts on 1024 bytes, the period of the 128-byte swizzle.
//
// dK and dV (kDQ false): R1 = K, R2 = V of (kv tile, kv head); C1 = Q, C2 =
// dO of the rep heads' q tiles that reach it. dQ (kDQ true): R1 = Q, R2 = dO
// of (q tile, head); C1 = K, C2 = V of the kv tiles its rows reach. The
// products of 64 resident rows: X = R1 C1^T (S^T or S) gives P, Y = R2 C2^T
// (dP^T or dP) gives dS with P; then dV += P^T dO (from C2) and dK += dS^T Q
// or dQ += dS K (from C1). Solo, a warpgroup takes all of them for its own
// 64 rows; as a pair, warpgroup 0 takes X, P and dV, warpgroup 1 Y, dS and
// dK or dQ, P passing through a slot as P (1 - t^2) scale.
template <int D, bool kDQ, bool kCap>
__global__ void __launch_bounds__(Bw<D>::THREADS, 1)
    fa_bwd_tc_kernel(const __grid_constant__ CUtensorMap tr1,
                     const __grid_constant__ CUtensorMap tr2,
                     const __grid_constant__ CUtensorMap tc1,
                     const __grid_constant__ CUtensorMap tc2, const Params p) {
  using T = Bw<D>;
  constexpr int BR = T::BR, BN = T::BN, SW = T::SW, CC = T::CC, STAGES = T::STAGES;
  constexpr int SLOTS = T::SLOTS, kSlots = SLOTS > 0 ? SLOTS : 1;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);  // the same bytes, generic
  const uint32_t sR1 = base, sR2 = base + T::R_BYTES;
  const uint32_t c1_ring = base + 2 * T::R_BYTES, c2_ring = c1_ring + STAGES * T::C_BYTES;
  const uint32_t pd_off = 2 * T::R_BYTES + 2 * STAGES * T::C_BYTES;
  float* const pd = reinterpret_cast<float*>(gbase + pd_off);
  const uint32_t st_off = pd_off + SLOTS * T::PD_BYTES;
  const float2* const sst = reinterpret_cast<const float2*>(gbase + st_off);
  const uint32_t bars = base + st_off + STAGES * T::ST_BYTES;
  const uint32_t r_full = bars, full = bars + 8, empty = full + 8 * STAGES;
  const uint32_t p_full = empty + 8 * STAGES, p_empty = p_full + 8 * SLOTS;

  // The block's work: resident rows [r0, r0 + BR) of head r_head (a kv head
  // of [B * G] for dK and dV, a q head of [B * H] for dQ), and N streamed
  // steps: step n is the tile of rows [c_row0, c_row0 + BN) of head c_head.
  const int rep = p.H / p.G;
  const int idx = blockIdx.x;
  int b, r0, r_head, lo, hi, g;
  if (kDQ) {
    const int n_tiles = (p.Sq + BR - 1) / BR;
    const int hb = idx % (p.H * p.B);
    r0 = (n_tiles - 1 - idx / (p.H * p.B)) * BR;  // the last q tiles first
    b = hb / p.H;
    g = hb % p.H / rep;
    r_head = hb;
    col_range(p, r0, min(r0 + BR, p.Sq) - 1, lo, hi);
  } else {
    const int gb = idx % (p.G * p.B);
    r0 = idx / (p.G * p.B) * BR;  // the first kv tiles first
    b = gb / p.G;
    g = gb % p.G;
    r_head = gb;
    row_range(p, r0, min(r0 + BR, p.Skv) - 1, lo, hi);
  }
  const int t0 = lo / BN, nt = hi > lo ? (hi + BN - 1) / BN - t0 : 0;
  const int N = kDQ ? nt : rep * nt;
  auto c_head = [&](int n) { return kDQ ? b * p.G + g : b * p.H + g * rep + n / max(nt, 1); };
  auto c_row0 = [&](int n) { return (t0 + (kDQ ? n : n % max(nt, 1))) * BN; };

  if (threadIdx.x == 0) {
    mbar_init(r_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);      // the producer's expect_tx
      mbar_init(empty + 8 * s, 256);   // every consumer thread
    }
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(p_full + 8 * s, 128);   // warpgroup 0's threads
      mbar_init(p_empty + 8 * s, 128);  // warpgroup 1's threads
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The warpgroup index, read through a shuffle so that the compiler knows it
  // is the same in every thread of a warp (no wgmma on a divergent path).
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 2) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(T::PRODUCER_REGS));
    if (threadIdx.x == 256) {
      mbar_expect_tx(r_full, 2 * T::R_BYTES);
#pragma unroll
      for (int c = 0; c < T::NCH; ++c) {
        tma_load(sR1 + c * BR * SW, &tr1, r_full, c * CC, r0, r_head);
        tma_load(sR2 + c * BR * SW, &tr2, r_full, c * CC, r0, r_head);
      }
      for (int n = 0; n < N; ++n) {
        const int s = n % STAGES, row0 = c_row0(n), head = c_head(n);
        if (n >= STAGES) mbar_wait(empty + 8 * s, (n / STAGES - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * T::C_BYTES + (kDQ ? 0 : T::ST_BYTES));
#pragma unroll
        for (int c = 0; c < T::NCH; ++c) {
          tma_load(c1_ring + s * T::C_BYTES + c * BN * SW, &tc1, full + 8 * s, c * CC, row0, head);
          tma_load(c2_ring + s * T::C_BYTES + c * BN * SW, &tc2, full + 8 * s, c * CC, row0, head);
        }
        if (!kDQ)
          bulk_load(base + st_off + s * T::ST_BYTES,
                    p.stats + static_cast<size_t>(head) * p.Sq_pad + row0, T::ST_BYTES, full + 8 * s);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(T::CONSUMER_REGS));
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, quad = lane % 4;
  const float k_in = kCap ? p.scale / p.softcap : 0.f;
  const float k2 = (kCap ? p.softcap : p.scale) * kLog2e;
  const int w0 = T::SOLO ? 64 * wg : 0;  // this warpgroup's first resident row in the block
  // dQ: this thread's two resident (query) rows' -lse log2(e) and D_i
  float nl_row[2] = {0.f, 0.f}, dl_row[2] = {0.f, 0.f};
  if (kDQ) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float2 st = p.stats[static_cast<size_t>(r_head) * p.Sq_pad + r0 + w0 + 16 * warp +
                                lane / 4 + 8 * e];
      nl_row[e] = -st.x * kLog2e;
      dl_row[e] = st.y;
    }
  }

  // A warpgroup's work; its role a compile-time constant: 0 forms P and 1 dS
  // of a pair, 2 both (solo).
  auto consume = [&](auto role) {
    constexpr int kRole = decltype(role)::value;
    constexpr bool kX = kRole != 1, kY = kRole != 0;   // takes X (S), takes Y (dP)
    constexpr bool kOutP = !kDQ && kX;                 // dV += P^T dO
    constexpr bool kOutS = kY;                         // dK += dS^T Q, or dQ += dS K
    constexpr bool kOut = kOutP || kOutS;
    // Solo dK and dV at D = 128 run each step's accumulations alone: with the
    // next step's products in flight beside them, the tiles, their bf16
    // copies and the two sums (224 registers) spill.
    constexpr bool kOverlap = kRole != 2 || (kSoloOverlap && (kDQ || D < 128));
    float sx[BN / 2], sy[BN / 2], acc_p[D / 2], acc_s[D / 2];
    uint32_t fp[BN / 16][4], fs[BN / 16][4];
    if constexpr (kOutP) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc_p[i] = 0.f;
    }
    if constexpr (kOutS) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc_s[i] = 0.f;
    }
    auto fence_tiles = [&]() {
      if constexpr (kX) fence_regs(sx);
      if constexpr (kY) fence_regs(sy);
    };
    auto fence_outs = [&]() {
      if constexpr (kOutP) {
        fence_regs(acc_p);
        fence_regs(fp);
      }
      if constexpr (kOutS) {
        fence_regs(acc_s);
        fence_regs(fs);
      }
    };
    auto wait_full = [&](int n) { mbar_wait(full + 8 * (n % STAGES), (n / STAGES) & 1); };
    auto free_stage = [&](int n) { mbar_arrive(empty + 8 * (n % STAGES)); };
    // The operands' wgmma descriptors: a base a call, each k16 step's an
    // offset added to it (the start address is the low field, in 16 bytes).
    // The bases pass through an empty asm, so that the compiler builds them
    // each step and keeps no step's descriptors in registers across the loop.
    auto desc = [&](uint32_t addr, uint32_t lbo) {
      asm volatile("" : "+r"(addr));
      return smem_desc(addr, lbo, 8 * SW, T::LAYOUT);
    };
    auto issue_prod = [&](int n) {  // X and/or Y over D, committed as one group
      const uint32_t stage = (n % STAGES) * T::C_BYTES;
      const uint64_t r1 = desc(sR1 + w0 * SW, 16), r2 = desc(sR2 + w0 * SW, 16);
      const uint64_t s1 = desc(c1_ring + stage, 16), s2 = desc(c2_ring + stage, 16);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int ch = kk / T::KPC, in = kk % T::KPC;
        const uint32_t ra = (ch * BR * SW + in * 32) >> 4, ca = (ch * BN * SW + in * 32) >> 4;
        if constexpr (kX) wgmma_ss<BN>(sx, r1 + ra, s1 + ca, kk > 0);
        if constexpr (kY) wgmma_ss<BN>(sy, r2 + ra, s2 + ca, kk > 0);
      }
      wg_commit();
    };
    auto issue_out = [&](int n) {  // the accumulations of step n, committed as one group
      const uint32_t stage = (n % STAGES) * T::C_BYTES;
      const uint64_t s1 = desc(c1_ring + stage, BN * SW), s2 = desc(c2_ring + stage, BN * SW);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        if constexpr (kOutP) wgmma_rs<D>(acc_p, fp[kk], s2 + ((kk * 16 * SW) >> 4));
        if constexpr (kOutS) wgmma_rs<D>(acc_s, fs[kk], s1 + ((kk * 16 * SW) >> 4));
      }
      wg_commit();
    };
    auto round_tiles = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if constexpr (kOutP) fp[kk][r] = pack_bf16(sx[8 * kk + 2 * r], sx[8 * kk + 2 * r + 1]);
          if constexpr (kOutS) fs[kk][r] = pack_bf16(sy[8 * kk + 2 * r], sy[8 * kk + 2 * r + 1]);
        }
    };
    // Step n's tiles, in place: P in sx and dS in sy. A pair's warpgroup 0
    // hands P (1 - t^2) scale to warpgroup 1 through a slot.
    auto form = [&](int n) {
      const int s = n % STAGES, row0 = c_row0(n);
      const int slot = n % kSlots, turn = n / kSlots;
      float* const slot_p = pd + slot * (64 * BN);
      if constexpr (kRole == 0) {
        if (n >= SLOTS) mbar_wait(p_empty + 8 * slot, (turn - 1) & 1);
      } else if constexpr (kRole == 1) {
        mbar_wait(p_full + 8 * slot, turn & 1);
      }
      // the pairs this tile covers: query rows [qa, qb], kv columns [ka, kb]
      const int qa = kDQ ? r0 + w0 : row0, qb = qa + (kDQ ? 64 : BN) - 1;
      const int ka = kDQ ? row0 : r0 + w0, kb = ka + (kDQ ? BN : 64) - 1;
      const bool edge = !all_live(p, qa, qb, ka, kb);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float4 st = make_float4(0.f, 0.f, 0.f, 0.f);  // dK, dV: the columns' (lse, D_i)
        if (!kDQ) st = *reinterpret_cast<const float4*>(sst + s * BN + 8 * j + 2 * quad);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = 4 * j + x, e = x / 2;  // accumulator row half e, column 8j + 2quad + x%2
          const int rr = r0 + w0 + 16 * warp + lane / 4 + 8 * e, cc = row0 + 8 * j + 2 * quad + x % 2;
          const bool ok = !edge || (kDQ ? live(p, rr, cc) : live(p, cc, rr));
          float pdv = 0.f;
          if constexpr (kX) {
            float u = sx[i], dcap = 1.f;
            if (kCap) {
              u = tanh_approx(u * k_in);
              dcap = 1.f - u * u;
            }
            const float nl = kDQ ? nl_row[e] : -(x % 2 ? st.z : st.x) * kLog2e;
            const float pr = ok ? exp2_approx(fmaf(u, k2, nl)) : 0.f;
            pdv = pr * dcap * p.scale;
            sx[i] = pr;
            if constexpr (kRole == 0) slot_p[i * 128 + t] = pdv;
          }
          if constexpr (kY) {
            if constexpr (kRole == 1) pdv = slot_p[i * 128 + t];
            const float dl = kDQ ? dl_row[e] : (x % 2 ? st.w : st.y);
            sy[i] = pdv * (sy[i] - dl);
          }
        }
      }
      if constexpr (kRole == 0) mbar_arrive(p_full + 8 * slot);
      if constexpr (kRole == 1) mbar_arrive(p_empty + 8 * slot);
    };

    mbar_wait(r_full, 0);
    if (N > 0) {
      wait_full(0);
      wg_fence();
      issue_prod(0);
      wg_wait<0>();
      fence_tiles();
      form(0);
      if (kOut) round_tiles(); else free_stage(0);
      auto accumulate = [&](int n) {  // step n's accumulations alone
        fence_outs();
        wg_fence();
        issue_out(n);
        wg_wait<0>();
        fence_outs();
        free_stage(n);
      };
      for (int n = 1; n < N; ++n) {
        if (kOut && !kOverlap) accumulate(n - 1);
        wait_full(n);
        if (kOut && kOverlap) fence_outs();
        wg_fence();
        issue_prod(n);
        if (kOut && kOverlap) {
          issue_out(n - 1);
          wg_wait<1>();  // the products are done; the accumulations may still run
        } else {
          wg_wait<0>();
        }
        fence_tiles();
        form(n);
        if (kOut && kOverlap) {
          wg_wait<0>();
          fence_outs();
          free_stage(n - 1);
        }
        if (kOut) round_tiles(); else free_stage(n);
      }
      if (kOut) accumulate(N - 1);
    }
    // dV, then dK or dQ, rows past the end left out
    const int n_rows = kDQ ? p.Sq : p.Skv;
    auto write = [&](const float (&acc)[D / 2], void* dst) {
      __nv_bfloat16* const out = static_cast<__nv_bfloat16*>(dst);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = r0 + w0 + 16 * warp + lane / 4 + 8 * e;
        if (row >= n_rows) continue;
        __nv_bfloat16* const orow = out + (static_cast<size_t>(r_head) * n_rows + row) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * quad) =
              __floats2bfloat162_rn(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
      }
    };
    if constexpr (kOutP) write(acc_p, p.dv);
    if constexpr (kOutS) write(acc_s, kDQ ? p.dq : p.dk);
  };
  if constexpr (T::SOLO) {
    consume(std::integral_constant<int, 2>{});
  } else {
    if (wg == 0)
      consume(std::integral_constant<int, 0>{});
    else
      consume(std::integral_constant<int, 1>{});
  }
}

template <int D, bool kDQ, bool kCap>
cudaError_t launch_tc(const Params& p, PFN_cuTensorMapEncodeTiled_v12000 encode,
                      cudaStream_t stream) {
  using T = Bw<D>;
  const int qh = p.B * p.H, kh = p.B * p.G;
  CUtensorMap r1, r2, c1, c2;
  const bool ok =
      kDQ ? tensor_map<D>(encode, &r1, p.q, p.Sq, qh, T::BR) &&
                tensor_map<D>(encode, &r2, p.dout, p.Sq, qh, T::BR) &&
                tensor_map<D>(encode, &c1, p.k, p.Skv, kh, T::BN) &&
                tensor_map<D>(encode, &c2, p.v, p.Skv, kh, T::BN)
          : tensor_map<D>(encode, &r1, p.k, p.Skv, kh, T::BR) &&
                tensor_map<D>(encode, &r2, p.v, p.Skv, kh, T::BR) &&
                tensor_map<D>(encode, &c1, p.q, p.Sq, qh, T::BN) &&
                tensor_map<D>(encode, &c2, p.dout, p.Sq, qh, T::BN);
  if (!ok) return cudaErrorInvalidValue;
  const auto kernel = fa_bwd_tc_kernel<D, kDQ, kCap>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return err;
  const long long tiles = kDQ ? (p.Sq + T::BR - 1) / T::BR : (p.Skv + T::BR - 1) / T::BR;
  const dim3 grid(static_cast<unsigned>(tiles * (kDQ ? p.H : p.G) * p.B));
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(r1, r2, c1, c2, p);
  return cudaGetLastError();
}

template <typename K>
cudaError_t run(K kernel, dim3 grid, int smem, const Params& p, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const Params& p, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.B) * p.H * p.Sq_pad;
  const dim3 row_grid(static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32)));
  if (dtype == 0) {
    cudaError_t err = run(fa_bwd_delta_kernel<float, D>, row_grid, 0, p, stream);
    if (err != cudaSuccess) return err;
    const dim3 q_grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
    const dim3 kv_grid((p.Skv + kBK - 1) / kBK, p.G, p.B);
    err = run(fa_bwd_dkdv_kernel<D>, kv_grid, dkdv_smem<D>(), p, stream);
    if (err != cudaSuccess) return err;
    return run(fa_bwd_dq_kernel<D>, q_grid, dq_smem<D>(), p, stream);
  }
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  cudaError_t err = run(fa_bwd_delta_kernel<__nv_bfloat16, D>, row_grid, 0, p, stream);
  if (err != cudaSuccess) return err;
  const bool cap = p.softcap > 0.f;
  err = cap ? launch_tc<D, false, true>(p, encode, stream)
            : launch_tc<D, false, false>(p, encode, stream);
  if (err != cudaSuccess) return err;
  return cap ? launch_tc<D, true, true>(p, encode, stream)
             : launch_tc<D, true, false>(p, encode, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (backend.FLOAT_CODES). q, o, dout and dq are
// [B, H, Sq, D]; k, v, dk and dv [B, G, Skv, D]; lse the forward's fp32 [B,
// H, Sq]; stats fp32 scratch of [B * H, Sq_pad, 2], Sq_pad = Sq rounded up
// to a multiple of 128 (ops.py::STATS_ROWS). The wrapper checks that every
// tensor is contiguous on one card, 16-byte aligned, of one dtype (lse
// fp32), with H % G == 0, D in {32, 64, 128, 256} and B, H, Sq and Skv at
// least 1. Three launches on the stream: the delta pass, then dK and dV,
// then dQ.
extern "C" __attribute__((visibility("default"))) int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, void* dq, void* dk, void* dv, float* stats, int dtype, int B, int H, int G,
    int Sq, int Skv, int D, int causal, int window, float softcap, float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || G < 1 || H % G != 0 || B < 1 || Sq < 1 || Skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Sq_pad = (Sq + kRowPad - 1) / kRowPad * kRowPad;
  const Params p{q,  k,  v,  o,   dout, lse, dq,       dk,     dv, reinterpret_cast<float2*>(stats),
                 B,  H,  G,  Sq, Skv,  Skv - Sq, causal, window, Sq_pad, softcap, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch<32>(dtype, p, s); break;
    case 64: err = launch<64>(dtype, p, s); break;
    case 128: err = launch<128>(dtype, p, s); break;
    case 256: err = launch<256>(dtype, p, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
