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
// a fully masked row gives 0.
//
// The TPU kernel walks a grid (B, H, q tiles, kv tiles) whose last axis runs
// in order on one core and carries (acc, m, l) across it in VMEM. Blocks on
// the card run in no order, so here one block owns a (b, h, q tile) and
// loops over the kv tiles itself, holding the softmax state in registers.
// It visits only the tiles in [lo, hi) that hold a live pair, which is the
// TPU kernel's skip rule plus col < kv_len[b]; q tiles are issued from the
// last (the most work under a causal mask) to the first. Any Sq and Skv:
// the ragged edges are masked (out-of-range K and V rows staged as zeros),
// not asserted away.
//
// Bound: at the prefill shapes of gemma2-2b (Sq = Skv = 32768, D = 256) the
// work is 4 * D operations per live (row, col) pair per head, some 900
// operations per byte of q, k, v and o: operations bound it. At decode
// (Sq = 1 against a 32768-token cache) each K and V row is used by one query
// row per head: bytes bound it, the whole cache read once per step.
//
// Design: two kernels behind one launcher, each templated on D (32, 64, 128
// or 256, the head widths of the LM archs).
//  * bf16 (the serving dtype): flash_attention_wmma_kernel, a block of 4
//    warps over 64 query rows; each warp owns 16 rows and runs Q K^T and P V
//    on the tensor cores with nvcuda::wmma 16x16x16 bf16 tiles and fp32
//    accumulators. Q, K and V tiles are staged in dynamic shared memory with
//    16-byte loads (D = 256 takes 83 KB, so 2 blocks fit on an SM); the
//    scores go through shared memory for the masked softmax, P is rounded to
//    bf16 for its product with V (the TPU kernel keeps P and V in fp32 there:
//    this kernel's one departure from its arithmetic, a relative error of at
//    most 2^-8 in each weight), and the fp32 output accumulators stay in
//    registers, rescaled row by row through a fragment that holds each
//    element's row index (loaded from a 16x16 matrix of row numbers, so no
//    undocumented fragment layout is assumed). Warps whose 16 rows lie past
//    Sq skip their products, so a decode step (Sq = 1) runs one warp's.
//  * fp32: flash_attention_kernel, scalar FMAs over 32 x 32 tiles in shared
//    memory (rows padded by one float against bank conflicts), four threads
//    to a query row, each holding D / 4 output accumulators in registers.
// Both read K and V once per q tile with no pipelining, and decode has no
// split over the cache: a block walks all of its row's cache alone. wgmma,
// TMA and a split-KV decode are for a later change.
#include <cuda_bf16.h>
#include <mma.h>

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
  }
}

// ---------------------------------------------------------------------------
// bf16: wmma tensor-core tiles
// ---------------------------------------------------------------------------
constexpr int kWmmaBQ = 64;

template <int D>
constexpr int kWmmaBK = D >= 256 ? 32 : 64;  // kv tile: 83 KB of shared memory at D = 256

template <int D>
constexpr size_t wmma_smem_bytes() {
  constexpr int BQ = kWmmaBQ, BK = kWmmaBK<D>, LD = D + 8;
  return sizeof(bf16) * (BQ * LD + 2 * BK * LD + BQ * (BK + 8)) +
         sizeof(float) * (BQ * (BK + 4) + BQ + 256);
}

__device__ __forceinline__ uint4 load16(const bf16* src) {
  return *reinterpret_cast<const uint4*>(src);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_wmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, Params p) {
  using namespace nvcuda;
  constexpr int BQ = kWmmaBQ, BK = kWmmaBK<D>;
  constexpr int LD = D + 8, LS = BK + 4, LP = BK + 8;  // padded row strides
  constexpr int NF = D / 16, NJ = BK / 16, V8 = D / 8, HALF = BK / 2;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  using MatA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
  // Every region's size is a multiple of 32 bytes, so each fragment's base
  // is 32-byte aligned, as wmma requires.
  extern __shared__ __align__(128) unsigned char raw[];
  bf16* sQ = reinterpret_cast<bf16*>(raw);                   // [BQ][LD]
  bf16* sK = sQ + BQ * LD;                                   // [BK][LD]
  bf16* sV = sK + BK * LD;                                   // [BK][LD]
  bf16* sP = sV + BK * LD;                                   // [BQ][LP]
  float* sS = reinterpret_cast<float*>(sP + BQ * LP);        // [BQ][LS]
  float* sA = sS + BQ * LS;                                  // [BQ] per-row factor
  float* sRow = sA + BQ;                                     // [16][16] row numbers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int r0 = qt * BQ, r1 = min(r0 + BQ, p.Sq);
  const size_t q_base = ((size_t)b * p.H + h) * p.Sq * D;
  const size_t kv_base = ((size_t)b * (p.H / p.rep) + h / p.rep) * p.Skv * D;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < BQ * V8; i += kThreads) {
    const int rr = i / V8, c8 = (i % V8) * 8;
    *reinterpret_cast<uint4*>(sQ + rr * LD + c8) =
        r0 + rr < p.Sq ? load16(q + q_base + (size_t)(r0 + rr) * D + c8) : zero;
  }
  for (int i = tid; i < 256; i += kThreads) sRow[i] = (float)(i / 16);
  __syncthreads();
  Acc rowmap;  // element i of any accumulator fragment lies in row rowmap.x[i]
  wmma::load_matrix_sync(rowmap, sRow, 16, wmma::mem_row_major);

  Acc o[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(o[f], 0.f);
  const int klen = kv_len_of(p, b);
  int lo, hi;
  col_range(p, r0, r1, klen, lo, hi);
  const bool warp_live = r0 + warp * 16 < p.Sq;          // any of its rows real
  const int my_r = warp * 16 + (lane >> 1), half = lane & 1;  // softmax: 2 lanes a row
  const int row = r0 + my_r, row_abs = row + p.off;
  const bool row_ok = row < p.Sq;
  float m = kNeg, l = 0.f;

  for (int c0 = lo / BK * BK; c0 < hi; c0 += BK) {
    __syncthreads();  // every warp is done with the previous K and V
    for (int i = tid; i < BK * V8; i += kThreads) {
      const int cc = i / V8, c8 = (i % V8) * 8, col = c0 + cc;
      uint4 kx = zero, vx = zero;
      if (col < p.Skv) {
        const size_t at = kv_base + (size_t)col * D + c8;
        kx = load16(k + at);
        vx = load16(v + at);
      }
      *reinterpret_cast<uint4*>(sK + cc * LD + c8) = kx;
      *reinterpret_cast<uint4*>(sV + cc * LD + c8) = vx;
    }
    __syncthreads();
    if (!warp_live) continue;

    {  // S = Q K^T for this warp's 16 rows, into shared memory
      Acc s[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) wmma::fill_fragment(s[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        MatA a;
        wmma::load_matrix_sync(a, sQ + warp * 16 * LD + kk * 16, LD);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
          wmma::load_matrix_sync(kb, sK + j * 16 * LD + kk * 16, LD);
          wmma::mma_sync(s[j], a, kb, s[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        wmma::store_matrix_sync(sS + warp * 16 * LS + j * 16, s[j], LS, wmma::mem_row_major);
    }
    __syncwarp();

    {  // the masked online softmax: two lanes per row, HALF columns each
      const float* srow = sS + my_r * LS + half * HALF;
      float sv[HALF];
      unsigned live = 0;
      float mx = kNeg;
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const bool ok = row_ok && is_live(p, row_abs, c0 + half * HALF + i, klen);
        sv[i] = ok ? score(srow[i], p) : kNeg;
        live |= (unsigned)ok << i;
        mx = fmaxf(mx, sv[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      const float m_new = fmaxf(m, mx), alpha = __expf(m - m_new);
      float sum = 0.f;
      bf16* prow = sP + my_r * LP + half * HALF;
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const float e = (live >> i) & 1u ? __expf(sv[i] - m_new) : 0.f;
        prow[i] = __float2bfloat16(e);
        sum += e;
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      l = l * alpha + sum;
      m = m_new;
      if (half == 0) sA[my_r] = alpha;
    }
    __syncwarp();

    float a_row[Acc::num_elements];
#pragma unroll
    for (int i = 0; i < Acc::num_elements; ++i) a_row[i] = sA[warp * 16 + (int)rowmap.x[i]];
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int i = 0; i < Acc::num_elements; ++i) o[f].x[i] *= a_row[i];
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {  // O += P V
      MatA pa;
      wmma::load_matrix_sync(pa, sP + warp * 16 * LP + kk * 16, LP);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, sV + kk * 16 * LD + f * 16, LD);
        wmma::mma_sync(o[f], pa, vb, o[f]);
      }
    }
  }

  if (!warp_live) return;  // no block-wide barrier follows
  if (half == 0) sA[my_r] = 1.f / fmaxf(l, 1e-30f);
  __syncwarp();
  float inv[Acc::num_elements];
#pragma unroll
  for (int i = 0; i < Acc::num_elements; ++i) inv[i] = sA[warp * 16 + (int)rowmap.x[i]];
  float* stage = sS + warp * 16 * LS;  // this warp's own score rows, free now
#pragma unroll
  for (int f = 0; f < NF; ++f) {
#pragma unroll
    for (int i = 0; i < Acc::num_elements; ++i) o[f].x[i] *= inv[i];
    wmma::store_matrix_sync(stage, o[f], LS, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      const int rr = i / 16, cc = i % 16, orow = r0 + warp * 16 + rr;
      if (orow < p.Sq)
        out[q_base + (size_t)orow * D + f * 16 + cc] = __float2bfloat16(stage[rr * LS + cc]);
    }
    __syncwarp();
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int dtype, int B,
                   const Params& p, cudaStream_t stream) {
  if (dtype == 0) {
    constexpr size_t smem = scalar_smem_bytes<D>();
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sq + kScalarBQ - 1) / kScalarBQ, p.H, B);
    flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), p);
  } else {
    constexpr size_t smem = wmma_smem_bytes<D>();
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_wmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sq + kWmmaBQ - 1) / kWmmaBQ, p.H, B);
    flash_attention_wmma_kernel<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), p);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (backend.FLOAT_CODES); kv_len may be null.
// The wrapper checks the shapes (H % G == 0, D in {32, 64, 128, 256}), that
// every tensor is contiguous on one card with 16-byte aligned rows, and that
// B, H, Sq and Skv are at least 1.
extern "C" __attribute__((visibility("default"))) int flash_attention_launch(
    const void* q, const void* k, const void* v, const int* kv_len, void* out, int dtype,
    int B, int H, int G, int Sq, int Skv, int D, int causal, int window, float softcap,
    float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || G < 1 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{kv_len, H, Sq, Skv, H / G, Skv - Sq, causal, window, softcap, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch<32>(q, k, v, out, dtype, B, p, s); break;
    case 64: err = launch<64>(q, k, v, out, dtype, B, p, s); break;
    case 128: err = launch<128>(q, k, v, out, dtype, B, p, s); break;
    case 256: err = launch<256>(q, k, v, out, dtype, B, p, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
