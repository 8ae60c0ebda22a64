// Flash attention's backward for Hopper (sm_90a): dQ, dK and dV.
//
// The TPU package has no backward kernel: its trainers differentiate the
// reference attention (kernels/flash_attention/ref.py::flash_attention_ref,
// JAX package) by autodiff. This file computes exactly that gradient, so the
// port can train through its forward kernel (csrc/flash_attention.cu, which
// replaces kernels/flash_attention/kernel.py::flash_attention_kernel):
// given q [B, H, Sq, D], k, v [B, G, Skv, D], the forward's output o and
// its cotangent dO [B, H, Sq, D], it writes dQ [B, H, Sq, D] and dK, dV
// [B, G, Skv, D] in the inputs' dtype (fp32 or bf16), accumulating in fp32.
//
// The function, per head h (kv head g = h / rep, rep = H / G), with
// x = scale * q.k and, under a softcap c, s = c * tanh(x / c) (else s = x):
//   P = softmax over the live columns of s; O = P V;
//   D_i = sum_d dO_id O_id;  dP = dO V^T;  dS = P * (dP - D_i);
//   dX = dS * (1 - tanh^2(x / c)) (1 without a softcap);
//   dQ = scale * dX K;  dK = scale * dX^T Q (summed over the rep heads of g);
//   dV = P^T dO (summed over the rep heads of g).
// The masks are the reference's: with off = Skv - Sq, row i sees column j
// iff (not causal or j <= i + off) and (window <= 0 or j > i + off - window).
// A row with no live column has P = 0 and so a zero gradient, as the
// reference's where() gives. The softcap's tanh is tanhf here (the bf16
// forward kernel takes tanh.approx.f32, the fp32 one tanhf): P is recomputed
// with the accurate tanh, and D_i is taken from the forward's o, so in bf16
// the two differ by the approximate tanh's error (~2^-11 relative in s),
// far below bf16's rounding of o.
//
// Plan (FA2's backward, written plainly: fp32 FMAs on shared-memory tiles,
// no tensor cores yet):
//  1. fa_bwd_rows_kernel, a block per (32-row q tile, head, batch row):
//     the row's log-sum-exp over its live columns (an online max and sum
//     over the kv tiles that hold a live pair) and D_i, into fp32 scratch;
//  2. fa_bwd_dkdv_kernel, a block per (32-column kv tile, kv head, batch
//     row): K and V stay in shared memory while the block loops over the rep
//     heads of its kv head and the q tiles that reach its columns,
//     recomputing P and dS tile by tile; dK and dV accumulate in registers;
//  3. fa_bwd_dq_kernel, a block per (q tile, head, batch row): loops over
//     the kv tiles its rows reach; dQ accumulates in registers.
// Tiles are 32 x 32 and a block has 256 threads: for a score tile, thread t
// owns row t / 8 and columns t % 8 + 8c (c < 4), so a row's 32 columns sit
// on 8 neighbouring lanes (shuffles reduce them); for an accumulator, thread
// t owns row t / 8 and the float4 columns 4 (t % 8) + 32c of D. Shared rows
// are padded by 4 floats (row starts 16 banks apart, float4 loads conflict
// free) and the [32, 32] P and dS tiles by 8.
//
// Bound: operations. The gradient needs five products over the live pairs
// (S = Q K^T, dP = dO V^T, dV, dK, dQ: 10 D operations a live pair a head),
// above the card's 295 operations a byte in bf16 at any training length.
// This kernel does eight (S in each of the three passes, dP in two) on the
// fp32 FMA units, so it runs far from the tensor cores' rate: a wgmma and
// TMA version is later work.
#include <cuda_bf16.h>

#include "qac_common.cuh"  // qac_error_string, which every kernel library exports

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 32;            // query rows a tile
constexpr int kBK = 32;            // kv columns a tile
constexpr int kPad = 4;            // floats of padding per shared row of a [rows, D] tile
constexpr int kPS = kBK + 8;       // row stride of the shared P and dS tiles

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;      // [B, H, Sq]
  float* delta;    // [B, H, Sq]
  int H, G, Sq, Skv, off, causal, window;
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
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void fma4(float4& acc, float a, float4 x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

// Rows [row0, row0 + kRows) of a [n_rows, D] matrix into a padded fp32 tile,
// zeros past n_rows.
template <typename T, int D, int kRows>
__device__ void load_tile(float* dst, const T* src, int row0, int n_rows) {
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

__device__ __forceinline__ bool live(const Params& p, int row, int col) {
  if (row >= p.Sq || col >= p.Skv) return false;
  const int r = row + p.off;
  return (!p.causal || col <= r) && (p.window <= 0 || col > r - p.window);
}

// The score s of a raw product qk, and ds/dx (the softcap's derivative).
__device__ __forceinline__ float score(const Params& p, float qk, float& dcap) {
  const float x = qk * p.scale;
  if (p.softcap > 0.f) {
    const float t = tanhf(x / p.softcap);
    dcap = 1.f - t * t;
    return p.softcap * t;
  }
  dcap = 1.f;
  return x;
}

// Sum over the 8 lanes that hold a row's columns.
__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}
__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return x;
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
    float dcap;
    const float x = score(p, s[c], dcap);
    pr[c] = live(p, q0 + ti, k0 + tj + 8 * c) ? expf(x - lse) : 0.f;
    ds[c] = pr[c] * (dp[c] - delta) * dcap * p.scale;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fa_bwd_rows_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * (D + kPad);
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int ti = threadIdx.x / 8, tj = threadIdx.x % 8;
  const long long head = static_cast<long long>(b) * p.H + h;
  const T* q = static_cast<const T*>(p.q) + head * p.Sq * D;
  const T* k = static_cast<const T*>(p.k) + (static_cast<long long>(b) * p.G + g) * p.Skv * D;
  load_tile<T, D, kBQ>(Qs, q, q0, p.Sq);
  const int row = q0 + ti;
  float dl = 0.f;
  if (row < p.Sq) {
    const T* o = static_cast<const T*>(p.o) + (head * p.Sq + row) * D;
    const T* dout = static_cast<const T*>(p.dout) + (head * p.Sq + row) * D;
    for (int d = tj * 4; d < D; d += 32) {
      const float4 a = load4(o + d), c = load4(dout + d);
      dl += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
    }
  }
  dl = row_sum8(dl);
  int lo, hi;
  col_range(p, q0, min(q0 + kBQ, p.Sq) - 1, lo, hi);
  float m = -INFINITY, l = 0.f;
  for (int k0 = (lo / kBK) * kBK; k0 < hi; k0 += kBK) {
    __syncthreads();
    load_tile<T, D, kBK>(Ks, k, k0, p.Skv);
    __syncthreads();
    float s[4], x[4];
    dot_tile<D>(Qs, Ks, ti, tj, s);
    float tmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float dcap;
      x[c] = live(p, row, k0 + tj + 8 * c) ? score(p, s[c], dcap) : -INFINITY;
      tmax = fmaxf(tmax, x[c]);
    }
    const float m_new = fmaxf(m, row_max8(tmax));
    float ts = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) ts += x[c] > -INFINITY ? expf(x[c] - m_new) : 0.f;
    ts = row_sum8(ts);
    if (m_new > -INFINITY) {
      l = l * expf(m - m_new) + ts;   // expf(-inf) = 0 while m is unset
      m = m_new;
    }
  }
  if (tj == 0 && row < p.Sq) {
    p.lse[head * p.Sq + row] = l > 0.f ? m + logf(l) : INFINITY;   // no live column: P = 0
    p.delta[head * p.Sq + row] = dl;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fa_bwd_dkdv_kernel(Params p) {
  constexpr int S = D + kPad, kC = D / 32;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kBK * S;
  float* Qs = Vs + kBK * S;
  float* dOs = Qs + kBQ * S;
  float* Ps = dOs + kBQ * S;
  float* dSs = Ps + kBQ * kPS;
  float* lse_s = dSs + kBQ * kPS;
  float* dl_s = lse_s + kBQ;
  const int k0 = blockIdx.x * kBK, g = blockIdx.y, b = blockIdx.z;
  const int rep = p.H / p.G;
  const int ti = threadIdx.x / 8, tj = threadIdx.x % 8;
  const long long kv = (static_cast<long long>(b) * p.G + g) * p.Skv * D;
  load_tile<T, D, kBK>(Ks, static_cast<const T*>(p.k) + kv, k0, p.Skv);
  load_tile<T, D, kBK>(Vs, static_cast<const T*>(p.v) + kv, k0, p.Skv);
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
    const T* q = static_cast<const T*>(p.q) + head * p.Sq * D;
    const T* dout = static_cast<const T*>(p.dout) + head * p.Sq * D;
    for (int q0 = (lo / kBQ) * kBQ; q0 < hi; q0 += kBQ) {
      __syncthreads();
      load_tile<T, D, kBQ>(Qs, q, q0, p.Sq);
      load_tile<T, D, kBQ>(dOs, dout, q0, p.Sq);
      if (threadIdx.x < kBQ) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < p.Sq ? p.lse[head * p.Sq + row] : INFINITY;
        dl_s[threadIdx.x] = row < p.Sq ? p.delta[head * p.Sq + row] : 0.f;
      }
      __syncthreads();
      float pr[4], ds[4];
      p_ds_tile<D>(p, Qs, dOs, Ks, Vs, q0, k0, ti, tj, lse_s[ti], dl_s[ti], pr, ds);
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
    T* dk = static_cast<T*>(p.dk) + kv + static_cast<long long>(col) * D;
    T* dv = static_cast<T*>(p.dv) + kv + static_cast<long long>(col) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      store4(dk + tj * 4 + 32 * c, acc_k[c]);
      store4(dv + tj * 4 + 32 * c, acc_v[c]);
    }
  }
}

template <typename T, int D>
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
  load_tile<T, D, kBQ>(Qs, static_cast<const T*>(p.q) + head * p.Sq * D, q0, p.Sq);
  load_tile<T, D, kBQ>(dOs, static_cast<const T*>(p.dout) + head * p.Sq * D, q0, p.Sq);
  const int row = q0 + ti;
  const float lse = row < p.Sq ? p.lse[head * p.Sq + row] : INFINITY;
  const float delta = row < p.Sq ? p.delta[head * p.Sq + row] : 0.f;
  float4 acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  int lo, hi;
  col_range(p, q0, min(q0 + kBQ, p.Sq) - 1, lo, hi);
  for (int k0 = (lo / kBK) * kBK; k0 < hi; k0 += kBK) {
    __syncthreads();
    load_tile<T, D, kBK>(Ks, static_cast<const T*>(p.k) + kv, k0, p.Skv);
    load_tile<T, D, kBK>(Vs, static_cast<const T*>(p.v) + kv, k0, p.Skv);
    __syncthreads();
    float pr[4], ds[4];
    p_ds_tile<D>(p, Qs, dOs, Ks, Vs, q0, k0, ti, tj, lse, delta, pr, ds);
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
    T* dq = static_cast<T*>(p.dq) + (head * p.Sq + row) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) store4(dq + tj * 4 + 32 * c, acc[c]);
  }
}

template <int D>
constexpr int rows_smem() { return (kBQ + kBK) * (D + kPad) * 4; }
template <int D>
constexpr int dkdv_smem() { return (2 * kBK + 2 * kBQ) * (D + kPad) * 4 + 2 * kBQ * kPS * 4 + 2 * kBQ * 4; }
template <int D>
constexpr int dq_smem() { return (2 * kBK + 2 * kBQ) * (D + kPad) * 4 + kBQ * kPS * 4; }

template <typename K>
cudaError_t run(K kernel, dim3 grid, int smem, const Params& p, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const dim3 q_grid((p.Sq + kBQ - 1) / kBQ, p.H, B);
  const dim3 kv_grid((p.Skv + kBK - 1) / kBK, p.G, B);
  cudaError_t err = run(fa_bwd_rows_kernel<T, D>, q_grid, rows_smem<D>(), p, stream);
  if (err != cudaSuccess) return err;
  err = run(fa_bwd_dkdv_kernel<T, D>, kv_grid, dkdv_smem<D>(), p, stream);
  if (err != cudaSuccess) return err;
  return run(fa_bwd_dq_kernel<T, D>, q_grid, dq_smem<D>(), p, stream);
}

template <int D>
cudaError_t launch_d(int dtype, const Params& p, int B, cudaStream_t stream) {
  return dtype == 0 ? launch<float, D>(p, B, stream) : launch<__nv_bfloat16, D>(p, B, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (backend.FLOAT_CODES). q, o, dout and dq are
// [B, H, Sq, D]; k, v, dk and dv [B, G, Skv, D]; lse and delta fp32 [B, H,
// Sq] scratch. The wrapper checks that every tensor is contiguous on one
// card, 16-byte aligned, of one dtype, with H % G == 0, D in {32, 64, 128,
// 256} and B, H, Sq and Skv at least 1. Three launches on the stream: the
// rows pass, then dK and dV, then dQ.
extern "C" __attribute__((visibility("default"))) int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
    void* dk, void* dv, float* lse, float* delta, int dtype, int B, int H, int G, int Sq,
    int Skv, int D, int causal, int window, float softcap, float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || G < 1 || H % G != 0 || B < 1 || Sq < 1 || Skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,  k,     v,   o,        dout,   dq,     dk,      dv,     lse,
                 delta, H, G, Sq, Skv, Skv - Sq, causal, window, softcap, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch_d<32>(dtype, p, B, s); break;
    case 64: err = launch_d<64>(dtype, p, B, s); break;
    case 128: err = launch_d<128>(dtype, p, B, s); break;
    case 256: err = launch_d<256>(dtype, p, B, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
