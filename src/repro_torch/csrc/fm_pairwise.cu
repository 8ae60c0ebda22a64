// FM on Hopper (sm_90a): the TPU's pairwise kernel, and the whole forward.
//
// fm_pairwise_kernel<T> replaces the TPU kernel
// kernels/fm_pairwise/kernel.py::_kernel / fm_pairwise_kernel (JAX package)
// and keeps its contract: for each row of emb [B, F, D],
//   out[b] = 0.5 * sum_d ((sum_f e[b,f,d])^2 - sum_f e[b,f,d]^2),
// from fp32 or bf16 input, accumulated in fp32, written as fp32 [B] for any B
// (the TPU kernel stored a (256, 128) block per 256 rows, scalar in lane 0).
// One warp per row stages the row's F*D elements in shared memory with
// coalesced loads; lane d (and d+32, ...) sums s_d and sq_d over f and a
// shuffle reduction finishes. Bound: bytes, B*(F*D*sizeof(T) + 4).
//
// fm_forward_kernel<T, kVec> is FM's whole forward from the ids, in one
// launch: the gathers of the JAX package's models/recsys.py:109-111 and the
// TPU kernel above,
//   logits[b] = bias + sum_f linear[f, clamp(ids[b,f])]
//               + 0.5 * sum_d ((sum_f e[b,f,d])^2 - sum_f e[b,f,d]^2),
//   e[b,f,d] = tables[f, clamp(ids[b,f]), d],
// where clamp wraps a negative id once (+V) and then clamps to [0, V-1]
// (numpy-style indexing, models/layers.py::clamp_rows). No index and no
// [B, F, D] tensor goes to device memory: the composition it replaces wrote
// an int64 [B, F] index (four passes), the [B, F, D] embeddings and a second
// gather, and read them back.
//
// Bound: bytes, and the bytes are scattered. The least traffic is the ids,
// each distinct (field, row) of tables and linear once, and 4 B a row out
// (about 4 operations an element: no arithmetic limit). Each id leads to a
// dependent gather of a short row (40 B at FM's D = 10 in fp32), so the
// kernel must keep many row loads in flight; once it does, what sets its
// time is the sectors it gathers: a 40-B row spans two 32-B sectors and its
// linear weight a third, every time the id recurs (from L2 or L1 for the
// hot ids of a Zipf batch, from DRAM for uniform ids). None of the other
// block sizes, loads in flight or lanes per row tried gains a tenth
// (scripts/fm_forward_sweep.py). Design:
//  * a block stages its rows' ids ([rows x F] int32, contiguous) in shared
//    memory with coalesced loads and applies the clamp there;
//  * a row belongs to a group of lanes_d x lanes_f lanes (a power of two up
//    to a warp): lanes_d lanes split the row's d into kVec-byte loads (16 B
//    where D*sizeof(T) and the table's address allow, else 8, 4 or, bf16,
//    2), at most kEltsPerLane elements a lane, held as s[] and sq[] in
//    registers; lanes_f lanes split the fields, which fills the card at
//    small B (the wrapper's plan_fm_forward picks both). At FM's width a
//    thread owns a whole row;
//  * a lane issues the loads of kFieldsInFlight fields (and their linear
//    weights) before it uses any of them;
//  * row offsets (f*V + id)*D are 64-bit (1.56e9 B at full width);
//  * s is summed over the field lanes by shuffles before it is squared; the
//    linear sum, both reductions and the bias (read through its pointer:
//    no host sync) stay in registers; lane 0 of the group writes the row.
// bf16 follows the plain route's dtype steps: the linear sum and then
// bias + lin are rounded to bf16, and the fp32 pair term is added last.
// No TMA and no wgmma: there is no matrix product, and TMA's tiled copies
// cannot gather scattered 40-B rows on sm_90.
//
// fm_pairwise_bwd_kernel<T> is fm_pairwise's gradient, which the TPU package
// leaves to autodiff of its reference (jax.grad of fm_pairwise_ref): for the
// cotangent g float32 [B],
//   grad_emb[b, f, d] = g[b] * (sum_f' e[b, f', d] - e[b, f, d]),
// computed in fp32 and written in emb's dtype. One warp per row, as the
// forward: the row staged in shared memory with coalesced loads, lane d (and
// d + 32, ...) sums s_d over f into shared memory, then the warp writes the
// row's F*D gradients with coalesced stores. Bound: bytes, B*(2*F*D*sizeof(T)
// + 4) (emb read, its gradient written, g read).
#include <cuda_bf16.h>

#include <type_traits>

#include "qac_common.cuh"  // qac_error_string, which every kernel library exports

namespace {

constexpr int kMaxStageBytes = 48 * 1024;
constexpr int kMaxWarps = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void fm_pairwise_kernel(const T* __restrict__ emb, float* __restrict__ out,
                                   int B, int F, int D) {
  extern __shared__ float stage[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= B) return;  // the whole warp shares its row, so all lanes leave
  const int n = F * D;
  float* e = stage + warp * n;
  const T* src = emb + row * n;
  for (int i = lane; i < n; i += 32) e[i] = to_float(src[i]);
  __syncwarp();
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) {
    float s = 0.f, sq = 0.f;
    for (int f = 0; f < F; ++f) {
      const float x = e[f * D + d];
      s += x;
      sq += x * x;
    }
    acc += s * s - sq;
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[row] = 0.5f * acc;
}

template <typename T>
void launch(const void* emb, float* out, int B, int F, int D, cudaStream_t stream) {
  const int row_bytes = F * D * (int)sizeof(float);
  const int warps = max(1, min(kMaxWarps, kMaxStageBytes / row_bytes));
  const int blocks = (B + warps - 1) / warps;
  fm_pairwise_kernel<T><<<blocks, warps * 32, warps * row_bytes, stream>>>(
      static_cast<const T*>(emb), out, B, F, D);
}

__device__ __forceinline__ void from_float(float x, float* y) { *y = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* y) { *y = __float2bfloat16(x); }

template <typename T>
__global__ void fm_pairwise_bwd_kernel(const T* __restrict__ emb, const float* __restrict__ g,
                                       T* __restrict__ grad, int B, int F, int D) {
  extern __shared__ float stage[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= B) return;  // the whole warp shares its row, so all lanes leave
  const int n = F * D;
  float* e = stage + warp * (n + D);   // the row, then its sums over the fields
  float* s = e + n;
  const T* src = emb + row * n;
  for (int i = lane; i < n; i += 32) e[i] = to_float(src[i]);
  __syncwarp();
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int f = 0; f < F; ++f) acc += e[f * D + d];
    s[d] = acc;
  }
  __syncwarp();
  const float gb = g[row];
  T* dst = grad + row * n;
  for (int i = lane; i < n; i += 32) from_float(gb * (s[i % D] - e[i]), dst + i);
}

template <typename T>
void launch_bwd(const void* emb, const float* g, void* grad, int B, int F, int D,
                cudaStream_t stream) {
  const int row_bytes = (F * D + D) * (int)sizeof(float);
  const int warps = max(1, min(kMaxWarps, kMaxStageBytes / row_bytes));
  const int blocks = (B + warps - 1) / warps;
  fm_pairwise_bwd_kernel<T><<<blocks, warps * 32, warps * row_bytes, stream>>>(
      static_cast<const T*>(emb), g, static_cast<T*>(grad), B, F, D);
}

// ---- fm_forward ----------------------------------------------------------
// kernels/fm_pairwise/ops.py mirrors the first two in its launch plan;
// scripts/fm_forward_sweep.py times other values of all three.
constexpr int kThreads = 128;
constexpr int kEltsPerLane = 16;    // at least one load's elements
constexpr int kFieldsInFlight = 2;

template <int kVec> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = unsigned int; };
template <> struct Vec<2> { using type = unsigned short; };

__device__ __forceinline__ void words(const uint4& v, unsigned* w) {
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void words(const uint2& v, unsigned* w) { w[0] = v.x; w[1] = v.y; }
__device__ __forceinline__ void words(unsigned v, unsigned* w) { w[0] = v; }

// The kVec / sizeof(T) elements of one load, as fp32 (bf16 is the high half
// of an fp32 word; the lower address holds the lower element).
template <typename T, int kVec>
__device__ __forceinline__ void unpack(const typename Vec<kVec>::type& v, float* x) {
  if constexpr (kVec == 2) {
    x[0] = __uint_as_float(static_cast<unsigned>(v) << 16);
  } else {
    unsigned w[kVec / 4];
    words(v, w);
#pragma unroll
    for (int i = 0; i < kVec / 4; ++i) {
      if constexpr (std::is_same_v<T, float>) {
        x[i] = __uint_as_float(w[i]);
      } else {
        x[2 * i] = __uint_as_float(w[i] << 16);
        x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
}

// One element read through the read-only path, as fp32.
template <typename T>
__device__ __forceinline__ float load_elt(const T* p) {
  if constexpr (std::is_same_v<T, float>) {
    return __ldg(p);
  } else {
    return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
                           << 16);
  }
}

// bias + lin + pair in the plain route's dtype steps.
template <typename T>
__device__ __forceinline__ float finish(float bias, float lin, float pair) {
  if constexpr (std::is_same_v<T, float>) {
    return (bias + lin) + pair;
  } else {
    const float lin_b = __bfloat162float(__float2bfloat16(lin));
    return __bfloat162float(__float2bfloat16(bias + lin_b)) + pair;
  }
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads) fm_forward_kernel(
    const int* __restrict__ ids, const T* __restrict__ tables, const T* __restrict__ linear,
    const T* __restrict__ bias, float* __restrict__ out, int B, int F, int V, int D,
    int lanes_d, int lanes_f) {
  using Load = typename Vec<kVec>::type;
  constexpr int kPer = kVec / (int)sizeof(T);     // elements a load brings
  constexpr int kLoads = kEltsPerLane > kPer ? kEltsPerLane / kPer : 1;  // a field's loads a lane
  constexpr int kElts = kLoads * kPer;            // accumulators s[] and sq[] a lane holds
  extern __shared__ int row_ids[];                // [rows][F], clamped
  const int group = lanes_d * lanes_f;
  const int rows = kThreads / group;
  const long long row0 = (long long)blockIdx.x * rows;
  const int n_rows = (int)min((long long)rows, B - row0);

  const int* src = ids + row0 * F;
  for (int i = threadIdx.x; i < n_rows * F; i += kThreads) {
    int id = src[i];
    if (id < 0) id += V;
    row_ids[i] = min(max(id, 0), V - 1);
  }
  __syncthreads();

  const int r = threadIdx.x / group, lane = threadIdx.x % group;
  const int dl = lane % lanes_d, fl = lane / lanes_d;
  const bool live = r < n_rows;   // dead rows still join the shuffles below
  const int chunks = D / kPer;    // loads that cover a row
  const int* rid = row_ids + r * F;
  float s[kElts], sq[kElts];
#pragma unroll
  for (int e = 0; e < kElts; ++e) s[e] = sq[e] = 0.f;
  float lin = 0.f;

  for (int f0 = live ? fl : F; f0 < F; f0 += lanes_f * kFieldsInFlight) {
    Load v[kFieldsInFlight][kLoads];
    float lv[kFieldsInFlight];
#pragma unroll
    for (int u = 0; u < kFieldsInFlight; ++u) {
      const int f = f0 + u * lanes_f;
      if (f < F) {
        const long long at = (long long)f * V + rid[f];
        const Load* p = reinterpret_cast<const Load*>(tables + at * D);
#pragma unroll
        for (int c = 0; c < kLoads; ++c)
          if (dl + c * lanes_d < chunks) v[u][c] = __ldg(p + dl + c * lanes_d);
        if (dl == 0) lv[u] = load_elt(linear + at);
      }
    }
#pragma unroll
    for (int u = 0; u < kFieldsInFlight; ++u) {
      if (f0 + u * lanes_f < F) {
#pragma unroll
        for (int c = 0; c < kLoads; ++c) {
          if (dl + c * lanes_d < chunks) {
            float x[kPer];
            unpack<T, kVec>(v[u][c], x);
#pragma unroll
            for (int k = 0; k < kPer; ++k) {
              s[c * kPer + k] += x[k];
              sq[c * kPer + k] += x[k] * x[k];
            }
          }
        }
        if (dl == 0) lin += lv[u];
      }
    }
  }

  // s over the field lanes of this d slice (lanes lanes_d apart), then one
  // scalar per lane reduced over the group.
  for (int off = lanes_d; off < group; off <<= 1) {
#pragma unroll
    for (int e = 0; e < kElts; ++e) s[e] += __shfl_xor_sync(0xffffffffu, s[e], off, group);
  }
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < kElts; ++e) acc += (fl == 0 ? s[e] * s[e] : 0.f) - sq[e];
  for (int off = 1; off < group; off <<= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off, group);
    lin += __shfl_xor_sync(0xffffffffu, lin, off, group);
  }
  if (live && lane == 0) out[row0 + r] = finish<T>(load_elt(bias), lin, 0.5f * acc);
}

template <typename T, int kVec>
void launch_forward(const void* ids, const void* tables, const void* linear, const void* bias,
                    float* out, int B, int F, int V, int D, int lanes_d, int lanes_f,
                    cudaStream_t stream) {
  const int rows = kThreads / (lanes_d * lanes_f);
  const int blocks = (B + rows - 1) / rows;
  fm_forward_kernel<T, kVec><<<blocks, kThreads, rows * F * (int)sizeof(int), stream>>>(
      static_cast<const int*>(ids), static_cast<const T*>(tables),
      static_cast<const T*>(linear), static_cast<const T*>(bias), out, B, F, V, D, lanes_d,
      lanes_f);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (backend.FLOAT_CODES). The wrapper checks
// 1 <= F <= 64, 1 <= D <= 128 and B >= 1.
extern "C" __attribute__((visibility("default"))) int fm_pairwise_launch(
    const void* emb, int dtype, float* out, int B, int F, int D, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(emb, out, B, F, D, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(emb, out, B, F, D, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// emb [B, F, D] and grad (its gradient, written) of dtype (0 float32, 1
// bfloat16); g float32 [B], the cotangent of fm_pairwise's output. The
// wrapper checks 1 <= F <= 64, 1 <= D <= 128 and B >= 1.
extern "C" __attribute__((visibility("default"))) int fm_pairwise_bwd_launch(
    const void* emb, const float* g, void* grad, int dtype, int B, int F, int D, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_bwd<float>(emb, g, grad, B, F, D, s);
  } else if (dtype == 1) {
    launch_bwd<__nv_bfloat16>(emb, g, grad, B, F, D, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ids int32 [B, F]; tables [F, V, D], linear [F, V, 1] and bias [] of dtype
// (0 float32, 1 bfloat16); out float32 [B]. vec, lanes_d and lanes_f come
// from kernels/fm_pairwise/ops.py::plan_fm_forward; the wrapper checks
// 1 <= F <= 64, 1 <= D <= 128, B >= 1 and V >= 1.
extern "C" __attribute__((visibility("default"))) int fm_forward_launch(
    const void* ids, const void* tables, const void* linear, const void* bias, int dtype,
    float* out, int B, int F, int V, int D, int vec, int lanes_d, int lanes_f, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FM_FORWARD(T, VEC) \
  launch_forward<T, VEC>(ids, tables, linear, bias, out, B, F, V, D, lanes_d, lanes_f, s)
  if (dtype == 0 && vec == 16) {
    FM_FORWARD(float, 16);
  } else if (dtype == 0 && vec == 8) {
    FM_FORWARD(float, 8);
  } else if (dtype == 0 && vec == 4) {
    FM_FORWARD(float, 4);
  } else if (dtype == 1 && vec == 16) {
    FM_FORWARD(__nv_bfloat16, 16);
  } else if (dtype == 1 && vec == 8) {
    FM_FORWARD(__nv_bfloat16, 8);
  } else if (dtype == 1 && vec == 4) {
    FM_FORWARD(__nv_bfloat16, 4);
  } else if (dtype == 1 && vec == 2) {
    FM_FORWARD(__nv_bfloat16, 2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FM_FORWARD
  return static_cast<int>(cudaGetLastError());
}
