// FM second-order interaction for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/fm_pairwise/kernel.py::_kernel /
// fm_pairwise_kernel (JAX package): for each row of emb [B, F, D],
//   out[b] = 0.5 * sum_d ((sum_f e[b,f,d])^2 - sum_f e[b,f,d]^2),
// from fp32 or bf16 input, cast to fp32 and accumulated in fp32. The TPU
// kernel tiled 256 rows into VMEM and stored a (256, 128) block with the
// scalar in lane 0 to keep the store lane-aligned, so its wrapper needed
// B % 256 == 0. Here the output is fp32 [B] directly, for any B.
//
// Bound: bytes. A row reads its F*D elements once and writes 4 bytes, with
// about 3 operations per element (0.75 per byte at fp32): far below the
// card's balance point, so the least time is B*(F*D*sizeof(T) + 4) bytes
// over the memory rate. Design: one warp per row stages the row's F*D
// contiguous elements in shared memory with coalesced loads (lane i reads
// elements i, i+32, ...), converted to fp32; lane d (and d+32, d+64, d+96
// when D > 32) then sums s_d and sq_d over f in order, and a shuffle
// reduction gives 0.5 * sum_d (s_d^2 - sq_d). Warps per block shrink as the
// row grows, so that a block stages at most 48 KB (one warp at F=64, D=128:
// 32 KB). Several rows per warp, 16-byte loads and fusing the embedding
// gather are for a later change.
#include <cuda_bf16.h>

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
