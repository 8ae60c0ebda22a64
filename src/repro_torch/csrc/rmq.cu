// Batched range-minimum query for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/rmq/kernel.py::_kernel / rmq_query_kernel
// (JAX package), which pre-gathered both partial 128-wide blocks to VMEM and
// took masked 128-lane argmins. Here each query is one thread running the
// shared qac::rmq_window body: two overlapping in-block windows per partial
// block through the int8 ib table, read as int8 with no widening copy, plus
// two sparse-table windows for the middle blocks.
//
// Bound: gather latency. A query needs at most 8 bytes of (p, q) in, 8 bytes
// of (pos, val) out, 4 ib bytes, 6 values reads and 2 sparse-table reads:
// under 64 bytes, each a dependent scattered load. The design keeps every
// query to two rounds of independent loads (ib, then values / st then
// values) and skips the reads the result cannot depend on; at the per-pop
// engine's batch of 2B lanes the launch itself dominates.
#include "qac_common.cuh"

namespace {

__global__ void rmq_query_kernel(qac::RmqTables t, const int* __restrict__ p,
                                 const int* __restrict__ q, int* __restrict__ pos,
                                 int* __restrict__ val, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  int op, ov;
  qac::rmq_window(t, p[i], q[i], op, ov);
  pos[i] = op;
  val[i] = ov;
}

}  // namespace

extern "C" __attribute__((visibility("default"))) int rmq_query_launch(
    const int* values, const int8_t* ib, const int* st_pos, int n, int n_pad,
    int levels, int n_blocks, const int* p, const int* q, int* pos, int* val,
    int B, void* stream) {
  const qac::RmqTables t{values, ib, st_pos, n, n_pad, levels, n_blocks};
  const int threads = 128;
  rmq_query_kernel<<<(B + threads - 1) / threads, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(t, p, q, pos, val, B);
  return static_cast<int>(cudaGetLastError());
}
