// gather_score: gathered fp32 inner products,
//   out[b, w] = q[b] . items[max(ids[b, w], 0)]   (the caller masks -1 ids).
//
// Replaces the TPU kernel _gather_score_kernel_rowwise (src/repro/kernels/
// gather_score/kernel.py:34, launched by gather_score_pallas :39 behind
// ops.py:19; the blocked _gather_score_kernel :26 is never launched).  The
// semantics are similarity.gather_scores': ids are clamped to >= 0, as the
// JAX wrapper does, and must be < N.  The port's walk scores its f32 seeds
// and the int8 walk's exact fp32 rerank with it, so the [B, W, d] gather of
// the plain version never materializes.
//
// What bounds it on the H100: bytes.  Per (b, w) it reads one id and one row
// of 4*d bytes and writes one score: B*W*(4*d + 8) + 4*B*d bytes, for 2*d
// flops per row.  The rows are random gathers.
//
// Design: one block per query; the query sits in shared memory; one warp per
// (b, w) output loads the row as float4 (d % 4 == 0) or floats and reduces
// with shuffles: repro::row_score, the scorer of beam_step_f32.
#include <cuda_runtime.h>

#include "select.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) gather_score_kernel(
    const float* __restrict__ queries, const float* __restrict__ items,
    const int* __restrict__ ids, int W, int d, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* q_sh = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    q_sh[c] = queries[static_cast<size_t>(b) * d + c];
  }
  __syncthreads();
  for (int w = warp; w < W; w += nwarps) {
    const int id = max(ids[static_cast<size_t>(b) * W + w], 0);
    const float s = repro::row_score(q_sh, items, nullptr, id, d, lane);
    if (lane == 0) out[static_cast<size_t>(b) * W + w] = s;
  }
}

}  // namespace

extern "C" int gather_score_f32(const float* queries, const float* items, const int* ids,
                                int B, int W, int d, float* out, void* stream) {
  const size_t smem = sizeof(float) * ((d + 3) & ~3);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(gather_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  gather_score_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      queries, items, ids, W, d, out);
  return static_cast<int>(cudaGetLastError());
}
