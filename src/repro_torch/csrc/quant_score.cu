// quant_score: gathered scores of the int8 item store,
//   out[b, w] = (q[b] . codes[ids[b, w]]) * scales[ids[b, w]],  -1 ids -> -inf.
//
// Replaces the TPU kernel _quant_score_kernel (src/repro/kernels/quant_score/
// kernel.py:23, launched by quant_score_pallas :31 behind ops.py:21).  The
// semantics are quant_score_ref's (quant_score/ref.py:19): an fp32 dot over
// the cast codes, then one multiply by the row's scale.  The port's int8
// walk seeds with it, so seeds and beam_step_i8 share one scorer,
// repro::row_score (select.cuh).
//
// What bounds it on the H100: bytes.  Per (b, w) it reads one id, one code
// row of d bytes and one scale, and writes one score: B*W*(d + 12) + 4*B*d
// bytes, about 13 MB at the int8 seed shape (256 x 160 x 300), for 2*d flops
// per row -- far below the card's flop rate.  The rows are random gathers.
//
// Design: one block per query; the query sits in shared memory; one warp per
// (b, w) output loads the code row as char4 (d % 4 == 0) or bytes, casts to
// float, FMAs, reduces with shuffles and multiplies by the scale once.  A -1
// id writes -inf without reading a row.  Ids must be < N.
#include <cuda_runtime.h>

#include "select.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) quant_score_kernel(
    const float* __restrict__ queries, const signed char* __restrict__ codes,
    const float* __restrict__ scales, const int* __restrict__ ids, int W, int d,
    float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* q_sh = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    q_sh[c] = queries[static_cast<size_t>(b) * d + c];
  }
  __syncthreads();
  for (int w = warp; w < W; w += nwarps) {
    const int id = ids[static_cast<size_t>(b) * W + w];
    float s = -INFINITY;
    if (id >= 0) s = repro::row_score(q_sh, codes, scales, id, d, lane);
    if (lane == 0) out[static_cast<size_t>(b) * W + w] = s;
  }
}

}  // namespace

extern "C" int quant_score_i8(const float* queries, const signed char* codes,
                              const float* scales, const int* ids, int B, int W, int d,
                              float* out, void* stream) {
  const size_t smem = sizeof(float) * ((d + 3) & ~3);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(quant_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  quant_score_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      queries, codes, scales, ids, W, d, out);
  return static_cast<int>(cudaGetLastError());
}
