// quant_score: gathered scores of the int8 item store,
//   out[b, w] = (q[b] . codes[ids[b, w]]) * scales[ids[b, w]],  -1 ids -> -inf.
//
// Replaces the TPU kernel _quant_score_kernel (src/repro/kernels/quant_score/
// kernel.py:23, launched by quant_score_pallas :31 behind ops.py:21).  The
// semantics are quant_score_ref's (quant_score/ref.py:19): an fp32 dot over
// the cast codes, then one multiply by the row's scale.  The port's int8
// walk seeds with it, so seeds and beam_walk_i8 share one scorer,
// repro::row_score (select.cuh).
//
// What bounds it on the H100: bytes -- each distinct code row of d bytes and
// its scale read once, plus the ids, the queries and the scores: about 9 MB
// at the int8 seed shape (256 x 160 x 300), 0.0026 ms at the H100 SXM's
// 3.35 TB/s (data sheet, 700 W), for 2*d flops a row.  The rows are random gathers of 300 bytes, so the time is
// set by the trips to memory a warp waits on, not by the bytes.
//
// Design: gather_score's (csrc/gather_score.cu).  A warp scores a tile of
// kRows consecutive (b, w) slots of one query with no block barrier: one
// load of the tile's ids, then every code row's char4 loads, the kRows
// scales and the query's chunks in flight together before the first FMA
// (repro::score_rows); the kRows shuffle trees run interleaved and each sum
// is multiplied by its scale once, so a score equals row_score's bit for
// bit.  A -1 id writes -inf and loads nothing.  The grid is (query, tile of
// kWarps * kRows slots).  Ids must be < N.  It holds ~92 registers, so 20
// warps an SM: at the seed shape ~4 waves of two dependent trips each,
// which set its time (PERF.md).
//
// quant_score_rowwise_i8 keeps the previous kernel (a block a query, a warp
// a row, one row after another): the witness the new kernel is held and
// timed against.  No wrapper or system path launches it.
#include <cuda_runtime.h>

#include "select.cuh"

namespace {

constexpr int kWarps = 4;  // tiles a block
constexpr int kRows = 4;   // rows a warp keeps in flight
constexpr int kVec = 3;    // char4 loads a lane a row a round: d <= 384 in one round
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 5;  // blocks an SM the registers are budgeted for: <= 96 a thread

template <bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks) quant_score_kernel(
    const float* __restrict__ queries, const signed char* __restrict__ codes,
    const float* __restrict__ scales, const int* __restrict__ ids, int W, int d,
    float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = (W + kWarps * kRows - 1) / (kWarps * kRows);
  const int b = blockIdx.x / tiles;
  const int w0 = (blockIdx.x % tiles) * (kWarps * kRows) + warp * kRows;
  const int n = min(kRows, W - w0);  // the tile's slots; <= 0: a masked tile
  if (n <= 0) return;
  const size_t base = static_cast<size_t>(b) * W + w0;
  const int mine = lane < n ? ids[base + lane] : -1;
  const float* q = queries + static_cast<size_t>(b) * d;
  int id[kRows];
  bool ok[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    id[r] = __shfl_sync(repro::kFullMask, mine, r);
    ok[r] = r < n && id[r] >= 0;
  }
  float s[kRows];
  if (VEC) {
    repro::score_rows<kRows, kVec>(q, codes, scales, d, lane, id, ok, s);
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      s[r] = ok[r] ? repro::row_score(q, codes, scales, id[r], d, lane) : -INFINITY;
    }
  }
  float mine_s = s[0];
#pragma unroll
  for (int r = 1; r < kRows; ++r) mine_s = lane == r ? s[r] : mine_s;
  if (lane < n) out[base + lane] = mine_s;
}

constexpr int kRowwiseThreads = 256;

__global__ void __launch_bounds__(kRowwiseThreads) quant_score_rowwise_kernel(
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

// queries [B, d] 16-byte aligned where d % 4 == 0.
extern "C" int quant_score_i8(const float* queries, const signed char* codes,
                              const float* scales, const int* ids, int B, int W, int d,
                              float* out, void* stream) {
  const dim3 grid(B * ((W + kWarps * kRows - 1) / (kWarps * kRows)));
  const auto s = static_cast<cudaStream_t>(stream);
  if ((d & 3) == 0) {
    quant_score_kernel<true><<<grid, kThreads, 0, s>>>(queries, codes, scales, ids, W, d, out);
  } else {
    quant_score_kernel<false><<<grid, kThreads, 0, s>>>(queries, codes, scales, ids, W, d, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int quant_score_rowwise_i8(const float* queries, const signed char* codes,
                                      const float* scales, const int* ids, int B, int W, int d,
                                      float* out, void* stream) {
  const size_t smem = sizeof(float) * ((d + 3) & ~3);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(quant_score_rowwise_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  }
  quant_score_rowwise_kernel<<<B, kRowwiseThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      queries, codes, scales, ids, W, d, out);
  return static_cast<int>(cudaGetLastError());
}
