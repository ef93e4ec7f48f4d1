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
// What bounds it on the H100: bytes -- each distinct row of 4*d bytes read
// once, plus the ids, the queries and the scores: about 32 MB at the seed
// shape (256 x 160 x 300, a fifth of the ids on 64 hub rows), 0.0097 ms at
// the H100 SXM's 3.35 TB/s (data sheet, 700 W), for 2*d flops a row.  The rows are random gathers, so what
// the card reaches is set by the dependent trips to memory a warp waits on
// and how many warps wait at once.
//
// Design: a warp scores a tile of kRows consecutive (b, w) slots of one
// query, with no block barrier.  Its lanes read the tile's ids in one load,
// then issue every load of the kRows rows and of the query's chunks before
// the first FMA (repro::score_rows), so a warp waits on two trips to memory
// (ids, then rows), not two a row.  A block is kWarps such tiles of one
// query (its warps share the query row in L1); the grid is (query, tile of
// kWarps * kRows slots), so narrow launches ([B, 1] seeds) and ragged edges
// are masked slots and warps that exit at once.  Each row's arithmetic is
// repro::row_score's -- the lane partition, the FMA order and the shuffle
// tree -- so a score equals gather_score_rowwise_f32's (below) and
// beam_walk's bit for bit.  d % 4 != 0 scores the tile's rows one after
// another with row_score's scalar loads.  The vector path's registers are
// budgeted for kMinBlocks blocks an SM, the most that does not spill.
// PERF.md gives what this grid and budget measured on the H100 against the
// other choices (rows in flight, warps a block, budgets, a persistent grid).
//
// gather_score_rowwise_f32 keeps the previous kernel, a block a query and a
// warp a row, each row's id, loads and shuffle tree one after another: the
// witness the new kernel is held and timed against.  No wrapper or system
// path launches it.
#include <cuda_runtime.h>

#include "select.cuh"

namespace {

constexpr int kWarps = 4;  // tiles a block
constexpr int kRows = 4;   // rows a warp keeps in flight
constexpr int kVec = 3;    // 16-byte loads a lane a row a round: d <= 384 in one round
constexpr int kThreads = 32 * kWarps;
// blocks an SM the vector path's registers are budgeted for: <= 80 a thread
// (the scalar path, d % 4 != 0, spills under that budget and keeps none)
constexpr int kMinBlocks = 6;

template <bool VEC>
__global__ void __launch_bounds__(kThreads, VEC ? kMinBlocks : 1) gather_score_kernel(
    const float* __restrict__ queries, const float* __restrict__ items,
    const int* __restrict__ ids, int W, int d, float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = (W + kWarps * kRows - 1) / (kWarps * kRows);
  const int b = blockIdx.x / tiles;
  const int w0 = (blockIdx.x % tiles) * (kWarps * kRows) + warp * kRows;
  const int n = min(kRows, W - w0);  // the tile's slots; <= 0: a masked tile
  if (n <= 0) return;
  const size_t base = static_cast<size_t>(b) * W + w0;
  const int mine = lane < n ? ids[base + lane] : 0;
  const float* q = queries + static_cast<size_t>(b) * d;
  int id[kRows];
  bool ok[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    id[r] = max(__shfl_sync(repro::kFullMask, mine, r), 0);
    ok[r] = r < n;
  }
  float s[kRows];
  if (VEC) {
    repro::score_rows<kRows, kVec>(q, items, nullptr, d, lane, id, ok, s);
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      s[r] = ok[r] ? repro::row_score(q, items, nullptr, id[r], d, lane) : 0.f;
    }
  }
  float mine_s = s[0];
#pragma unroll
  for (int r = 1; r < kRows; ++r) mine_s = lane == r ? s[r] : mine_s;
  if (lane < n) out[base + lane] = mine_s;
}

constexpr int kRowwiseThreads = 256;

__global__ void __launch_bounds__(kRowwiseThreads) gather_score_rowwise_kernel(
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

// queries [B, d] and items [N, d] 16-byte aligned where d % 4 == 0.
extern "C" int gather_score_f32(const float* queries, const float* items, const int* ids,
                                int B, int W, int d, float* out, void* stream) {
  const dim3 grid(B * ((W + kWarps * kRows - 1) / (kWarps * kRows)));
  const auto s = static_cast<cudaStream_t>(stream);
  if ((d & 3) == 0) {
    gather_score_kernel<true><<<grid, kThreads, 0, s>>>(queries, items, ids, W, d, out);
  } else {
    gather_score_kernel<false><<<grid, kThreads, 0, s>>>(queries, items, ids, W, d, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_score_rowwise_f32(const float* queries, const float* items,
                                        const int* ids, int B, int W, int d, float* out,
                                        void* stream) {
  const size_t smem = sizeof(float) * ((d + 3) & ~3);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(gather_score_rowwise_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  }
  gather_score_rowwise_kernel<<<B, kRowwiseThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      queries, items, ids, W, d, out);
  return static_cast<int>(cudaGetLastError());
}
