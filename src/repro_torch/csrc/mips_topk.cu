// mips_topk: exact maximum-inner-product search with a streaming top-k, over
// fp32 items (mips_topk_f32) or the int8 store (mips_topk_i8).
//
// Replaces the TPU kernel _mips_topk_kernel + _select_topk (src/repro/
// kernels/mips_topk/kernel.py:32-88, launched by mips_topk_pallas :91 and by
// the second pallas_call that mips_topk/ops.py:22 builds around the same
// body).  It returns top_k(q @ items^T) per query by score descending, then
// item id ascending: lax.top_k's order.
//
// What bounds it on the H100: operations.  2*B*N*d fp32 FMAs against one
// read of the N*d item matrix -- at B = 256 that is 128 flops per item byte,
// far past the card's fp32 balance point (67 TFLOP/s over 3.35 TB/s = 20).
// This slice uses fp32 FMAs only: TF32 tensor cores would change the ids.
//
// Design: the TPU's sequential grid carried the top-k accumulator across
// item tiles; blocks on the card run in no order, so the work is split in
// two passes.  The ranking is lax.top_k's: +0.0 above -0.0.
//   Pass 1: one block per (64-query tile x item chunk).  It walks its chunk
//   in 64-item tiles: a shared-memory tiled product over d in steps of 16,
//   each thread holding a 4x4 register tile of scores; then one warp per
//   query row keeps that query's top k for the chunk in shared memory,
//   inserting only the (ballot-selected) scores that beat its current k-th.
//   Pass 2: one block per query merges the chunk lists, ranking every
//   candidate by counting under (score desc, id asc).
//   int8 store (kernel.py:69-75): pass 1 casts the code tile to float as it
//   fills shared memory and multiplies each finished score by its column's
//   scale once, before the top-k insert -- the (q . codes) * scale order of
//   quant_score/ref.py.  It streams d bytes per item instead of 4*d.  Pass 2
//   is the same.
#include <cuda_runtime.h>

#include "select.cuh"

namespace {

constexpr int kBQ = 64;  // queries per tile
constexpr int kBN = 64;  // items per tile
constexpr int kBK = 16;  // depth per shared-memory step
constexpr int kThreads = 256;

__device__ __forceinline__ void topk_insert(float* ls, int* li, int k, float s, int id) {
  if (!repro::precedes_total(s, id, ls[k - 1], li[k - 1])) return;
  int p = k - 1;
  while (p > 0 && repro::precedes_total(s, id, ls[p - 1], li[p - 1])) {
    ls[p] = ls[p - 1];
    li[p] = li[p - 1];
    --p;
  }
  ls[p] = s;
  li[p] = id;
}

// Row is float (fp32 items; scales unused) or signed char (int8 codes).
template <typename Row>
__global__ void __launch_bounds__(kThreads) mips_topk_chunk_kernel(
    const float* __restrict__ q, const Row* __restrict__ x, const float* __restrict__ scales,
    int B, int N, int d, int k, int chunk, float* __restrict__ part_s,
    int* __restrict__ part_i) {
  __shared__ float qs[kBK][kBQ + 1];
  __shared__ float xs[kBK][kBN + 1];
  __shared__ float S[kBQ][kBN + 1];
  extern __shared__ float dyn[];
  float* top_s = dyn;                                   // [kBQ * k]
  int* top_i = reinterpret_cast<int*>(dyn + kBQ * k);   // [kBQ * k]

  const int c = blockIdx.x, nchunks = gridDim.x;
  const int q0 = blockIdx.y * kBQ;
  const int n_begin = c * chunk;
  const int n_end = min(N, n_begin + chunk);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid & 31, warp = tid >> 5, nwarps = kThreads / 32;

  for (int e = tid; e < kBQ * k; e += kThreads) {
    top_s[e] = -INFINITY;
    top_i[e] = -1;
  }

  for (int n0 = n_begin; n0 < n_end; n0 += kBN) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < d; k0 += kBK) {
      for (int e = tid; e < kBQ * kBK; e += kThreads) {
        const int r = e / kBK, kk = e % kBK;
        const int gq = q0 + r, gk = k0 + kk;
        qs[kk][r] = (gq < B && gk < d) ? q[static_cast<size_t>(gq) * d + gk] : 0.f;
      }
      for (int e = tid; e < kBN * kBK; e += kThreads) {
        const int r = e / kBK, kk = e % kBK;
        const int gn = n0 + r, gk = k0 + kk;
        xs[kk][r] =
            (gn < n_end && gk < d) ? static_cast<float>(x[static_cast<size_t>(gn) * d + gk]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = xs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      const float scale = (scales != nullptr && col < n_end) ? scales[col] : 1.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = acc[i][j];
        if (scales != nullptr) s *= scale;
        S[ty + 16 * i][tx + 16 * j] = col < n_end ? s : -INFINITY;
      }
    }
    __syncthreads();

    for (int r = warp; r < kBQ; r += nwarps) {
      if (q0 + r >= B) break;
      float* ls = top_s + r * k;
      int* li = top_i + r * k;
      for (int half = 0; half < kBN; half += 32) {
        const float s = S[r][half + lane];
        const int id = n0 + half + lane;
        unsigned mask =
            __ballot_sync(repro::kFullMask, repro::precedes_total(s, id, ls[k - 1], li[k - 1]));
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const float sv = __shfl_sync(repro::kFullMask, s, src);
          const int iv = __shfl_sync(repro::kFullMask, id, src);
          if (lane == 0) topk_insert(ls, li, k, sv, iv);
          __syncwarp();
        }
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < kBQ * k; e += kThreads) {
    const int r = e / k;
    if (q0 + r < B) {
      const size_t o = (static_cast<size_t>(q0 + r) * nchunks + c) * k + e % k;
      part_s[o] = top_s[e];
      part_i[o] = top_i[e];
    }
  }
}

// Pass 2: rank the nchunks*k candidates of one query by (score desc, id asc);
// empty entries (-inf, -1) of short chunks rank last, in position order.
__global__ void __launch_bounds__(kThreads) mips_topk_merge_kernel(
    const float* __restrict__ part_s, const int* __restrict__ part_i, int C, int k,
    float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ float dyn[];
  float* cs = dyn;
  int* ci = reinterpret_cast<int*>(dyn + C);
  const int b = blockIdx.x;
  for (int e = threadIdx.x; e < C; e += blockDim.x) {
    cs[e] = part_s[static_cast<size_t>(b) * C + e];
    ci[e] = part_i[static_cast<size_t>(b) * C + e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    const float si = cs[i];
    const int idi = ci[i];
    int r = 0;
    for (int j = 0; j < C; ++j) {
      r += repro::precedes_total(cs[j], ci[j], si, idi) ||
           (cs[j] == si && ci[j] == idi && j < i);
    }
    if (r < k) {
      out_s[static_cast<size_t>(b) * k + r] = si;
      out_i[static_cast<size_t>(b) * k + r] = idi;
    }
  }
}

template <typename Row>
int launch(const float* q, const Row* x, const float* scales, int B, int N, int d, int k,
           int nchunks, int chunk, float* part_s, int* part_i, float* out_s, int* out_i,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nchunks, (B + kBQ - 1) / kBQ);
  mips_topk_chunk_kernel<Row><<<grid, kThreads, sizeof(float) * 2 * kBQ * k, s>>>(
      q, x, scales, B, N, d, k, chunk, part_s, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int C = nchunks * k;
  mips_topk_merge_kernel<<<B, kThreads, sizeof(float) * 2 * C, s>>>(part_s, part_i, C, k,
                                                                     out_s, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mips_topk_f32(const float* q, const float* x, int B, int N, int d, int k,
                             int nchunks, int chunk, float* part_s, int* part_i, float* out_s,
                             int* out_i, void* stream) {
  return launch(q, x, static_cast<const float*>(nullptr), B, N, d, k, nchunks, chunk, part_s,
                part_i, out_s, out_i, stream);
}

extern "C" int mips_topk_i8(const float* q, const signed char* codes, const float* scales,
                            int B, int N, int d, int k, int nchunks, int chunk, float* part_s,
                            int* part_i, float* out_s, int* out_i, void* stream) {
  return launch(q, codes, scales, B, N, d, k, nchunks, chunk, part_s, part_i, out_s, out_i,
                stream);
}
