// mips_topk: exact maximum-inner-product search with a streaming top-k, over
// fp32 items (mips_topk_f32) or the int8 store (mips_topk_i8).
//
// Replaces the TPU kernel _mips_topk_kernel + _select_topk (src/repro/
// kernels/mips_topk/kernel.py:32-88, launched by mips_topk_pallas :91 and by
// the second pallas_call that mips_topk/ops.py:22 builds around the same
// body).  It returns top_k(q @ items^T) per query by score descending, then
// item id ascending: lax.top_k's order, +0.0 above -0.0.
//
// What bounds it on the H100: operations.  2*B*N*d fp32 FMAs against one
// read of the N*d item matrix -- at B = 256 that is 128 flops per item byte,
// far past the card's fp32 balance point (67 TFLOP/s over 3.35 TB/s = 20).
// The scores are exact fp32 FMAs: they are the ground truth of every recall
// number, and TF32 tensor cores (or a 3xTF32 split) would change scores and
// ids.  So the kernel is a register-tiled fp32 product whose pace must be
// set by the FMA units, not by the top-k.  With an 8 x 8 tile a thread, an
// SM's shared memory (one 128-byte wavefront a clock; a warp's four float4
// loads of a depth step are 16 wavefronts) and its FMA lanes (four warp
// FMAs a clock; 64 a depth step) are loaded alike, which holds the scan
// near half the fp32 peak; a larger tile a thread ran out of registers.
//
// Design: the TPU's sequential grid carried the top-k accumulator across
// item tiles; blocks on the card run in no order, so the work is split in
// two passes.
//   Pass 1: one block of 256 threads per (128-query tile x item chunk).  It
//   walks its chunk in 128-item tiles.  Each thread holds an 8 x 8 register
//   tile of scores (queries 4 ty + {0..3} and 64 + 4 ty + {0..3}, items
//   likewise from tx), so one depth step costs 4 float4 shared loads for 64
//   FMAs.  q and x (both d-contiguous) are read in slices of 16 columns with
//   16-byte loads into registers while the previous slice is multiplied, and
//   stored transposed into the other of two padded shared stages; the
//   ragged depth, N and B are zero-filled there, never branched on in the
//   FMA loop.  Epilogue, with no score matrix in shared memory: the 16
//   threads of a half-warp hold all 128 scores of 8 queries, and each query's
//   top k lives in shared memory, owned by that half-warp.  Each thread tests
//   its scores against the query's current k-th entry (in a chunk's first
//   tile, against a bound from the lanes' best scores instead of the empty
//   list); when some beat it (after the first tiles, rarely) the half-warp
//   packs them by a prefix sum and merges them with the list by counting
//   ranks, 16 lanes at a time.
//   Pass 2: one block per query merges the chunk lists: a bound from the
//   lists' heads drops the candidates that cannot rank, and the few left are
//   ranked by counting under (score desc, id asc).
//   int8 store (kernel.py:69-75): pass 1 casts the codes to float as they
//   fill shared memory (d bytes a row streamed instead of 4*d) and multiplies
//   each finished score by its column's scale once, before the top-k test --
//   the (q . codes) * scale order of quant_score/ref.py.  Pass 2 is the same.
//
// k > 32 (mips_topk_select_*): the lists no longer fit beside the tiles, so
// pass 1 runs the same product with an epilogue that writes every score
// into a [rows, N] scratch (queries in chunks of rows, so the scratch stays
// bounded), and one block per query selects its top k from the row: a radix
// select, 8 bits at a time from the top, on the 64-bit key (order_key of the
// score, then the complement of the id) -- a strict total order, lax.top_k's
// with ties to the lower id -- finds the k-th key; the keys at or above it
// are gathered and sorted (bitonic, in shared memory) into the output.  A k
// beyond one sort's 4,096 keys takes several rounds, each below the last
// round's smallest key.  The bytes bound it: one write and about four reads
// of the scratch beside the product.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "select.cuh"

namespace {

constexpr int kBQ = 128;           // queries per tile
constexpr int kBN = 128;           // items per tile
constexpr int kBK = 16;            // depth per shared stage
constexpr int kLd = kBQ + 4;       // padded stage row (floats); rows stay 16-byte aligned
constexpr int kThreads = 256;      // 16 x 16 threads, 8 x 8 scores each
constexpr int kEmptyId = INT_MAX;  // an empty list slot: ranks after every real score
constexpr int kMaxK = 32;

// Four consecutive columns [c, c + 4) of row ``row`` as floats, zero past the
// end of the matrix (rows >= rows_end) or of the row (c >= d).  VEC: d is a
// multiple of 4 and rows start 16-byte (fp32) / 4-byte (int8) aligned.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ m, int row, int rows_end,
                                        int c, int d) {
  if (row >= rows_end) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = m + static_cast<size_t>(row) * d + c;
  if (VEC) return c < d ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(c < d ? __ldg(p) : 0.f, c + 1 < d ? __ldg(p + 1) : 0.f,
                     c + 2 < d ? __ldg(p + 2) : 0.f, c + 3 < d ? __ldg(p + 3) : 0.f);
}

template <bool VEC>
__device__ __forceinline__ float4 load4(const signed char* __restrict__ m, int row,
                                        int rows_end, int c, int d) {
  if (row >= rows_end) return make_float4(0.f, 0.f, 0.f, 0.f);
  const signed char* p = m + static_cast<size_t>(row) * d + c;
  if (VEC) {
    if (c >= d) return make_float4(0.f, 0.f, 0.f, 0.f);
    const char4 v = __ldg(reinterpret_cast<const char4*>(p));
    return make_float4(v.x, v.y, v.z, v.w);
  }
  return make_float4(c < d ? __ldg(p) : 0.f, c + 1 < d ? __ldg(p + 1) : 0.f,
                     c + 2 < d ? __ldg(p + 2) : 0.f, c + 3 < d ? __ldg(p + 3) : 0.f);
}

__device__ __forceinline__ void store_t(float (*st)[kLd], int r, int c, float4 v) {
  st[c][r] = v.x;
  st[c + 1][r] = v.y;
  st[c + 2][r] = v.z;
  st[c + 3][r] = v.w;
}

// Merges the c candidates (cs, ci), distinct and not in the list, into one
// query's sorted top-k list (ls, li), by the 16 lanes of a half-warp.  A list
// entry moves down by the candidates before it; a candidate lands after the
// list entries before it (a binary search) and the candidates before it.
// The k first land in (ns, ni), then the list takes them.
__device__ __noinline__ void merge_into_list(float* ls, int* li, const float* cs, const int* ci,
                                             int c, int k, int hl, unsigned hmask, float* ns,
                                             int* ni) {
  for (int p = hl; p < k; p += 16) {
    const float s = ls[p];
    const int id = li[p];
    int r = p;
#pragma unroll 4
    for (int y = 0; y < c; ++y) r += repro::precedes_total(cs[y], ci[y], s, id);
    if (r < k) {
      ns[r] = s;
      ni[r] = id;
    }
  }
  for (int x = hl; x < c; x += 16) {
    const float s = cs[x];
    const int id = ci[x];
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (repro::precedes_total(ls[mid], li[mid], s, id)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int r = lo;
#pragma unroll 4
    for (int y = 0; y < c; ++y) r += repro::precedes_total(cs[y], ci[y], s, id);
    if (r < k) {
      ns[r] = s;
      ni[r] = id;
    }
  }
  __syncwarp(hmask);
  for (int x = hl; x < k; x += 16) {
    ls[x] = ns[x];
    li[x] = ni[x];
  }
  __syncwarp(hmask);
}

// A bound for a query's first full tile, whose list is still empty: the
// k-th entry, in precedes_total order, of the best two entries of each of
// the half-warp's 16 lanes (k <= 32).  k distinct entries of the tile come
// before it or are it, so no entry after it can reach the top k; on random
// scores a small share of the tile passes it instead of all of it.
__device__ __forceinline__ void lane_best_bound(const float (&sc)[8], const int (&ids)[8], int k,
                                                unsigned hmask, float* bound_s, int* bound_i) {
  float s1 = -INFINITY, s2 = -INFINITY;
  int i1 = kEmptyId, i2 = kEmptyId;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (repro::precedes_total(sc[j], ids[j], s1, i1)) {
      s2 = s1;
      i2 = i1;
      s1 = sc[j];
      i1 = ids[j];
    } else if (repro::precedes_total(sc[j], ids[j], s2, i2)) {
      s2 = sc[j];
      i2 = ids[j];
    }
  }
  int r1 = 0, r2 = 0;
#pragma unroll
  for (int src = 0; src < 16; ++src) {
    const float o1 = __shfl_sync(hmask, s1, src, 16), o2 = __shfl_sync(hmask, s2, src, 16);
    const int j1 = __shfl_sync(hmask, i1, src, 16), j2 = __shfl_sync(hmask, i2, src, 16);
    r1 += repro::precedes_total(o1, j1, s1, i1) + repro::precedes_total(o2, j2, s1, i1);
    r2 += repro::precedes_total(o1, j1, s2, i2) + repro::precedes_total(o2, j2, s2, i2);
  }
  // the ranks are distinct: exactly one of the 32 entries has rank k - 1
  const bool has1 = r1 == k - 1;
  const unsigned who = __ballot_sync(hmask, has1 || r2 == k - 1);
  const int src = (__ffs(who) - 1) & 15;
  *bound_s = __shfl_sync(hmask, has1 ? s1 : s2, src, 16);
  *bound_i = __shfl_sync(hmask, has1 ? i1 : i2, src, 16);
}

// Row is float (fp32 items; scales unused) or signed char (int8 codes).
// SCORES: the k > 32 route -- part_s is the [B, N] score scratch, and the
// epilogue writes every score there instead of keeping top-k lists.
template <typename Row, bool VEC, bool SCORES>
__global__ void __launch_bounds__(kThreads, 2) mips_topk_chunk_kernel(
    const float* __restrict__ q, const Row* __restrict__ x, const float* __restrict__ scales,
    int B, int N, int d, int k, int chunk, float* __restrict__ part_s,
    int* __restrict__ part_i) {
  __shared__ __align__(16) float qs[2][kBK][kLd];
  __shared__ __align__(16) float xs[2][kBK][kLd];
  extern __shared__ float dyn[];
  float* top_s = dyn;                                      // [kBQ][k]
  int* top_i = reinterpret_cast<int*>(top_s + kBQ * k);    // [kBQ][k]
  float* cand_s = reinterpret_cast<float*>(top_i + kBQ * k);  // [16 half-warps][kBN]
  int* cand_i = reinterpret_cast<int*>(cand_s + 16 * kBN);
  float* new_s = reinterpret_cast<float*>(cand_i + 16 * kBN);  // [16][kMaxK]
  int* new_i = reinterpret_cast<int*>(new_s + 16 * kMaxK);

  const int c = blockIdx.x, nchunks = gridDim.x;
  const int q0 = blockIdx.y * kBQ;
  const int n_begin = c * chunk;
  const int n_end = min(N, n_begin + chunk);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const unsigned hmask = 0xffffu << (tid & 16);
  // loader: thread -> row lr of the tile, 4-column groups lg and lg + 2
  const int lr = tid & (kBQ - 1), lg = tid >> 7;

  if (!SCORES) {
    for (int e = tid; e < kBQ * k; e += kThreads) {
      top_s[e] = -INFINITY;
      top_i[e] = kEmptyId;
    }
  }

  const int nslices = (d + kBK - 1) / kBK;
  for (int n0 = n_begin; n0 < n_end; n0 += kBN) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    float4 qa[2], xa[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qa[h] = load4<VEC>(q, q0 + lr, B, 4 * (lg + 2 * h), d);
      xa[h] = load4<VEC>(x, n0 + lr, n_end, 4 * (lg + 2 * h), d);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the last slice of the previous tile is read
      store_t(qs[0], lr, 4 * (lg + 2 * h), qa[h]);
      store_t(xs[0], lr, 4 * (lg + 2 * h), xa[h]);
    }
    __syncthreads();

    for (int ks = 0; ks < nslices; ++ks) {
      const int cur = ks & 1;
      const bool more = ks + 1 < nslices;
      if (more) {  // the next slice's loads fly while this one is multiplied
        const int k0 = (ks + 1) * kBK;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          qa[h] = load4<VEC>(q, q0 + lr, B, k0 + 4 * (lg + 2 * h), d);
          xa[h] = load4<VEC>(x, n0 + lr, n_end, k0 + 4 * (lg + 2 * h), d);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&qs[cur][kk][4 * ty]);
        const float4 a1 = *reinterpret_cast<const float4*>(&qs[cur][kk][64 + 4 * ty]);
        const float4 b0 = *reinterpret_cast<const float4*>(&xs[cur][kk][4 * tx]);
        const float4 b1 = *reinterpret_cast<const float4*>(&xs[cur][kk][64 + 4 * tx]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (more) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          store_t(qs[cur ^ 1], lr, 4 * (lg + 2 * h), qa[h]);
          store_t(xs[cur ^ 1], lr, 4 * (lg + 2 * h), xa[h]);
        }
      }
      __syncthreads();
    }

    // epilogue: the half-warp ty holds every score of its 8 queries
    const bool full_tile = n_end - n0 >= kBN;
    int ids[8];
    float scale[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ids[j] = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      scale[j] = (scales != nullptr && ids[j] < n_end) ? __ldg(scales + ids[j]) : 1.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4;
      if (q0 + row >= B) continue;
      if (SCORES) {
        float* out = part_s + static_cast<size_t>(q0 + row) * N;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (ids[j] < n_end) {
            out[ids[j]] = scales != nullptr ? acc[i][j] * scale[j] : acc[i][j];
          }
        }
        continue;
      }
      float* ls = top_s + row * k;
      int* li = top_i + row * k;
      float sc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[j] = scales != nullptr ? acc[i][j] * scale[j] : acc[i][j];
      // an entry is a candidate if it comes before the list's k-th, or, while
      // the list is empty and the tile full, if it is or comes before the
      // lanes' bound
      float ts = ls[k - 1];
      int ti = li[k - 1];
      const bool bounded = ti == kEmptyId && full_tile;
      if (bounded) lane_best_bound(sc, ids, k, hmask, &ts, &ti);
      unsigned mine = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (ids[j] < n_end && (repro::precedes_total(sc[j], ids[j], ts, ti) ||
                               (bounded && ids[j] == ti))) {
          mine |= 1u << j;
        }
      }
      if (!__any_sync(hmask, mine != 0)) continue;
      const int cnt = __popc(mine);
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) {
        const int y = __shfl_up_sync(hmask, incl, o, 16);
        if (tx >= o) incl += y;
      }
      const int total = __shfl_sync(hmask, incl, 15, 16);
      float* cs = cand_s + ty * kBN;
      int* ci = cand_i + ty * kBN;
      int pos = incl - cnt;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (mine & (1u << j)) {
          cs[pos] = sc[j];
          ci[pos] = ids[j];
          ++pos;
        }
      }
      __syncwarp(hmask);
      merge_into_list(ls, li, cs, ci, total, k, tx, hmask, new_s + ty * kMaxK,
                      new_i + ty * kMaxK);
    }
  }
  if (SCORES) return;
  __syncthreads();

  for (int e = tid; e < kBQ * k; e += kThreads) {
    const int r = e / k;
    if (q0 + r < B) {
      const size_t o = (static_cast<size_t>(q0 + r) * nchunks + c) * k + e % k;
      part_s[o] = top_s[e];
      part_i[o] = top_i[e];
    }
  }
}

// Pass 2: the top k of one query's nchunks lists of k, each sorted.  The
// k-th best of the lists' first ceil(k / nchunks) entries bounds the answer
// (k entries come before it or are it); only the entries up to it are
// ranked, by counting under (score desc, id asc), empty entries (-inf,
// kEmptyId) of short chunks last, in position order.
__device__ __forceinline__ bool before(const float* cs, const int* ci, int a, int b) {
  const int ka = repro::order_key(cs[a]), kb = repro::order_key(cs[b]);
  return ka > kb || (ka == kb && (ci[a] < ci[b] || (ci[a] == ci[b] && a < b)));
}

__global__ void __launch_bounds__(kThreads) mips_topk_merge_kernel(
    const float* __restrict__ part_s, const int* __restrict__ part_i, int C, int k,
    float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ float dyn[];
  float* cs = dyn;
  int* ci = reinterpret_cast<int*>(dyn + C);
  int* keep = ci + C;  // positions of the entries up to the bound
  __shared__ int bound, kept;
  const int b = blockIdx.x, nchunks = C / k;
  const int m = (k + nchunks - 1) / nchunks;  // heads per list: nchunks * m >= k
  for (int e = threadIdx.x; e < C; e += blockDim.x) {
    cs[e] = part_s[static_cast<size_t>(b) * C + e];
    ci[e] = part_i[static_cast<size_t>(b) * C + e];
  }
  if (threadIdx.x == 0) kept = 0;
  __syncthreads();
  for (int h = threadIdx.x; h < nchunks * m; h += blockDim.x) {
    const int e = (h / m) * k + h % m;
    int r = 0;
    for (int g = 0; g < nchunks * m && r < k; ++g) r += before(cs, ci, (g / m) * k + g % m, e);
    if (r == k - 1) bound = e;  // ranks are distinct: one head has rank k - 1
  }
  __syncthreads();
  for (int e = threadIdx.x; e < C; e += blockDim.x) {
    if (!before(cs, ci, bound, e)) keep[atomicAdd(&kept, 1)] = e;
  }
  __syncthreads();
  for (int x = threadIdx.x; x < kept; x += blockDim.x) {
    const int e = keep[x];
    int r = 0;
    for (int y = 0; y < kept && r < k; ++y) r += before(cs, ci, keep[y], e);
    if (r < k) {
      out_s[static_cast<size_t>(b) * k + r] = cs[e];
      out_i[static_cast<size_t>(b) * k + r] = ci[e];
    }
  }
}

template <typename Row, bool VEC, bool SCORES = false>
cudaError_t launch_chunks(const float* q, const Row* x, const float* scales, int B, int N, int d,
                          int k, int nchunks, int chunk, float* part_s, int* part_i,
                          cudaStream_t s) {
  const size_t smem =
      SCORES ? 0 : sizeof(float) * (2 * kBQ * k + 2 * 16 * kBN + 2 * 16 * kMaxK);
  const cudaError_t attr = cudaFuncSetAttribute(
      mips_topk_chunk_kernel<Row, VEC, SCORES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(nchunks, (B + kBQ - 1) / kBQ);
  mips_topk_chunk_kernel<Row, VEC, SCORES><<<grid, kThreads, smem, s>>>(
      q, x, scales, B, N, d, k, chunk, part_s, part_i);
  return cudaGetLastError();
}

// 16-byte loads of q and fp32 rows (4-byte loads of int8 rows) need d % 4 ==
// 0 and aligned bases; anything else takes the scalar loads
template <typename Row>
bool vector_loads(const float* q, const Row* x, int d) {
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(x) % (sizeof(Row) == 4 ? 16 : 4) == 0;
}

template <typename Row>
int launch(const float* q, const Row* x, const float* scales, int B, int N, int d, int k,
           int nchunks, int chunk, float* part_s, int* part_i, float* out_s, int* out_i,
           void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = vector_loads(q, x, d);
  const cudaError_t err =
      vec ? launch_chunks<Row, true>(q, x, scales, B, N, d, k, nchunks, chunk, part_s, part_i, s)
          : launch_chunks<Row, false>(q, x, scales, B, N, d, k, nchunks, chunk, part_s, part_i, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int C = nchunks * k;
  const cudaError_t attr = cudaFuncSetAttribute(
      mips_topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(float) * 3 * C));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  mips_topk_merge_kernel<<<B, kThreads, sizeof(float) * 3 * C, s>>>(part_s, part_i, C, k,
                                                                     out_s, out_i);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------- k > 32: select from scores

constexpr int kSelThreads = 512;
constexpr int kSortMax = 4096;  // keys one round sorts in shared memory

// The strict total order of the output as one unsigned 64-bit key, larger
// first: order_key of the score (sign flipped to unsigned order), then the
// complement of the id (the lower id first).
__device__ __forceinline__ unsigned long long select_key(float s, int id) {
  const unsigned hi = static_cast<unsigned>(repro::order_key(s)) ^ 0x80000000u;
  return (static_cast<unsigned long long>(hi) << 32) | (0xffffffffu - static_cast<unsigned>(id));
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  const int ok = static_cast<int>(static_cast<unsigned>(key >> 32) ^ 0x80000000u);
  return __int_as_float(ok < 0 ? ok ^ 0x7fffffff : ok);
}

// One block per query row of ``scores`` ([rows, N]): its top k keys, in
// rounds of at most kSortMax.
__global__ void __launch_bounds__(kSelThreads) mips_topk_select_kernel(
    const float* __restrict__ scores, int N, int k, float* __restrict__ out_s,
    int* __restrict__ out_i) {
  __shared__ unsigned long long keys[kSortMax];
  __shared__ int hist[256];
  __shared__ int s_digit, s_need, s_done, s_count;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const float* row = scores + static_cast<size_t>(b) * N;
  unsigned long long bound = 0;  // round > 0: only keys below the last round's smallest
  for (int off = 0; off < k; off += kSortMax) {
    const int want = min(kSortMax, k - off);
    const bool bounded = off > 0;
    // radix select of the want-th largest key below the bound: after the
    // digit at shift ``shift`` the keys whose bits from ``shift`` up equal
    // ``prefix`` hold the want-th, ``need`` of them to take
    unsigned long long prefix = 0;
    int shift = 64, need = want;
    while (shift > 0) {
      shift -= 8;
      for (int i = tid; i < 256; i += kSelThreads) hist[i] = 0;
      __syncthreads();
      for (int e0 = 0; e0 < N; e0 += kSelThreads) {
        const int e = e0 + tid;
        int digit = 256;  // not counted
        if (e < N) {
          const unsigned long long key = select_key(row[e], e);
          const bool below = !bounded || key < bound;
          const bool match = shift == 56 || (key >> (shift + 8)) == (prefix >> (shift + 8));
          if (below && match) digit = static_cast<int>((key >> shift) & 255);
        }
        const unsigned peers = __match_any_sync(repro::kFullMask, digit);
        if (digit < 256 && lane == __ffs(peers) - 1) atomicAdd(hist + digit, __popc(peers));
      }
      __syncthreads();
      if (tid == 0) {
        int above = 0, dg = 255;
        while (above + hist[dg] < need) above += hist[dg--];
        s_digit = dg;
        s_need = need - above;
        s_done = hist[dg] == need - above;  // every key of this digit is taken
      }
      __syncthreads();
      prefix |= static_cast<unsigned long long>(s_digit) << shift;
      need = s_need;
      const bool done = s_done;
      __syncthreads();
      if (done) break;
    }
    // gather the keys at or above the threshold (exactly ``want`` of them)
    if (tid == 0) s_count = 0;
    __syncthreads();
    for (int e0 = 0; e0 < N; e0 += kSelThreads) {
      const int e = e0 + tid;
      bool take = false;
      unsigned long long key = 0;
      if (e < N) {
        key = select_key(row[e], e);
        take = (!bounded || key < bound) && (key >> shift) >= (prefix >> shift);
      }
      const unsigned who = __ballot_sync(repro::kFullMask, take);
      int base = 0;
      if (lane == 0 && who) base = atomicAdd(&s_count, __popc(who));
      base = __shfl_sync(repro::kFullMask, base, 0);
      if (take) keys[base + __popc(who & ((1u << lane) - 1))] = key;
    }
    int size = 1;
    while (size < want) size <<= 1;
    for (int i = want + tid; i < size; i += kSelThreads) keys[i] = 0;  // below every key
    __syncthreads();
    // bitonic sort, descending
    for (int len = 2; len <= size; len <<= 1) {
      for (int stride = len >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < size; i += kSelThreads) {
          const int j = i ^ stride;
          if (j > i) {
            const unsigned long long a = keys[i], c = keys[j];
            const bool desc = (i & len) == 0;
            if (desc ? a < c : a > c) {
              keys[i] = c;
              keys[j] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int i = tid; i < want; i += kSelThreads) {
      const size_t o = static_cast<size_t>(b) * k + off + i;
      out_s[o] = key_score(keys[i]);
      out_i[o] = static_cast<int>(0xffffffffu - static_cast<unsigned>(keys[i]));
    }
    bound = keys[want - 1];
    __syncthreads();
  }
}

template <typename Row>
int launch_select(const float* q, const Row* x, const float* scales, int B, int N, int d, int k,
                  int rows, int nchunks, int chunk, float* scores, float* out_s, int* out_i,
                  void* stream) {
  if (k < 1 || k > N || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int r0 = 0; r0 < B; r0 += rows) {
    const int nr = min(rows, B - r0);
    const float* qr = q + static_cast<size_t>(r0) * d;
    const cudaError_t err =
        vector_loads(qr, x, d)
            ? launch_chunks<Row, true, true>(qr, x, scales, nr, N, d, k, nchunks, chunk, scores,
                                             nullptr, s)
            : launch_chunks<Row, false, true>(qr, x, scales, nr, N, d, k, nchunks, chunk,
                                              scores, nullptr, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    mips_topk_select_kernel<<<nr, kSelThreads, 0, s>>>(scores, N, k,
                                                       out_s + static_cast<size_t>(r0) * k,
                                                       out_i + static_cast<size_t>(r0) * k);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return static_cast<int>(launched);
  }
  return 0;
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

extern "C" int mips_topk_select_f32(const float* q, const float* x, int B, int N, int d, int k,
                                    int rows, int nchunks, int chunk, float* scores,
                                    float* out_s, int* out_i, void* stream) {
  return launch_select(q, x, static_cast<const float*>(nullptr), B, N, d, k, rows, nchunks,
                       chunk, scores, out_s, out_i, stream);
}

extern "C" int mips_topk_select_i8(const float* q, const signed char* codes,
                                   const float* scales, int B, int N, int d, int k, int rows,
                                   int nchunks, int chunk, float* scores, float* out_s,
                                   int* out_i, void* stream) {
  return launch_select(q, codes, scales, B, N, d, k, rows, nchunks, chunk, scores, out_s, out_i,
                       stream);
}
