// beam_step: one Algorithm-1 iteration for every query of a walk, over fp32
// items (beam_step_f32) or the int8 store (beam_step_i8).
//
// Replaces the TPU kernel _beam_step_kernel (src/repro/kernels/beam_step/
// kernel.py:50, launched by beam_step_pallas :188 behind ops.py:26).  The
// semantics are beam_step_ref's (src/repro/kernels/beam_step/ref.py:37):
//   * the current slot is the first unchecked slot holding an id >= 0;
//   * done is sticky: done | no unchecked slot; done rows take no step;
//   * a neighbour is valid if its id is >= 0 and not in the row's visited
//     buffer; invalid ones get score -inf, id -1 and are born checked;
//   * [pool, neighbours] merge into the top L by lax.top_k's order;
//   * with the int8 store a neighbour scores (q . codes[id]) * scales[id]
//     (kernel.py:151-161, quant_score/ref.py:19): repro::row_score, the
//     same function quant_score.cu seeds the walk with;
//   * with a tombstone mask (live != nullptr, the mutation layer's [N] bool
//     live bytes; kernel.py:57-77, 128-144, 178-183) out_ndead counts the
//     valid neighbours that are dead.  The mask changes nothing else: dead
//     nodes are scored and merged like live ones (they still route walks).
//     A null live pointer writes no n_dead.
//
// What bounds it on the H100: bytes.  A step reads, per updating query, its
// pool, its visited buffer (V ids, the largest read: 1440 ids at the search
// shape), M adjacency ids and up to M gathered rows of d floats, and does
// 2*d flops per row -- far below the card's flop rate.  The rows are random
// gathers, so the time goes to latency, not to streaming bandwidth.  An int8
// row is d bytes instead of 4*d plus a 4-byte scale.
//
// Design: one block per query.  The query row sits in shared memory; the M
// adjacency ids are loaded once; the block scans the visited ids once,
// coalesced, against all M ids in shared memory; one warp per neighbour row
// loads it as float4 (d % 4 == 0) or floats and reduces with shuffles, so
// every row is fetched by 32 lanes at once and the block keeps several rows
// in flight (int8 rows: char4 loads, cast to float, one scale multiply).
// The L+M merge ranks each candidate by counting (select.cuh) and writes it
// to its slot: no sort.  Done rows copy their pool through and fetch nothing
// -- the pool is sorted (it comes out of a merge or the seeding top-k), so
// the merge would return it unchanged.  With a mask, lane 0 of the warp that
// scores a valid neighbour also reads its one live byte into a shared flag,
// and thread 0 sums the flags beside n_scored: at most M bytes per updating
// query beside M rows of 4*d, so the byte bound barely moves.
#include <cuda_runtime.h>

#include "select.cuh"

namespace {

constexpr int kThreads = 256;

// Row is float (fp32 items; scales unused) or signed char (int8 codes).
template <typename Row>
__global__ void __launch_bounds__(kThreads) beam_step_kernel(
    const int* __restrict__ pool_ids, const float* __restrict__ pool_scores,
    const unsigned char* __restrict__ pool_checked,
    const int* __restrict__ visited, const unsigned char* __restrict__ done_in,
    const float* __restrict__ queries, const int* __restrict__ adj,
    const Row* __restrict__ items, const float* __restrict__ scales, int L, int V, int M,
    int d,
    int* __restrict__ out_ids, float* __restrict__ out_scores,
    unsigned char* __restrict__ out_checked, int* __restrict__ out_nbr,
    unsigned char* __restrict__ out_done, int* __restrict__ out_nscored,
    const unsigned char* __restrict__ live, int* __restrict__ out_ndead) {
  extern __shared__ float4 smem4[];
  const int dq = (d + 3) & ~3;
  const int C = L + M;
  float* q_sh = reinterpret_cast<float*>(smem4);                  // [dq]
  float* cs = q_sh + dq;                                          // [C]
  int* ci = reinterpret_cast<int*>(cs + C);                       // [C]
  int* nbr = ci + C;                                              // [M]
  unsigned char* cc = reinterpret_cast<unsigned char*>(nbr + M);  // [C]
  unsigned char* seen = cc + C;                                   // [M]
  unsigned char* dead = seen + M;                                 // [M]
  __shared__ int s_slot, s_upd;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int* pi = pool_ids + static_cast<size_t>(b) * L;
  const float* ps = pool_scores + static_cast<size_t>(b) * L;
  const unsigned char* pc = pool_checked + static_cast<size_t>(b) * L;
  int* oi = out_ids + static_cast<size_t>(b) * L;
  float* os = out_scores + static_cast<size_t>(b) * L;
  unsigned char* oc = out_checked + static_cast<size_t>(b) * L;

  // 1. the first unchecked slot (min over slot index, as kernel.py:87)
  if (tid == 0) {
    int slot = L;
    for (int i = 0; i < L; ++i) {
      if (!pc[i] && pi[i] >= 0) { slot = i; break; }
    }
    s_slot = slot;
    s_upd = !done_in[b] && slot < L;
  }
  __syncthreads();
  const int slot = s_slot;
  if (!s_upd) {
    for (int i = tid; i < L; i += blockDim.x) {
      oi[i] = pi[i];
      os[i] = ps[i];
      oc[i] = pc[i];
    }
    for (int j = tid; j < M; j += blockDim.x) out_nbr[static_cast<size_t>(b) * M + j] = -1;
    if (tid == 0) {
      out_done[b] = 1;
      out_nscored[b] = 0;
      if (live) out_ndead[b] = 0;
    }
    return;
  }

  // 2. the adjacency row of the chosen id, and the query
  const int cur = max(pi[slot], 0);
  for (int j = tid; j < M; j += blockDim.x) {
    nbr[j] = adj[static_cast<size_t>(cur) * M + j];
    seen[j] = 0;
  }
  for (int c = tid; c < d; c += blockDim.x) q_sh[c] = queries[static_cast<size_t>(b) * d + c];
  __syncthreads();

  // 3. visited check: one coalesced pass over the V ids
  const int* vis = visited + static_cast<size_t>(b) * V;
  for (int v = tid; v < V; v += blockDim.x) {
    const int id = vis[v];
    for (int j = 0; j < M; ++j) {
      if (nbr[j] == id) seen[j] = 1;
    }
  }
  // pool candidates, the chosen slot now checked
  for (int i = tid; i < L; i += blockDim.x) {
    cs[i] = ps[i];
    ci[i] = pi[i];
    cc[i] = pc[i] | (i == slot);
  }
  __syncthreads();

  // 4. score the valid neighbours, one warp per row
  for (int j = warp; j < M; j += nwarps) {
    const int id = nbr[j];
    const bool valid = id >= 0 && !seen[j];
    float s = -INFINITY;
    if (valid) s = repro::row_score(q_sh, items, scales, id, d, lane);
    if (lane == 0) {
      cs[L + j] = s;
      ci[L + j] = valid ? id : -1;
      cc[L + j] = !valid;
      dead[j] = live && valid && !live[id];
    }
  }
  __syncthreads();

  // 5. merge [pool, neighbours] into the top L by counting
  for (int i = tid; i < C; i += blockDim.x) {
    const int r = repro::rank_first_occurrence(cs, C, i);
    if (r < L) {
      oi[r] = ci[i];
      os[r] = cs[i];
      oc[r] = cc[i];
    }
  }
  for (int j = tid; j < M; j += blockDim.x) out_nbr[static_cast<size_t>(b) * M + j] = ci[L + j];
  if (tid == 0) {
    int n = 0, n_dead = 0;
    for (int j = 0; j < M; ++j) {
      n += ci[L + j] >= 0;
      n_dead += dead[j];
    }
    out_done[b] = 0;
    out_nscored[b] = n;
    if (live) out_ndead[b] = n_dead;
  }
}

template <typename Row>
int launch(const int* pool_ids, const float* pool_scores, const unsigned char* pool_checked,
           const int* visited, const unsigned char* done, const float* queries,
           const int* adj, const Row* items, const float* scales, int B, int L, int V,
           int M, int d, int* out_ids, float* out_scores, unsigned char* out_checked,
           int* out_nbr, unsigned char* out_done, int* out_nscored,
           const unsigned char* live, int* out_ndead, void* stream) {
  const int C = L + M;
  const size_t smem = sizeof(float) * ((d + 3) & ~3) + (sizeof(float) + sizeof(int)) * C +
                      sizeof(int) * M + C + 2 * M;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(beam_step_kernel<Row>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  beam_step_kernel<Row><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pool_ids, pool_scores, pool_checked, visited, done, queries, adj, items, scales, L, V,
      M, d, out_ids, out_scores, out_checked, out_nbr, out_done, out_nscored, live,
      out_ndead);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------- beam_walk
//
// The whole walk in one launch: the JAX package's lax.while_loop over
// _beam_step_kernel (src/repro/core/search.py:335-357) moves into the block.
// A block owns one query row and runs its steps until the row is done or
// max_steps is reached.  Rows are independent (a step reads only its own
// pool, visited row and done flag; adj and the items are read-only during a
// walk), so the kernel needs no grid-wide sync; the global step count of the
// while_loop is the largest per-row count, which the wrapper reads back once.
//
// What bounds it on the H100: latency, not bytes.  A step is two dependent
// trips to memory -- the adjacency row of the chosen slot, then up to M
// gathered rows of d -- and moves about 20 KB; all rows of a search (256)
// or a build batch (512) are resident at once (4 blocks of 256 threads an
// SM), so a walk takes the slowest row's step count times one step's
// latency.  The design keeps everything else off that path:
//   * the row's state lives in shared memory across steps: the query, the
//     L-pool (two buffers, merged from one into the other), the step's M
//     candidates, and the visited ids when 4*V bytes fit (vis_shared; else
//     the visited row is scanned in global memory, as the per-step kernel
//     does).  visited goes to global memory only as output, M ids a step;
//   * the slot is chosen by one warp's __ballot_sync / __ffs over the
//     unchecked flags, 32 slots at a time;
//   * the visited test scans only the filled prefix (S + t*M ids; the rest
//     is -1 on entry and never matches a valid neighbour), 16 neighbour ids
//     held in registers, hits OR-reduced per warp;
//   * a warp gathers two neighbour rows with all their 16-byte (int8: 4-byte)
//     loads in flight before its first FMA;
//   * the merge ranks by counting as select.cuh does, in O((L + M) * M): the
//     pool is sorted, so pool slot i ranks i plus the new candidates above
//     it, and a new candidate ranks by a binary search of the pool plus the
//     new candidates above it -- the same ranks as rank_first_occurrence
//     over [pool, neighbours].
// No tensor cores: a row costs 2*d fp32 flops, and the scores must be
// exact fp32 -- every recall number depends on them.  Each lane accumulates
// its columns in warp_dot's order and the warp reduces with warp_sum, so a
// score equals the per-step kernel's bit for bit, and so does every output:
// the pool, visited, evals and dead_evals (seed values plus the steps in
// which the row advanced) and the row's step count (the steps it ran,
// including the one that found no unchecked slot; 0 for a row done on entry).
namespace walk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 3;  // 16-byte loads a lane keeps in flight per row: d <= 384 in one round

__device__ __forceinline__ float4 load_vec(const float* __restrict__ row, int c) {
  return __ldg(reinterpret_cast<const float4*>(row) + c);
}
__device__ __forceinline__ char4 load_vec(const signed char* __restrict__ row, int c) {
  return __ldg(reinterpret_cast<const char4*>(row) + c);
}
__device__ __forceinline__ float fma4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float fma4(char4 a, float4 b, float acc) {
  acc = fmaf(static_cast<float>(a.x), b.x, acc);
  acc = fmaf(static_cast<float>(a.y), b.y, acc);
  acc = fmaf(static_cast<float>(a.z), b.z, acc);
  return fmaf(static_cast<float>(a.w), b.w, acc);
}
__device__ __forceinline__ float row_scale(const float* /*scales*/, const float*, int) {
  return 1.f;
}
__device__ __forceinline__ float row_scale(const float* scales, const signed char*, int id) {
  return __ldg(scales + id);
}

// Scores neighbour rows j0 and j1 (j1 >= M: none) by one warp: warp_dot's
// arithmetic (repro::row_score), with every load of both rows issued first.
// ok_* says whether the row is a valid neighbour; an invalid one loads
// nothing and scores -inf.
template <typename Row>
__device__ __forceinline__ void score_pair(const float* __restrict__ q_sh,
                                           const Row* __restrict__ items,
                                           const float* __restrict__ scales, int d, int lane,
                                           int id0, bool ok0, int id1, bool ok1, float* s0,
                                           float* s1) {
  using V = decltype(load_vec(items, 0));
  const int d4 = d >> 2;
  const Row* r0 = items + static_cast<size_t>(max(id0, 0)) * d;
  const Row* r1 = items + static_cast<size_t>(max(id1, 0)) * d;
  const float4* q4 = reinterpret_cast<const float4*>(q_sh);
  // the int8 scales load beside the rows, not after the sum
  const float sc0 = ok0 ? row_scale(scales, items, id0) : 1.f;
  const float sc1 = ok1 ? row_scale(scales, items, id1) : 1.f;
  float a0 = 0.f, a1 = 0.f;
  for (int c0 = 0; c0 < d4; c0 += 32 * kVec) {
    V v0[kVec], v1[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int c = c0 + lane + 32 * u;
      if (ok0 && c < d4) v0[u] = load_vec(r0, c);
      if (ok1 && c < d4) v1[u] = load_vec(r1, c);
    }
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int c = c0 + lane + 32 * u;
      if (c < d4) {
        const float4 b = q4[c];
        if (ok0) a0 = fma4(v0[u], b, a0);
        if (ok1) a1 = fma4(v1[u], b, a1);
      }
    }
  }
  a0 = repro::warp_sum(a0);
  a1 = repro::warp_sum(a1);
  *s0 = ok0 ? a0 * sc0 : -INFINITY;
  *s1 = ok1 ? a1 * sc1 : -INFINITY;
}

// warp_dot needs d % 4 == 0 for its vector loads; other widths score one row
// at a time with repro::row_score (its scalar loop).
template <typename Row, bool VEC>
__device__ __forceinline__ void score_rows(const float* __restrict__ q_sh,
                                           const Row* __restrict__ items,
                                           const float* __restrict__ scales, int d, int lane,
                                           int id0, bool ok0, int id1, bool ok1, float* s0,
                                           float* s1) {
  if (VEC) {
    score_pair(q_sh, items, scales, d, lane, id0, ok0, id1, ok1, s0, s1);
  } else {
    *s0 = ok0 ? repro::row_score(q_sh, items, scales, id0, d, lane) : -INFINITY;
    *s1 = ok1 ? repro::row_score(q_sh, items, scales, id1, d, lane) : -INFINITY;
  }
}

template <typename Row, bool VEC>
__global__ void __launch_bounds__(kThreads, 4) beam_walk_kernel(
    const int* __restrict__ pool_ids, const float* __restrict__ pool_scores,
    const unsigned char* __restrict__ pool_checked, int* visited,
    const unsigned char* __restrict__ done_in, const int* __restrict__ evals_in,
    const int* __restrict__ dead_in, const float* __restrict__ queries,
    const int* __restrict__ adj, const Row* __restrict__ items,
    const float* __restrict__ scales, const unsigned char* __restrict__ live, int L, int V,
    int M, int d, int S, int max_steps, int vis_shared, int* __restrict__ out_ids,
    float* __restrict__ out_scores, unsigned char* __restrict__ out_checked,
    int* __restrict__ out_evals, int* __restrict__ out_dead, int* __restrict__ out_steps) {
  extern __shared__ float4 smem4[];
  const int dq = (d + 3) & ~3;
  const int words = (M + 15) >> 4;  // 16-neighbour groups of the visited test
  float* q_sh = reinterpret_cast<float*>(smem4);  // [dq]
  float* ps = q_sh + dq;                          // [2][L] pool scores, two buffers
  int* pi = reinterpret_cast<int*>(ps + 2 * L);   // [2][L] pool ids
  float* cs = reinterpret_cast<float*>(pi + 2 * L);  // [M] the step's scores
  int* nbr = reinterpret_cast<int*>(cs + M);         // [M] adjacency ids, then -1 if invalid
  unsigned* seen = reinterpret_cast<unsigned*>(nbr + M);  // [words] visited hits
  int* vsh = reinterpret_cast<int*>(seen + words);        // [V] when vis_shared
  unsigned char* pc = reinterpret_cast<unsigned char*>(vsh + (vis_shared ? V : 0));  // [2][L]
  unsigned char* dead = pc + 2 * L;  // [M]
  __shared__ int s_slot;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* vis_g = visited + static_cast<size_t>(b) * V;
  int* vis = vis_shared ? vsh : vis_g;

  for (int i = tid; i < L; i += kThreads) {
    ps[i] = pool_scores[static_cast<size_t>(b) * L + i];
    pi[i] = pool_ids[static_cast<size_t>(b) * L + i];
    pc[i] = pool_checked[static_cast<size_t>(b) * L + i];
  }
  for (int c = tid; c < d; c += kThreads) q_sh[c] = queries[static_cast<size_t>(b) * d + c];
  if (vis_shared) {
    for (int v = tid; v < S; v += kThreads) vsh[v] = vis_g[v];
  }
  __syncthreads();

  int cur = 0, steps = 0, n_eval = 0, n_dead = 0;  // tallies: warp 0's lanes
  const bool born_done = done_in[b];
  for (int t = 0; t < max_steps && !born_done; ++t) {
    const float* sp = ps + cur * L;
    const int* ip = pi + cur * L;
    const unsigned char* cp = pc + cur * L;
    ++steps;
    // 1. the first unchecked slot holding an id (kernel.py:87)
    if (warp == 0) {
      int slot = L;
      for (int i0 = 0; i0 < L; i0 += 32) {
        const int i = i0 + lane;
        const unsigned m = __ballot_sync(repro::kFullMask, i < L && !cp[i] && ip[i] >= 0);
        if (m) {
          slot = i0 + __ffs(m) - 1;
          break;
        }
      }
      if (lane == 0) s_slot = slot;
    }
    __syncthreads();
    const int slot = s_slot;
    if (slot == L) break;  // done: this step counted, wrote nothing

    // 2. the adjacency row of the chosen id
    const int node = ip[slot];
    for (int j = tid; j < M; j += kThreads) nbr[j] = adj[static_cast<size_t>(node) * M + j];
    if (tid < words) seen[tid] = 0;
    __syncthreads();

    // 3. visited test over the filled prefix, 16 neighbour ids at a time
    const int filled = S + t * M;
    for (int w = 0; w < words; ++w) {
      int nb[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) nb[u] = 16 * w + u < M ? nbr[16 * w + u] : -2;
      unsigned hit = 0;
      for (int v = tid; v < filled; v += kThreads) {
        const int id = vis[v];
#pragma unroll
        for (int u = 0; u < 16; ++u) hit |= static_cast<unsigned>(nb[u] == id) << u;
      }
      hit = __reduce_or_sync(repro::kFullMask, hit);
      if (lane == 0 && hit) atomicOr(seen + w, hit);
    }
    __syncthreads();

    // 4. score the valid neighbours: a warp takes rows j and j + kWarps
    for (int j = warp; j < M; j += 2 * kWarps) {
      const int j1 = j + kWarps;
      const int id0 = nbr[j];
      const int id1 = j1 < M ? nbr[j1] : -1;
      const bool ok0 = id0 >= 0 && !((seen[j >> 4] >> (j & 15)) & 1u);
      const bool ok1 = id1 >= 0 && !((seen[j1 >> 4] >> (j1 & 15)) & 1u);
      const bool live0 = !ok0 || live == nullptr || live[id0];
      const bool live1 = !ok1 || live == nullptr || live[id1];
      float s0, s1;
      score_rows<Row, VEC>(q_sh, items, scales, d, lane, id0, ok0, id1, ok1, &s0, &s1);
      if (lane == 0) {
        cs[j] = s0;
        nbr[j] = ok0 ? id0 : -1;
        dead[j] = !live0;
        if (j1 < M) {
          cs[j1] = s1;
          nbr[j1] = ok1 ? id1 : -1;
          dead[j1] = !live1;
        }
      }
    }
    __syncthreads();

    // 5. merge [pool, neighbours] into the other buffer by rank; the
    //    chosen slot is now checked, an invalid neighbour is born checked
    float* sn = ps + (cur ^ 1) * L;
    int* in = pi + (cur ^ 1) * L;
    unsigned char* cn = pc + (cur ^ 1) * L;
    for (int i = tid; i < L + M; i += kThreads) {
      int r;
      float s;
      int id;
      unsigned char ck;
      if (i < L) {
        s = sp[i];
        id = ip[i];
        ck = cp[i] | (i == slot);
        const int key = repro::order_key(s);
        r = i;
        for (int j = 0; j < M; ++j) r += repro::order_key(cs[j]) > key;
      } else {
        const int j = i - L;
        s = cs[j];
        id = nbr[j];
        ck = id < 0;
        const int key = repro::order_key(s);
        int lo = 0, hi = L;  // pool slots at or above key: the pool is sorted
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (repro::order_key(sp[mid]) >= key) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        r = lo;
        for (int y = 0; y < M; ++y) {
          const int ky = repro::order_key(cs[y]);
          r += ky > key || (ky == key && y < j);
        }
      }
      if (r < L) {
        sn[r] = s;
        in[r] = id;
        cn[r] = ck;
      }
    }
    for (int j = tid; j < M; j += kThreads) {
      vis_g[filled + j] = nbr[j];
      if (vis_shared) vsh[filled + j] = nbr[j];
    }
    if (warp == 0) {
      for (int j0 = 0; j0 < M; j0 += 32) {
        const int j = j0 + lane;
        n_eval += __popc(__ballot_sync(repro::kFullMask, j < M && nbr[j] >= 0));
        n_dead += __popc(__ballot_sync(repro::kFullMask, j < M && dead[j]));
      }
    }
    cur ^= 1;
    __syncthreads();
  }

  for (int i = tid; i < L; i += kThreads) {
    out_ids[static_cast<size_t>(b) * L + i] = pi[cur * L + i];
    out_scores[static_cast<size_t>(b) * L + i] = ps[cur * L + i];
    out_checked[static_cast<size_t>(b) * L + i] = pc[cur * L + i];
  }
  if (tid == 0) {
    out_evals[b] = evals_in[b] + n_eval;
    if (live) out_dead[b] = dead_in[b] + n_dead;
    out_steps[b] = steps;
  }
}

template <typename Row>
int launch(const int* pool_ids, const float* pool_scores, const unsigned char* pool_checked,
           int* visited, const unsigned char* done, const int* evals, const int* dead_evals,
           const float* queries, const int* adj, const Row* items, const float* scales, int B,
           int L, int V, int M, int d, int S, int max_steps, int vis_shared, int* out_ids,
           float* out_scores, unsigned char* out_checked, int* out_evals, int* out_dead,
           int* out_steps, const unsigned char* live, void* stream) {
  if (B == 0) return 0;
  if (S < 0 || S + static_cast<long long>(max_steps) * M > V) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dq = (d + 3) & ~3;
  const size_t smem = sizeof(float) * dq + (sizeof(float) + sizeof(int)) * 2 * L +
                      (sizeof(float) + sizeof(int)) * M + sizeof(unsigned) * ((M + 15) >> 4) +
                      (vis_shared ? sizeof(int) * V : 0) + 2 * L + M;
  const bool vec = d % 4 == 0;
  auto kernel = vec ? beam_walk_kernel<Row, true> : beam_walk_kernel<Row, false>;
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pool_ids, pool_scores, pool_checked, visited, done, evals, dead_evals, queries, adj, items,
      scales, live, L, V, M, d, S, max_steps, vis_shared, out_ids, out_scores, out_checked,
      out_evals, out_dead, out_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace walk

}  // namespace

extern "C" int beam_step_f32(const int* pool_ids, const float* pool_scores,
                             const unsigned char* pool_checked, const int* visited,
                             const unsigned char* done, const float* queries,
                             const int* adj, const float* items, int B, int L,
                             int V, int M, int d, int* out_ids, float* out_scores,
                             unsigned char* out_checked, int* out_nbr,
                             unsigned char* out_done, int* out_nscored,
                             const unsigned char* live, int* out_ndead, void* stream) {
  return launch(pool_ids, pool_scores, pool_checked, visited, done, queries, adj, items,
                static_cast<const float*>(nullptr), B, L, V, M, d, out_ids, out_scores,
                out_checked, out_nbr, out_done, out_nscored, live, out_ndead, stream);
}

extern "C" int beam_step_i8(const int* pool_ids, const float* pool_scores,
                            const unsigned char* pool_checked, const int* visited,
                            const unsigned char* done, const float* queries, const int* adj,
                            const signed char* codes, const float* scales, int B, int L,
                            int V, int M, int d, int* out_ids, float* out_scores,
                            unsigned char* out_checked, int* out_nbr,
                            unsigned char* out_done, int* out_nscored,
                            const unsigned char* live, int* out_ndead, void* stream) {
  return launch(pool_ids, pool_scores, pool_checked, visited, done, queries, adj, codes,
                scales, B, L, V, M, d, out_ids, out_scores, out_checked, out_nbr, out_done,
                out_nscored, live, out_ndead, stream);
}

extern "C" int beam_walk_f32(const int* pool_ids, const float* pool_scores,
                             const unsigned char* pool_checked, int* visited,
                             const unsigned char* done, const int* evals,
                             const int* dead_evals, const float* queries, const int* adj,
                             const float* items, int B, int L, int V, int M, int d, int S,
                             int max_steps, int vis_shared, int* out_ids, float* out_scores,
                             unsigned char* out_checked, int* out_evals, int* out_dead,
                             int* out_steps, const unsigned char* live, void* stream) {
  return walk::launch(pool_ids, pool_scores, pool_checked, visited, done, evals, dead_evals,
                      queries, adj, items, static_cast<const float*>(nullptr), B, L, V, M, d,
                      S, max_steps, vis_shared, out_ids, out_scores, out_checked, out_evals,
                      out_dead, out_steps, live, stream);
}

extern "C" int beam_walk_i8(const int* pool_ids, const float* pool_scores,
                            const unsigned char* pool_checked, int* visited,
                            const unsigned char* done, const int* evals, const int* dead_evals,
                            const float* queries, const int* adj, const signed char* codes,
                            const float* scales, int B, int L, int V, int M, int d, int S,
                            int max_steps, int vis_shared, int* out_ids, float* out_scores,
                            unsigned char* out_checked, int* out_evals, int* out_dead,
                            int* out_steps, const unsigned char* live, void* stream) {
  return walk::launch(pool_ids, pool_scores, pool_checked, visited, done, evals, dead_evals,
                      queries, adj, codes, scales, B, L, V, M, d, S, max_steps, vis_shared,
                      out_ids, out_scores, out_checked, out_evals, out_dead, out_steps, live,
                      stream);
}
