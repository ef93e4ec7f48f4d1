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
