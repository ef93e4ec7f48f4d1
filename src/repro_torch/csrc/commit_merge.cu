// commit_merge: the reverse-link top-M merge of one build batch, f32 items.
//
// Replaces the TPU kernel _commit_merge_kernel (src/repro/kernels/
// commit_merge/kernel.py:78, launched by commit_merge_pallas :187 behind
// ops.py:122).  The semantics are commit_merge_ref's two stable sorts
// (src/repro/kernels/commit_merge/ref.py:36): every touched row is rewritten
// with the top M of its deduplicated proposals and its rescored existing
// edges, by valid first, score descending, id ascending; empty slots are -1.
//
// Input: the wrapper's pre-pass (kernels/commit_merge/ops.py) has sorted the
// proposals by (target, cand), dropped repeated pairs (the first proposal
// wins) and laid them out in CSR form: unique targets utgt[U], offsets[U+1],
// and per segment the cand ids (ascending) and their scores.  The TPU's
// [G, K] bucket table existed only because a BlockSpec needs static shapes.
//
// What bounds it on the H100: bytes.  Per touched row it reads the target
// vector, its M adjacency ids and up to M gathered neighbour rows (d floats
// each), and does 2*d flops per row; the rows are random gathers, so latency
// rules, as in beam_step.
//
// Design: one block per unique target.  The target vector goes to shared
// memory, with the segment's proposals and the existing row.  An existing
// slot that a proposal repeats (the proposal's score wins) or that repeats
// an earlier slot is dropped; the survivors are rescored one warp per row
// (float4 loads, shuffle reduction); every valid candidate is ranked by
// counting under the ranked_top_m order and written straight to its slot of
// adj -- in place: a block reads and writes only its own target's row.
#include <cuda_runtime.h>

#include "select.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) commit_merge_kernel(
    const int* __restrict__ utgt, const int* __restrict__ offsets,
    const int* __restrict__ cand_ids, const float* __restrict__ cand_scores,
    int* __restrict__ adj, const float* __restrict__ items, int M, int d) {
  extern __shared__ float4 smem4[];
  const int u = blockIdx.x;
  const int t = utgt[u];
  const int p0 = offsets[u];
  const int P = offsets[u + 1] - p0;
  const int C = P + M;
  const int dq = (d + 3) & ~3;
  float* t_sh = reinterpret_cast<float*>(smem4);                  // [dq]
  float* cs = t_sh + dq;                                          // [C]
  int* ci = reinterpret_cast<int*>(cs + C);                       // [C]
  unsigned char* cv = reinterpret_cast<unsigned char*>(ci + C);   // [C]
  __shared__ int s_nvalid;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  int* row = adj + static_cast<size_t>(t) * M;

  for (int c = tid; c < d; c += blockDim.x) t_sh[c] = items[static_cast<size_t>(t) * d + c];
  for (int i = tid; i < P; i += blockDim.x) {
    cs[i] = cand_scores[p0 + i];
    ci[i] = cand_ids[p0 + i];
    cv[i] = 1;
  }
  for (int j = tid; j < M; j += blockDim.x) ci[P + j] = row[j];
  if (tid == 0) s_nvalid = 0;
  __syncthreads();

  // existing slots: drop -1s and repeats of an earlier slot ...
  for (int j = tid; j < M; j += blockDim.x) {
    const int id = ci[P + j];
    bool ok = id >= 0;
    for (int jj = 0; jj < j; ++jj) ok = ok && ci[P + jj] != id;
    cv[P + j] = ok;
  }
  __syncthreads();
  // ... and the ones a proposal repeats
  for (int i = tid; i < P; i += blockDim.x) {
    const int id = ci[i];
    for (int j = 0; j < M; ++j) {
      if (ci[P + j] == id) cv[P + j] = 0;
    }
  }
  __syncthreads();

  // rescore the surviving existing edges, one warp per row
  for (int j = warp; j < M; j += nwarps) {
    float s = -INFINITY;
    if (cv[P + j]) {
      s = repro::warp_dot(t_sh, items + static_cast<size_t>(ci[P + j]) * d, d, lane);
    }
    if (lane == 0) cs[P + j] = s;
  }
  __syncthreads();

  // rank the valid candidates and write the row in place
  int mine = 0;
  for (int i = tid; i < C; i += blockDim.x) {
    if (!cv[i]) continue;
    ++mine;
    const int r = repro::rank_valid_by_id(cs, ci, cv, C, i);
    if (r < M) row[r] = ci[i];
  }
  if (mine) atomicAdd(&s_nvalid, mine);
  __syncthreads();
  for (int r = s_nvalid + tid; r < M; r += blockDim.x) row[r] = -1;
}

}  // namespace

extern "C" int commit_merge_f32(const int* utgt, const int* offsets, const int* cand_ids,
                                const float* cand_scores, int* adj, const float* items,
                                int U, int M, int d, int max_seg, void* stream) {
  const int C = max_seg + M;
  const size_t smem =
      sizeof(float) * ((d + 3) & ~3) + (sizeof(float) + sizeof(int) + 1) * static_cast<size_t>(C);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(commit_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  commit_merge_kernel<<<U, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      utgt, offsets, cand_ids, cand_scores, adj, items, M, d);
  return static_cast<int>(cudaGetLastError());
}
