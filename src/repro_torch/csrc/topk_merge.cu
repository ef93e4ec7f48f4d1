// topk_merge: the top L of an L-slot pool and M new candidates per query,
// carrying (score f32, id i32, checked i32):
//   cand = [pool, new];  out = cand[top L by score]
//
// Replaces the TPU kernel _merge_kernel (src/repro/kernels/topk_merge/
// kernel.py:55, launched by topk_merge_pallas :64 -> pallas_call :77, its
// selection masked_top_l :23).  The semantics are topk_merge_ref's
// (src/repro/kernels/topk_merge/ref.py:9), lax.top_k's order: score
// descending, +0.0 above -0.0, the first occurrence winning exact ties, -inf
// slots included; each slot's own score is written.  (The Pallas kernel keeps
// +-0 equal and writes the row maximum, so it returns +0.0 for a -0.0 slot;
// the port follows the ref.)  The JAX wrapper's pad of B to 128 rows is TPU
// tiling and is gone: any B.
//
// What bounds it on the H100: bytes.  It reads 12 bytes per candidate,
// B*(L+M)*12, and writes B*L*12, with C^2 compares per row (C = L+M <= 80)
// that cost nothing beside them; at the walk's shapes (B <= 512) the launch
// itself dominates.
//
// Design: one block per query row.  The C candidates are staged in shared
// memory, pool first, then new, as JAX concatenates; each thread ranks one
// candidate by counting (select.cuh::rank_first_occurrence, the order
// beam_step's merge uses) and writes the candidates of rank < L, with both
// payloads, to their rank's slot: no sort, no second pass.
#include <cuda_runtime.h>

#include "select.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) topk_merge_kernel(
    const float* __restrict__ pool_s, const int* __restrict__ pool_i,
    const int* __restrict__ pool_c, const float* __restrict__ new_s,
    const int* __restrict__ new_i, const int* __restrict__ new_c, int L, int M,
    float* __restrict__ out_s, int* __restrict__ out_i, int* __restrict__ out_c) {
  extern __shared__ float smem[];
  const int C = L + M;
  float* cs = smem;                             // [C]
  int* ci = reinterpret_cast<int*>(cs + C);     // [C]
  int* cc = ci + C;                             // [C]
  const size_t b = blockIdx.x;
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    const bool pool = i < L;
    const size_t at = pool ? b * L + i : b * M + (i - L);
    cs[i] = pool ? pool_s[at] : new_s[at];
    ci[i] = pool ? pool_i[at] : new_i[at];
    cc[i] = pool ? pool_c[at] : new_c[at];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    const int r = repro::rank_first_occurrence(cs, C, i);
    if (r < L) {
      out_s[b * L + r] = cs[i];
      out_i[b * L + r] = ci[i];
      out_c[b * L + r] = cc[i];
    }
  }
}

}  // namespace

extern "C" int topk_merge_f32(const float* pool_s, const int* pool_i, const int* pool_c,
                              const float* new_s, const int* new_i, const int* new_c, int B,
                              int L, int M, float* out_s, int* out_i, int* out_c,
                              void* stream) {
  const size_t smem = static_cast<size_t>(L + M) * 12;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  topk_merge_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pool_s, pool_i, pool_c, new_s, new_i, new_c, L, M, out_s, out_i, out_c);
  return static_cast<int>(cudaGetLastError());
}
