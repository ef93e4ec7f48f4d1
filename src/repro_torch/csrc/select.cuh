// Device helpers shared by the port's kernels: the two rank-counting
// selectors that carry the JAX package's tie rules, and the one-warp gathered
// dot product.
//
// A selection by counting gives each candidate its final position directly:
// rank_i = #{j : j comes before i}.  With a strict total order every rank is
// distinct, so the candidates of rank < L are written to their slots with no
// sort, no atomics and no second pass, and -inf scores need no special case.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;

// (sa, ka) comes before (sb, kb): score descending, then key ascending.
__device__ __forceinline__ bool precedes(float sa, int ka, float sb, int kb) {
  return sa > sb || (sa == sb && ka < kb);
}

// lax.top_k / masked_top_l order (src/repro/kernels/topk_merge/kernel.py:23):
// rank of candidate i of s[0, n) by score descending, the first occurrence
// winning ties (-inf slots included).
__device__ __forceinline__ int rank_first_occurrence(const float* s, int n, int i) {
  const float si = s[i];
  int r = 0;
  for (int j = 0; j < n; ++j) r += precedes(s[j], j, si, i);
  return r;
}

// ranked_top_m order (src/repro/kernels/commit_merge/kernel.py:52): rank of
// valid candidate i among the valid candidates by score descending, then id
// ascending.  Valid ids are unique; a valid -inf score still ranks.
__device__ __forceinline__ int rank_valid_by_id(const float* s, const int* id,
                                                const unsigned char* valid,
                                                int n, int i) {
  const float si = s[i];
  const int idi = id[i];
  int r = 0;
  for (int j = 0; j < n; ++j) r += valid[j] && precedes(s[j], id[j], si, idi);
  return r;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// Dot of a vector in shared memory (16-byte aligned) with one row in global
// memory, by one warp; every lane gets the sum.  Rows load as float4 when d is
// a multiple of 4 (rows then start on 16-byte boundaries), else as floats.
__device__ __forceinline__ float warp_dot(const float* __restrict__ v_sh,
                                          const float* __restrict__ row,
                                          int d, int lane) {
  float acc = 0.f;
  if ((d & 3) == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* v4 = reinterpret_cast<const float4*>(v_sh);
    for (int c = lane; c < (d >> 2); c += 32) {
      const float4 a = __ldg(r4 + c);
      const float4 b = v4[c];
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
  } else {
    for (int c = lane; c < d; c += 32) acc = fmaf(__ldg(row + c), v_sh[c], acc);
  }
  return warp_sum(acc);
}

}  // namespace repro
