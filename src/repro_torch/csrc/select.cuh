// Device helpers shared by the port's kernels: the two rank-counting
// selectors that carry the JAX package's tie rules, and the one-warp gathered
// dot products over fp32 rows and int8 codes.
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

// Key of a score in lax.top_k's total order: +0.0 above -0.0, every other
// pair as the floats compare (core/similarity.py::order_key).
__device__ __forceinline__ int order_key(float s) {
  const int b = __float_as_int(s);
  return b < 0 ? b ^ 0x7fffffff : b;
}

// precedes() in that total order: the order of lax.top_k, where lax.sort
// (and so commit_merge) keeps -0.0 and +0.0 equal.
__device__ __forceinline__ bool precedes_total(float sa, int ka, float sb, int kb) {
  const int a = order_key(sa), b = order_key(sb);
  return a > b || (a == b && ka < kb);
}

// lax.top_k / masked_top_l order (src/repro/kernels/topk_merge/kernel.py:23):
// rank of candidate i of s[0, n) by score descending, +0.0 above -0.0, the
// first occurrence winning exact ties (-inf slots included).
__device__ __forceinline__ int rank_first_occurrence(const float* s, int n, int i) {
  const int ki = order_key(s[i]);
  int r = 0;
  for (int j = 0; j < n; ++j) {
    const int kj = order_key(s[j]);
    r += kj > ki || (kj == ki && j < i);
  }
  return r;
}

// lax.top_k's order as one 64-bit key that sorts ascending: the score's
// order_key descending in the high word (+0.0 above -0.0), the candidate's
// position ascending in the low word (the first occurrence wins an exact tie).
// Distinct positions make the order strict, the order of
// rank_first_occurrence; score and position come back out of the key
// exactly.  kTopkPad sorts after every key.
constexpr unsigned long long kTopkPad = ~0ull;

// order_key(s) ^ 0x7fffffff as an unsigned word: the larger the key, the
// smaller the word
__device__ __forceinline__ unsigned topk_rank_word(float s) {
  const unsigned b = __float_as_uint(s);
  return b >> 31 ? b : b ^ 0x7fffffffu;
}

__device__ __forceinline__ float topk_word_score(unsigned w) {
  return __uint_as_float(w >> 31 ? w : w ^ 0x7fffffffu);
}

__device__ __forceinline__ unsigned long long topk_key(float s, int pos) {
  return (static_cast<unsigned long long>(topk_rank_word(s)) << 32) | static_cast<unsigned>(pos);
}

__device__ __forceinline__ int topk_key_pos(unsigned long long key) {
  return static_cast<int>(static_cast<unsigned>(key));
}

__device__ __forceinline__ float topk_key_score(unsigned long long key) {
  return topk_word_score(static_cast<unsigned>(key >> 32));
}

// Sorts the NL * E keys of a row ascending, where NL lanes (an aligned
// group of the warp) hold E keys each: key e of the group's lane ``sub`` sits
// at position sub * E + e.  A bitonic network: the exchanges across a
// distance below E stay in the lane, the others are shuffles within the group.
template <int NL, int E>
__device__ __forceinline__ void row_sort_keys(unsigned long long (&key)[E], int sub) {
#pragma unroll
  for (int k = 2; k <= NL * E; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j < E) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e & j) continue;
          const bool up = ((sub * E + e) & k) == 0;  // this block of k sorts ascending
          const unsigned long long a = key[e], b = key[e | j];
          const bool swap = (a > b) == up;
          key[e] = swap ? b : a;
          key[e | j] = swap ? a : b;
        }
        continue;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const unsigned long long other = __shfl_xor_sync(kFullMask, key[e], j / E);
        const int x = sub * E + e;
        const bool keep_min = ((x & k) == 0) == ((x & j) == 0);
        key[e] = (key[e] < other) == keep_min ? key[e] : other;
      }
    }
  }
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

// warp_dot over one row of int8 codes (d % 4 == 0: rows start on 4-byte
// boundaries and load as char4).  The codes are cast to float and FMA'd in
// the same order as warp_dot; the caller multiplies the sum by the row's
// scale once, so every scorer of the int8 store does the same arithmetic.
__device__ __forceinline__ float warp_dot_i8(const float* __restrict__ v_sh,
                                             const signed char* __restrict__ row,
                                             int d, int lane) {
  float acc = 0.f;
  if ((d & 3) == 0) {
    const char4* r4 = reinterpret_cast<const char4*>(row);
    const float4* v4 = reinterpret_cast<const float4*>(v_sh);
    for (int c = lane; c < (d >> 2); c += 32) {
      const char4 a = __ldg(r4 + c);
      const float4 b = v4[c];
      acc = fmaf(static_cast<float>(a.x), b.x, acc);
      acc = fmaf(static_cast<float>(a.y), b.y, acc);
      acc = fmaf(static_cast<float>(a.z), b.z, acc);
      acc = fmaf(static_cast<float>(a.w), b.w, acc);
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      acc = fmaf(static_cast<float>(__ldg(row + c)), v_sh[c], acc);
    }
  }
  return warp_sum(acc);
}

// The score of row ``id`` under each item store: the fp32 dot, or the int8
// convention (q . codes[id]) * scales[id] -- one multiply after the dot,
// never folded into the query or the row.
__device__ __forceinline__ float row_score(const float* __restrict__ q_sh,
                                           const float* __restrict__ items,
                                           const float* __restrict__ /*scales*/,
                                           int id, int d, int lane) {
  return warp_dot(q_sh, items + static_cast<size_t>(id) * d, d, lane);
}

__device__ __forceinline__ float row_score(const float* __restrict__ q_sh,
                                           const signed char* __restrict__ codes,
                                           const float* __restrict__ scales,
                                           int id, int d, int lane) {
  return warp_dot_i8(q_sh, codes + static_cast<size_t>(id) * d, d, lane) * __ldg(scales + id);
}

// Chunk c of a row (4 values: a float4, or a char4 of codes), its four FMAs
// in warp_dot's order, and the row's scale (1 for fp32 rows).
__device__ __forceinline__ float4 row_chunk(const float* __restrict__ row, int c) {
  return __ldg(reinterpret_cast<const float4*>(row) + c);
}
__device__ __forceinline__ char4 row_chunk(const signed char* __restrict__ row, int c) {
  return __ldg(reinterpret_cast<const char4*>(row) + c);
}
__device__ __forceinline__ float fma_chunk(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float fma_chunk(char4 a, float4 b, float acc) {
  acc = fmaf(static_cast<float>(a.x), b.x, acc);
  acc = fmaf(static_cast<float>(a.y), b.y, acc);
  acc = fmaf(static_cast<float>(a.z), b.z, acc);
  return fmaf(static_cast<float>(a.w), b.w, acc);
}
__device__ __forceinline__ float row_scale(const float* /*scales*/, const float* /*rows*/,
                                           int /*id*/) {
  return 1.f;
}
__device__ __forceinline__ float row_scale(const float* __restrict__ scales,
                                           const signed char* /*rows*/, int id) {
  return __ldg(scales + id);
}
__device__ __forceinline__ float scaled(float sum, float /*scale*/, const float* /*rows*/) {
  return sum;
}
__device__ __forceinline__ float scaled(float sum, float scale, const signed char* /*rows*/) {
  return sum * scale;
}

// row_score of R rows by one warp (d % 4 == 0), with every load of the R
// rows, their scales and the query's chunks issued before the first FMA:
// s[r] = row_score(q, rows, scales, id[r], d, lane) bit for bit where ok[r],
// -inf elsewhere (a row not ok loads nothing).  Each lane FMAs its chunks
// c = lane, lane + 32, ... of a row in order, the R xor trees run
// interleaved, and an int8 sum is multiplied by its scale once.  A round
// keeps V chunks a lane a row in flight (d <= 128 V in one round); ``q``
// is 16-byte aligned, in shared or global memory.
template <int R, int V, typename Row>
__device__ __forceinline__ void score_rows(const float* __restrict__ q,
                                           const Row* __restrict__ rows,
                                           const float* __restrict__ scales, int d, int lane,
                                           const int (&id)[R], const bool (&ok)[R],
                                           float (&s)[R]) {
  using Chunk = decltype(row_chunk(rows, 0));
  const int d4 = d >> 2;
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const Row* row[R];
  float sc[R], acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = rows + static_cast<size_t>(max(id[r], 0)) * d;
    sc[r] = ok[r] ? row_scale(scales, rows, id[r]) : 1.f;
    acc[r] = 0.f;
  }
  for (int c0 = 0; c0 < d4; c0 += 32 * V) {
    Chunk v[R][V];
    float4 b[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int c = c0 + lane + 32 * u;
      if (c < d4) {
        b[u] = q4[c];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (ok[r]) v[r][u] = row_chunk(row[r], c);
        }
      }
    }
    // a row's chunks before the next row's: its codes are cast and used
    // together, which frees their registers sooner
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        if (ok[r] && c0 + lane + 32 * u < d4) {
          acc[r] = fma_chunk(v[r][u], b[u], acc[r]);
        }
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] += __shfl_xor_sync(kFullMask, acc[r], o);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = ok[r] ? scaled(acc[r], sc[r], rows) : -INFINITY;
}

}  // namespace repro
