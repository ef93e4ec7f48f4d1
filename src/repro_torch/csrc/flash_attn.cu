// flash_attn: causal / sliding-window attention forward with an online
// softmax, grouped-query heads, fp32 or bf16 inputs, fp32 accumulation.
//
//   out[b, i, h] = sum_t softmax_t(q[b, i, h] . k[b, t, g] / sqrt(hd)) v[b, t, g]
//   over t <= q_offset + i (and t > q_offset + i - window), g = h / (H / KV)
//
// Replaces the TPU kernel _flash_kernel (src/repro/kernels/flash_attn/
// kernel.py:34, launched by flash_attention_head :83 -> pallas_call :105 and
// vmapped over batch and heads by ops.py:16).  The arithmetic is the Pallas
// kernel's: scores accumulate in fp32 and are scaled by 1/sqrt(hd); per kv
// tile m' = max(m, rowmax s), p = exp(s - m'), corr = exp(m - m'),
// l' = l corr + sum p, acc' = acc corr + round(p to v's type) . v; the row
// is written as acc / max(l, 1e-30) in v's type.  The semantics of a row
// with no key in its window are the plain reference's
// (src/repro/kernels/flash_attn/ref.py:19): it is 0.  The Pallas kernel's
// finite -1e30 mask gives every masked p the value 1 there and returns the
// mean of v; here masked scores are -inf, a tile whose running max is still
// -inf contributes p = 0 and corr = 1, so such a row ends with acc = 0.
//
// What bounds it on the H100: operations.  Per (query, key) pair in the
// window it does 2*hd flops for the score and 2*hd for p.v; it reads q, k, v
// and writes out once, far fewer bytes than that at these shapes (causal
// S = T = 4096, hd 64: 6.9e10 flops against 84 MB).  This kernel computes on
// the fp32 units (67 TFLOP/s); the tensor cores (989 TFLOP/s dense bf16) are
// a later PR's.
//
// Design: one block of 8 warps per (q tile of 64 rows, head, batch).  The q
// tile sits in shared memory as fp32; each warp owns 8 of its rows and keeps,
// per row, the running max, the denominator and hd/32 accumulators per lane
// (columns lane + 32 t) in registers.  The kv range of the tile's windows is
// walked in tiles of 32 keys, staged in shared memory as fp32 (k rows padded
// to hd + 4 floats, so the lanes' float4 reads of 32 different rows hit
// distinct banks); tiles wholly outside every row's window are never loaded.
// Scores: lane j computes key j's score for the warp's 8 rows, each k float4
// read from shared memory serving all 8.  p.v: the warp's p values go through
// shared memory and are read back as broadcast float4s; each v value a lane
// reads serves 8 rows.
//
// Shared memory, hd = 256: q 64 x 256 fp32 (64 KiB) + k 32 x 260 (32.5 KiB)
// + v 32 x 256 (32 KiB) + p 8 warps x 8 rows x 32 (8 KiB) = 136.5 KiB of the
// 227 KiB a block may opt into; hd = 64 takes 40.5 KiB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kQTile = kWarps * kRowsPerWarp;  // 64 query rows per block
constexpr int kKTile = 32;                     // keys per kv tile, one per lane

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// DPL = hd / 32: the columns each lane accumulates.
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads) flash_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, int S, int T_,
    int H, int KV, float scale, int q_offset, int window, T* __restrict__ out) {
  constexpr int HD = DPL * 32;
  constexpr int KS = HD + 4;  // padded k row stride (floats)
  extern __shared__ float4 smem4[];
  float* q_sh = reinterpret_cast<float*>(smem4);   // [kQTile][HD]
  float* k_sh = q_sh + kQTile * HD;                // [kKTile][KS]
  float* v_sh = k_sh + kKTile * KS;                // [kKTile][HD]
  float* p_sh = v_sh + kKTile * HD;                // [kWarps][kRowsPerWarp][kKTile]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kQTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const size_t q_stride = static_cast<size_t>(H) * HD;   // between sequence positions
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const T* qb = q + static_cast<size_t>(b) * S * q_stride + static_cast<size_t>(h) * HD;
  const T* kb = k + static_cast<size_t>(b) * T_ * kv_stride + static_cast<size_t>(g) * HD;
  const T* vb = v + static_cast<size_t>(b) * T_ * kv_stride + static_cast<size_t>(g) * HD;
  T* ob = out + static_cast<size_t>(b) * S * q_stride + static_cast<size_t>(h) * HD;

  for (int idx = tid; idx < kQTile * HD; idx += kThreads) {
    const int r = idx / HD, c = idx % HD;
    const int row = row0 + r;
    q_sh[idx] = row < S ? to_f32(qb[static_cast<size_t>(row) * q_stride + c]) : 0.f;
  }

  // the keys some row of this tile may see: [t_lo, t_hi]
  const int last_row = min(row0 + kQTile, S) - 1;
  const int t_hi = min(T_ - 1, q_offset + last_row);
  const int t_lo = window > 0 ? max(0, q_offset + row0 - window + 1) : 0;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[r][t] = 0.f;
  }
  const int wrow0 = row0 + warp * kRowsPerWarp;  // this warp's first row
  float* pw = p_sh + warp * kRowsPerWarp * kKTile;

  for (int t0 = (t_lo / kKTile) * kKTile; t0 <= t_hi; t0 += kKTile) {
    __syncthreads();  // the previous tile's readers are done (and q is staged)
    for (int idx = tid; idx < kKTile * HD; idx += kThreads) {
      const int j = idx / HD, c = idx % HD;
      const int t = t0 + j;
      const bool in = t < T_;
      k_sh[j * KS + c] = in ? to_f32(kb[static_cast<size_t>(t) * kv_stride + c]) : 0.f;
      v_sh[idx] = in ? to_f32(vb[static_cast<size_t>(t) * kv_stride + c]) : 0.f;
    }
    __syncthreads();

    // scores: lane = key
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(k_sh + lane * KS);
#pragma unroll 4
    for (int c4 = 0; c4 < HD / 4; ++c4) {
      const float4 kk = k4[c4];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qq =
            reinterpret_cast<const float4*>(q_sh + (warp * kRowsPerWarp + r) * HD)[c4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    // online softmax, one row at a time across the warp
    const int t = t0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qpos = q_offset + wrow0 + r;
      const bool ok = wrow0 + r < S && t < T_ && t <= qpos && (window <= 0 || t > qpos - window);
      const float sr = ok ? s[r] * scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = sr == -INFINITY ? 0.f : expf(sr - m_new);
      const float corr = m_new == -INFINITY ? 1.f : expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
      pw[r * kKTile + lane] = to_f32(from_f32<T>(p));
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= corr;
    }
    __syncwarp();

    // acc += p . v: each v value serves the warp's rows
#pragma unroll 2
    for (int j4 = 0; j4 < kKTile / 4; ++j4) {
      float4 p4[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        p4[r] = reinterpret_cast<const float4*>(pw + r * kKTile)[j4];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vr = v_sh + (4 * j4 + jj) * HD + lane;
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const float vv = vr[32 * c];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const float pj = jj == 0 ? p4[r].x : jj == 1 ? p4[r].y : jj == 2 ? p4[r].z : p4[r].w;
            acc[r][c] = fmaf(pj, vv, acc[r][c]);
          }
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = wrow0 + r;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = ob + static_cast<size_t>(row) * q_stride;
#pragma unroll
    for (int c = 0; c < DPL; ++c) orow[lane + 32 * c] = from_f32<T>(acc[r][c] * inv);
  }
}

template <typename T, int DPL>
int launch_hd(const T* q, const T* k, const T* v, int B, int S, int T_, int H, int KV,
              float scale, int q_offset, int window, T* out, cudaStream_t stream) {
  constexpr int HD = DPL * 32;
  const size_t smem = sizeof(float) * (kQTile * HD + kKTile * (HD + 4) + kKTile * HD +
                                       kWarps * kRowsPerWarp * kKTile);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(flash_attn_kernel<T, DPL>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  }
  const dim3 grid((S + kQTile - 1) / kQTile, H, B);
  flash_attn_kernel<T, DPL><<<grid, kThreads, smem, stream>>>(q, k, v, S, T_, H, KV, scale,
                                                              q_offset, window, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, int B, int S, int T_, int H, int KV,
           int hd, float scale, int q_offset, int window, void* out, void* stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_hd<T, 1>(qt, kt, vt, B, S, T_, H, KV, scale, q_offset, window, ot, st);
    case 64: return launch_hd<T, 2>(qt, kt, vt, B, S, T_, H, KV, scale, q_offset, window, ot, st);
    case 128: return launch_hd<T, 4>(qt, kt, vt, B, S, T_, H, KV, scale, q_offset, window, ot, st);
    case 256: return launch_hd<T, 8>(qt, kt, vt, B, S, T_, H, KV, scale, q_offset, window, ot, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out: [B, S, H, hd]; k, v: [B, T, KV, hd]; window <= 0: causal only.
extern "C" int flash_attn_f32(const void* q, const void* k, const void* v, int B, int S, int T,
                              int H, int KV, int hd, float scale, int q_offset, int window,
                              void* out, void* stream) {
  return launch<float>(q, k, v, B, S, T, H, KV, hd, scale, q_offset, window, out, stream);
}

extern "C" int flash_attn_bf16(const void* q, const void* k, const void* v, int B, int S,
                               int T, int H, int KV, int hd, float scale, int q_offset,
                               int window, void* out, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, B, S, T, H, KV, hd, scale, q_offset, window, out,
                               stream);
}
