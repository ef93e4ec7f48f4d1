// flash_attn_bwd: the backward of csrc/flash_attn.cu's causal / sliding-window
// attention with grouped-query heads, fp32 (flash_attn_bwd_f32) or bf16
// (flash_attn_bwd_bf16) inputs and outputs, fp32 arithmetic.
//
//   delta[i]  = sum_c do[i, c] out[i, c]
//   p[i, t]   = exp(q[i] . k[t] / sqrt(hd) - lse[i])   (0 where t is masked)
//   ds[i, t]  = p[i, t] (do[i] . v[t] - delta[i]), rounded to q's type
//   dq[i]     = sum_t ds[i, t] k[t] / sqrt(hd)
//   dk[t]     = sum_{i, heads of t's group} ds[i, t] q[i] / sqrt(hd)
//   dv[t]     = sum_{i, heads of t's group} p[i, t] do[i]
//
// Replaces no Pallas kernel: the JAX package's attention backward is the
// custom VJP _attend_flash_bwd (src/repro/models/layers.py:235), a scan over
// kv chunks that recomputes each score tile from the forward's row
// statistics.  Here the statistic is one fp32 log-sum-exp a row (lse,
// written by the forward kernels); the semantics and casts are the plain
// version's (kernels/flash_attn/ref.py: flash_attention_bwd_ref): scores,
// dp and every sum in fp32, ds rounded to q's type before the dq and dk
// products, dv from fp32 p.
//
// What bounds it on the H100: operations.  Each (query, key) pair in the
// window needs five hd-long products (s, dp, dq, dk, dv: 10 hd flops); this
// design recomputes s and dp in both kernels, 14 hd flops a pair, on the
// CUDA cores' fp32 FMAs (67 TFLOP/s) for both input types: bf16 values are
// widened to fp32 as they are staged in shared memory.  A tensor-core design
// (wgmma on bf16, TMA) is later work (ROADMAP Queue 2).
//
// Three kernels, launched in order on the caller's stream:
//   delta_kernel: one warp a (batch, position, head) row.
//   dkv_kernel: one block a (64 keys, kv head, batch) (32 keys at hd 256).
//     Its k and v tile stay in shared memory while it walks the query heads
//     of its group and, for each, the query tiles whose causal / window range
//     reaches its keys; dk and dv are accumulated in registers and written
//     once, so the sum over the group's heads needs no atomics.
//   dq_kernel: one block a (64 query rows, head, batch); it walks the kv
//     tiles in its rows' range, the tiles with the most keys launched first,
//     and writes dq once.
// Both tile kernels run two register-tiled stages a tile, with 256 threads:
//   scores: thread (to, ti) of a 16 x 16 grid computes the outer rows to +
//     16 r against the inner rows ti + 16 u (s and dp together, float4 reads
//     along hd from rows padded by 4 floats), masks, forms p and ds and
//     writes them transposed, [inner][outer], to shared memory;
//   sums: a thread owns 2 or 4 consecutive outer rows and 4-column chunks of
//     hd, and for each inner row adds p (or ds) times that row of do, q or k.
// Every output element is summed by one thread in a fixed order: two runs
// give the same bits.  Shared memory, dq at hd 256 (the largest): q and do
// 64 rows, k and v 32 rows, x 260 floats, and ds: 210 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16 bytes of global memory as floats (4 fp32 or 8 bf16 values); rounding to
// the type; 4 floats stored as the type.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
  }
  __device__ static float round(float x) { return x; }
  __device__ static void store4(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x, out[2 * i + 1] = f.y;
    }
  }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
  __device__ static void store4(__nv_bfloat16* p, const float* in) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(in[0], in[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(in[2], in[3]);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

// N = 4 or 2 consecutive floats of shared memory (16- or 8-byte aligned).
template <int N>
__device__ __forceinline__ void load_chunk(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x, out[1] = x.y;
  }
}

// Row stride of a transposed [inner][outer] p / ds buffer: rows ti and ti + 1
// of one store fall in opposite halves of the banks.
__host__ __device__ constexpr int ts_stride(int outer) { return outer + 16; }

// Tiles by head dim.  kS: row stride of a staged [rows][hd] tile (floats).
// dq_kernel: kQO query rows a block, kQI keys a kv tile; dkv_kernel: kKO keys
// a block, kKI query rows a q tile.  The sums stage: kNC threads across hd
// (kNCH chunks of 4 columns each), kNR across the outer rows.
template <int HD>
struct Cfg {
  static constexpr int kS = HD + 4;
  static constexpr int kQO = 64, kQI = HD <= 128 ? 64 : 32;
  static constexpr int kKO = HD <= 128 ? 64 : 32, kKI = kKO;
  static constexpr int kNC = HD / 4 < 16 ? HD / 4 : 16;
  static constexpr int kNR = kThreads / kNC;
  static constexpr int kNCH = HD / (4 * kNC);
  static constexpr size_t kDqSmem =
      sizeof(float) * (static_cast<size_t>(2 * kQO + 2 * kQI) * kS + kQI * ts_stride(kQO));
  static constexpr size_t kDkvSmem =
      sizeof(float) *
      (static_cast<size_t>(2 * kKO + 2 * kKI) * kS + 2 * kKI * ts_stride(kKO) + 2 * kKI);
};

// Rows [0, rows) of a [positions][stride] tensor (rows past ``valid`` are 0)
// into shared memory as fp32 [rows][HD + 4].
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                                          size_t stride, int rows, int valid) {
  constexpr int N = Vec<T>::kN, PER = HD / N;
  for (int idx = threadIdx.x; idx < rows * PER; idx += kThreads) {
    const int r = idx / PER, c = (idx % PER) * N;
    float x[N];
    if (r < valid) {
      Vec<T>::load(src + r * stride + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      *reinterpret_cast<float4*>(dst + r * (HD + 4) + c + e) =
          make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    }
  }
}

// x[r][u] = a1[to + 16 r] . b1[ti + 16 u], y[r][u] = a2[to + 16 r] . b2[ti + 16 u]
// over hd, from staged tiles.
template <int HD, int RO, int RI>
__device__ __forceinline__ void dots(const float* __restrict__ a1, const float* __restrict__ a2,
                                     const float* __restrict__ b1, const float* __restrict__ b2,
                                     int to, int ti, float (&x)[RO][RI], float (&y)[RO][RI]) {
  constexpr int S4 = (HD + 4) / 4;
#pragma unroll
  for (int r = 0; r < RO; ++r) {
#pragma unroll
    for (int u = 0; u < RI; ++u) x[r][u] = y[r][u] = 0.f;
  }
  const float4* a14 = reinterpret_cast<const float4*>(a1) + to * S4;
  const float4* a24 = reinterpret_cast<const float4*>(a2) + to * S4;
  const float4* b14 = reinterpret_cast<const float4*>(b1) + ti * S4;
  const float4* b24 = reinterpret_cast<const float4*>(b2) + ti * S4;
#pragma unroll 2
  for (int c = 0; c < HD / 4; ++c) {
    float4 p1[RI], p2[RI];
#pragma unroll
    for (int u = 0; u < RI; ++u) {
      p1[u] = b14[16 * u * S4 + c];
      p2[u] = b24[16 * u * S4 + c];
    }
#pragma unroll
    for (int r = 0; r < RO; ++r) {
      const float4 q1 = a14[16 * r * S4 + c], q2 = a24[16 * r * S4 + c];
#pragma unroll
      for (int u = 0; u < RI; ++u) {
        x[r][u] = fmaf(q1.x, p1[u].x, x[r][u]);
        x[r][u] = fmaf(q1.y, p1[u].y, x[r][u]);
        x[r][u] = fmaf(q1.z, p1[u].z, x[r][u]);
        x[r][u] = fmaf(q1.w, p1[u].w, x[r][u]);
        y[r][u] = fmaf(q2.x, p2[u].x, y[r][u]);
        y[r][u] = fmaf(q2.y, p2[u].y, y[r][u]);
        y[r][u] = fmaf(q2.z, p2[u].z, y[r][u]);
        y[r][u] = fmaf(q2.w, p2[u].w, y[r][u]);
      }
    }
  }
}

__device__ __forceinline__ bool visible(int t, int pos, int T_, int window) {
  return t < T_ && t <= pos && (window <= 0 || t > pos - window);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) delta_kernel(const T* __restrict__ out,
                                                         const T* __restrict__ dout,
                                                         size_t rows, int S, int H,
                                                         float* __restrict__ delta) {
  const size_t row = static_cast<size_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + row * HD;
  const T* d = dout + row * HD;
  float sum = 0.f;
  for (int c = lane; c < HD; c += 32) sum = fmaf(to_float(d[c]), to_float(o[c]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {  // rows are [B, S, H]; delta is [B, H, S]
    const size_t b = row / (static_cast<size_t>(S) * H);
    const int s = static_cast<int>(row / H % S), h = static_cast<int>(row % H);
    delta[(b * H + h) * S + s] = sum;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    int S, int T_, int H, int KV, float scale_log2, float scale, int q_offset, int window,
    T* __restrict__ dk, T* __restrict__ dv) {
  using C = Cfg<HD>;
  constexpr int BO = C::kKO, BI = C::kKI, RO = BO / 16, RI = BI / 16, SS = C::kS;
  constexpr int TS = ts_stride(BO), RA = BO / C::kNR, NC = C::kNC, NCH = C::kNCH;
  extern __shared__ float4 smem4[];
  float* k_sh = reinterpret_cast<float*>(smem4);  // [BO][SS]
  float* v_sh = k_sh + BO * SS;                   // [BO][SS]
  float* q_sh = v_sh + BO * SS;                   // [BI][SS]
  float* do_sh = q_sh + BI * SS;                  // [BI][SS]
  float* p_sh = do_sh + BI * SS;                  // [BI][TS]
  float* ds_sh = p_sh + BI * TS;                  // [BI][TS]
  float* lse_sh = ds_sh + BI * TS;                // [BI], log2 units
  float* delta_sh = lse_sh + BI;                  // [BI]

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BO, grp = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const size_t qs = static_cast<size_t>(H) * HD, ks = static_cast<size_t>(KV) * HD;
  const size_t kv_at = static_cast<size_t>(b) * T_ * ks + static_cast<size_t>(grp) * HD;
  load_tile<T, HD>(k_sh, k + kv_at + k0 * ks, ks, BO, T_ - k0);
  load_tile<T, HD>(v_sh, v + kv_at + k0 * ks, ks, BO, T_ - k0);

  // the query rows that see some key of the tile: [i_lo, i_hi], in q tiles
  const int k_last = min(k0 + BO, T_) - 1;
  const int i_lo = max(0, k0 - q_offset);
  const int i_hi = window > 0 ? min(S - 1, k_last - q_offset + window - 1) : S - 1;
  const int first = i_lo / BI;
  const int ntiles = i_hi >= i_lo ? i_hi / BI - first + 1 : 0;

  const int to = tid % 16, ti = tid / 16;
  const int cg = tid % NC, ro = tid / NC;
  float acc_k[RA][4 * NCH], acc_v[RA][4 * NCH];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
#pragma unroll
    for (int c = 0; c < 4 * NCH; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;
  }

  for (int gi = 0; gi < G; ++gi) {
    const int h = grp * G + gi;
    const T* qh = q + static_cast<size_t>(b) * S * qs + static_cast<size_t>(h) * HD;
    const T* doh = dout + static_cast<size_t>(b) * S * qs + static_cast<size_t>(h) * HD;
    const size_t stat = (static_cast<size_t>(b) * H + h) * S;
    for (int it = 0; it < ntiles; ++it) {
      const int r0 = (first + it) * BI;
      __syncthreads();  // the last tile's reads are done
      load_tile<T, HD>(q_sh, qh + r0 * qs, qs, BI, S - r0);
      load_tile<T, HD>(do_sh, doh + r0 * qs, qs, BI, S - r0);
      for (int i = tid; i < BI; i += kThreads) {
        const bool in = r0 + i < S;
        lse_sh[i] = in ? lse[stat + r0 + i] * kLog2e : 0.f;
        delta_sh[i] = in ? delta[stat + r0 + i] : 0.f;
      }
      __syncthreads();

      float x[RO][RI], y[RO][RI];
      dots<HD, RO, RI>(k_sh, v_sh, q_sh, do_sh, to, ti, x, y);
#pragma unroll
      for (int u = 0; u < RI; ++u) {
        const int i = ti + 16 * u, row = r0 + i;
        const float l2 = lse_sh[i], dl = delta_sh[i];
#pragma unroll
        for (int r = 0; r < RO; ++r) {
          const int o = to + 16 * r;
          const bool ok = row < S && visible(k0 + o, q_offset + row, T_, window);
          const float p = ok ? exp2f(fmaf(x[r][u], scale_log2, -l2)) : 0.f;
          p_sh[i * TS + o] = p;
          ds_sh[i * TS + o] = Vec<T>::round(p * (y[r][u] - dl));
        }
      }
      __syncthreads();

      // dv[o] += p[i, o] do[i], dk[o] += ds[i, o] q[i]
#pragma unroll 4
      for (int i = 0; i < BI; ++i) {
        float pv[RA], dsv[RA];
        load_chunk<RA>(p_sh + i * TS + RA * ro, pv);
        load_chunk<RA>(ds_sh + i * TS + RA * ro, dsv);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          float dov[4], qv[4];
          load_chunk<4>(do_sh + i * SS + 4 * (cg + NC * ch), dov);
          load_chunk<4>(q_sh + i * SS + 4 * (cg + NC * ch), qv);
#pragma unroll
          for (int a = 0; a < RA; ++a) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc_v[a][4 * ch + e] = fmaf(pv[a], dov[e], acc_v[a][4 * ch + e]);
              acc_k[a][4 * ch + e] = fmaf(dsv[a], qv[e], acc_k[a][4 * ch + e]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int t = k0 + RA * ro + a;
    if (t >= T_) continue;
    T* dkr = dk + kv_at + t * ks;
    T* dvr = dv + kv_at + t * ks;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      float kk[4], vv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        kk[e] = acc_k[a][4 * ch + e] * scale;
        vv[e] = acc_v[a][4 * ch + e];
      }
      Vec<T>::store4(dkr + 4 * (cg + NC * ch), kk);
      Vec<T>::store4(dvr + 4 * (cg + NC * ch), vv);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    int S, int T_, int H, int KV, float scale_log2, float scale, int q_offset, int window,
    T* __restrict__ dq) {
  using C = Cfg<HD>;
  constexpr int BO = C::kQO, BI = C::kQI, RO = BO / 16, RI = BI / 16, SS = C::kS;
  constexpr int TS = ts_stride(BO), RA = BO / C::kNR, NC = C::kNC, NCH = C::kNCH;
  extern __shared__ float4 smem4[];
  float* q_sh = reinterpret_cast<float*>(smem4);  // [BO][SS]
  float* do_sh = q_sh + BO * SS;                  // [BO][SS]
  float* k_sh = do_sh + BO * SS;                  // [BI][SS]
  float* v_sh = k_sh + BI * SS;                   // [BI][SS]
  float* ds_sh = v_sh + BI * SS;                  // [BI][TS]

  const int tid = threadIdx.x;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BO;  // the rows with most keys first
  const int h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (H / KV);
  const size_t qs = static_cast<size_t>(H) * HD, ks = static_cast<size_t>(KV) * HD;
  const size_t q_at = static_cast<size_t>(b) * S * qs + static_cast<size_t>(h) * HD;
  const size_t kv_at = static_cast<size_t>(b) * T_ * ks + static_cast<size_t>(grp) * HD;
  load_tile<T, HD>(q_sh, q + q_at + row0 * qs, qs, BO, S - row0);
  load_tile<T, HD>(do_sh, dout + q_at + row0 * qs, qs, BO, S - row0);

  const int to = tid % 16, ti = tid / 16;
  const size_t stat = (static_cast<size_t>(b) * H + h) * S;
  float l2[RO], dl[RO];
#pragma unroll
  for (int r = 0; r < RO; ++r) {
    const int row = row0 + to + 16 * r;
    l2[r] = row < S ? lse[stat + row] * kLog2e : 0.f;
    dl[r] = row < S ? delta[stat + row] : 0.f;
  }

  // the keys some row of this tile may see: [t_lo, t_hi], in kv tiles
  const int last_row = min(row0 + BO, S) - 1;
  const int t_hi = min(T_ - 1, q_offset + last_row);
  const int t_lo = window > 0 ? max(0, q_offset + row0 - window + 1) : 0;
  const int first = t_lo / BI;
  const int ntiles = t_hi >= t_lo ? t_hi / BI - first + 1 : 0;

  const int cg = tid % NC, ro = tid / NC;
  float acc[RA][4 * NCH];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
#pragma unroll
    for (int c = 0; c < 4 * NCH; ++c) acc[a][c] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = (first + it) * BI;
    __syncthreads();  // the last tile's reads are done
    load_tile<T, HD>(k_sh, k + kv_at + t0 * ks, ks, BI, T_ - t0);
    load_tile<T, HD>(v_sh, v + kv_at + t0 * ks, ks, BI, T_ - t0);
    __syncthreads();

    float x[RO][RI], y[RO][RI];
    dots<HD, RO, RI>(q_sh, do_sh, k_sh, v_sh, to, ti, x, y);
#pragma unroll
    for (int r = 0; r < RO; ++r) {
      const int o = to + 16 * r, row = row0 + o;
#pragma unroll
      for (int u = 0; u < RI; ++u) {
        const int i = ti + 16 * u;
        const bool ok = row < S && visible(t0 + i, q_offset + row, T_, window);
        const float p = ok ? exp2f(fmaf(x[r][u], scale_log2, -l2[r])) : 0.f;
        ds_sh[i * TS + o] = Vec<T>::round(p * (y[r][u] - dl[r]));
      }
    }
    __syncthreads();

    // dq[o] += ds[i, o] k[i]
#pragma unroll 4
    for (int i = 0; i < BI; ++i) {
      float dsv[RA];
      load_chunk<RA>(ds_sh + i * TS + RA * ro, dsv);
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        float kv[4];
        load_chunk<4>(k_sh + i * SS + 4 * (cg + NC * ch), kv);
#pragma unroll
        for (int a = 0; a < RA; ++a) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][4 * ch + e] = fmaf(dsv[a], kv[e], acc[a][4 * ch + e]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int row = row0 + RA * ro + a;
    if (row >= S) continue;
    T* dqr = dq + q_at + row * qs;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = acc[a][4 * ch + e] * scale;
      Vec<T>::store4(dqr + 4 * (cg + NC * ch), o);
    }
  }
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const void* lse, int B, int S, int T_, int H, int KV, float scale, int q_offset,
               int window, void* delta, void* dq, void* dk, void* dv, cudaStream_t stream) {
  using C = Cfg<HD>;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  cudaError_t err = cudaFuncSetAttribute(dkv_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::kDkvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kDqSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t rows = static_cast<size_t>(B) * S * H;
  const unsigned row_blocks = static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  delta_kernel<T, HD><<<row_blocks, kThreads, 0, stream>>>(static_cast<const T*>(out), dot, rows,
                                                           S, H, df);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = scale * kLog2e;
  dkv_kernel<T, HD><<<dim3((T_ + C::kKO - 1) / C::kKO, KV, B), kThreads, C::kDkvSmem, stream>>>(
      qt, kt, vt, dot, lf, df, S, T_, H, KV, scale_log2, scale, q_offset, window,
      static_cast<T*>(dk), static_cast<T*>(dv));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, HD><<<dim3((S + C::kQO - 1) / C::kQO, H, B), kThreads, C::kDqSmem, stream>>>(
      qt, kt, vt, dot, lf, df, S, T_, H, KV, scale_log2, scale, q_offset, window,
      static_cast<T*>(dq));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* out, const void* dout,
             const void* lse, int B, int S, int T_, int H, int KV, int hd, float scale,
             int q_offset, int window, void* delta, void* dq, void* dk, void* dv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch_bwd<T, 32>(q, k, v, out, dout, lse, B, S, T_, H, KV, scale, q_offset, window,
                               delta, dq, dk, dv, st);
    case 64:
      return launch_bwd<T, 64>(q, k, v, out, dout, lse, B, S, T_, H, KV, scale, q_offset, window,
                               delta, dq, dk, dv, st);
    case 128:
      return launch_bwd<T, 128>(q, k, v, out, dout, lse, B, S, T_, H, KV, scale, q_offset,
                                window, delta, dq, dk, dv, st);
    case 256:
      return launch_bwd<T, 256>(q, k, v, out, dout, lse, B, S, T_, H, KV, scale, q_offset,
                                window, delta, dq, dk, dv, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out, dout, dq: [B, S, H, hd]; k, v, dk, dv: [B, T, KV, hd] (16-byte
// aligned); lse: [B, H, S] fp32 from the forward; delta: [B, H, S] fp32
// scratch; window <= 0: causal only.  S, T > 0.
extern "C" int flash_attn_bwd_f32(const void* q, const void* k, const void* v, const void* out,
                                  const void* dout, const void* lse, int B, int S, int T, int H,
                                  int KV, int hd, float scale, int q_offset, int window,
                                  void* delta, void* dq, void* dk, void* dv, void* stream) {
  return dispatch<float>(q, k, v, out, dout, lse, B, S, T, H, KV, hd, scale, q_offset, window,
                         delta, dq, dk, dv, stream);
}

// The same for bf16 q, k, v, out, dout and gradients.
extern "C" int flash_attn_bwd_bf16(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, int B, int S, int T, int H,
                                   int KV, int hd, float scale, int q_offset, int window,
                                   void* delta, void* dq, void* dk, void* dv, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, dout, lse, B, S, T, H, KV, hd, scale, q_offset,
                                 window, delta, dq, dk, dv, stream);
}
