// flash_attn_bwd: the backward of csrc/flash_attn.cu's causal / sliding-window
// attention with grouped-query heads, fp32 (flash_attn_bwd_f32) or bf16
// (flash_attn_bwd_bf16) inputs and outputs, fp32 sums.
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
// products, dv from p.
//
// What bounds it on the H100: operations.  Each (query, key) pair in the
// window needs five hd-long products (s, dp, dq, dk, dv: 10 hd flops).  Three
// kernels run in order on the caller's stream: delta_kernel (one warp a
// (batch, position, head) row), then a dK / dV kernel and a dQ kernel.  Both
// tile kernels recompute s and dp, 14 hd flops a pair: dq sums over keys and
// dk, dv over queries, and a kernel that formed ds once would have to add
// one of them across blocks, with atomics whose order changes from run to
// run.  Here every output element is summed by one thread (or one wgmma
// accumulator) in a fixed loop order and written once: two runs give the
// same bits.
//
// fp32 (dkv_kernel<float>, dq_kernel<float>): the CUDA cores' fp32 FMAs (67
// TFLOP/s), 256 threads a block:
//   dkv_kernel: one block a (64 keys, kv head, batch) (32 keys at hd 256).
//     Its k and v tile stay in shared memory while it walks the query heads
//     of its group and, for each, the query tiles whose causal / window range
//     reaches its keys; dk and dv are accumulated in registers.
//   dq_kernel: one block a (64 query rows, head, batch); it walks the kv
//     tiles in its rows' range, the tiles with the most keys launched first.
// Both run two register-tiled stages a tile:
//   scores: thread (to, ti) of a 16 x 16 grid computes the outer rows to +
//     16 r against the inner rows ti + 16 u (s and dp together, float4 reads
//     along hd from rows padded by 4 floats), masks, forms p and ds and
//     writes them transposed, [inner][outer], to shared memory;
//   sums: a thread owns 2 or 4 consecutive outer rows and 4-column chunks of
//     hd, and for each inner row adds p (or ds) times that row of do, q or k.
// Shared memory, dq at hd 256 (the largest): q and do 64 rows, k and v 32
// rows, x 260 floats, and ds: 210 KB.
//
// bf16 (namespace tc): the tensor cores (989 TFLOP/s dense bf16), in the
// forward's shape (hopper.cuh holds the shared pieces): a producer warpgroup
// whose warp 0 copies tiles with TMA into a ring of kStages stages (mbarriers
// "full" and "empty" a stage), and consumer warpgroups of 64 rows that run
// wgmma on them; setmaxnreg gives the consumers 240 registers (hd 256's dq
// kernel has one consumer warpgroup and needs no transfer).
//   tc::dkv_kernel: one block a (kv head, batch, 128 keys; 64 at hd 256), the
//     keys with the most queries first.  k and v stay resident; for each of
//     the G heads and each query tile that reaches the keys, a stage brings
//     q, do (TMA) and the tile's 64 lse and delta values (cp.async, warp 0).
//     Per 64 keys x 64 queries a warpgroup computes s^T = k q^T and dp^T =
//     v do^T (SS wgmma m64n64k16, both read K-major), p^T and ds^T in the
//     accumulator layout (lse, delta per column), and dv += bf16(p)^T do,
//     dk += ds^T q (RS wgmma: the accumulator layout of s^T is the A-fragment
//     layout, as the forward feeds p to p . v; q and do read MN-major from
//     the tile that s read K-major).  hd <= 128: two warpgroups on 64 keys
//     each, dk and dv 2 x hd / 2 fp32 a thread (128 at hd 128) beside s^T
//     and dp^T (64).  hd 256: dk and dv (256 fp32) do not fit one
//     warpgroup, so the two warpgroups share the block's 64 keys, each
//     owning 128 of the hd columns, and each computes s^T and dp^T whole:
//     18 hd flops a pair instead of 14, but no exchange through shared
//     memory and no barrier between the warpgroups, which the hd 256 cells
//     (gemma's) can afford.  Stages: 4 (hd <= 128), 2 at hd 256 (k, v 64
//     KiB + 2 x (q, do) 64 KiB).
//   tc::dq_kernel: one block a (head, batch, 128 query rows; 64 at hd 256),
//     the rows with the most keys first.  q and do stay resident; a stage
//     brings a (k, v) tile; s = q k^T, dp = do v^T (SS), p and ds (lse,
//     delta per row, from registers), dq += ds k (RS, k read MN-major).
//     hd 256: one consumer warpgroup (q, do 64 KiB + 2 stages x (k, v) 64
//     KiB = 192 KiB), dq 128 fp32 a thread.
//   The causal / window mask is evaluated only on the tiles that cross an
//   edge (or the end of S or T); a warpgroup skips a tile with no visible
//   pair.  A row with no key (lse = -inf) takes p = 0 by select, never
//   exp2(+inf).  Keys and query rows past T and S are TMA's zero fill.
//   The one rounding the plain version does not have: the products take
//   bf16 A operands, so p is rounded to bf16 before dv += p^T do (the plain
//   version and JAX use fp32 p there); ds was rounded already.  One
//   rounding of p, not a hi / lo split (16 hd a pair): the CPU emulation
//   (tests/test_torch_lm_train.py) and phase 11 (a) on the card hold dv
//   within FLASH_BWD_TOL with it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16 bytes of global memory as floats; rounding to the type; 4 floats stored
// as the type (the CUDA-core kernels run fp32 alone).
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

// ---------------------------------------------------------------- bf16: tensor cores
//
// Both tile kernels are the forward's shape (csrc/flash_attn.cu, namespace
// tc): two consumer warpgroups (one in hd 256's dq kernel) and one producer
// warpgroup, of which warp 0 starts the copies; setmaxnreg gives the
// producer's registers to the consumers.  Tiles are TMA boxes of [64
// positions][kBoxCols columns] of one head (hopper.cuh), 1024-byte aligned;
// a tile of 64 rows x hd is hd / kBoxCols boxes.  Every wgmma operand is
// one of these tiles, read K-major (along hd: s and dp) or MN-major (along
// the rows: the dq, dk and dv products, as the forward reads v) by
// descriptor.

namespace tc {

using namespace hopper;

constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 128 * (24 + 2 * 240) = 65,536 - 1,024

template <int HD>
struct Cfg {
  static constexpr int kSwizzle = HD >= 64 ? 128 : 64;  // bytes of one row of a box
  static constexpr int kBoxCols = kSwizzle / 2;         // bf16 columns of a box
  static constexpr int kChunkBytes = 64 * kSwizzle;     // one [64][kBoxCols] box
  static constexpr int kTileBytes = 64 * HD * 2;        // 64 rows x hd
  static constexpr uint32_t kLayout = kSwizzle == 128 ? 1 : 2;  // descriptor: B128, B64
  static constexpr uint32_t kSbo = 8 * kSwizzle;                // eight rows of a box
  static constexpr int kStages = HD >= 256 ? 2 : 4;
  // dkv_kernel: kGroups groups of 64 keys a block; kSplit warpgroups share a
  // group, each owning kCols of dk's and dv's hd columns (hd 256: 2 x 128)
  static constexpr int kSplit = HD >= 256 ? 2 : 1;
  static constexpr int kGroups = 2 / kSplit;
  static constexpr int kCols = HD / kSplit;
  static constexpr int kKeys = 64 * kGroups;
  // smem: k, v [kGroups][tile]; q, do [kStages][tile]; lse, delta
  // [kStages][2][64] fp32; mbarriers: kv, full[kStages], empty[kStages]
  static constexpr size_t kKvStat = static_cast<size_t>(2 * kGroups + 2 * kStages) * kTileBytes;
  static constexpr size_t kKvBars = kKvStat + kStages * 2 * 64 * sizeof(float);
  static constexpr size_t kKvSmem = 1024 + kKvBars + 8 * (1 + 2 * kStages);
  // dq_kernel: kQWarpgroups of 64 query rows, q and do resident
  static constexpr int kQWarpgroups = HD >= 256 ? 1 : 2;
  static constexpr int kRows = 64 * kQWarpgroups;
  static constexpr size_t kQBars =
      static_cast<size_t>(2 * kQWarpgroups + 2 * kStages) * kTileBytes;
  static constexpr size_t kQSmem = 1024 + kQBars + 8 * (1 + 2 * kStages);
};

// One 4-byte cp.async into shared memory, zero-filled when !in.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

// An arrival on ``bar`` once this thread's earlier cp.asyncs have landed
// (counted in the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

template <int NC>
__device__ __forceinline__ void producer_regs() {
  if constexpr (NC > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}

template <int NC>
__device__ __forceinline__ void consumer_regs() {
  if constexpr (NC > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// d = a . b^T over hd, a and b [64][hd] tiles read K-major: 64 x 64 fp32 in
// the accumulator layout (not yet waited for).
template <int HD>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint32_t a, uint32_t b) {
  using C = Cfg<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (16 * kk / C::kBoxCols) * C::kChunkBytes + (16 * kk % C::kBoxCols) * 2;
    wgmma_ss_n64(d, smem_desc(a + off, 16, C::kSbo, C::kLayout),
                 smem_desc(b + off, 16, C::kSbo, C::kLayout), kk > 0);
  }
}

// d += a . b, a [64 x 64] bf16 A fragments (a[kk]: columns 16 kk ..), b the
// 64-row tile at ``b`` read MN-major, N columns from box ``box0`` on.
template <int HD, int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4][4], uint32_t b,
                                       int box0) {
  using C = Cfg<HD>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs<N>(d, a[kk],
                smem_desc(b + 16 * kk * C::kSwizzle + box0 * C::kChunkBytes, C::kChunkBytes,
                          C::kSbo, C::kLayout));
  }
}

// p = exp2(s log2(e) / sqrt(hd) - lse log2(e)) and ds = p (dp - delta) for one
// element; ``ok``: the pair is visible (p = 0 otherwise, never exp2(+inf) of
// a row without keys).
__device__ __forceinline__ void p_ds(float& s, float& dp, float scale_log2, float lse2,
                                     float dl, bool ok) {
  const float p = exp2f(fmaf(s, scale_log2, -lse2));
  s = ok ? p : 0.f;
  dp = s * (dp - dl);
}

// A 64 x 64 fp32 accumulator tile as bf16 A fragments (a[kk]: its columns
// 16 kk .. 16 kk + 15), rounded to nearest even.
__device__ __forceinline__ void to_fragments(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
  }
}

// One block per (kv head, batch, kKeys keys); keys with the most queries
// (the first, causal) launch first.  Warpgroup w holds keys 64 (w % kGroups)
// of the block, columns kCols (w / kGroups) of dk and dv.
template <int HD>
__global__ void __launch_bounds__(128 * 3, 1) dkv_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, int S, int T_, int H, int KV,
    float scale_log2, float scale, int q_offset, int window, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv) {
  using C = Cfg<HD>;
  constexpr int NC = 2, ST = C::kStages, TB = C::kTileBytes, BOXES = HD / C::kBoxCols;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  uint8_t* k_sh = base;                           // [kGroups][tile]
  uint8_t* v_sh = k_sh + C::kGroups * TB;         // [kGroups][tile]
  uint8_t* q_sh = v_sh + C::kGroups * TB;         // [ST][tile]
  uint8_t* do_sh = q_sh + ST * TB;                // [ST][tile]
  float* stat_sh = reinterpret_cast<float*>(base + C::kKvStat);  // [ST][lse 64, delta 64]
  const uint32_t kv_full = smem_u32(base + C::kKvBars);
  const uint32_t full0 = kv_full + 8, empty0 = full0 + 8 * ST;

  const int grp = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * C::kKeys;
  const int G = H / KV;
  // the query tiles whose rows see some key of the block, each walked for
  // the G heads of the group
  const int k_last = min(k0 + C::kKeys, T_) - 1;
  const int i_lo = max(0, k0 - q_offset);
  const int i_hi = window > 0 ? min(S - 1, k_last - q_offset + window - 1) : S - 1;
  const int first = i_lo / 64;
  const int ntiles = i_hi >= i_lo ? i_hi / 64 - first + 1 : 0;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(full0 + 8 * st, 1 + 32);  // the TMA bytes and warp 0's stat copies
      mbar_init(empty0 + 8 * st, 4 * NC);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // ---- producer: warp 0 keeps the ring of (q, do, lse, delta) stages full
    producer_regs<NC>();
    if (tid < NC * 128 + 32) {
      const int lane = tid & 31;
      if (lane == 0) {  // the key groups that hold a key (a box wholly past T is not loaded)
        const int groups = min(C::kGroups, (T_ - k0 + 63) / 64);
        mbar_expect_tx(kv_full, 2 * groups * TB);
        for (int w = 0; w < groups; ++w) {
          for (int c = 0; c < BOXES; ++c) {
            const int off = w * TB + c * C::kChunkBytes;
            tma_load(smem_u32(k_sh + off), &k_map, kv_full, c * C::kBoxCols, grp, k0 + 64 * w, b);
            tma_load(smem_u32(v_sh + off), &v_map, kv_full, c * C::kBoxCols, grp, k0 + 64 * w, b);
          }
        }
      }
      int j = 0;
      for (int gi = 0; gi < G; ++gi) {
        const int h = grp * G + gi;
        const float* lse_h = lse + (static_cast<size_t>(b) * H + h) * S;
        const float* delta_h = delta + (static_cast<size_t>(b) * H + h) * S;
        for (int it = 0; it < ntiles; ++it, ++j) {
          const int st = j % ST, r0 = (first + it) * 64;
          if (j >= ST) mbar_wait(empty0 + 8 * st, (j / ST - 1) & 1);
          const uint32_t full = full0 + 8 * st;
          if (lane == 0) {
            mbar_expect_tx(full, 2 * TB);
            for (int c = 0; c < BOXES; ++c) {
              const int off = st * TB + c * C::kChunkBytes;
              tma_load(smem_u32(q_sh + off), &q_map, full, c * C::kBoxCols, h, r0, b);
              tma_load(smem_u32(do_sh + off), &do_map, full, c * C::kBoxCols, h, r0, b);
            }
          }
          const uint32_t stat = smem_u32(stat_sh + st * 128);
#pragma unroll
          for (int i = lane; i < 64; i += 32) {  // rows past S: 0, masked
            const int row = min(r0 + i, S - 1);
            cp_async4(stat + 4 * i, lse_h + row, r0 + i < S);
            cp_async4(stat + 4 * (64 + i), delta_h + row, r0 + i < S);
          }
          cp_async_arrive(full);
        }
      }
    }
    return;
  }

  // ---- consumers
  consumer_regs<NC>();
  constexpr int NCOL = C::kCols;
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int kg = wg % C::kGroups, part = wg / C::kGroups;
  const int t0 = k0 + 64 * kg;  // the warpgroup's first key
  // accumulator layout (m64nN f32): this thread holds rows r + {0, 8} and, for
  // each group of 8 columns, the columns 2 (lane % 4) + {0, 1}: element
  // 4 i + 2 half + e is (row r + 8 half, column 8 i + 2 (lane % 4) + e).
  // Here rows are keys and the columns of s^T and dp^T are query rows.
  const int r = 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float dk_acc[NCOL / 2], dv_acc[NCOL / 2];
#pragma unroll
  for (int i = 0; i < NCOL / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint32_t ka = smem_u32(k_sh + kg * TB), va = smem_u32(v_sh + kg * TB);
  const int box0 = part * (NCOL / C::kBoxCols);
  mbar_wait(kv_full, 0);

  int j = 0;
  for (int gi = 0; gi < G; ++gi) {
    for (int it = 0; it < ntiles; ++it, ++j) {
      const int st = j % ST, r0 = (first + it) * 64, p0 = q_offset + r0;
      mbar_wait(full0 + 8 * st, (j / ST) & 1);
      // a tile with no visible (key, query) pair adds nothing
      const bool skip = t0 >= T_ || t0 > p0 + 63 || (window > 0 && t0 + 63 <= p0 - window);
      if (!skip) {
        const uint32_t qa = smem_u32(q_sh + st * TB), da = smem_u32(do_sh + st * TB);
        float s[32], dp[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
        wgmma_fence();
        mma_ss<HD>(s, ka, qa);   // s^T = k q^T
        mma_ss<HD>(dp, va, da);  // dp^T = v do^T
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);

        const float* stat = stat_sh + st * 128;
        const bool edge = t0 + 63 >= T_ || r0 + 63 >= S || t0 + 63 > p0 ||
                          (window > 0 && t0 <= p0 + 63 - window);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * i + cq + e;
            const float lse2 = stat[col] * kLog2e, dl = stat[64 + col];
            const int pos = p0 + col;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int t = t0 + r + 8 * hf;
              const bool ok = !edge || (r0 + col < S && t < T_ && t <= pos &&
                                        (window <= 0 || t > pos - window));
              p_ds(s[4 * i + 2 * hf + e], dp[4 * i + 2 * hf + e], scale_log2, lse2, dl, ok);
            }
          }
        }
        // dv += bf16(p)^T do, dk += ds^T q: p^T and ds^T in the accumulator
        // layout are the A fragments; do and q read MN-major
        uint32_t pa[4][4], dsa[4][4];
        to_fragments(s, pa);
        to_fragments(dp, dsa);
        wgmma_fence();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        mma_rs<HD, NCOL>(dv_acc, pa, da, box0);
        mma_rs<HD, NCOL>(dk_acc, dsa, qa, box0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
      }
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }
  }

  const size_t kv_stride = static_cast<size_t>(KV) * HD;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = t0 + r + 8 * hf;
    if (t >= T_) continue;
    const size_t at = (static_cast<size_t>(b) * T_ + t) * kv_stride +
                      static_cast<size_t>(grp) * HD + part * NCOL + cq;
#pragma unroll
    for (int i = 0; i < NCOL / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * i) = __floats2bfloat162_rn(
          dk_acc[4 * i + 2 * hf] * scale, dk_acc[4 * i + 2 * hf + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * i) =
          __floats2bfloat162_rn(dv_acc[4 * i + 2 * hf], dv_acc[4 * i + 2 * hf + 1]);
    }
  }
}

// One block per (head, batch, kRows query rows); the rows with the most keys
// (the last, causal) launch first.  Warpgroup w holds rows 64 w of the block.
template <int HD>
__global__ void __launch_bounds__(128 * (Cfg<HD>::kQWarpgroups + 1), 1) dq_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, int S, int T_, int H, int KV,
    float scale_log2, float scale, int q_offset, int window, __nv_bfloat16* __restrict__ dq) {
  using C = Cfg<HD>;
  constexpr int NC = C::kQWarpgroups, ST = C::kStages, TB = C::kTileBytes;
  constexpr int BOXES = HD / C::kBoxCols;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  uint8_t* q_sh = base;                // [NC][tile]
  uint8_t* do_sh = q_sh + NC * TB;     // [NC][tile]
  uint8_t* k_sh = do_sh + NC * TB;     // [ST][tile]
  uint8_t* v_sh = k_sh + ST * TB;      // [ST][tile]
  const uint32_t qd_full = smem_u32(base + C::kQBars);
  const uint32_t full0 = qd_full + 8, empty0 = full0 + 8 * ST;

  const int h = blockIdx.x, b = blockIdx.y;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * C::kRows;
  const int grp = h / (H / KV);
  // the kv tiles holding a key some row of the block may see
  const int t_hi = min(T_ - 1, q_offset + min(row0 + C::kRows, S) - 1);
  const int t_lo = window > 0 ? max(0, q_offset + row0 - window + 1) : 0;
  const int tile0 = t_lo / 64;
  const int ntiles = t_hi >= t_lo ? t_hi / 64 - tile0 + 1 : 0;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    mbar_init(qd_full, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // ---- producer: one thread loads q and do once, then the ring of (k, v)
    producer_regs<NC>();
    if (tid == NC * 128) {
      const int wgs = min(NC, (S - row0 + 63) / 64);  // the warpgroups that hold a row
      mbar_expect_tx(qd_full, 2 * wgs * TB);
      for (int w = 0; w < wgs; ++w) {
        for (int c = 0; c < BOXES; ++c) {
          const int off = w * TB + c * C::kChunkBytes;
          tma_load(smem_u32(q_sh + off), &q_map, qd_full, c * C::kBoxCols, h, row0 + 64 * w, b);
          tma_load(smem_u32(do_sh + off), &do_map, qd_full, c * C::kBoxCols, h, row0 + 64 * w,
                   b);
        }
      }
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % ST;
        if (j >= ST) mbar_wait(empty0 + 8 * st, (j / ST - 1) & 1);
        const uint32_t full = full0 + 8 * st;
        mbar_expect_tx(full, 2 * TB);
        const int t0 = (tile0 + j) * 64;
        for (int c = 0; c < BOXES; ++c) {
          const int off = st * TB + c * C::kChunkBytes;
          tma_load(smem_u32(k_sh + off), &k_map, full, c * C::kBoxCols, grp, t0, b);
          tma_load(smem_u32(v_sh + off), &v_map, full, c * C::kBoxCols, grp, t0, b);
        }
      }
    }
    return;
  }

  // ---- consumers: rows wrow0 .. wrow0 + 63, in the accumulator layout
  consumer_regs<NC>();
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int wrow0 = row0 + 64 * wg, p0 = q_offset + wrow0;
  const int r = wrow0 + 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float lse2[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r + 8 * hf;
    const size_t at = (static_cast<size_t>(b) * H + h) * S + min(row, S - 1);
    lse2[hf] = row < S ? lse[at] * kLog2e : 0.f;
    dl[hf] = row < S ? delta[at] : 0.f;
  }
  float dq_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq_acc[i] = 0.f;
  const uint32_t qa = smem_u32(q_sh + wg * TB), da = smem_u32(do_sh + wg * TB);
  mbar_wait(qd_full, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % ST, t0 = (tile0 + j) * 64;
    mbar_wait(full0 + 8 * st, (j / ST) & 1);
    const bool skip = wrow0 >= S || t0 > p0 + 63 || (window > 0 && t0 + 63 <= p0 - window);
    if (!skip) {
      const uint32_t ka = smem_u32(k_sh + st * TB), va = smem_u32(v_sh + st * TB);
      float s[32], dp[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
      wgmma_fence();
      mma_ss<HD>(s, qa, ka);   // s = q k^T
      mma_ss<HD>(dp, da, va);  // dp = do v^T
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // rows past S are never written: only keys and the mask matter here
      const bool edge = t0 + 63 >= T_ || t0 + 63 > p0 || (window > 0 && t0 <= p0 + 63 - window);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = t0 + 8 * i + cq + e;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int pos = q_offset + r + 8 * hf;
            const bool ok = !edge || (t < T_ && t <= pos && (window <= 0 || t > pos - window));
            p_ds(s[4 * i + 2 * hf + e], dp[4 * i + 2 * hf + e], scale_log2, lse2[hf], dl[hf],
                 ok);
          }
        }
      }
      // dq += ds k: ds in the accumulator layout is the A fragment; k MN-major
      uint32_t dsa[4][4];
      to_fragments(dp, dsa);
      wgmma_fence();
      fence_regs(dq_acc);
      mma_rs<HD, HD>(dq_acc, dsa, ka, 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq_acc);
    }
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  const size_t q_stride = static_cast<size_t>(H) * HD;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r + 8 * hf;
    if (row >= S) continue;
    __nv_bfloat16* out = dq + (static_cast<size_t>(b) * S + row) * q_stride +
                         static_cast<size_t>(h) * HD + cq;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * i) = __floats2bfloat162_rn(
          dq_acc[4 * i + 2 * hf] * scale, dq_acc[4 * i + 2 * hf + 1] * scale);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const void* lse, int B, int S, int T_, int H, int KV, float scale, int q_offset,
           int window, void* delta, void* dq, void* dk, void* dv, cudaStream_t stream) {
  using C = Cfg<HD>;
  const CUtensorMapSwizzle sw =
      C::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!tensor_map(&q_map, q, B, S, H, HD, C::kBoxCols, sw) ||
      !tensor_map(&do_map, dout, B, S, H, HD, C::kBoxCols, sw) ||
      !tensor_map(&k_map, k, B, T_, KV, HD, C::kBoxCols, sw) ||
      !tensor_map(&v_map, v, B, T_, KV, HD, C::kBoxCols, sw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kKvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kQSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  const size_t rows = static_cast<size_t>(B) * S * H;
  const unsigned row_blocks = static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  delta_kernel<__nv_bfloat16, HD><<<row_blocks, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout), rows, S,
      H, df);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = scale * kLog2e;
  dkv_kernel<HD><<<dim3(KV, B, (T_ + C::kKeys - 1) / C::kKeys), 128 * 3, C::kKvSmem, stream>>>(
      q_map, k_map, v_map, do_map, lf, df, S, T_, H, KV, scale_log2, scale, q_offset, window,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<HD><<<dim3(H, B, (S + C::kRows - 1) / C::kRows), 128 * (C::kQWarpgroups + 1),
                  C::kQSmem, stream>>>(q_map, k_map, v_map, do_map, lf, df, S, T_, H, KV,
                                       scale_log2, scale, q_offset, window,
                                       static_cast<__nv_bfloat16*>(dq));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

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

// The same for bf16 q, k, v, out, dout and gradients (16-byte aligned: TMA
// reads q, k, v and dout).
extern "C" int flash_attn_bwd_bf16(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, int B, int S, int T, int H,
                                   int KV, int hd, float scale, int q_offset, int window,
                                   void* delta, void* dq, void* dk, void* dv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return tc::launch<32>(q, k, v, out, dout, lse, B, S, T, H, KV, scale, q_offset, window,
                            delta, dq, dk, dv, st);
    case 64:
      return tc::launch<64>(q, k, v, out, dout, lse, B, S, T, H, KV, scale, q_offset, window,
                            delta, dq, dk, dv, st);
    case 128:
      return tc::launch<128>(q, k, v, out, dout, lse, B, S, T, H, KV, scale, q_offset, window,
                             delta, dq, dk, dv, st);
    case 256:
      return tc::launch<256>(q, k, v, out, dout, lse, B, S, T, H, KV, scale, q_offset, window,
                             delta, dq, dk, dv, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
