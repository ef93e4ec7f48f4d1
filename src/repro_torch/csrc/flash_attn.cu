// flash_attn: causal / sliding-window attention forward with an online
// softmax, grouped-query heads, fp32 (flash_attn_f32) or bf16
// (flash_attn_bf16) inputs, fp32 accumulation.
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
// is written as acc / max(l, 1e-30) in v's type.  Given an ``lse`` pointer
// (training: the backward of csrc/flash_attn_bwd.cu recomputes p from it)
// both kernels also write each row's log-sum-exp of its scaled scores,
// lse = ln sum_t exp(s_t / sqrt(hd)) = (m + log2 l) ln 2 with m in log2
// units, fp32 [B, H, S], -inf for a row with no key, and the bf16 kernel
// given an ``out_f32`` pointer writes acc / max(l, 1e-30) in fp32 too (the
// backward's delta reads it, as JAX's reads its fp32 residual); with null
// pointers the serving path is unchanged.  The semantics of a row
// with no key in its window are the plain reference's
// (src/repro/kernels/flash_attn/ref.py:19): it is 0.  The Pallas kernel's
// finite -1e30 mask gives every masked p the value 1 there and returns the
// mean of v; here masked scores are -inf, a tile whose running max is still
// -inf contributes p = 0, so such a row ends with acc = 0.  Both kernels skip
// the kv tiles that lie wholly outside every row's window.
//
// What bounds it on the H100: operations.  Per (query, key) pair in the
// window it does 2*hd flops for the score and 2*hd for p.v; it reads q, k, v
// and writes out once, far fewer bytes than that at these shapes (causal
// S = T = 4096, hd 64: 6.9e10 flops against 84 MB in fp32).
//
// fp32: the CUDA cores' fp32 FMAs (67 TFLOP/s).  One TF32 tensor-core pass
// would break the fp32 contract (2e-5): it keeps 10 of an operand's 23
// mantissa bits.  3xTF32 (three passes on split operands, about 2^-22 of a
// product) would not: csrc/flash_attn_bwd.cu's fp32 backward runs so.
// Both products are register-tiled, so the FMAs and not shared memory set
// the pace.  One block of 8 warps per (q tile, head, batch), the q tiles
// with the most keys launched first.  A warp holds
// two row groups of 16 lanes; a thread owns kTR query rows of its group
// (rows 2i + g of the warp's 2 kTR) and keeps their running max, its own
// partial denominator and kTR x hd/16 accumulators in registers:
//   s = q . k^T: lane j of a group scores keys j, j + 16, ... of the kv tile
//     for its kTR rows, from float4s of q (its rows: the 16 lanes of a group
//     read the same address) and k (16 rows a group), kTR x kBK/16 x 4 FMAs
//     per depth step for kTR + 2 kBK/16 shared-memory wavefronts;
//   the row max takes 4 shuffles (the group is one half-warp); the
//     denominator stays a partial sum per lane, added across the group once
//     at the end (only the order of the sums changes);
//   p goes through shared memory transposed, [key][row], so a lane reads its
//     kTR rows' p for one key as kTR / 4 float4s; o += p . v takes
//     kTR x hd/16 FMAs per key for kTR / 4 + hd/32 wavefronts (lane j's
//     columns are 4-float chunks j, j + 16, ...: a group reads 256
//     consecutive bytes of v).
// q, k and p rows are padded by 4 floats (p: 2 kTR + 4), so the float4 reads
// and the transposed p writes are free of bank conflicts.  k and v tiles are
// copied by cp.async (16 bytes, .cg, zero-filled past T) into a ring of
// kStages stages: tile t + kStages - 1 is in flight while tile t is
// computed, one barrier a tile.  The mask is evaluated only on the tiles
// that cross a row's causal or window edge, or the end of the keys; a warp
// skips a tile wholly outside its rows' windows.  Scores are scaled by
// log2(e) / sqrt(hd) and exponentiated by exp2f: p = exp(s - m') up to
// rounding.  Tiles and shared memory by hd (F32Cfg): 128 rows x 64 keys at
// hd <= 64 (173 KiB at hd 64), 128 x 32 at hd 128 (184 KiB), 64 x 32 at hd
// 256 (206 KiB): at most 64 accumulators a thread.
//
// bf16: the tensor cores (989 TFLOP/s dense bf16), where a product of two
// bf16 values is exact and sums are kept in fp32, so the result differs from
// fp32 FMAs only in the order of the sums.  The design (namespace tc below)
// keeps the tensor cores fed: a producer warpgroup copies k / v tiles with
// TMA into a ring of stages while two consumer warpgroups, 64 query rows
// each, run s = q . k^T as wgmma m64n64k16 (both operands read from shared
// memory by descriptor), the online softmax in registers in wgmma's
// accumulator layout (a row lives in one quad: two shuffles per row max),
// and o += bf16(p) . v as wgmma m64n{hd}k16 with p straight from registers
// (the accumulator layout of s is the A-fragment layout) and v read
// N-major (the transposed operand).  setmaxnreg moves the producer's
// registers to the consumers: at hd 128 / 256 they take 240 (o alone is 128
// fp32 a thread at hd 256) and a block fills an SM; at hd <= 64 they take
// 104 and two blocks share an SM, so one block's softmax runs while the
// other's wgmma does (granite's hd 64 ran about 17% faster so).  Shared memory, hd 256: q 2 x 32 KiB + 2 stages x
// (k + v) 32 KiB = 192 KiB.  Within a warpgroup the tensor cores still wait
// for the softmax between a tile's two products: nothing overlaps them there.
#include <cuda.h>  // CUtensorMap and its enums (types only: libcuda is not linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kF32Warps = 8;
constexpr int kF32Threads = kF32Warps * 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Tiles of the fp32 kernel by head dim: kG lanes a row group (a warp holds
// 32 / kG groups), kTR query rows a thread (a block holds kF32Warps * 32 /
// kG * kTR rows), kBK keys a kv tile, kStages tiles in the copy ring.
template <int HD>
struct F32Cfg {
  static constexpr int kG = 16;
  static constexpr int kTR = HD <= 128 ? 8 : 4;
  static constexpr int kBK = HD <= 64 ? 64 : 32;
  static constexpr int kStages = HD <= 128 ? 3 : 2;
  static constexpr int kGroups = 32 / kG;                // row groups a warp
  static constexpr int kBQ = kF32Warps * kGroups * kTR;  // query rows a block
  static constexpr int kTK = kBK / kG;                   // keys a thread
  static constexpr int kTC = HD / kG;                    // output columns a thread
  static constexpr int kCW = kTC < 4 ? kTC : 4;          // columns of one chunk
  static constexpr int kNCH = kTC / kCW;                 // chunks a thread
  static constexpr int kPW = kTR < 4 ? kTR : 4;          // p values of one chunk
  static constexpr int kQS = HD + 4, kKS = HD + 4, kVS = HD;  // row strides (floats)
  static constexpr int kPS = kGroups * kTR + 4;
  static constexpr size_t kSmem =
      sizeof(float) * (static_cast<size_t>(kBQ) * kQS + kStages * kBK * (kKS + kVS) +
                       kF32Warps * kBK * kPS);
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool in) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

template <int N>
__device__ __forceinline__ void store_chunk(float* p, const float* in) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  }
}

// One kv tile against one thread's rows (ks, vs: the tile's stage; pw: the
// warp's p buffer).  pos0 is the position of the thread's row 0 (row i sits at
// pos0 + kGroups i); t0 the tile's first key.  MASK: some (row, key) of the
// warp is masked, so every score is tested.
template <int HD, bool MASK>
__device__ __forceinline__ void f32_tile(const float* __restrict__ q_rows,
                                         const float* __restrict__ ks,
                                         const float* __restrict__ vs, float* __restrict__ pw,
                                         int g, int j, int pos0, int t0, int T_, int window,
                                         float scale_log2, float (&m)[F32Cfg<HD>::kTR],
                                         float (&l)[F32Cfg<HD>::kTR],
                                         float (&acc)[F32Cfg<HD>::kTR][F32Cfg<HD>::kTC]) {
  using C = F32Cfg<HD>;
  constexpr int TR = C::kTR, TK = C::kTK, TC = C::kTC, CW = C::kCW, PW = C::kPW, G = C::kG;
  float s[TR][TK];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
#pragma unroll
    for (int u = 0; u < TK; ++u) s[i][u] = 0.f;
  }
  // s = q . k^T, 4 depths a step
  const float4* q4 = reinterpret_cast<const float4*>(q_rows);
  const float4* k4 = reinterpret_cast<const float4*>(ks + j * C::kKS);
#pragma unroll (HD <= 64 ? HD / 4 : 8)
  for (int c = 0; c < HD / 4; ++c) {
    float4 kk[TK];
#pragma unroll
    for (int u = 0; u < TK; ++u) kk[u] = k4[u * G * (C::kKS / 4) + c];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float4 qq = q4[i * C::kGroups * (C::kQS / 4) + c];
#pragma unroll
      for (int u = 0; u < TK; ++u) {
        s[i][u] = fmaf(qq.x, kk[u].x, s[i][u]);
        s[i][u] = fmaf(qq.y, kk[u].y, s[i][u]);
        s[i][u] = fmaf(qq.z, kk[u].z, s[i][u]);
        s[i][u] = fmaf(qq.w, kk[u].w, s[i][u]);
      }
    }
  }
  // online softmax: the row max over the group's G lanes, p, corr
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < TK; ++u) {
      float x = s[i][u] * scale_log2;
      if (MASK) {
        const int t = t0 + j + G * u, pos = pos0 + C::kGroups * i;
        const bool ok = t <= pos && t < T_ && (window <= 0 || t > pos - window);
        x = ok ? x : -INFINITY;
      }
      s[i][u] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int o = 1; o < G; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m[i], mx);
    // a row with no key yet: every p and corr is 0 (exp2(-inf)), no NaN
    const float m_use = MASK && m_new == -INFINITY ? 0.f : m_new;
    const float corr = exp2f(m[i] - m_use);
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < TK; ++u) {
      s[i][u] = exp2f(s[i][u] - m_use);
      sum += s[i][u];
    }
    l[i] = l[i] * corr + sum;
    m[i] = m_new;
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[i][c] *= corr;
  }
  // p to shared memory, [key][row]: the group's rows of one key in one line
#pragma unroll
  for (int u = 0; u < TK; ++u) {
#pragma unroll
    for (int i0 = 0; i0 < TR; i0 += PW) {
      float chunk[PW];
#pragma unroll
      for (int i = 0; i < PW; ++i) chunk[i] = s[i0 + i][u];
      store_chunk<PW>(pw + (j + G * u) * C::kPS + g * TR + i0, chunk);
    }
  }
  __syncwarp();
  // o += p . v, one key a step
  const float* pr = pw + g * TR;
#pragma unroll 8
  for (int key = 0; key < C::kBK; ++key) {
    float p[TR], vv[TC];
#pragma unroll
    for (int i0 = 0; i0 < TR; i0 += PW) load_chunk<PW>(pr + key * C::kPS + i0, p + i0);
#pragma unroll
    for (int ch = 0; ch < C::kNCH; ++ch) {
      load_chunk<CW>(vs + key * C::kVS + (j + G * ch) * CW, vv + ch * CW);
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads, 1) flash_attn_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, int S,
    int T_, int H, int KV, float scale_log2, int q_offset, int window, float* __restrict__ out,
    float* __restrict__ lse) {
  using C = F32Cfg<HD>;
  constexpr int TR = C::kTR, TC = C::kTC, CW = C::kCW, BK = C::kBK, ST = C::kStages, G = C::kG;
  constexpr int BQ = C::kBQ, C4 = HD / 4;  // 16-byte chunks of a row
  extern __shared__ float4 smem4[];
  float* q_sh = reinterpret_cast<float*>(smem4);  // [BQ][kQS]
  float* k_sh = q_sh + BQ * C::kQS;               // [ST][BK][kKS]
  float* v_sh = k_sh + ST * BK * C::kKS;          // [ST][BK][kVS]
  float* p_sh = v_sh + ST * BK * C::kVS;          // [warps][BK][kPS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane / G, j = lane % G;
  const int h = blockIdx.x, b = blockIdx.y;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // the q tiles with most keys first
  const int grp = h / (H / KV);
  const size_t q_stride = static_cast<size_t>(H) * HD;  // between sequence positions
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const float* qb = q + static_cast<size_t>(b) * S * q_stride + static_cast<size_t>(h) * HD;
  const float* kb = k + static_cast<size_t>(b) * T_ * kv_stride + static_cast<size_t>(grp) * HD;
  const float* vb = v + static_cast<size_t>(b) * T_ * kv_stride + static_cast<size_t>(grp) * HD;
  float* ob = out + static_cast<size_t>(b) * S * q_stride + static_cast<size_t>(h) * HD;

  // the keys some row of this tile may see: [t_lo, t_hi], in whole kv tiles
  const int last_row = min(row0 + BQ, S) - 1;
  const int t_hi = min(T_ - 1, q_offset + last_row);
  const int t_lo = window > 0 ? max(0, q_offset + row0 - window + 1) : 0;
  const int first = t_lo / BK;
  const int ntiles = t_hi >= t_lo ? t_hi / BK - first + 1 : 0;

  auto load_tile = [&](int tile, int stage) {
    float* ks = k_sh + stage * BK * C::kKS;
    float* vs = v_sh + stage * BK * C::kVS;
    for (int idx = tid; idx < BK * C4; idx += kF32Threads) {
      const int r = idx / C4, c = (idx % C4) * 4;
      const int t = tile * BK + r;
      const size_t at = static_cast<size_t>(t < T_ ? t : 0) * kv_stride + c;
      cp_async16(ks + r * C::kKS + c, kb + at, t < T_);
      cp_async16(vs + r * C::kVS + c, vb + at, t < T_);
    }
  };
  // q joins the first copy group
  for (int idx = tid; idx < BQ * C4; idx += kF32Threads) {
    const int r = idx / C4, c = (idx % C4) * 4;
    const int row = row0 + r;
    cp_async16(q_sh + r * C::kQS + c, qb + static_cast<size_t>(row < S ? row : 0) * q_stride + c,
               row < S);
  }
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < ntiles) load_tile(first + s, s);
    cp_async_commit();
  }

  float m[TR], l[TR], acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[i][c] = 0.f;
  }
  const int wrow0 = warp * C::kGroups * TR;  // the warp's first row in the tile
  const int pmin = q_offset + row0 + wrow0;   // positions of the warp's rows: [pmin, pmax]
  const int pmax = pmin + C::kGroups * TR - 1;
  const float* q_rows = q_sh + (wrow0 + g) * C::kQS;  // this thread's row 0
  float* pw = p_sh + warp * BK * C::kPS;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<ST - 2>();  // this thread's copies of tile it have landed
    __syncthreads();          // everyone's have, and tile it - 1's stage is free
    if (it + ST - 1 < ntiles) load_tile(first + it + ST - 1, (it + ST - 1) % ST);
    cp_async_commit();
    const int t0 = (first + it) * BK;
    // a tile wholly outside the warp's rows' windows changes nothing
    if (t0 > pmax || (window > 0 && t0 + BK - 1 <= pmin - window)) continue;
    const float* ks = k_sh + (it % ST) * BK * C::kKS;
    const float* vs = v_sh + (it % ST) * BK * C::kVS;
    const bool edge = t0 + BK - 1 > pmin || t0 + BK > T_ || (window > 0 && t0 <= pmax - window);
    if (edge) {
      f32_tile<HD, true>(q_rows, ks, vs, pw, g, j, pmin + g, t0, T_, window, scale_log2, m, l,
                         acc);
    } else {
      f32_tile<HD, false>(q_rows, ks, vs, pw, g, j, pmin + g, t0, T_, window, scale_log2, m, l,
                          acc);
    }
  }

  // the denominators: each lane's partial sums, added across the group
#pragma unroll
  for (int i = 0; i < TR; ++i) {
#pragma unroll
    for (int o = 1; o < G; o <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
  }
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = row0 + wrow0 + C::kGroups * i + g;
    if (row >= S) continue;
    if (lse != nullptr && j == 0) {  // m is in log2 units
      lse[(static_cast<size_t>(b) * H + h) * S + row] =
          l[i] > 0.f ? (m[i] + log2f(l[i])) * kLn2 : -INFINITY;
    }
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = ob + static_cast<size_t>(row) * q_stride;
#pragma unroll
    for (int ch = 0; ch < C::kNCH; ++ch) {
      float o[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) o[c] = acc[i][ch * CW + c] / den;
      store_chunk<CW>(orow + (j + G * ch) * CW, o);
    }
  }
}

template <int HD>
int launch_f32(const float* q, const float* k, const float* v, int B, int S, int T_, int H,
               int KV, float scale, int q_offset, int window, float* out, float* lse,
               cudaStream_t stream) {
  using C = F32Cfg<HD>;
  const cudaError_t attr =
      cudaFuncSetAttribute(flash_attn_f32_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(H, B, (S + C::kBQ - 1) / C::kBQ);
  flash_attn_f32_kernel<HD><<<grid, kF32Threads, C::kSmem, stream>>>(
      q, k, v, S, T_, H, KV, scale * kLog2e, q_offset, window, out, lse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------- bf16: tensor cores
//
// One block per (128 query rows, head, batch): two consumer warpgroups of 64
// rows each and one producer warpgroup, of which one thread issues the TMA
// copies.  Shared memory holds the block's q tile (loaded once) and a ring of
// kStages kv stages (64 keys x hd of k and of v); each stage has a "full"
// mbarrier (TMA bytes arrived) and an "empty" one (every consumer warp done
// with it).  Tiles are TMA boxes of [64 rows][64 columns] bf16 (hd 32:
// [64][32]) in the 128-byte (64-byte) swizzle, the canonical layouts that
// wgmma descriptors name.

namespace {
namespace tc {

using namespace hopper;

constexpr int kConsumers = 2;                // warpgroups of 64 query rows
constexpr int kRows = 64 * kConsumers;       // query rows per block
constexpr int kKeys = 64;                    // keys per kv tile
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kEmptyArrivals = 4 * kConsumers;  // one per consumer warp
constexpr int kProducerRegs = 24;

template <int HD>
struct Cfg {
  static constexpr int kSwizzle = HD >= 64 ? 128 : 64;  // bytes of one row of a box
  static constexpr int kBoxCols = kSwizzle / 2;         // bf16 columns of a box
  static constexpr int kChunkBytes = 64 * kSwizzle;     // one [64][kBoxCols] box
  static constexpr int kTileBytes = 64 * HD * 2;        // 64 rows x hd: HD / kBoxCols boxes
  static constexpr int kStages = HD >= 256 ? 2 : 3;
  // hd <= 64 fits two blocks an SM (one's softmax overlaps the other's
  // wgmma): 2 * 128 * (24 + 2 * 104) <= 65,536; else one, its consumers
  // holding o at hd 256 (128 fp32): 128 * (24 + 2 * 240) <= 65,536
  static constexpr int kBlocksPerSm = HD <= 64 ? 2 : 1;
  static constexpr int kConsumerRegs = HD <= 64 ? 104 : 240;
  static constexpr uint32_t kLayout = kSwizzle == 128 ? 1 : 2;  // descriptor: B128, B64
  static constexpr size_t kSmem =
      1024 + static_cast<size_t>(kConsumers + 2 * kStages) * kTileBytes + 8 * (1 + 2 * kStages);
};

// The kv tiles block ``qt`` visits: [first, first + count), 64 keys each --
// the tiles holding any key some row of the block may see.
__device__ __forceinline__ void kv_tiles(int qt, int S, int T_, int q_offset, int window,
                                         int* first, int* count) {
  const int row0 = qt * kRows;
  const int t_hi = min(T_ - 1, q_offset + min(row0 + kRows, S) - 1);
  const int t_lo = window > 0 ? max(0, q_offset + row0 - window + 1) : 0;
  *first = t_lo / kKeys;
  *count = t_hi >= t_lo ? t_hi / kKeys - t_lo / kKeys + 1 : 0;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, Cfg<HD>::kBlocksPerSm) flash_attn_bf16_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, float* __restrict__ out_f32, int S, int T_, int H, int KV,
    float scale_log2, int q_offset, int window) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* q_sh = base;                                   // [kConsumers][tile]
  uint8_t* k_sh = q_sh + kConsumers * C::kTileBytes;      // [kStages][tile]
  uint8_t* v_sh = k_sh + C::kStages * C::kTileBytes;      // [kStages][tile]
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_sh + C::kStages * C::kTileBytes);
  const uint32_t q_full = smem_u32(bars);
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * C::kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows start first
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = qt * kRows;
  int tile0, ntiles;
  kv_tiles(qt, S, T_, q_offset, window, &tile0, &ntiles);
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring of kv stages full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers * 128) {
      const int g = h / (H / KV);
      mbar_expect_tx(q_full, kConsumers * C::kTileBytes);
      for (int w = 0; w < kConsumers; ++w) {
        for (int c = 0; c < HD / C::kBoxCols; ++c) {
          tma_load(smem_u32(q_sh + w * C::kTileBytes + c * C::kChunkBytes), &q_map, q_full,
                   c * C::kBoxCols, h, row0 + 64 * w, b);
        }
      }
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % C::kStages;
        if (j >= C::kStages) mbar_wait(empty0 + 8 * st, (j / C::kStages - 1) & 1);
        const uint32_t full = full0 + 8 * st;
        mbar_expect_tx(full, 2 * C::kTileBytes);
        const int t0 = (tile0 + j) * kKeys;
        for (int c = 0; c < HD / C::kBoxCols; ++c) {
          const int off = st * C::kTileBytes + c * C::kChunkBytes;
          tma_load(smem_u32(k_sh + off), &k_map, full, c * C::kBoxCols, g, t0, b);
          tma_load(smem_u32(v_sh + off), &v_map, full, c * C::kBoxCols, g, t0, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows row0 + 64 wg .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int wrow0 = row0 + 64 * wg;
  // accumulator layout (m64nN f32): this thread holds rows r + {0, 8} and, for
  // each group of 8 columns, the columns 2 (lane % 4) + {0, 1}: element
  // 4 i + 2 half + e is (row r + 8 half, column 8 i + 2 (lane % 4) + e).
  const int r = wrow0 + 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const uint32_t q_addr = smem_u32(q_sh + wg * C::kTileBytes);
  constexpr uint32_t kSbo = 8 * C::kSwizzle;  // eight rows of a box
  mbar_wait(q_full, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % C::kStages;
    mbar_wait(full0 + 8 * st, (j / C::kStages) & 1);
    const uint32_t k_addr = smem_u32(k_sh + st * C::kTileBytes);
    const uint32_t v_addr = smem_u32(v_sh + st * C::kTileBytes);

    // s = q . k^T over hd in steps of 16: both operands K-major
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (16 * kk / C::kBoxCols) * C::kChunkBytes + (16 * kk % C::kBoxCols) * 2;
      wgmma_ss_n64(s, smem_desc(q_addr + off, 16, kSbo, C::kLayout),
                   smem_desc(k_addr + off, 16, kSbo, C::kLayout), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const int t0 = (tile0 + j) * kKeys;
    const bool edge = t0 + kKeys - 1 > q_offset + wrow0 || t0 + kKeys > T_ ||
                      (window > 0 && t0 <= q_offset + wrow0 + 63 - window);
    if (edge) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int t = t0 + 8 * (e >> 2) + cq + (e & 1);
        const int qpos = q_offset + r + 8 * ((e >> 1) & 1);
        const bool ok = t < T_ && t <= qpos && (window <= 0 || t > qpos - window);
        if (!ok) s[e] = -INFINITY;
      }
    }

    // online softmax, per row half: the row's 64 scores sit in a quad
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) mx = fmaxf(mx, fmaxf(s[4 * i + 2 * hf], s[4 * i + 2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx);
      // a row with no key yet keeps p = 0 (and corr = 0 on its zero sums)
      const float m_use = m_new == -INFINITY ? 0.f : m_new * scale_log2;
      const float corr = exp2f(m[hf] * scale_log2 - m_use);
      m[hf] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(fmaf(s[4 * i + 2 * hf + e], scale_log2, -m_use));
          s[4 * i + 2 * hf + e] = p;
          sum += p;
        }
      }
      l[hf] = l[hf] * corr + sum;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        o[4 * i + 2 * hf] *= corr;
        o[4 * i + 2 * hf + 1] *= corr;
      }
    }

    // o += bf16(p) . v: p's accumulator layout is wgmma's A-fragment layout
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x) pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
    }
    wgmma_fence();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // v rows 16 kk .. 16 kk + 15, N-major: boxes of 64 columns C::kChunkBytes apart
      wgmma_rs<HD>(o, pa[kk],
                   smem_desc(v_addr + 16 * kk * C::kSwizzle, C::kChunkBytes, kSbo, C::kLayout));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float sum = l[hf];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int row = r + 8 * hf;
    if (lse != nullptr && (lane & 3) == 0 && row < S) {  // m is in score units
      lse[(static_cast<size_t>(b) * H + h) * S + row] =
          sum > 0.f ? (m[hf] * scale_log2 + log2f(sum)) * kLn2 : -INFINITY;
    }
    if (row < S) {
      const size_t at = ((static_cast<size_t>(b) * S + row) * H + h) * HD + cq;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        const float x0 = o[4 * i + 2 * hf] * inv, x1 = o[4 * i + 2 * hf + 1] * inv;
        *reinterpret_cast<__nv_bfloat162*>(out + at + 8 * i) = __floats2bfloat162_rn(x0, x1);
        // training: the fp32 value the bf16 one was rounded from (the backward's delta)
        if (out_f32 != nullptr) {
          *reinterpret_cast<float2*>(out_f32 + at + 8 * i) = make_float2(x0, x1);
        }
      }
    }
  }
}

__global__ void fill_kernel(float* __restrict__ x, size_t n, float value) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    x[i] = value;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, int B, int S, int T_, int H, int KV,
           float scale, int q_offset, int window, void* out, float* lse, float* out_f32,
           cudaStream_t stream) {
  using C = Cfg<HD>;
  if (T_ == 0) {  // no key: every row is 0, its lse -inf
    cudaMemsetAsync(out, 0, static_cast<size_t>(B) * S * H * HD * 2, stream);
    if (out_f32 != nullptr) {
      cudaMemsetAsync(out_f32, 0, static_cast<size_t>(B) * S * H * HD * 4, stream);
    }
    if (lse != nullptr) {
      fill_kernel<<<64, 256, 0, stream>>>(lse, static_cast<size_t>(B) * H * S, -INFINITY);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const CUtensorMapSwizzle sw =
      C::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap q_map, k_map, v_map;
  if (!tensor_map(&q_map, q, B, S, H, HD, C::kBoxCols, sw) ||
      !tensor_map(&k_map, k, B, T_, KV, HD, C::kBoxCols, sw) ||
      !tensor_map(&v_map, v, B, T_, KV, HD, C::kBoxCols, sw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attn_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_attn_bf16_kernel<HD><<<grid, kThreads, C::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), lse, out_f32, S, T_, H, KV,
      scale * 1.4426950408889634f, q_offset, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace

// q, out: [B, S, H, hd]; k, v: [B, T, KV, hd] (16-byte aligned: cp.async
// copies them); window <= 0: causal only; lse: [B, H, S] fp32, or null.
extern "C" int flash_attn_f32(const void* q, const void* k, const void* v, int B, int S, int T,
                              int H, int KV, int hd, float scale, int q_offset, int window,
                              void* out, void* lse, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch_f32<32>(qf, kf, vf, B, S, T, H, KV, scale, q_offset, window, of, lf, st);
    case 64:
      return launch_f32<64>(qf, kf, vf, B, S, T, H, KV, scale, q_offset, window, of, lf, st);
    case 128:
      return launch_f32<128>(qf, kf, vf, B, S, T, H, KV, scale, q_offset, window, of, lf, st);
    case 256:
      return launch_f32<256>(qf, kf, vf, B, S, T, H, KV, scale, q_offset, window, of, lf, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same for bf16 q, k, v (16-byte aligned: TMA reads them) and out;
// out_f32: [B, S, H, hd] fp32, the values out was rounded from, or null (the
// serving path).
extern "C" int flash_attn_bf16(const void* q, const void* k, const void* v, int B, int S,
                               int T, int H, int KV, int hd, float scale, int q_offset,
                               int window, void* out, void* lse, void* out_f32, void* stream) {
  float* lf = static_cast<float*>(lse);
  float* of = static_cast<float*>(out_f32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return tc::launch<32>(q, k, v, B, S, T, H, KV, scale, q_offset, window, out, lf, of, st);
    case 64:
      return tc::launch<64>(q, k, v, B, S, T, H, KV, scale, q_offset, window, out, lf, of, st);
    case 128:
      return tc::launch<128>(q, k, v, B, S, T, H, KV, scale, q_offset, window, out, lf, of, st);
    case 256:
      return tc::launch<256>(q, k, v, B, S, T, H, KV, scale, q_offset, window, out, lf, of, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
