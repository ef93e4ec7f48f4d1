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
// products, dv from p.  ``out`` is the forward's fp32 output for both types
// (JAX's residual: the bf16 forward writes it beside its bf16 output), so
// delta is JAX's, not that of the output rounded to bf16.
//
// What bounds it on the H100: operations.  Each (query, key) pair in the
// window needs five hd-long products (s, dp, dq, dk, dv: 10 hd flops).  Three
// kernels run in order on the caller's stream: delta_kernel (one warp a
// (batch, position, head) row), then a dK / dV kernel and a dQ kernel.  Both
// tile kernels recompute s and dp, 14 hd flops a pair: dq sums over keys and
// dk, dv over queries, and a kernel that formed ds once would have to add
// one of them across blocks, with atomics whose order changes from run to
// run.  Here every output element is summed by one wgmma accumulator in a
// fixed loop order and written once: two runs give the same bits.
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
//
// fp32: the tensor cores in 3xTF32 (495 TFLOP/s dense tf32 by wgmma; the
// fp32 FMAs give 67).  Every fp32 operand x of every product is split
// into big = tf32(x) and small = tf32(x - big), both rounded to nearest (ties
// away) by cvt.rna, and a product is big . big + big . small + small . big,
// summed in the fp32 accumulators, the small terms first.  What is dropped
// (small . small, and the rounding of small) is about 2^-22 of a product:
// the CPU emulation (tests/test_torch_lm_train.py) is 2.1e-7 to 2.6e-6 of a
// tensor's largest from the plain version, against FLASH_BWD_TOL's 1e-4;
// one tf32 pass is 4.0e-4 to 1.1e-3.  s and dp are split like the rest:
// an absolute error e in s is a relative error e in p.  The tensor cores'
// accumulator does not round each addition to nearest, and over a long
// chain that drifts (dk of granite's 16,384 query rows a key: 1.3e-4 of its
// largest; s over hd 256: gemma's block VJPs 1.8e-3 of a leaf's largest,
// 4x the fp32 units'), so each chain is cut short: an output product's tile
// and, at hd 128 and 256, each kBatch k-steps of an s or dp product are
// summed in a fresh accumulator and added to the running sum by fp32 adds.
// So the kernels do 3 x 14 hd tf32 flops a pair; the bound is 3 x 10 hd at
// 495 TFLOP/s.
// hd 32 and 64 (namespace x3, wgmma):
//   wgmma reads a 32-bit operand from shared memory only K-major (.tf32 has
//   no transpose), and the dq, dk and dv products sum over the rows of a
//   tile (the keys of k, the queries of q and do).  So every A operand is
//   in registers, split there: the resident tile's fragments (k, v; q, do)
//   loaded from shared memory for s and dp, and the accumulator of s or dp
//   (p, ds) for the output products -- in a tf32 A fragment a thread holds
//   columns t and t + 4 of each 8 where the accumulator gives it 2t and
//   2t + 1, so those stand for k = t and t + 4, and the B tile's rows are
//   permuted to match.  Every B operand is a streamed tile split in shared
//   memory: as it came ([rows][hd], the 128-byte swizzle TMA writes; for s
//   and dp) and transposed ([hd][rows], no swizzle, rows permuted; for the
//   output products).  The producer warpgroup's warps 1-3 make both from
//   each TMA tile (in place and beside it), in dK / dV also copy the
//   tile's lse and delta, and arrive on the stage's "ready" mbarrier;
//   setmaxnreg gives them 56 registers and the two consumer warpgroups
//   224.  The other choice, p and ds written to shared memory as B with the
//   transposed operand from registers, needs as much shared memory a stage
//   and a barrier inside each warpgroup's tile.
//   A streamed tile is R = 2048 / hd rows, 8 KiB; the resident tiles are 64
//   rows (a wgmma's M).  Above hd 64 this stops paying: at hd 256 the
//   resident k and v (128 KiB) leave one stage of 8-row tiles (N 8), and on
//   the H100 that took 2.05x the CUDA-core kernel's time at gemma's shape.
//   x3::dkv_kernel: one block a (kv head, batch, 128 keys), k and v
//     resident, unsplit (64 KiB at hd 64); a stage brings R query rows of q
//     and do: 8 split tiles, 64 KiB; 2 stages.
//   x3::dq_kernel: one block a (head, batch, 128 query rows), q and do
//     resident; a stage brings R keys of k and v: k, v and k^T split, 48
//     KiB; 3 stages.
// hd 128 and 256 (namespace x3m, mma.sync m16n8k8): mma.sync takes both
// operands from registers, so shared memory holds only the raw fp32 tiles,
// rows padded by 4 floats (a fragment load of a row-indexed operand touches
// 32 distinct banks), and each fragment is split as it is loaded.  256
// threads, 8 warps, tiles loaded synchronously between barriers; a block
// holds 64 keys (dK / dV) or 64 query rows (dQ), a streamed tile kTile =
// 64 rows at hd 128, 32 at hd 256.  Per tile:
//   s and dp: each warp 16 rows x kTile / 2 columns, over hd in chains of
//     kBatch = 2 k-steps;
//   p and ds in the fragments' layout (which is the wgmma accumulator's, so
//     p_ds_by_key / _by_row apply), written to shared memory [64][kTile + 4];
//   the output products: each warp 16 rows x hd / 2 columns over the tile's
//     rows, each n8 atom's sum in a fresh accumulator added by an fp32 add.
//   Shared memory at hd 256: dK / dV 213 KiB (k, v staged once, 130 KiB),
//   dQ 204 KiB.
// Masks, skipped tiles, rows without keys and the zero fill as in bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // delta_kernel
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// delta = sum(dout * out) a row: out is fp32 (the forward's residual), dout
// of the inputs' type.
template <typename TD, int HD>
__global__ void __launch_bounds__(kThreads) delta_kernel(const float* __restrict__ out,
                                                         const TD* __restrict__ dout,
                                                         size_t rows, int S, int H,
                                                         float* __restrict__ delta) {
  const size_t row = static_cast<size_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* o = out + row * HD;
  const TD* d = dout + row * HD;
  float sum = 0.f;
  for (int c = lane; c < HD; c += 32) sum = fmaf(to_float(d[c]), o[c], sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {  // rows are [B, S, H]; delta is [B, H, S]
    const size_t b = row / (static_cast<size_t>(S) * H);
    const int s = static_cast<int>(row / H % S), h = static_cast<int>(row % H);
    delta[(b * H + h) * S + s] = sum;
  }
}

// setmaxnreg: with NC > 1 consumer warpgroups the producer warpgroup gives
// registers to them (one consumer keeps the kernel's own budget).
template <int NC, int REGS>
__device__ __forceinline__ void producer_regs() {
  if constexpr (NC > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int NC, int REGS>
__device__ __forceinline__ void consumer_regs() {
  if constexpr (NC > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// ---------------------------------------------------------------- shared by the tile kernels
//
// The mask and the tile ranges: a pair (query row i at position q_offset + i,
// key t) is visible when t < T, t <= the position and, with a window, t >
// position - window.  A kernel walks only the tiles that hold a pair some
// row may see, skips a tile with no visible pair, evaluates the mask only on
// a tile that crosses an edge (or the end of T), and gives a masked pair p =
// 0 by select (never exp2(+inf) of a row without keys, whose lse is -inf).

__device__ __forceinline__ bool visible(int t, int pos, int T_, int window) {
  return t < T_ && t <= pos && (window <= 0 || t > pos - window);
}

struct Tiles {
  int first, count;
};

// The tiles of R query rows whose rows see some key k0 .. k0 + keys - 1.
__device__ __forceinline__ Tiles query_tiles(int k0, int keys, int S, int T_, int q_offset,
                                             int window, int R) {
  const int k_last = min(k0 + keys, T_) - 1;
  const int i_lo = max(0, k0 - q_offset);
  const int i_hi = window > 0 ? min(S - 1, k_last - q_offset + window - 1) : S - 1;
  return {i_lo / R, i_hi >= i_lo ? i_hi / R - i_lo / R + 1 : 0};
}

// The tiles of R keys that some row row0 .. row0 + rows - 1 sees.
__device__ __forceinline__ Tiles key_tiles(int row0, int rows, int S, int T_, int q_offset,
                                           int window, int R) {
  const int t_hi = min(T_ - 1, q_offset + min(row0 + rows, S) - 1);
  const int t_lo = window > 0 ? max(0, q_offset + row0 - window + 1) : 0;
  return {t_lo / R, t_hi >= t_lo ? t_hi / R - t_lo / R + 1 : 0};
}

// Keys t0 .. t0 + TK - 1 against positions p0 .. p0 + TQ - 1: no pair is
// visible by the mask ...
template <int TK, int TQ>
__device__ __forceinline__ bool no_pair(int t0, int p0, int window) {
  return t0 > p0 + TQ - 1 || (window > 0 && t0 + TK - 1 <= p0 - window);
}

// ... or some pair is masked, or some key is past T.
template <int TK, int TQ>
__device__ __forceinline__ bool on_edge(int t0, int p0, int T_, int window) {
  return t0 + TK - 1 >= T_ || t0 + TK - 1 > p0 || (window > 0 && t0 <= p0 + TQ - 1 - window);
}

// p = exp2(s log2(e) / sqrt(hd) - lse log2(e)) and ds = p (dp - delta) for one
// element; ``ok``: the pair is visible.
__device__ __forceinline__ void p_ds(float& s, float& dp, float scale_log2, float lse2,
                                     float dl, bool ok) {
  const float p = exp2f(fmaf(s, scale_log2, -lse2));
  s = ok ? p : 0.f;
  dp = s * (dp - dl);
}

// s and dp turned into p and ds in an m64 x N wgmma accumulator (m64nN f32:
// this thread holds rows r + {0, 8} and, in each group of 8 columns, columns
// 2 (lane % 4) + {0, 1}; element 4 i + 2 hf + e is (row r + 8 hf, column
// 8 i + 2 (lane % 4) + e)); ``lane`` is the thread's lane.
// By key (x3m's dK / dV): the rows are keys t + {0, 8}, the columns query
// rows r0 .. r0 + N - 1 at positions p0 .., their lse (log2 units) and delta
// in shared memory; query rows past S are masked too.  (The wgmma dK / dV
// kernels write this loop out: as a call it cost them 5-12% on the H100.)
template <int N>
__device__ __forceinline__ void p_ds_by_key(float (&s)[N / 2], float (&dp)[N / 2],
                                            const float* lse, const float* delta, int lane, int t,
                                            int r0, int p0, int S, int T_, int window,
                                            float scale_log2, bool edge) {
  const int cq = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * i + cq + e;
      const float lse2 = lse[col], dl = delta[col];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const bool ok = !edge || (r0 + col < S && visible(t + 8 * hf, p0 + col, T_, window));
        p_ds(s[4 * i + 2 * hf + e], dp[4 * i + 2 * hf + e], scale_log2, lse2, dl, ok);
      }
    }
  }
}

// By query row (every dQ kernel): the rows are positions pos + {0, 8} (lse
// in log2 units and delta in registers), the columns keys t0 .. t0 + N - 1.
template <int N>
__device__ __forceinline__ void p_ds_by_row(float (&s)[N / 2], float (&dp)[N / 2],
                                            const float (&lse2)[2], const float (&dl)[2], int lane,
                                            int t0, int pos, int T_, int window, float scale_log2,
                                            bool edge) {
  const int cq = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = t0 + 8 * i + cq + e;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const bool ok = !edge || visible(t, pos + 8 * hf, T_, window);
        p_ds(s[4 * i + 2 * hf + e], dp[4 * i + 2 * hf + e], scale_log2, lse2[hf], dl[hf], ok);
      }
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The dK / dV epilogue from an accumulator layout: keys t + {0, 8} (those
// before T), NCOL columns from col0; dk scaled.  dk and dv point at (batch,
// key 0, kv head, column 0) of [B, T, KV, HD].
template <int HD, int NCOL, typename T>
__device__ __forceinline__ void store_dkv(T* dk, T* dv, const float (&dk_acc)[NCOL / 2],
                                          const float (&dv_acc)[NCOL / 2], int t, int T_, int KV,
                                          int col0, float scale) {
  const int cq = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (t + 8 * hf >= T_) continue;
    const size_t at = static_cast<size_t>(t + 8 * hf) * KV * HD + col0 + cq;
#pragma unroll
    for (int i = 0; i < NCOL / 8; ++i) {
      store2(dk + at + 8 * i, dk_acc[4 * i + 2 * hf] * scale, dk_acc[4 * i + 2 * hf + 1] * scale);
      store2(dv + at + 8 * i, dv_acc[4 * i + 2 * hf], dv_acc[4 * i + 2 * hf + 1]);
    }
  }
}

// The dQ epilogue: rows row + {0, 8} (those before S), NCOL columns from
// col0, scaled.  dq points at (batch, row 0, head, column 0) of [B, S, H, HD].
template <int HD, int NCOL, typename T>
__device__ __forceinline__ void store_dq(T* dq, const float (&acc)[NCOL / 2], int row, int S,
                                         int H, int col0, float scale) {
  const int cq = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (row + 8 * hf >= S) continue;
    T* out = dq + static_cast<size_t>(row + 8 * hf) * H * HD + col0 + cq;
#pragma unroll
    for (int i = 0; i < NCOL / 8; ++i) {
      store2(out + 8 * i, acc[4 * i + 2 * hf] * scale, acc[4 * i + 2 * hf + 1] * scale);
    }
  }
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

template <typename TD, int HD>
cudaError_t launch_delta(const void* out, const void* dout, int B, int S, int H, void* delta,
                         cudaStream_t stream) {
  const size_t rows = static_cast<size_t>(B) * S * H;
  const unsigned blocks = static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  delta_kernel<TD, HD><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(out), static_cast<const TD*>(dout), rows, S, H,
      static_cast<float*>(delta));
  return cudaGetLastError();
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
  const auto [first, ntiles] = query_tiles(k0, C::kKeys, S, T_, q_offset, window, 64);
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
    producer_regs<NC, kProducerRegs>();
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
  consumer_regs<NC, kConsumerRegs>();
  constexpr int NCOL = C::kCols;
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int kg = wg % C::kGroups, part = wg / C::kGroups;
  const int t0 = k0 + 64 * kg;  // the warpgroup's first key
  // in the accumulator layout (p_ds_by_key) this thread holds keys t0 + r
  // (+ 8); the columns of s^T and dp^T are query rows
  const int r = 16 * warp + (lane >> 2);
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
      if (t0 < T_ && !no_pair<64, 64>(t0, p0, window)) {
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

        // p^T and ds^T, the lse and delta of each column (query row) from the
        // stage.  Written out, mask and edge test too: as calls (p_ds_by_key,
        // visible, on_edge) they cost this kernel 5-12% on the H100.
        const float* stat = stat_sh + st * 128;
        const bool edge = t0 + 63 >= T_ || r0 + 63 >= S || t0 + 63 > p0 ||
                          (window > 0 && t0 <= p0 + 63 - window);
        const int cq = 2 * (lane & 3);
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

  const size_t at = (static_cast<size_t>(b) * T_ * KV + grp) * HD;
  store_dkv<HD, NCOL>(dk + at, dv + at, dk_acc, dv_acc, t0 + r, T_, KV, part * NCOL, scale);
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
  const auto [tile0, ntiles] = key_tiles(row0, C::kRows, S, T_, q_offset, window, 64);
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
    producer_regs<NC, kProducerRegs>();
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
  consumer_regs<NC, kConsumerRegs>();
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int wrow0 = row0 + 64 * wg, p0 = q_offset + wrow0;
  const int r = wrow0 + 16 * warp + (lane >> 2);
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
    if (wrow0 < S && !no_pair<64, 64>(t0, p0, window)) {
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
      p_ds_by_row<64>(s, dp, lse2, dl, lane, t0, q_offset + r, T_, window, scale_log2,
                      on_edge<64, 64>(t0, p0, T_, window));
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

  store_dq<HD, HD>(dq + (static_cast<size_t>(b) * S * H + h) * HD, dq_acc, r, S, H, 0, scale);
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
  err = launch_delta<__nv_bfloat16, HD>(out, dout, B, S, H, delta, stream);
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

// ------------------------------------------------------ fp32, hd 32 and 64: 3xTF32 by wgmma
//
// The bf16 kernels' shape (namespace tc) with the operands split in three
// tf32 products each (the header note says why each operand sits where it
// does).  Tiles are fp32: a resident [64][hd] tile and a streamed tile as
// TMA writes it are boxes of [rows][32 columns] (128 bytes) in the 128-byte
// swizzle, box c at c x rows x 128 bytes; a transposed tile [hd][R] is in
// the no-swizzle K-major layout of 8 x 4 core matrices.

namespace x3 {

using namespace hopper;

constexpr int kProducerRegs = 56;   // warp 0: TMA; warps 1-3: the split
constexpr int kConsumerRegs = 224;  // 128 * (56 + 2 * 224) = 64,512 <= 65,536
constexpr int kHelpers = 96;        // the producer warpgroup's warps 1-3

// hd 32 and 64 (x3m takes 128 and 256)
template <int HD>
struct Cfg {
  static_assert(HD <= 64, "x3 tiles hd 32 and 64");
  static constexpr int kR = 2048 / HD;            // rows of a streamed tile
  static constexpr int kTileBytes = kR * HD * 4;  // 8 KiB
  static constexpr int kResBytes = 64 * HD * 4;   // a resident [64][hd] tile
  static constexpr int kBoxes = HD / 32;          // 32-column boxes of a row
  // dkv_kernel: 128 keys, 64 a warpgroup; smem: k, v [2][res]; [kKvStages][8
  // tiles: q, q small, do, do small, q^T, q^T small, do^T, do^T small]; lse
  // (log2 units), delta [kKvStages][2 R]; mbarriers kv, raw[ST], ready[ST],
  // empty[ST]
  static constexpr int kKeys = 128;
  static constexpr int kKvStages = 2;
  static constexpr size_t kKvStat = static_cast<size_t>(4) * kResBytes +
                                    static_cast<size_t>(8 * kKvStages) * kTileBytes;
  static constexpr size_t kKvBars = kKvStat + kKvStages * 2 * kR * sizeof(float);
  static constexpr size_t kKvSmem = 1024 + kKvBars + 8 * (1 + 3 * kKvStages);
  // dq_kernel: 128 query rows, 64 a warpgroup; q, do [2][res]; [kQStages][6
  // tiles: k, k small, v, v small, k^T, k^T small]
  static constexpr int kRows = 128;
  static constexpr int kQStages = 3;
  static constexpr size_t kQBars = static_cast<size_t>(4) * kResBytes +
                                   static_cast<size_t>(6 * kQStages) * kTileBytes;
  static constexpr size_t kQSmem = 1024 + kQBars + 8 * (1 + 3 * kQStages);
};


// Byte offset of (row, col), col % 4 == 0, in a [rows][hd] tile of 128-byte
// swizzled boxes [rows][32].
__device__ __forceinline__ uint32_t nat_off(int rows, int row, int col) {
  return (col >> 5) * rows * 128 + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4);
}

// Byte offset of (n, k), k % 4 == 0, in an [n][K] tile, K-major without
// swizzle: core matrix (n / 8, k / 4) of 8 rows x 16 bytes at (n / 8) 32 K +
// (k / 4) 128.
__device__ __forceinline__ uint32_t tr_off(int K, int n, int k) {
  return (n >> 3) * (K * 32) + (k >> 2) * 128 + (n & 7) * 16;
}

// B descriptor of k-step kk (columns 8 kk ..) of a [N][hd] tile as TMA writes it.
template <int N>
__device__ __forceinline__ uint64_t nat_desc(uint32_t tile, int kk) {
  return smem_desc(tile + ((8 * kk) >> 5) * N * 128 + ((8 * kk) & 31) * 4, 16, 1024, 1);
}

// B descriptor of k-step kk (rows 8 kk .. of the streamed tile) of a
// transposed [hd][K] tile.
template <int K>
__device__ __forceinline__ uint64_t tr_desc(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 256, 128, K * 32, 0);
}

// The split A fragments of k-steps kk0 .. kk0 + NB - 1 of a resident [64][hd]
// tile: this thread's rows 16 warp + g (+ 8), columns 8 kk + t (+ 4).
template <int NB>
__device__ __forceinline__ void res_frags(const uint8_t* tile, int warp, int lane, int kk0,
                                          uint32_t (&big)[NB][4], uint32_t (&small)[NB][4]) {
  const int g = lane >> 2, t = lane & 3;
  const uint8_t* row = tile + (16 * warp + g) * 128 + 4 * t;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int kk = kk0 + i;
    const uint8_t* box = row + (kk >> 2) * 64 * 128;
    const int u = 2 * (kk & 3);  // the 16-byte unit of column 8 kk (+ t)
    const uint8_t* lo = box + ((u ^ g) << 4);        // column 8 kk + t
    const uint8_t* hi = box + (((u + 1) ^ g) << 4);  // column 8 kk + t + 4
    split_tf32(*reinterpret_cast<const float*>(lo), big[i][0], small[i][0]);
    split_tf32(*reinterpret_cast<const float*>(lo + 1024), big[i][1], small[i][1]);  // row + 8
    split_tf32(*reinterpret_cast<const float*>(hi), big[i][2], small[i][2]);
    split_tf32(*reinterpret_cast<const float*>(hi + 1024), big[i][3], small[i][3]);
  }
}

// Columns 8 i .. 8 i + 7 of an m64 accumulator (d = its elements 4 i ..) as
// the split A fragment of one k-step: the thread's columns 2 t and 2 t + 1
// stand for k = t and t + 4 (tr_row permutes the B tile's rows to match).
__device__ __forceinline__ void acc_frag(const float* d, uint32_t (&big)[4],
                                         uint32_t (&small)[4]) {
  split_tf32(d[0], big[0], small[0]);
  split_tf32(d[2], big[1], small[1]);
  split_tf32(d[1], big[2], small[2]);
  split_tf32(d[3], big[3], small[3]);
}

// d (m64 x N) = a . b^T over hd in 3xTF32, one chain of hd / 8 k-steps: a a
// resident [64][hd] tile (split in registers), b a streamed [N][hd] tile
// split in shared memory.  Waited for.
template <int HD, int N>
__device__ __forceinline__ void product(float (&d)[N / 2], const uint8_t* a, const uint8_t* b_big,
                                        const uint8_t* b_small, int warp, int lane) {
  constexpr int NK = HD / 8;
  const uint32_t bb = smem_u32(b_big), bs = smem_u32(b_small);
  uint32_t ab[NK][4], as[NK][4];
  res_frags<NK>(a, warp, lane, 0, ab, as);
#pragma unroll
  for (int e = 0; e < N / 2; ++e) d[e] = 0.f;
  wgmma_fence();
  fence_regs(d);
#pragma unroll
  for (int i = 0; i < NK; ++i) {  // the small terms first
    wgmma_tf32<N>(d, as[i], nat_desc<N>(bb, i));
    wgmma_tf32<N>(d, ab[i], nat_desc<N>(bs, i));
  }
#pragma unroll
  for (int i = 0; i < NK; ++i) wgmma_tf32<N>(d, ab[i], nat_desc<N>(bb, i));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
#pragma unroll
  for (int i = 0; i < NK; ++i) {
    fence_regs(ab[i]);
    fence_regs(as[i]);
  }
}

// d (m64 x N) += a . b over the R rows of a streamed tile in 3xTF32: a an
// m64 x R accumulator (p or ds), b the transposed split tile ([N][R]).  The
// tile's sum is formed by the tensor cores in a fresh accumulator and then
// added to d by fp32 adds (the header note says why).
template <int R, int N>
__device__ __forceinline__ void product_acc(float (&d)[N / 2], const float (&a)[R / 2],
                                            const uint8_t* b_big, const uint8_t* b_small) {
  uint32_t ab[R / 8][4], as[R / 8][4];
#pragma unroll
  for (int i = 0; i < R / 8; ++i) acc_frag(a + 4 * i, ab[i], as[i]);
  const uint32_t bb = smem_u32(b_big), bs = smem_u32(b_small);
  float part[N / 2];
#pragma unroll
  for (int j = 0; j < N / 2; ++j) part[j] = 0.f;
  wgmma_fence();
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < R / 8; ++i) {  // the small terms first
    wgmma_tf32<N>(part, as[i], tr_desc<R>(bb, i));
    wgmma_tf32<N>(part, ab[i], tr_desc<R>(bs, i));
  }
#pragma unroll
  for (int i = 0; i < R / 8; ++i) wgmma_tf32<N>(part, ab[i], tr_desc<R>(bb, i));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(part);
#pragma unroll
  for (int j = 0; j < N / 2; ++j) d[j] += part[j];
#pragma unroll
  for (int i = 0; i < R / 8; ++i) {
    fence_regs(ab[i]);
    fence_regs(as[i]);
  }
}

// Row r of a streamed tile is row tr_row(r) of the transposed one: within
// each 8, rows 2 j and 2 j + 1 go to j and j + 4 (acc_frag's k order).
__device__ __forceinline__ int tr_row(int r) { return (r & ~7) + ((r & 7) >> 1) + 4 * (r & 1); }

// The producer's split of a streamed [R][hd] tile that TMA wrote to ``big``:
// big and small in place of and beside it and, with TR, both transposed
// (tr_big, tr_small: [hd][R], rows permuted by tr_row).  A unit is 4 rows of
// one parity in an 8 (they are 4 consecutive rows of the transposed tile)
// by 4 columns; helper h of kHelpers takes units h, h + kHelpers, ...
template <int HD, bool TR>
__device__ __forceinline__ void split_tile(uint8_t* big, uint8_t* small, uint8_t* tr_big,
                                           uint8_t* tr_small, int h) {
  constexpr int R = Cfg<HD>::kR, CG = HD / 4;
  for (int u = h; u < (R / 4) * CG; u += kHelpers) {
    const int rg = u / CG, c = 4 * (u % CG);
    const int r0 = 8 * (rg >> 1) + (rg & 1);  // rows r0, r0 + 2, r0 + 4, r0 + 6
    float x[4][4];  // the raw values (the split is formed again for the transposed copy)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t off = nat_off(R, r0 + 2 * e, c);
      const float4 v = *reinterpret_cast<const float4*>(big + off);
      x[e][0] = v.x, x[e][1] = v.y, x[e][2] = v.z, x[e][3] = v.w;
      uint32_t b[4], sm[4];
#pragma unroll
      for (int ci = 0; ci < 4; ++ci) split_tf32(x[e][ci], b[ci], sm[ci]);
      *reinterpret_cast<uint4*>(big + off) = make_uint4(b[0], b[1], b[2], b[3]);
      *reinterpret_cast<uint4*>(small + off) = make_uint4(sm[0], sm[1], sm[2], sm[3]);
    }
    if constexpr (TR) {
      const int k = tr_row(r0);  // rows r0 + 2 e land on k + e
#pragma unroll
      for (int ci = 0; ci < 4; ++ci) {
        uint32_t b[4], sm[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(x[e][ci], b[e], sm[e]);
        const uint32_t off = tr_off(R, c + ci, k);
        *reinterpret_cast<uint4*>(tr_big + off) = make_uint4(b[0], b[1], b[2], b[3]);
        *reinterpret_cast<uint4*>(tr_small + off) = make_uint4(sm[0], sm[1], sm[2], sm[3]);
      }
    }
  }
}

// One block per (kv head, batch, 128 keys); keys with the most queries (the
// first, causal) launch first.  Warpgroup w holds keys 64 w of the block.
template <int HD>
__global__ void __launch_bounds__(128 * 3, 1) dkv_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, int S, int T_, int H, int KV,
    float scale_log2, float scale, int q_offset, int window, float* __restrict__ dk,
    float* __restrict__ dv) {
  using C = Cfg<HD>;
  constexpr int NC = 2, R = C::kR, ST = C::kKvStages, TB = C::kTileBytes, RB = C::kResBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  uint8_t* k_sh = base;                // [2][res]
  uint8_t* v_sh = k_sh + 2 * RB;       // [2][res]
  uint8_t* stage_sh = v_sh + 2 * RB;   // [ST][8][tile]
  float* stat_sh = reinterpret_cast<float*>(base + C::kKvStat);  // [ST][lse R, delta R]
  const uint32_t kv_full = smem_u32(base + C::kKvBars);
  const uint32_t raw0 = kv_full + 8, ready0 = raw0 + 8 * ST, empty0 = ready0 + 8 * ST;
  // tile i of stage st: 0 q, 1 q small, 2 do, 3 do small, 4 q^T, 5 q^T small,
  // 6 do^T, 7 do^T small
  auto tile = [&](int st, int i) { return stage_sh + (st * 8 + i) * TB; };

  const int grp = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * C::kKeys;
  const int G = H / KV;
  // the query tiles whose rows see some key of the block, each walked for
  // the G heads of the group
  const auto [first, ntiles] = query_tiles(k0, C::kKeys, S, T_, q_offset, window, R);
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(raw0 + 8 * st, 1);
      mbar_init(ready0 + 8 * st, kHelpers);
      mbar_init(empty0 + 8 * st, 4 * NC);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    producer_regs<NC, kProducerRegs>();
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    if (warp == 0) {
      // ---- warp 0's lane 0: k and v once, then the ring of (q, do) tiles
      if (lane != 0) return;
      const int groups = min(2, (T_ - k0 + 63) / 64);  // a box wholly past T is not loaded
      mbar_expect_tx(kv_full, 2 * groups * RB);
      for (int w = 0; w < groups; ++w) {
        for (int c = 0; c < C::kBoxes; ++c) {
          const int off = w * RB + c * 64 * 128;
          tma_load(smem_u32(k_sh + off), &k_map, kv_full, 32 * c, grp, k0 + 64 * w, b);
          tma_load(smem_u32(v_sh + off), &v_map, kv_full, 32 * c, grp, k0 + 64 * w, b);
        }
      }
      int j = 0;
      for (int gi = 0; gi < G; ++gi) {
        const int h = grp * G + gi;
        for (int it = 0; it < ntiles; ++it, ++j) {
          const int st = j % ST, r0 = (first + it) * R;
          if (j >= ST) mbar_wait(empty0 + 8 * st, (j / ST - 1) & 1);
          const uint32_t raw = raw0 + 8 * st;
          mbar_expect_tx(raw, 2 * TB);
          for (int c = 0; c < C::kBoxes; ++c) {
            tma_load(smem_u32(tile(st, 0) + c * R * 128), &q_map, raw, 32 * c, h, r0, b);
            tma_load(smem_u32(tile(st, 2) + c * R * 128), &do_map, raw, 32 * c, h, r0, b);
          }
        }
      }
      return;
    }
    // ---- warps 1-3: split each stage, load its lse and delta
    const int hl = tid - NC * 128 - 32;
    int j = 0;
    for (int gi = 0; gi < G; ++gi) {
      const int h = grp * G + gi;
      const size_t stat = (static_cast<size_t>(b) * H + h) * S;
      for (int it = 0; it < ntiles; ++it, ++j) {
        const int st = j % ST, r0 = (first + it) * R;
        mbar_wait(raw0 + 8 * st, (j / ST) & 1);
        split_tile<HD, true>(tile(st, 0), tile(st, 1), tile(st, 4), tile(st, 5), hl);
        split_tile<HD, true>(tile(st, 2), tile(st, 3), tile(st, 6), tile(st, 7), hl);
        for (int i = hl; i < R; i += kHelpers) {  // rows past S: 0, masked
          const bool in = r0 + i < S;
          stat_sh[st * 2 * R + i] = in ? lse[stat + r0 + i] * kLog2e : 0.f;
          stat_sh[st * 2 * R + R + i] = in ? delta[stat + r0 + i] : 0.f;
        }
        fence_proxy_async();
        mbar_arrive(ready0 + 8 * st);
      }
    }
    return;
  }

  // ---- consumers
  consumer_regs<NC, kConsumerRegs>();
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int t0 = k0 + 64 * wg;  // the warpgroup's first key
  // in the accumulator layout (p_ds_by_key) this thread holds keys t0 + r
  // (+ 8); the columns of s^T and dp^T are query rows
  const int r = 16 * warp + (lane >> 2);
  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint8_t* ka = k_sh + wg * RB;
  const uint8_t* va = v_sh + wg * RB;
  mbar_wait(kv_full, 0);

  int j = 0;
  for (int gi = 0; gi < G; ++gi) {
    for (int it = 0; it < ntiles; ++it, ++j) {
      const int st = j % ST, r0 = (first + it) * R, p0 = q_offset + r0;
      mbar_wait(ready0 + 8 * st, (j / ST) & 1);
      if (t0 < T_ && !no_pair<64, R>(t0, p0, window)) {
        float s[R / 2], dp[R / 2];
        product<HD, R>(s, ka, tile(st, 0), tile(st, 1), warp, lane);   // s^T = k q^T
        product<HD, R>(dp, va, tile(st, 2), tile(st, 3), warp, lane);  // dp^T = v do^T
        // p^T and ds^T, written out as in tc::dkv_kernel (lse in log2 units)
        const float* stat = stat_sh + st * 2 * R;
        const bool edge = t0 + 63 >= T_ || r0 + R - 1 >= S || t0 + 63 > p0 ||
                          (window > 0 && t0 <= p0 + R - 1 - window);
        const int cq = 2 * (lane & 3);
#pragma unroll
        for (int i = 0; i < R / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * i + cq + e;
            const float lse2 = stat[col], dl = stat[R + col];
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
        product_acc<R, HD>(dv_acc, s, tile(st, 6), tile(st, 7));   // dv += p^T do
        product_acc<R, HD>(dk_acc, dp, tile(st, 4), tile(st, 5));  // dk += ds^T q
      }
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }
  }

  const size_t at = (static_cast<size_t>(b) * T_ * KV + grp) * HD;
  store_dkv<HD, HD>(dk + at, dv + at, dk_acc, dv_acc, t0 + r, T_, KV, 0, scale);
}

// One block per (head, batch, kRows query rows); the rows with the most keys
// (the last, causal) launch first.  Warpgroup w holds rows 64 w of the block.
template <int HD>
__global__ void __launch_bounds__(128 * 3, 1) dq_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, int S, int T_, int H, int KV,
    float scale_log2, float scale, int q_offset, int window, float* __restrict__ dq) {
  using C = Cfg<HD>;
  constexpr int NC = 2, R = C::kR, ST = C::kQStages, TB = C::kTileBytes;
  constexpr int RB = C::kResBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  uint8_t* q_sh = base;                  // [NC][res]
  uint8_t* do_sh = q_sh + NC * RB;       // [NC][res]
  uint8_t* stage_sh = do_sh + NC * RB;   // [ST][6][tile]
  const uint32_t qd_full = smem_u32(base + C::kQBars);
  const uint32_t raw0 = qd_full + 8, ready0 = raw0 + 8 * ST, empty0 = ready0 + 8 * ST;
  // tile i of stage st: 0 k, 1 k small, 2 v, 3 v small, 4 k^T, 5 k^T small
  auto tile = [&](int st, int i) { return stage_sh + (st * 6 + i) * TB; };

  const int h = blockIdx.x, b = blockIdx.y;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * C::kRows;
  const int grp = h / (H / KV);
  // the kv tiles holding a key some row of the block may see
  const auto [tile0, ntiles] = key_tiles(row0, C::kRows, S, T_, q_offset, window, R);
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    mbar_init(qd_full, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(raw0 + 8 * st, 1);
      mbar_init(ready0 + 8 * st, kHelpers);
      mbar_init(empty0 + 8 * st, 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    producer_regs<NC, kProducerRegs>();
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    if (warp == 0) {
      // ---- warp 0's lane 0: q and do once, then the ring of (k, v) tiles
      if (lane != 0) return;
      const int wgs = min(NC, (S - row0 + 63) / 64);  // the warpgroups that hold a row
      mbar_expect_tx(qd_full, 2 * wgs * RB);
      for (int w = 0; w < wgs; ++w) {
        for (int c = 0; c < C::kBoxes; ++c) {
          const int off = w * RB + c * 64 * 128;
          tma_load(smem_u32(q_sh + off), &q_map, qd_full, 32 * c, h, row0 + 64 * w, b);
          tma_load(smem_u32(do_sh + off), &do_map, qd_full, 32 * c, h, row0 + 64 * w, b);
        }
      }
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % ST, t0 = (tile0 + j) * R;
        if (j >= ST) mbar_wait(empty0 + 8 * st, (j / ST - 1) & 1);
        const uint32_t raw = raw0 + 8 * st;
        mbar_expect_tx(raw, 2 * TB);
        for (int c = 0; c < C::kBoxes; ++c) {
          tma_load(smem_u32(tile(st, 0) + c * R * 128), &k_map, raw, 32 * c, grp, t0, b);
          tma_load(smem_u32(tile(st, 2) + c * R * 128), &v_map, raw, 32 * c, grp, t0, b);
        }
      }
      return;
    }
    // ---- warps 1-3: split each stage (k also transposed)
    const int hl = tid - NC * 128 - 32;
    for (int j = 0; j < ntiles; ++j) {
      const int st = j % ST;
      mbar_wait(raw0 + 8 * st, (j / ST) & 1);
      split_tile<HD, true>(tile(st, 0), tile(st, 1), tile(st, 4), tile(st, 5), hl);
      split_tile<HD, false>(tile(st, 2), tile(st, 3), nullptr, nullptr, hl);
      fence_proxy_async();
      mbar_arrive(ready0 + 8 * st);
    }
    return;
  }

  // ---- consumers: rows wrow0 .. wrow0 + 63, in the accumulator layout
  consumer_regs<NC, kConsumerRegs>();
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int wrow0 = row0 + 64 * wg, p0 = q_offset + wrow0;
  const int r = wrow0 + 16 * warp + (lane >> 2);
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
  const uint8_t* qa = q_sh + wg * RB;
  const uint8_t* da = do_sh + wg * RB;
  mbar_wait(qd_full, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % ST, t0 = (tile0 + j) * R;
    mbar_wait(ready0 + 8 * st, (j / ST) & 1);
    if (wrow0 < S && !no_pair<R, 64>(t0, p0, window)) {
      float s[R / 2], dp[R / 2];
      product<HD, R>(s, qa, tile(st, 0), tile(st, 1), warp, lane);   // s = q k^T
      product<HD, R>(dp, da, tile(st, 2), tile(st, 3), warp, lane);  // dp = do v^T
      // rows past S are never written: only keys and the mask matter here
      p_ds_by_row<R>(s, dp, lse2, dl, lane, t0, q_offset + r, T_, window, scale_log2,
                     on_edge<R, 64>(t0, p0, T_, window));
      product_acc<R, HD>(dq_acc, dp, tile(st, 4), tile(st, 5));  // dq += ds k
    }
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  store_dq<HD, HD>(dq + (static_cast<size_t>(b) * S * H + h) * HD, dq_acc, r, S, H, 0, scale);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const void* lse, int B, int S, int T_, int H, int KV, float scale, int q_offset,
           int window, void* delta, void* dq, void* dk, void* dv, cudaStream_t stream) {
  using C = Cfg<HD>;
  constexpr CUtensorMapSwizzle kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  // resident tiles: 64-row boxes; streamed tiles: R-row boxes
  CUtensorMap q_res, do_res, k_res, v_res, q_st, do_st, k_st, v_st;
  if (!tensor_map<float>(&q_res, q, B, S, H, HD, 32, kSw) ||
      !tensor_map<float>(&do_res, dout, B, S, H, HD, 32, kSw) ||
      !tensor_map<float>(&k_res, k, B, T_, KV, HD, 32, kSw) ||
      !tensor_map<float>(&v_res, v, B, T_, KV, HD, 32, kSw) ||
      !tensor_map<float>(&q_st, q, B, S, H, HD, 32, kSw, C::kR) ||
      !tensor_map<float>(&do_st, dout, B, S, H, HD, 32, kSw, C::kR) ||
      !tensor_map<float>(&k_st, k, B, T_, KV, HD, 32, kSw, C::kR) ||
      !tensor_map<float>(&v_st, v, B, T_, KV, HD, 32, kSw, C::kR)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kKvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kQSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_delta<float, HD>(out, dout, B, S, H, delta, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  const float scale_log2 = scale * kLog2e;
  dkv_kernel<HD><<<dim3(KV, B, (T_ + C::kKeys - 1) / C::kKeys), 128 * 3, C::kKvSmem, stream>>>(
      q_st, k_res, v_res, do_st, lf, df, S, T_, H, KV, scale_log2, scale, q_offset, window,
      static_cast<float*>(dk), static_cast<float*>(dv));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<HD><<<dim3(H, B, (S + C::kRows - 1) / C::kRows), 128 * 3, C::kQSmem, stream>>>(
      q_res, k_st, v_st, do_res, lf, df, S, T_, H, KV, scale_log2, scale, q_offset, window,
      static_cast<float*>(dq));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace x3

// ---------------------------------------------- fp32, hd 128 and 256: 3xTF32 by mma.sync
//
// The header note says why these tile hd 128 and 256: raw fp32 tiles in
// shared memory, every operand split in registers as it is loaded.

namespace x3m {

using namespace hopper;

template <int HD>
struct Cfg {
  static constexpr int kLd = HD + 4;   // row stride (floats) of a staged tile
  static constexpr int kBlock = 64;    // keys (dK / dV) or query rows (dQ) a block
  // query rows (dK / dV) or keys (dQ) a streamed tile; s and dp of a warp:
  // 16 rows by kTile / 2 columns, kTile / 16 n8 atoms
  static constexpr int kTile = HD <= 128 ? 64 : 32;
  static constexpr int kPLd = kTile + 4;  // row stride of p^T, ds^T or ds [64][kTile]
  static constexpr int kBatch = 2;     // k-steps of an s or dp chain
  static constexpr int kCols = HD / 2;  // output columns a warp
  static constexpr size_t kStaged = static_cast<size_t>(2 * kBlock + 2 * kTile) * kLd;
  static constexpr size_t kDkvSmem = sizeof(float) * (kStaged + 2 * kBlock * kPLd + 2 * kTile);
  static constexpr size_t kDqSmem = sizeof(float) * (kStaged + kBlock * kPLd);
};

// Rows [0, rows) of a [positions][stride] fp32 tensor (rows from ``valid``
// on: 0) into shared memory as [rows][HD + 4].
template <int HD>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const float* __restrict__ src,
                                          size_t stride, int rows, int valid) {
  constexpr int PER = HD / 4;
  for (int idx = threadIdx.x; idx < rows * PER; idx += kThreads) {
    const int r = idx / PER, c = (idx % PER) * 4;
    *reinterpret_cast<float4*>(dst + r * (HD + 4) + c) =
        r < valid ? *reinterpret_cast<const float4*>(src + r * stride + c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The split A fragment of rows r0 .., columns c0 .. of a [rows][ld] tile.
__device__ __forceinline__ void a_frag(const float* x, int ld, int r0, int c0, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = x + (r0 + g) * ld + c0 + t;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[8 * ld], big[1], small[1]);
  split_tf32(p[4], big[2], small[2]);
  split_tf32(p[8 * ld + 4], big[3], small[3]);
}

// The split B fragment (k = c0 .., n = r0 ..) of a . x^T: x's rows are n.
__device__ __forceinline__ void b_frag_t(const float* x, int ld, int r0, int c0,
                                         uint32_t (&big)[2], uint32_t (&small)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = x + (r0 + g) * ld + c0 + t;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[4], big[1], small[1]);
}

// The split B fragment (k = r0 .., n = c0 ..) of a . x: x's rows are k.
__device__ __forceinline__ void b_frag(const float* x, int ld, int r0, int c0, uint32_t (&big)[2],
                                       uint32_t (&small)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = x + (r0 + t) * ld + c0 + g;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[4 * ld], big[1], small[1]);
}

// s = a1 . b1^T and dp = a2 . b2^T over hd: rows r0 .. r0 + 15 of a1 and a2
// by rows n0 .. n0 + 4 NA - 1 of b1 and b2 (NA / 2 n8 atoms, s[4 j ..]),
// [rows][hd + 4] tiles; each chain of kBatch k-steps summed apart.
template <int HD, int NA>
__device__ __forceinline__ void dots(float (&s)[NA], float (&dp)[NA], const float* a1,
                                     const float* a2, const float* b1, const float* b2, int r0,
                                     int n0) {
  constexpr int LD = HD + 4, NB = Cfg<HD>::kBatch;
#pragma unroll
  for (int e = 0; e < NA; ++e) s[e] = dp[e] = 0.f;
#pragma unroll 4
  for (int kk0 = 0; kk0 < HD / 8; kk0 += NB) {
    float ps[NA] = {}, pd[NA] = {};
#pragma unroll
    for (int kk = kk0; kk < kk0 + NB; ++kk) {
      uint32_t ab[4], as[4], bb[2], bs[2];
      a_frag(a1, LD, r0, 8 * kk, ab, as);
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {
        b_frag_t(b1, LD, n0 + 8 * j, 8 * kk, bb, bs);
        mma_3xtf32(ps + 4 * j, ab, as, bb, bs);
      }
      a_frag(a2, LD, r0, 8 * kk, ab, as);
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {
        b_frag_t(b2, LD, n0 + 8 * j, 8 * kk, bb, bs);
        mma_3xtf32(pd + 4 * j, ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int e = 0; e < NA; ++e) {
      s[e] += ps[e];
      dp[e] += pd[e];
    }
  }
}

// d += a . b over the K rows of b: rows r0 .. r0 + 15 of a ([16][K] of a
// [rows][lda] tile), NCOL columns of b from n0 (NCOL / 8 atoms, d[4 j ..]).
// Each atom's sum in a fresh accumulator, added to d by fp32 adds.
template <int K, int NCOL>
__device__ __forceinline__ void sums(float (&d)[NCOL / 2], const float* a, int lda,
                                     const float* b, int ldb, int r0, int n0) {
  uint32_t ab[K / 8][4], as[K / 8][4];
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) a_frag(a, lda, r0, 8 * kk, ab[kk], as[kk]);
#pragma unroll
  for (int j = 0; j < NCOL / 8; ++j) {
    float part[4] = {};
#pragma unroll
    for (int kk = 0; kk < K / 8; ++kk) {
      uint32_t bb[2], bs[2];
      b_frag(b, ldb, 8 * kk, n0 + 8 * j, bb, bs);
      mma_3xtf32(part, ab[kk], as[kk], bb, bs);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) d[4 * j + e] += part[e];
  }
}

// p or ds (NA values in the fragments' layout, rows r .. r + 15 by columns
// c .. c + 2 NA - 1) into [64][kPLd] shared memory.
template <int HD, int NA>
__device__ __forceinline__ void put_tile(float* dst, const float (&x)[NA], int r, int c) {
  constexpr int PL = Cfg<HD>::kPLd;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    float* p = dst + (r + g) * PL + c + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(p) = make_float2(x[4 * j], x[4 * j + 1]);
    *reinterpret_cast<float2*>(p + 8 * PL) = make_float2(x[4 * j + 2], x[4 * j + 3]);
  }
}

// One block per (kv head, batch, 64 keys), the keys with the most queries
// first.  Warp w: s^T and dp^T of keys kr = 16 (w % 4) by query rows kTile /
// 2 (w / 4) of the tile; dk and dv of keys kr, columns kCols (w / 4).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    int S, int T_, int H, int KV, float scale_log2, float scale, int q_offset, int window,
    float* __restrict__ dk, float* __restrict__ dv) {
  using C = Cfg<HD>;
  constexpr int LD = C::kLd, BK = C::kBlock, BQ = C::kTile, PL = C::kPLd, NCOL = C::kCols;
  constexpr int NA = BQ / 4;  // s^T and dp^T values a thread
  extern __shared__ float4 smem4[];
  float* k_sh = reinterpret_cast<float*>(smem4);  // [BK][LD]
  float* v_sh = k_sh + BK * LD;                   // [BK][LD]
  float* q_sh = v_sh + BK * LD;                   // [BQ][LD]
  float* do_sh = q_sh + BQ * LD;                  // [BQ][LD]
  float* p_sh = do_sh + BQ * LD;                  // [BK][PL]: p^T, keys by query rows
  float* ds_sh = p_sh + BK * PL;                  // [BK][PL]: ds^T
  float* lse_sh = ds_sh + BK * PL;                // [BQ], log2 units
  float* dl_sh = lse_sh + BQ;                     // [BQ]

  const int grp = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BK;
  const int G = H / KV, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qs = static_cast<size_t>(H) * HD, ks = static_cast<size_t>(KV) * HD;
  const size_t kv_at = static_cast<size_t>(b) * T_ * ks + static_cast<size_t>(grp) * HD;
  load_tile<HD>(k_sh, k + kv_at + k0 * ks, ks, BK, T_ - k0);
  load_tile<HD>(v_sh, v + kv_at + k0 * ks, ks, BK, T_ - k0);
  const auto [first, ntiles] = query_tiles(k0, BK, S, T_, q_offset, window, BQ);

  const int kr = 16 * (warp & 3), qc = (BQ / 2) * (warp >> 2), nc = NCOL * (warp >> 2);
  const int t = k0 + kr + (lane >> 2);  // this thread's keys t, t + 8
  float dk_acc[NCOL / 2], dv_acc[NCOL / 2];
#pragma unroll
  for (int i = 0; i < NCOL / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int gi = 0; gi < G; ++gi) {
    const int h = grp * G + gi;
    const size_t q_at = static_cast<size_t>(b) * S * qs + static_cast<size_t>(h) * HD;
    const size_t stat = (static_cast<size_t>(b) * H + h) * S;
    for (int it = 0; it < ntiles; ++it) {
      const int r0 = (first + it) * BQ, p0 = q_offset + r0;
      if (no_pair<BK, BQ>(k0, p0, window)) continue;
      __syncthreads();  // the last tile's reads are done
      load_tile<HD>(q_sh, q + q_at + r0 * qs, qs, BQ, S - r0);
      load_tile<HD>(do_sh, dout + q_at + r0 * qs, qs, BQ, S - r0);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {  // rows past S: 0, masked
        lse_sh[i] = r0 + i < S ? lse[stat + r0 + i] * kLog2e : 0.f;
        dl_sh[i] = r0 + i < S ? delta[stat + r0 + i] : 0.f;
      }
      __syncthreads();

      float s[NA], dp[NA];
      dots<HD>(s, dp, k_sh, v_sh, q_sh, do_sh, kr, qc);  // s^T = k q^T, dp^T = v do^T
      p_ds_by_key<BQ / 2>(s, dp, lse_sh + qc, dl_sh + qc, lane, t, r0 + qc, p0 + qc, S,
                                T_, window, scale_log2,
                                r0 + BQ - 1 >= S || on_edge<BK, BQ>(k0, p0, T_, window));
      put_tile<HD>(p_sh, s, kr, qc);
      put_tile<HD>(ds_sh, dp, kr, qc);
      __syncthreads();
      sums<BQ, NCOL>(dv_acc, p_sh, PL, do_sh, LD, kr, nc);   // dv += p^T do
      sums<BQ, NCOL>(dk_acc, ds_sh, PL, q_sh, LD, kr, nc);   // dk += ds^T q
    }
  }
  store_dkv<HD, NCOL>(dk + kv_at, dv + kv_at, dk_acc, dv_acc, t, T_, KV, nc, scale);
}

// One block per (head, batch, 64 query rows), the rows with the most keys
// first.  Warp w: s and dp of rows qr = 16 (w % 4) by keys kTile / 2 (w / 4)
// of the tile; dq of rows qr, columns kCols (w / 4).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    int S, int T_, int H, int KV, float scale_log2, float scale, int q_offset, int window,
    float* __restrict__ dq) {
  using C = Cfg<HD>;
  constexpr int LD = C::kLd, BQ = C::kBlock, BK = C::kTile, PL = C::kPLd, NCOL = C::kCols;
  constexpr int NA = BK / 4;  // s and dp values a thread
  extern __shared__ float4 smem4[];
  float* q_sh = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* do_sh = q_sh + BQ * LD;                  // [BQ][LD]
  float* k_sh = do_sh + BQ * LD;                  // [BK][LD]
  float* v_sh = k_sh + BK * LD;                   // [BK][LD]
  float* ds_sh = v_sh + BK * LD;                  // [BQ][PL]

  const int h = blockIdx.x, b = blockIdx.y;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int grp = h / (H / KV), warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qs = static_cast<size_t>(H) * HD, ks = static_cast<size_t>(KV) * HD;
  const size_t q_at = static_cast<size_t>(b) * S * qs + static_cast<size_t>(h) * HD;
  const size_t kv_at = static_cast<size_t>(b) * T_ * ks + static_cast<size_t>(grp) * HD;
  load_tile<HD>(q_sh, q + q_at + row0 * qs, qs, BQ, S - row0);
  load_tile<HD>(do_sh, dout + q_at + row0 * qs, qs, BQ, S - row0);
  const auto [tile0, ntiles] = key_tiles(row0, BQ, S, T_, q_offset, window, BK);

  const int qr = 16 * (warp & 3), kc = (BK / 2) * (warp >> 2), nc = NCOL * (warp >> 2);
  const int r = row0 + qr + (lane >> 2);  // this thread's rows r, r + 8
  float lse2[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const size_t at = (static_cast<size_t>(b) * H + h) * S + min(r + 8 * hf, S - 1);
    lse2[hf] = r + 8 * hf < S ? lse[at] * kLog2e : 0.f;
    dl[hf] = r + 8 * hf < S ? delta[at] : 0.f;
  }
  float dq_acc[NCOL / 2];
#pragma unroll
  for (int i = 0; i < NCOL / 2; ++i) dq_acc[i] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int t0 = (tile0 + j) * BK;
    if (no_pair<BK, BQ>(t0, q_offset + row0, window)) continue;
    __syncthreads();  // the last tile's reads are done (and q, do staged)
    load_tile<HD>(k_sh, k + kv_at + t0 * ks, ks, BK, T_ - t0);
    load_tile<HD>(v_sh, v + kv_at + t0 * ks, ks, BK, T_ - t0);
    __syncthreads();

    float s[NA], dp[NA];
    dots<HD>(s, dp, q_sh, do_sh, k_sh, v_sh, qr, kc);  // s = q k^T, dp = do v^T
    // rows past S are never written: only keys and the mask matter here
    p_ds_by_row<BK / 2>(s, dp, lse2, dl, lane, t0 + kc, q_offset + r, T_, window, scale_log2,
                        on_edge<BK, BQ>(t0, q_offset + row0, T_, window));
    put_tile<HD>(ds_sh, dp, qr, kc);
    __syncthreads();
    sums<BK, NCOL>(dq_acc, ds_sh, PL, k_sh, LD, qr, nc);  // dq += ds k
  }
  store_dq<HD, NCOL>(dq + q_at, dq_acc, r, S, H, nc, scale);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const void* lse, int B, int S, int T_, int H, int KV, float scale, int q_offset,
           int window, void* delta, void* dq, void* dk, void* dv, cudaStream_t stream) {
  using C = Cfg<HD>;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kDkvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kDqSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_delta<float, HD>(out, dout, B, S, H, delta, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = scale * kLog2e;
  dkv_kernel<HD><<<dim3(KV, B, (T_ + C::kBlock - 1) / C::kBlock), kThreads, C::kDkvSmem,
                   stream>>>(qf, kf, vf, df, lf, dl, S, T_, H, KV, scale_log2, scale, q_offset,
                             window, static_cast<float*>(dk), static_cast<float*>(dv));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<HD><<<dim3(H, B, (S + C::kBlock - 1) / C::kBlock), kThreads, C::kDqSmem, stream>>>(
      qf, kf, vf, df, lf, dl, S, T_, H, KV, scale_log2, scale, q_offset, window,
      static_cast<float*>(dq));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace x3m

}  // namespace

// q, dout, dq: [B, S, H, hd]; k, v, dk, dv: [B, T, KV, hd]; out: [B, S, H,
// hd] fp32 (the forward's); lse: [B, H, S] fp32 from the forward; delta:
// [B, H, S] fp32 scratch; window <= 0: causal only.  S, T > 0; 16-byte
// aligned (TMA reads q, k, v and dout).
extern "C" int flash_attn_bwd_f32(const void* q, const void* k, const void* v, const void* out,
                                  const void* dout, const void* lse, int B, int S, int T, int H,
                                  int KV, int hd, float scale, int q_offset, int window,
                                  void* delta, void* dq, void* dk, void* dv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return x3::launch<32>(q, k, v, out, dout, lse, B, S, T, H, KV, scale, q_offset, window,
                            delta, dq, dk, dv, st);
    case 64:
      return x3::launch<64>(q, k, v, out, dout, lse, B, S, T, H, KV, scale, q_offset, window,
                            delta, dq, dk, dv, st);
    case 128:
      return x3m::launch<128>(q, k, v, out, dout, lse, B, S, T, H, KV, scale, q_offset, window,
                              delta, dq, dk, dv, st);
    case 256:
      return x3m::launch<256>(q, k, v, out, dout, lse, B, S, T, H, KV, scale, q_offset, window,
                              delta, dq, dk, dv, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same for bf16 q, k, v, dout and gradients; out is still the fp32
// residual.
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
