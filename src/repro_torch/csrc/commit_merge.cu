// commit_merge: the reverse-link top-M merge of one build batch, f32 items.
//
// Replaces the TPU kernel _commit_merge_kernel (src/repro/kernels/
// commit_merge/kernel.py:78, launched by commit_merge_pallas :187 behind
// ops.py:122).  The semantics are commit_merge_ref's two stable sorts
// (src/repro/kernels/commit_merge/ref.py:36): every touched row is rewritten
// with the top M of its deduplicated proposals and its rescored existing
// edges, by valid first, score descending, id ascending; empty slots are -1.
//
// Input: the wrapper's pre-pass (kernels/commit_merge/ops.py) has only
// sorted the E proposals stably by (target, cand), invalid targets last
// (-1), invalid cands last in their target's run (-1): static shapes, no
// read-back.  The kernel finds each target's run and skips a repeated
// (target, cand) pair itself, the first proposal winning.  The TPU's [G, K]
// bucket table existed only because a BlockSpec needs static shapes.
//
// What bounds it on the H100: bytes.  Per touched row it reads the target
// vector, its M adjacency ids and up to M gathered neighbour rows (d floats
// each), and does 2*d flops per row.  The rows are random gathers of 4*d
// bytes: they stream at about 0.6 of the card's rate, and a warp's trips
// to memory (the head test, then the row and the target, then the rows in
// groups of kRows) are a chain.
//
// Design: a block of one warp per sorted position; the warp at the head of
// a target's run merges that target, the others end at once and free
// their slot.  No shared memory depends on the run's length: a warp holds
// the target vector, its row's M slots and the running top M (and one round
// of 32 proposals) in its own slice.  The run's proposals are loaded
// kBatch rounds of 32 at a time, with the row and the target vector.  An
// existing slot that repeats an earlier slot (__match_any_sync, the lowest
// lane winning) or that a proposal repeats (each lane tests its proposals
// against every slot) is dropped; the survivors are rescored kRows rows at
// a time with every row's loads issued before any FMA, summed in
// warp_dot's order (select.cuh), so the scores are bit-identical to
// warp_dot's.  The running top M takes the survivors, then each round of up
// to 32 proposals that holds one able to enter (the list not full, or one
// before its last entry), by a warp-wide rank under ranked_top_m's order,
// and is written over the target's row in place: a warp reads and writes
// only its own target's row.
#include <cuda_runtime.h>

#include "select.cuh"

namespace {

constexpr int kWarps = 1;         // warps a block: a block not at a run's head ends at once
constexpr int kWarpsPerSm = 24;   // resident warps an SM is built for (<= 85 registers)
constexpr int kRows = 4;          // existing rows whose loads fly together
constexpr int kChunks = 3;        // float4 chunks of a row a lane loads at once (d <= 384 in one go)
constexpr int kBatch = 4;         // rounds of 32 proposals whose loads fly together
constexpr size_t kMaxSmem = 227 * 1024;

// Words of one warp's shared slice: target vector [dq], existing ids and
// their scores [M] each, the running top M and the next one (scores, ids)
// [M] each, one round of proposals (scores, ids) [32] each; a multiple of 4
// so that every slice starts 16-byte aligned.
__host__ __device__ inline int warp_words(int M, int d) {
  return (((d + 3) & ~3) + 6 * M + 64 + 3) & ~3;
}

// Rows ids[0, kRows) (id < 0: none) against the target vector tv (shared,
// 16-byte aligned), by one warp, in warp_dot's arithmetic: a lane sums its
// chunks c = lane, lane + 32, ... in order, then warp_sum.  All rows' loads of
// kChunks chunks are issued before any FMA.  Every lane gets the sums.
__device__ __forceinline__ void rescore_rows(const float* __restrict__ tv,
                                             const float* __restrict__ items,
                                             const int (&ids)[kRows], int d, int lane,
                                             float (&out)[kRows]) {
  float acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
  if ((d & 3) == 0) {
    const int d4 = d >> 2;
    const float4* v4 = reinterpret_cast<const float4*>(tv);
    for (int c0 = 0; c0 < d4; c0 += 32 * kChunks) {
      float4 a[kRows][kChunks];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float4* r4 = reinterpret_cast<const float4*>(items + static_cast<size_t>(max(ids[j], 0)) * d);
#pragma unroll
        for (int h = 0; h < kChunks; ++h) {
          const int c = c0 + 32 * h + lane;
          a[j][h] = ids[j] >= 0 && c < d4 ? __ldg(r4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int h = 0; h < kChunks; ++h) {
        const int c = c0 + 32 * h + lane;
        if (c < d4) {
          const float4 b = v4[c];
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            acc[j] = fmaf(a[j][h].x, b.x, acc[j]);
            acc[j] = fmaf(a[j][h].y, b.y, acc[j]);
            acc[j] = fmaf(a[j][h].z, b.z, acc[j]);
            acc[j] = fmaf(a[j][h].w, b.w, acc[j]);
          }
        }
      }
    }
  } else {
    constexpr int kScalars = 4 * kChunks;
    for (int c0 = 0; c0 < d; c0 += 32 * kScalars) {
      float a[kRows][kScalars];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float* r = items + static_cast<size_t>(max(ids[j], 0)) * d;
#pragma unroll
        for (int h = 0; h < kScalars; ++h) {
          const int c = c0 + 32 * h + lane;
          a[j][h] = ids[j] >= 0 && c < d ? __ldg(r + c) : 0.f;
        }
      }
#pragma unroll
      for (int h = 0; h < kScalars; ++h) {
        const int c = c0 + 32 * h + lane;
        if (c < d) {
#pragma unroll
          for (int j = 0; j < kRows; ++j) acc[j] = fmaf(a[j][h], tv[c], acc[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) out[j] = repro::warp_sum(acc[j]);
}

// Merges the entries (xs, xi) of [0, R) -- xi < 0: none; the others distinct
// and not in the list -- into the warp's list (cs, ci) of its n best entries,
// sorted under ranked_top_m's order (score descending, id ascending), keeping
// the best M; returns the new n.  A list entry moves down by the entries that
// come before it; an entry lands after the list entries before it (a binary
// search) and the entries before it.  The ranks are distinct, so each lands
// in its own slot of (ns, ni).
__device__ int merge_top_m(float* cs, int* ci, int n, const float* xs, const int* xi, int R,
                           int M, float* ns, int* ni, int lane) {
  for (int p = lane; p < n; p += 32) {
    const float s = cs[p];
    const int id = ci[p];
    int r = p;
    for (int y = 0; y < R; ++y) r += xi[y] >= 0 && repro::precedes(xs[y], xi[y], s, id);
    if (r < M) {
      ns[r] = s;
      ni[r] = id;
    }
  }
  int added = 0;
  for (int x0 = 0; x0 < R; x0 += 32) {
    const int x = x0 + lane;
    const bool ok = x < R && xi[x] >= 0;
    added += __popc(__ballot_sync(repro::kFullMask, ok));
    if (!ok) continue;
    const float s = xs[x];
    const int id = xi[x];
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (repro::precedes(cs[mid], ci[mid], s, id)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int r = lo;
    for (int y = 0; y < R; ++y) r += xi[y] >= 0 && repro::precedes(xs[y], xi[y], s, id);
    if (r < M) {
      ns[r] = s;
      ni[r] = id;
    }
  }
  __syncwarp();
  const int m = min(M, n + added);
  for (int p = lane; p < m; p += 32) {
    cs[p] = ns[p];
    ci[p] = ni[p];
  }
  __syncwarp();
  return m;
}

__global__ void __launch_bounds__(32 * kWarps, kWarpsPerSm / kWarps) commit_merge_kernel(
    const int* __restrict__ tgt, const int* __restrict__ cand, const float* __restrict__ score,
    int E, int* __restrict__ adj, const float* __restrict__ items, int M, int d) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i0 = blockIdx.x * (blockDim.x >> 5) + warp;
  if (i0 >= E) return;
  const int t = tgt[i0];
  if (t < 0 || (i0 > 0 && tgt[i0 - 1] == t)) return;  // not the head of a target's run

  float* tv = reinterpret_cast<float*>(smem4) + static_cast<size_t>(warp) * warp_words(M, d);
  int* ex = reinterpret_cast<int*>(tv + ((d + 3) & ~3));  // [M] existing ids, -1 once dropped
  float* es = reinterpret_cast<float*>(ex + M);          // [M] their rescored scores
  float* cs = es + M;                                     // [M] the running top M
  int* ci = reinterpret_cast<int*>(cs + M);
  float* ns = reinterpret_cast<float*>(ci + M);           // [M] the next one
  int* ni = reinterpret_cast<int*>(ns + M);
  float* rs = reinterpret_cast<float*>(ni + M);           // [32] a round of proposals
  int* ri = reinterpret_cast<int*>(rs + 32);              // -1: none
  int* row = adj + static_cast<size_t>(t) * M;

  // kBatch rounds of 32 sorted positions from p, all loads in flight
  // together: the proposal of each position in t's run (id -1 for a -1
  // cand or a repeat of the pair before it); returns whether every
  // position was in the run (the run may go on).
  auto load_batch = [&](int p, float (&s)[kBatch], int (&id)[kBatch]) -> bool {
    int te[kBatch], ce[kBatch], cb[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = p + 32 * u + lane;
      te[u] = e < E ? tgt[e] : -1;
      ce[u] = e < E ? cand[e] : -1;
      cb[u] = e < E && e > i0 ? cand[e - 1] : -1;
      s[u] = e < E ? score[e] : 0.f;
    }
    bool all_in = true;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool in = te[u] == t;
      all_in &= in;
      id[u] = in && ce[u] >= 0 && ce[u] != cb[u] ? ce[u] : -1;
    }
    return __all_sync(repro::kFullMask, all_in);
  };
  float s0[kBatch];
  int id0[kBatch];
  const bool more0 = load_batch(i0, s0, id0);
  for (int c = lane; c < d; c += 32) tv[c] = items[static_cast<size_t>(t) * d + c];
  for (int j = lane; j < M; j += 32) ex[j] = row[j];
  __syncwarp();

  // existing slots: drop -1s and repeats of an earlier slot ...
  for (int j0 = 0; j0 < M; j0 += 32) {
    const int j = j0 + lane;
    const int id = j < M ? ex[j] : -1;
    const unsigned peers = __match_any_sync(repro::kFullMask, id);
    bool ok = id >= 0 && __ffs(peers) - 1 == lane;
    for (int jj = 0; jj < j0 && ok; ++jj) ok = ex[jj] != id;
    __syncwarp();
    if (j < M && !ok) ex[j] = -1;
    __syncwarp();
  }
  // ... and the ones a proposal repeats (the proposal's score wins): each
  // lane tests its proposals against every slot
  {
    float s[kBatch];
    int id[kBatch];
    bool more = more0;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) id[u] = id0[u];
    for (int p = i0;; p += 32 * kBatch) {
      for (int j = 0; j < M; ++j) {
        const int x = ex[j];
        bool hit = false;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) hit |= x >= 0 && id[u] == x;
        if (hit) ex[j] = -1;
      }
      if (!more) break;
      more = load_batch(p + 32 * kBatch, s, id);
    }
    __syncwarp();
  }

  // rescore the survivors, kRows rows at a time
  for (int j0 = 0; j0 < M; j0 += kRows) {
    int ids[kRows];
    float sc[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) ids[j] = j0 + j < M ? ex[j0 + j] : -1;
    rescore_rows(tv, items, ids, d, lane, sc);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (j0 + j < M) es[j0 + j] = sc[j];
      }
    }
  }
  __syncwarp();

  // the running top M: the survivors, then each round of proposals that
  // has one able to enter (the list not yet full, or before its last)
  int n = merge_top_m(cs, ci, 0, es, ex, M, M, ns, ni, lane);
  bool more = more0;
  for (int p = i0;; p += 32 * kBatch) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool enters =
          id0[u] >= 0 && (n < M || repro::precedes(s0[u], id0[u], cs[M - 1], ci[M - 1]));
      if (!__any_sync(repro::kFullMask, enters)) continue;
      rs[lane] = s0[u];
      ri[lane] = enters ? id0[u] : -1;
      __syncwarp();
      n = merge_top_m(cs, ci, n, rs, ri, 32, M, ns, ni, lane);
    }
    if (!more) break;
    more = load_batch(p + 32 * kBatch, s0, id0);
  }
  for (int r = lane; r < M; r += 32) row[r] = r < n ? ci[r] : -1;
}

}  // namespace

extern "C" int commit_merge_f32(const int* targets, const int* cands, const float* scores,
                                int* adj, const float* items, int E, int M, int d,
                                void* stream) {
  if (E < 1 || M < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t per_warp = sizeof(float) * warp_words(M, d);
  const int warps = kWarps;
  const size_t smem = per_warp * warps;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        commit_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  commit_merge_kernel<<<(E + warps - 1) / warps, 32 * warps, smem,
                        static_cast<cudaStream_t>(stream)>>>(targets, cands, scores, E, adj,
                                                             items, M, d);
  return static_cast<int>(cudaGetLastError());
}
