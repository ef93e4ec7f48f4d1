#!/usr/bin/env python3
"""Time and fault-test edited copies of the port's kernels on one card.

  python3 chip_compare.py --variants no_epilogue,flash_one_block
  python3 chip_compare.py --walk --variants walk_prefetch_rows,walk_prefetch_adj
  python3 chip_compare.py --scorers --variants score_rows_2,score_rows_8,gather_bulk_copy
  python3 chip_compare.py --attn-merge --parent build/parent/src --variants f32_stages_2
  python3 chip_compare.py --faults [score_skips_last_row,quant_scale_before_sum]

Each variant or fault is a named edit of a source (EDITS below), applied
to a copy of ``src/`` under ``build/compare/<name>``, which builds its own
kernel library.  ``--variants`` times ``mips_topk`` (k = 10, and its select
route at k = 33 and 1,000 with the select kernels' sum), the bf16
``flash_attention`` and ``commit_merge`` (both COMMIT_SHAPES cells) of the
checkout and of each variant, one process per tree, in turns (checkout,
variants, variants reversed, checkout), at the shapes of ``chip_smoke.py``'s
phase 3; with ``--walk`` it times
``beam_walk`` instead: at phase 3's search IP walk (random graph, f32 and
int8) and in an IpNSW search of 256 queries at Yahoo!Music's size; with
``--scorers`` it times ``gather_score`` and ``quant_score`` at phase 3's
cells (float inputs) beside their witness, the previous one-warp-a-row
kernel, in the same process; with ``--attn-merge`` it times the fp32
``flash_attention`` at phase 3's three model cells and ``topk_merge`` at
its walk, throughput and ef-400 cells.  ``--parent`` adds the ``src/`` of
another commit, unpacked where the build ignores it (``git archive <commit>
src | tar -x -C build/parent``), to the turns as ``parent``: how a kernel
compares with its previous design on the same card.  ``--faults`` runs each planted fault
through the check that must catch it (``chip_smoke.py``'s limits) and exits
1 if one passes.  It needs the card; no edit is ever made in ``src/``.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = "src/repro_torch/csrc"

# name -> (what it is, [(source, text, replacement)])
EDITS = {
    "no_epilogue": (
        "mips_topk pass 1 without its top-k epilogue (answers wrong; timing only)",
        [(f"{CSRC}/mips_topk.cu", "      if (q0 + row >= B) continue;\n",
          "      if (q0 + row >= B || acc[i][0] != 12345.f) continue;\n")]),
    "flash_one_block": (
        "flash_attn bf16 with one block an SM at every hd (consumers 240 registers)",
        [(f"{CSRC}/flash_attn.cu", "kBlocksPerSm = HD <= 64 ? 2 : 1", "kBlocksPerSm = 1"),
         (f"{CSRC}/flash_attn.cu", "kConsumerRegs = HD <= 64 ? 104 : 240", "kConsumerRegs = 240")]),
    "dropped_kv_tile": (
        "fault: the bf16 attention skips the last kv tile of the sequence",
        [(f"{CSRC}/flash_attn.cu",
          "  *count = t_hi >= t_lo ? t_hi / kKeys - t_lo / kKeys + 1 : 0;\n",
          "  *count = t_hi >= t_lo ? t_hi / kKeys - t_lo / kKeys + 1 : 0;\n"
          "  if (*count > 0 && (*first + *count) * kKeys >= T_) --*count;\n")]),
    "ragged_depth": (
        "fault: mips_topk drops the depth tail past the last whole slice of 16",
        [(f"{CSRC}/mips_topk.cu", "  const int nslices = (d + kBK - 1) / kBK;\n",
          "  const int nslices = d / kBK;\n")]),
}
EDITS.update({
    "walk_prefetch_rows": (
        "beam_walk: prefetch.global.L2 of the step's neighbour rows before the visited test",
        [(f"{CSRC}/beam_step.cu", "    const int filled = S + t * M;\n",
          "    const int filled = S + t * M;\n"
          "    for (int j = warp; j < M; j += kWarps) {\n"
          "      const int id = nbr[j];\n"
          "      const int bytes = d * static_cast<int>(sizeof(Row));\n"
          "      if (id >= 0 && 128 * lane < bytes + 127) {\n"
          "        const char* p = reinterpret_cast<const char*>(items + static_cast<size_t>(id) * d);\n"
          "        asm volatile(\"prefetch.global.L2 [%0];\" ::\"l\"(p + min(128 * lane, bytes - 1)));\n"
          "      }\n"
          "    }\n")]),
    "walk_prefetch_adj": (
        "beam_walk: prefetch.global.L2 of the adjacency row of the next unchecked slot",
        [(f"{CSRC}/beam_step.cu",
          "          slot = i0 + __ffs(m) - 1;\n          break;\n",
          "          slot = i0 + __ffs(m) - 1;\n"
          "          const unsigned rest = m & (m - 1);\n"
          "          if (rest && lane == 0) {\n"
          "            const int* a = adj + static_cast<size_t>(ip[i0 + __ffs(rest) - 1]) * M;\n"
          "            asm volatile(\"prefetch.global.L2 [%0];\" ::\"l\"(a));\n"
          "          }\n"
          "          break;\n")]),
})
EDITS["walk_slot_warp_loads_adj"] = (
    "beam_walk: the warp that picks the slot loads its adjacency row (one sync less a step)",
    [(f"{CSRC}/beam_step.cu",
      "      if (lane == 0) s_slot = slot;\n"
      "    }\n"
      "    __syncthreads();\n"
      "    const int slot = s_slot;\n"
      "    if (slot == L) break;  // done: this step counted, wrote nothing\n"
      "\n"
      "    // 2. the adjacency row of the chosen id\n"
      "    const int node = ip[slot];\n"
      "    for (int j = tid; j < M; j += kThreads) nbr[j] = adj[static_cast<size_t>(node) * M + j];\n"
      "    if (tid < words) seen[tid] = 0;\n"
      "    __syncthreads();\n",
      "      if (lane == 0) s_slot = slot;\n"
      "      if (slot < L) {\n"
      "        const int node = ip[slot];\n"
      "        for (int j = lane; j < M; j += 32) nbr[j] = adj[static_cast<size_t>(node) * M + j];\n"
      "      }\n"
      "      for (int w = lane; w < words; w += 32) seen[w] = 0;\n"
      "    }\n"
      "    __syncthreads();\n"
      "    const int slot = s_slot;\n"
      "    if (slot == L) break;  // done: this step counted, wrote nothing\n")])
EDITS["walk_scale_after_sum"] = (
    "beam_walk: the int8 scale loaded after the row's sum (a dependent load a step)",
    [(f"{CSRC}/beam_step.cu",
      "  const float sc0 = ok0 ? row_scale(scales, items, id0) : 1.f;\n"
      "  const float sc1 = ok1 ? row_scale(scales, items, id1) : 1.f;\n", ""),
     (f"{CSRC}/beam_step.cu",
      "  *s0 = ok0 ? a0 * sc0 : -INFINITY;\n  *s1 = ok1 ? a1 * sc1 : -INFINITY;\n",
      "  *s0 = ok0 ? a0 * row_scale(scales, items, id0) : -INFINITY;\n"
      "  *s1 = ok1 ? a1 * row_scale(scales, items, id1) : -INFINITY;\n")])

def _tick(phase: int) -> str:
    return f"    {{ const long long t = clock64(); ph[{phase}] += t - tc; tc = t; }}\n"


EDITS["walk_phase_clock"] = (
    "beam_walk instrumented (diagnostic, not a timing): block 0 prints the mean SM cycles "
    "a step spends in each phase, from clock64() after each barrier",
    [(f"{CSRC}/beam_step.cu", "#include <cuda_runtime.h>\n",
      "#include <cuda_runtime.h>\n#include <cstdio>\n"),
     (f"{CSRC}/beam_step.cu",
      "  int cur = 0, steps = 0, n_eval = 0, n_dead = 0;  // tallies: warp 0's lanes\n",
      "  int cur = 0, steps = 0, n_eval = 0, n_dead = 0;  // tallies: warp 0's lanes\n"
      "  long long ph[5] = {0, 0, 0, 0, 0};\n"
      "  long long tc = clock64();\n"),
     (f"{CSRC}/beam_step.cu", "    const int slot = s_slot;\n",
      _tick(0) + "    const int slot = s_slot;\n"),
     (f"{CSRC}/beam_step.cu",
      "    // 3. visited test over the filled prefix, 16 neighbour ids at a time\n",
      _tick(1) + "    // 3. visited test over the filled prefix, 16 neighbour ids at a time\n"),
     (f"{CSRC}/beam_step.cu",
      "    // 4. score the valid neighbours: a warp takes rows j and j + kWarps\n",
      _tick(2) + "    // 4. score the valid neighbours: a warp takes rows j and j + kWarps\n"),
     (f"{CSRC}/beam_step.cu",
      "    // 5. merge [pool, neighbours] into the other buffer by rank; the\n",
      _tick(3) + "    // 5. merge [pool, neighbours] into the other buffer by rank; the\n"),
     (f"{CSRC}/beam_step.cu", "    cur ^= 1;\n    __syncthreads();\n  }\n",
      "    cur ^= 1;\n    __syncthreads();\n" + _tick(4) + "  }\n"),
     (f"{CSRC}/beam_step.cu", "  if (tid == 0) {\n    out_evals[b] = evals_in[b] + n_eval;\n",
      "  if (tid == 0 && b == 0 && steps > 0) {\n"
      "    printf(\"RESULT phases steps=%d cycles_per_step slot=%lld adjacency=%lld "
      "visited=%lld score=%lld merge=%lld\\n\", steps, ph[0] / steps, ph[1] / steps, "
      "ph[2] / steps, ph[3] / steps, ph[4] / steps);\n"
      "  }\n"
      "  if (tid == 0) {\n    out_evals[b] = evals_in[b] + n_eval;\n")])
EDITS.update({
    "commit_8_warps": (
        "commit_merge with 8 warps a block (the warps not at a run's head hold their block)",
        [(f"{CSRC}/commit_merge.cu", "constexpr int kWarps = 1;", "constexpr int kWarps = 8;")]),
    "commit_prefetch_rows": (
        "commit_merge: prefetch.global.L2 of every existing slot's row as soon as the slots are "
        "read, before the slots are sorted out and rescored",
        [(f"{CSRC}/commit_merge.cu",
          "  for (int j = lane; j < M; j += 32) ex[j] = row[j];\n  __syncwarp();\n",
          "  for (int j = lane; j < M; j += 32) ex[j] = row[j];\n  __syncwarp();\n"
          "  {\n"
          "    const int bytes = d * static_cast<int>(sizeof(float));\n"
          "    const int lines = (bytes + 127) / 128 + 1;\n"
          "    for (int q = lane; q < M * lines; q += 32) {\n"
          "      const int id = ex[q / lines];\n"
          "      if (id >= 0) {\n"
          "        const char* p = reinterpret_cast<const char*>(items + static_cast<size_t>(id) * d);\n"
          "        asm volatile(\"prefetch.global.L2 [%0];\" ::\"l\"(p + min(128 * (q % lines), bytes - 1)));\n"
          "      }\n"
          "    }\n"
          "  }\n")]),
    "commit_rows_8": (
        "commit_merge: 8 existing rows' loads in flight at once (16 warps an SM, <= 128 registers)",
        [(f"{CSRC}/commit_merge.cu", "constexpr int kRows = 4;", "constexpr int kRows = 8;"),
         (f"{CSRC}/commit_merge.cu", "constexpr int kWarpsPerSm = 24;", "constexpr int kWarpsPerSm = 16;")]),
    "commit_l2_256": (
        "commit_merge: the rescored rows loaded with ld.global.nc.L2::256B (L2 fills 256-byte "
        "blocks of the 1,200-byte rows)",
        [(f"{CSRC}/commit_merge.cu", "// Rows ids[0, kRows) (id < 0: none)",
          "__device__ __forceinline__ float4 ldg256(const float4* p) {\n"
          "  float4 v;\n"
          "  asm(\"ld.global.nc.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];\"\n"
          "      : \"=f\"(v.x), \"=f\"(v.y), \"=f\"(v.z), \"=f\"(v.w) : \"l\"(p));\n"
          "  return v;\n"
          "}\n\n// Rows ids[0, kRows) (id < 0: none)"),
         (f"{CSRC}/commit_merge.cu", "? __ldg(r4 + c) :", "? ldg256(r4 + c) :")]),
    "commit_batch_1": (
        "commit_merge: one round of 32 proposals loaded at a time (fewer registers, longer runs "
        "wait once a round)",
        [(f"{CSRC}/commit_merge.cu", "constexpr int kBatch = 4;", "constexpr int kBatch = 1;")]),
    "commit_batch_8": (
        "commit_merge: eight rounds of 32 proposals loaded at a time",
        [(f"{CSRC}/commit_merge.cu", "constexpr int kBatch = 4;", "constexpr int kBatch = 8;")]),
    "commit_no_merge": (
        "commit_merge without its merges (answers wrong; timing only)",
        [(f"{CSRC}/commit_merge.cu", "  int n = merge_top_m(cs, ci, 0, es, ex, M, M, ns, ni, lane);\n",
          "  int n = 0;\n"),
         (f"{CSRC}/commit_merge.cu", "      n = merge_top_m(cs, ci, n, rs, ri, 32, M, ns, ni, lane);\n",
          "")]),
    "commit_no_rescore": (
        "commit_merge without the rescore's row loads (answers wrong; timing only)",
        [(f"{CSRC}/commit_merge.cu", "    for (int j = 0; j < kRows; ++j) ids[j] = j0 + j < M ? ex[j0 + j] : -1;\n",
          "    for (int j = 0; j < kRows; ++j) ids[j] = -1;\n")]),
    "commit_merge_unroll8": (
        "commit_merge: the merge's rank counts unrolled 8 entries at a time",
        [(f"{CSRC}/commit_merge.cu",
          "    int r = p;\n    for (int y = 0; y < R; ++y)",
          "    int r = p;\n#pragma unroll 8\n    for (int y = 0; y < R; ++y)"),
         (f"{CSRC}/commit_merge.cu",
          "    int r = lo;\n    for (int y = 0; y < R; ++y)",
          "    int r = lo;\n#pragma unroll 8\n    for (int y = 0; y < R; ++y)")]),
    "commit_clock": (
        "commit_merge instrumented (diagnostic): at the ip cell the heads of runs of more than "
        "128 proposals, and every 1,024th position's head, print their time from the head test "
        "to the row's write (%globaltimer)",
        [(f"{CSRC}/commit_merge.cu", "#include <cuda_runtime.h>\n",
          "#include <cuda_runtime.h>\n#include <cstdio>\n"),
         (f"{CSRC}/commit_merge.cu",
          "  if (t < 0 || (i0 > 0 && tgt[i0 - 1] == t)) return;  // not the head of a target's run\n",
          "  if (t < 0 || (i0 > 0 && tgt[i0 - 1] == t)) return;  // not the head of a target's run\n"
          "  unsigned long long t_start;\n"
          "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_start));\n"
          "  int nb = 1;\n"),
         (f"{CSRC}/commit_merge.cu", "      more = load_batch(p + 32 * kBatch, s, id);\n",
          "      more = load_batch(p + 32 * kBatch, s, id);\n      ++nb;\n"),
         (f"{CSRC}/commit_merge.cu",
          "  for (int r = lane; r < M; r += 32) row[r] = r < n ? ci[r] : -1;\n",
          "  for (int r = lane; r < M; r += 32) row[r] = r < n ? ci[r] : -1;\n"
          "  if (lane == 0 && M == 16 && (nb >= 2 || i0 % 1024 == 0)) {\n"
          "    unsigned long long t_end;\n"
          "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_end));\n"
          "    printf(\"RESULT phases commit head=%d batches=%d n=%d us=%.2f\\n\", i0, nb, n,\n"
          "           (t_end - t_start) * 1e-3);\n"
          "  }\n")]),
    "commit_32_warps": (
        "commit_merge built for 32 resident warps an SM (<= 64 registers)",
        [(f"{CSRC}/commit_merge.cu", "constexpr int kWarpsPerSm = 24;",
          "constexpr int kWarpsPerSm = 32;")]),
    "select_slice_32k": (
        "mips_topk select: 32,768 scores a block of the streaming passes (a quarter of the blocks)",
        [("src/repro_torch/kernels/mips_topk/ops.py", "SELECT_SLICE = 8192", "SELECT_SLICE = 32768")]),
    "select_drops_bin_key": (
        "fault: the select compaction drops the last threshold-bin key of each warp's ballot",
        [(f"{CSRC}/mips_topk.cu",
          "    const bool take = e != INT_MAX && select_bin(s) >= tb;\n",
          "    bool take = e != INT_MAX && select_bin(s) >= tb;\n"
          "    const unsigned in_bin = __ballot_sync(repro::kFullMask, take && select_bin(s) == tb);\n"
          "    take = take && !(in_bin && (lane == 31 - __clz(in_bin)));\n")]),
    "commit_keeps_repeated_slot": (
        "fault: commit_merge keeps an existing slot that a proposal repeats",
        [(f"{CSRC}/commit_merge.cu", "        if (hit) ex[j] = -1;\n", "")]),
    "commit_skips_round_2": (
        "fault: commit_merge skips the second round of 32 proposals of a run",
        [(f"{CSRC}/commit_merge.cu",
          "      if (!__any_sync(repro::kFullMask, enters)) continue;\n",
          "      if (u == 1 || !__any_sync(repro::kFullMask, enters)) continue;\n")]),
})
# the gathered scorers: rows a warp keeps in flight, warps a block, registers,
# the int8 codes' cast, and the f32 rows staged by Hopper's bulk copy into
# shared memory instead of registers
GATHER, QUANT, SELECT = (f"{CSRC}/gather_score.cu", f"{CSRC}/quant_score.cu",
                         f"{CSRC}/select.cuh")
for _r in (2, 8):
    EDITS[f"score_rows_{_r}"] = (
        f"gather_score and quant_score with {_r} rows a warp in flight (4 in the checkout)",
        [(src, "constexpr int kRows = 4;", f"constexpr int kRows = {_r};") for src in (GATHER, QUANT)])
EDITS["score_warps_8"] = (
    "gather_score and quant_score with 8 warps a block (4 in the checkout)",
    [(src, "constexpr int kWarps = 4;", "constexpr int kWarps = 8;") for src in (GATHER, QUANT)])


def _min_blocks(src: str, blocks: int) -> list:
    """Registers budgeted for ``blocks`` blocks (4 ``blocks`` warps) an SM."""
    code = (ROOT / src).read_text()
    now = code[code.index("constexpr int kMinBlocks = "):].split(";")[0]
    return [(src, now + ";", f"constexpr int kMinBlocks = {blocks};")]


for _src, _kernel, _blocks in ((QUANT, "quant", 6), (QUANT, "quant", 8), (QUANT, "quant", 12),
                               (GATHER, "gather", 8)):
    EDITS[f"{_kernel}_min_blocks_{_blocks}"] = (
        f"{_kernel}_score built for {_blocks} blocks an SM: at most "
        f"{65536 // (128 * _blocks)} registers a thread", _min_blocks(_src, _blocks))
EDITS["score_rows_chunk_major"] = (
    "score_rows FMAs chunk u of every row before chunk u + 1 (the earlier order; same bits)",
    [(SELECT,
      "    // a row's chunks before the next row's: its codes are cast and used\n"
      "    // together, which frees their registers sooner\n"
      "#pragma unroll\n    for (int r = 0; r < R; ++r) {\n#pragma unroll\n"
      "      for (int u = 0; u < V; ++u) {\n"
      "        if (ok[r] && c0 + lane + 32 * u < d4) {\n"
      "          acc[r] = fma_chunk(v[r][u], b[u], acc[r]);\n"
      "        }\n      }\n    }\n",
      "#pragma unroll\n    for (int u = 0; u < V; ++u) {\n"
      "      if (c0 + lane + 32 * u < d4) {\n#pragma unroll\n"
      "        for (int r = 0; r < R; ++r) {\n"
      "          if (ok[r]) acc[r] = fma_chunk(v[r][u], b[u], acc[r]);\n"
      "        }\n      }\n    }\n")])
EDITS["rounds_unroll_1"] = (
    "score_rows' loop over rounds of loads kept rolled (#pragma unroll 1)",
    [(SELECT, "  for (int c0 = 0; c0 < d4; c0 += 32 * V) {\n",
      "#pragma unroll 1\n  for (int c0 = 0; c0 < d4; c0 += 32 * V) {\n")])
# the codes cast to float by the integer and FMA pipes instead of the
# conversion unit: byte + 128 in the mantissa of 2^23, then 2^23 + 128
# subtracted -- the same floats, exactly
EDITS["quant_fast_codes"] = (
    "score_rows casts int8 codes by byte permutes and a subtraction (no I2F)",
    [(SELECT,
      "__device__ __forceinline__ float fma_chunk(char4 a, float4 b, float acc) {\n"
      "  acc = fmaf(static_cast<float>(a.x), b.x, acc);\n"
      "  acc = fmaf(static_cast<float>(a.y), b.y, acc);\n"
      "  acc = fmaf(static_cast<float>(a.z), b.z, acc);\n"
      "  return fmaf(static_cast<float>(a.w), b.w, acc);\n}\n",
      "__device__ __forceinline__ float code_at(unsigned biased, unsigned sel) {\n"
      "  return __int_as_float(static_cast<int>(__byte_perm(biased, 0x4B000000u, sel)))"
      " - 8388736.f;\n}\n"
      "__device__ __forceinline__ float fma_chunk(char4 a, float4 b, float acc) {\n"
      "  const unsigned u = *reinterpret_cast<const unsigned*>(&a) ^ 0x80808080u;\n"
      "  acc = fmaf(code_at(u, 0x7440), b.x, acc);\n"
      "  acc = fmaf(code_at(u, 0x7441), b.y, acc);\n"
      "  acc = fmaf(code_at(u, 0x7442), b.z, acc);\n"
      "  return fmaf(code_at(u, 0x7443), b.w, acc);\n}\n")])
BULK_KERNEL = r"""// (variant) one tile a warp, its rows staged by cp.async.bulk into the
// warp's slice of shared memory (lane 0 issues the copies against an
// mbarrier); d % 4 == 0 and d <= 128 * kVec; the FMAs in warp_dot's order.
__global__ void __launch_bounds__(kThreads) gather_score_bulk_kernel(
    const float* __restrict__ queries, const float* __restrict__ items,
    const int* __restrict__ ids, int B, int W, int d, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  __shared__ __align__(8) unsigned long long bar[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_query = (W + kRows - 1) / kRows;
  const int t = blockIdx.x * kWarps + warp;
  if (t >= B * per_query) return;
  const int b = t / per_query, w0 = (t - b * per_query) * kRows, n = min(kRows, W - w0);
  const int mine = lane < n ? ids[static_cast<size_t>(b) * W + w0 + lane] : 0;
  const int d4 = d >> 2;
  float4* rows_sh = smem4 + warp * kRows * d4;
  const unsigned mbar = static_cast<unsigned>(__cvta_generic_to_shared(&bar[warp]));
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(mbar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  const float4* q4 = reinterpret_cast<const float4*>(queries + static_cast<size_t>(b) * d);
  float4 qv[kVec];
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    if (lane + 32 * u < d4) qv[u] = __ldg(q4 + lane + 32 * u);
  }
  if (lane == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(mbar), "r"(static_cast<unsigned>(n * d * 4)) : "memory");
  }
  for (int r = 0; r < n; ++r) {
    const int id = max(__shfl_sync(repro::kFullMask, mine, r), 0);
    if (lane == 0) {
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(rows_sh + r * d4));
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
          ::"r"(dst), "l"(items + static_cast<size_t>(id) * d), "r"(d * 4), "r"(mbar)
          : "memory");
    }
  }
  unsigned ready = 0;
  while (!ready) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n" : "=r"(ready) : "r"(mbar) : "memory");
  }
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const int c = lane + 32 * u;
    if (c < d4) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < n) acc[r] = repro::fma_chunk(rows_sh[r * d4 + c], qv[u], acc[r]);
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] += __shfl_xor_sync(repro::kFullMask, acc[r], o);
  }
  float mine_s = acc[0];
#pragma unroll
  for (int r = 1; r < kRows; ++r) mine_s = lane == r ? acc[r] : mine_s;
  if (lane < n) out[static_cast<size_t>(b) * W + w0 + lane] = mine_s;
}

"""
EDITS["gather_bulk_copy"] = (
    "gather_score with one tile a warp, its rows staged by cp.async.bulk into shared memory "
    "(an mbarrier a warp, no row registers), d % 4 == 0 and d <= 384",
    [(GATHER, "constexpr int kRowwiseThreads = 256;\n",
      BULK_KERNEL + "constexpr int kRowwiseThreads = 256;\n"),
     (GATHER, "  if ((d & 3) == 0) {\n    gather_score_kernel<true>",
      "  if ((d & 3) == 0 && d <= 128 * kVec) {\n"
      "    const int blocks = (B * ((W + kRows - 1) / kRows) + kWarps - 1) / kWarps;\n"
      "    gather_score_bulk_kernel<<<blocks, kThreads, sizeof(float) * kWarps * kRows * d, s>>>(\n"
      "        queries, items, ids, B, W, d, out);\n"
      "  } else if ((d & 3) == 0) {\n    gather_score_kernel<true>")])
EDITS.update({
    "score_skips_last_row": (
        "fault: the scorers do not write the last slot of each tile",
        [(src, "  if (lane < n) out[base + lane] = mine_s;\n",
          "  if (lane < n - 1) out[base + lane] = mine_s;\n") for src in (GATHER, QUANT)]),
    "quant_scale_before_sum": (
        "fault: quant_score multiplies each lane's partial sum by the scale before the "
        "shuffle tree",
        [(SELECT,
          "  for (int o = 16; o > 0; o >>= 1) {\n#pragma unroll\n"
          "    for (int r = 0; r < R; ++r) acc[r] += __shfl_xor_sync(kFullMask, acc[r], o);\n  }\n"
          "#pragma unroll\n"
          "  for (int r = 0; r < R; ++r) s[r] = ok[r] ? scaled(acc[r], sc[r], rows) : -INFINITY;\n",
          "#pragma unroll\n  for (int r = 0; r < R; ++r) acc[r] = scaled(acc[r], sc[r], rows);\n"
          "  for (int o = 16; o > 0; o >>= 1) {\n#pragma unroll\n"
          "    for (int r = 0; r < R; ++r) acc[r] += __shfl_xor_sync(kFullMask, acc[r], o);\n  }\n"
          "#pragma unroll\n"
          "  for (int r = 0; r < R; ++r) s[r] = ok[r] ? acc[r] : -INFINITY;\n")]),
    "quant_scores_minus_one": (
        "fault: quant_score scores row 0 for a -1 id instead of writing -inf",
        [(QUANT, "    id[r] = __shfl_sync(repro::kFullMask, mine, r);\n",
          "    id[r] = max(__shfl_sync(repro::kFullMask, mine, r), 0);\n")]),
})
# the fp32 attention kernel and topk_merge's warp route: tile and ring sizes,
# and planted faults
MERGE_ONE_ROW = """  const int row0 = blockIdx.x * kRowWarps * RW;
  if (row0 + (threadIdx.x >> 5) * RW >= B) return;  // every row of this warp is past B
  const int row = row0 + slot;
  const bool live = row < B;
  const int C = L + M;
  const size_t pool_at = static_cast<size_t>(row) * L, new_at = static_cast<size_t>(row) * M;
  unsigned long long key[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int pos = sub * E + e;
    key[e] = repro::kTopkPad;
    if (live && pos < C) {
      const bool pool = pos < L;
      const size_t at = pool ? pool_at + pos : new_at + pos - L;
      key[e] = repro::topk_key(pool ? pool_s[at] : new_s[at], pos);
      payload[slot][pos] = make_int2(pool ? pool_i[at] : new_i[at], pool ? pool_c[at] : new_c[at]);
    }
  }
  __syncwarp();
  repro::row_sort_keys<NL, E>(key, sub);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int r = sub * E + e;
    if (live && r < L) {
"""
MERGE_ROW_LOOP = """  const int C = L + M;
  const int stride = gridDim.x * kRowWarps * RW;
  const int warp_row0 = blockIdx.x * kRowWarps * RW + (threadIdx.x >> 5) * RW;
  float next_s[E];
  int2 next_p[E];
  auto fetch = [&](int r) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int pos = sub * E + e;
      next_s[e] = 0.f;
      next_p[e] = make_int2(0, 0);
      if (r < B && pos < C) {
        const bool pool = pos < L;
        const size_t at = pool ? static_cast<size_t>(r) * L + pos
                               : static_cast<size_t>(r) * M + pos - L;
        next_s[e] = pool ? pool_s[at] : new_s[at];
        next_p[e] = make_int2(pool ? pool_i[at] : new_i[at], pool ? pool_c[at] : new_c[at]);
      }
    }
  };
  fetch(warp_row0 + lane / NL);
  for (int w0 = warp_row0; w0 < B; w0 += stride) {
  const int row = w0 + lane / NL;
  const bool live = row < B;
  const size_t pool_at = static_cast<size_t>(row) * L;
  unsigned long long key[E];
  __syncwarp();  // the previous row's payload reads are done
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int pos = sub * E + e;
    key[e] = live && pos < C ? repro::topk_key(next_s[e], pos) : repro::kTopkPad;
    if (live && pos < C) payload[slot][pos] = next_p[e];
  }
  __syncwarp();
  fetch(w0 + stride + lane / NL);
  repro::row_sort_keys<NL, E>(key, sub);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int r = sub * E + e;
    if (live && r < L) {
"""
FLASH = f"{CSRC}/flash_attn.cu"
EDITS.update({
    "f32_stages_2": (
        "flash_attn fp32 with a ring of 2 kv stages at every hd (3 at hd <= 128 in the checkout)",
        [(FLASH, "static constexpr int kStages = HD <= 128 ? 3 : 2;",
          "static constexpr int kStages = 2;")]),
    "f32_groups_8": (
        "flash_attn fp32 with row groups of 8 lanes (4 a warp) and half the rows a thread",
        [(FLASH, "static constexpr int kG = 16;", "static constexpr int kG = 8;"),
         (FLASH, "static constexpr int kTR = HD <= 128 ? 8 : 4;",
          "static constexpr int kTR = HD <= 128 ? 4 : 2;")]),
    "merge_lanes_16": (
        "topk_merge's sort route with 4 keys a lane: 8 lanes a row at C <= 32, 16 at C <= 64",
        [(f"{CSRC}/topk_merge.cu", "constexpr int kSmallLanes = 32, kSmallKeys = 1;",
          "constexpr int kSmallLanes = 8, kSmallKeys = 4;"),
         (f"{CSRC}/topk_merge.cu", "constexpr int kLargeLanes = 32, kLargeKeys = 2;",
          "constexpr int kLargeLanes = 16, kLargeKeys = 4;")]),
    "merge_keys_8": (
        "topk_merge's sort route with 8 keys a lane: 4 lanes a row at C <= 32, 8 at C <= 64",
        [(f"{CSRC}/topk_merge.cu", "constexpr int kSmallLanes = 32, kSmallKeys = 1;",
          "constexpr int kSmallLanes = 4, kSmallKeys = 8;"),
         (f"{CSRC}/topk_merge.cu", "constexpr int kLargeLanes = 32, kLargeKeys = 2;",
          "constexpr int kLargeLanes = 8, kLargeKeys = 8;")]),
    "merge_prefetch": (
        "topk_merge's sort route on a grid of at most the blocks the card holds, each warp "
        "looping over rows and loading its next row while it sorts this one",
        [(f"{CSRC}/topk_merge.cu", MERGE_ONE_ROW, MERGE_ROW_LOOP),
         (f"{CSRC}/topk_merge.cu",
          "  topk_merge_sort_kernel<NL, E><<<(B + rows - 1) / rows, kRowWarps * 32, 0, st>>>(",
          "  static int per_sm = 0, sms = 0;\n"
          "  if (per_sm == 0) {\n"
          "    int dev = 0;\n"
          "    cudaGetDevice(&dev);\n"
          "    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
          "    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_merge_sort_kernel<NL, E>,\n"
          "                                                  kRowWarps * 32, 0);\n"
          "  }\n"
          "  const int blocks = (B + rows - 1) / rows < per_sm * sms ? (B + rows - 1) / rows\n"
          "                                                          : per_sm * sms;\n"
          "  topk_merge_sort_kernel<NL, E><<<blocks, kRowWarps * 32, 0, st>>>("),
         (f"{CSRC}/topk_merge.cu",
          "      out_c[pool_at + r] = p.y;\n    }\n  }\n}\n",
          "      out_c[pool_at + r] = p.y;\n    }\n  }\n  }\n}\n")]),
    "merge_no_sort": (
        "topk_merge's sort route without its sort (answers wrong; timing only: the loads, the "
        "payload staging and the stores alone)",
        [(f"{CSRC}/topk_merge.cu", "  repro::row_sort_keys<NL, E>(key, sub);\n", "")]),
    "f32_two_chains": (
        "flash_attn fp32 with two accumulators a score (depths x, z and y, w), added after the "
        "loop: twice the independent FMA chains",
        [(FLASH, "  float s[TR][TK];\n", "  float s[TR][TK], s2[TR][TK];\n"),
         (FLASH, "    for (int u = 0; u < TK; ++u) s[i][u] = 0.f;\n",
          "    for (int u = 0; u < TK; ++u) s[i][u] = s2[i][u] = 0.f;\n"),
         (FLASH, "        s[i][u] = fmaf(qq.y, kk[u].y, s[i][u]);\n",
          "        s2[i][u] = fmaf(qq.y, kk[u].y, s2[i][u]);\n"),
         (FLASH, "        s[i][u] = fmaf(qq.w, kk[u].w, s[i][u]);\n",
          "        s2[i][u] = fmaf(qq.w, kk[u].w, s2[i][u]);\n"),
         (FLASH, "  // online softmax: the row max over the group's G lanes, p, corr\n",
          "#pragma unroll\n  for (int i = 0; i < TR; ++i) {\n#pragma unroll\n"
          "    for (int u = 0; u < TK; ++u) s[i][u] += s2[i][u];\n  }\n"
          "  // online softmax: the row max over the group's G lanes, p, corr\n")]),
    "f32_unroll_full": (
        "flash_attn fp32 with the score loop over the depth unrolled whole at every hd",
        [(FLASH, "#pragma unroll (HD <= 64 ? HD / 4 : 8)\n", "#pragma unroll\n")]),
    "f32_unroll_16": (
        "flash_attn fp32 with the score loop unrolled 16 depth steps at hd >= 128 (8)",
        [(FLASH, "#pragma unroll (HD <= 64 ? HD / 4 : 8)\n", "#pragma unroll (HD <= 64 ? HD / 4 : 16)\n")]),
    "f32_pv_unroll_16": (
        "flash_attn fp32 with the p.v loop unrolled 16 keys (8)",
        [(FLASH, "#pragma unroll 8\n  for (int key = 0; key < C::kBK; ++key) {",
          "#pragma unroll 16\n  for (int key = 0; key < C::kBK; ++key) {")]),
    "f32_pv_unroll_4": (
        "flash_attn fp32 with the p.v loop unrolled 4 keys (8)",
        [(FLASH, "#pragma unroll 8\n  for (int key = 0; key < C::kBK; ++key) {",
          "#pragma unroll 4\n  for (int key = 0; key < C::kBK; ++key) {")]),
    "f32_dropped_kv_tile": (
        "fault: the fp32 attention skips the last kv tile of the sequence",
        [(FLASH, "  const int ntiles = t_hi >= t_lo ? t_hi / BK - first + 1 : 0;\n",
          "  const int ntiles = (t_hi >= t_lo ? t_hi / BK - first + 1 : 0) -\n"
          "                     (t_hi >= t_lo && (t_hi / BK + 1) * BK >= T_);\n")]),
    "f32_skips_corr": (
        "fault: the fp32 attention does not rescale its accumulators by corr",
        [(FLASH, "    for (int c = 0; c < TC; ++c) acc[i][c] *= corr;\n", "")]),
    "f32_unmasked_diagonal": (
        "fault: the fp32 attention takes a tile that crosses the causal diagonal as unmasked",
        [(FLASH, "const bool edge = t0 + BK - 1 > pmin || t0 + BK > T_ ||",
          "const bool edge = t0 + BK > T_ ||")]),
    "merge_last_occurrence": (
        "fault: topk_merge's warp route lets the last occurrence win an exact tie",
        [(SELECT, "| static_cast<unsigned>(pos);", "| static_cast<unsigned>(0xffff - pos);"),
         (SELECT, "  return static_cast<int>(static_cast<unsigned>(key));",
          "  return static_cast<int>(0xffffu - static_cast<unsigned>(key));")]),
    "merge_neg_zero_first": (
        "fault: topk_merge's warp route ranks -0.0 above +0.0 (each slot's score still its own)",
        [(SELECT, "  return b >> 31 ? b : b ^ 0x7fffffffu;",
          "  return b == 0x80000000u ? 0x7fffffffu : b == 0u ? 0x80000000u\n"
          "         : b >> 31 ? b : b ^ 0x7fffffffu;"),
         (SELECT, "  return __uint_as_float(w >> 31 ? w : w ^ 0x7fffffffu);",
          "  return __uint_as_float(w == 0x7fffffffu ? 0x80000000u : w == 0x80000000u ? 0u\n"
          "                         : w >> 31 ? w : w ^ 0x7fffffffu);")]),
})
FAULTS = ("dropped_kv_tile", "ragged_depth", "select_drops_bin_key", "commit_keeps_repeated_slot",
          "commit_skips_round_2", "score_skips_last_row", "quant_scale_before_sum",
          "quant_scores_minus_one", "f32_dropped_kv_tile", "f32_skips_corr",
          "f32_unmasked_diagonal", "merge_last_occurrence", "merge_neg_zero_first")

TIMING = r'''
import torch, repro_torch, chip_smoke as cs
from repro_torch.kernels.commit_merge import commit_merge
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.mips_topk import mips_topk
cs.warm_up_profiler()
g = torch.Generator(device="cuda"); g.manual_seed(0)
out = []
for cell, (b, n, d, k) in cs.MIPS_SHAPES.items():
    for variant in ("f32", "int8"):
        q = cs._int_or_float((b, d), False, g); x = cs._int_or_float((n, d), False, g); sc = None
        if variant == "int8":
            x, sc = cs._int8_store(x, False, g)
        run = lambda: mips_topk(q, x, sc, k=k)
        out.append(f"mips_topk[{variant}]/{cell}={cs.device_ms(run, reps=10):.4f}"
                   f"(pass1={cs.device_ms(run, reps=10, only='chunk'):.4f})")
for cell in ("granite_3_2b", "gemma3_12b_local"):
    b, s, t, h, kv, hd, off, win = cs.FLASH_SHAPES[cell]
    q, k, v = cs._flash_inputs(cs.FLASH_SHAPES[cell], torch.bfloat16, g)
    out.append(f"flash_attn[bf16]/{cell}="
               f"{cs.device_ms(lambda: flash_attention(q, k, v, q_offset=off, window=win), reps=10):.4f}")
items = cs._int_or_float((cs.N_FULL, cs.D_FULL), False, g)
for cell in ("full_k33", "full_k1000"):
    b, n, d, k = cs.MIPS_WIDE_SHAPES[cell]
    q = cs._int_or_float((b, d), False, g)
    run = lambda: mips_topk(q, items, k=k)
    out.append(f"mips_topk[select]/{cell}={cs.device_ms(run, reps=10):.4f}"
               f"(select={cs.device_ms(run, reps=10, only='select'):.4f})")
for graph, (batch, m) in cs.COMMIT_SHAPES.items():
    adj0, t, c, sc = cs._commit_inputs(items, batch, m, g)
    work = adj0.clone()
    call = lambda: (work.copy_(adj0), commit_merge(work, items, t, c, sc))
    out.append(f"commit_merge/{graph}={cs.device_ms(call, only='commit_merge_kernel'):.4f}")
print("RESULT", " ".join(out), flush=True)
'''

WALK_TIMING = r'''
import time, torch, repro_torch, chip_smoke as cs
from repro_torch.core.ipnsw import IpNSW
from repro_torch.data import mips_dataset, mips_queries
from repro_torch.kernels.beam_step import beam_walk
cs.warm_up_profiler()
g = torch.Generator(device="cuda"); g.manual_seed(0)
out = []
items = cs._int_or_float((cs.N_FULL, cs.D_FULL), False, g)
for variant in ("f32", "int8"):
    rows, sc = (items, None) if variant == "f32" else cs._int8_store(items, False, g)
    args, kw = cs._walk_inputs(cs.WALK_SHAPES["search_ip"], rows, sc, False, None, g)
    got = beam_walk(*cs._fresh(args), **kw)
    ms = cs.device_ms(lambda: beam_walk(*cs._fresh(args), **kw), reps=10,
                      only="beam_walk_kernel", once=True)
    out.append(f"walk[{variant}]/search_ip={ms:.4f}({ms / got.steps * 1e3:.3f}us/step)")
x = torch.as_tensor(mips_dataset(cs.N_FULL, cs.D_FULL, "lognormal", seed=0), device="cuda")
q = torch.as_tensor(mips_queries(256, cs.D_FULL, seed=1), device="cuda")
index = IpNSW(max_degree=16, ef_construction=32, insert_batch=512).build(x)
for storage in ("f32", "int8"):
    r = index.search(q, k=10, ef=40, storage=storage)
    ms = cs.device_ms(lambda: index.search(q, k=10, ef=40, storage=storage), reps=10,
                      only="beam_walk_kernel", once=True)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize(); t0 = time.perf_counter()
        index.search(q, k=10, ef=40, storage=storage)
        torch.cuda.synchronize(); walls.append((time.perf_counter() - t0) * 1e3)
    out.append(f"ipnsw_search[{storage}]=walk {ms:.4f}({ms / r.steps * 1e3:.3f}us/step, "
               f"{r.steps} steps) wall_median {sorted(walls)[2]:.4f}")
print("RESULT", " ".join(out), flush=True)
'''

SCORER_TIMING = r'''
import torch, repro_torch, chip_smoke as cs
from repro_torch.kernels.gather_score import gather_score
from repro_torch.kernels.quant_score import quant_score
cs.warm_up_profiler()
g = torch.Generator(device="cuda"); g.manual_seed(0)
items = cs._int_or_float((cs.N_FULL, cs.D_FULL), False, g)
codes, scales = cs._int8_store(items, False, g)
out = []
for name, shapes in (("gather_score", cs.GATHER_SHAPES), ("quant_score", cs.QUANT_SHAPES)):
    for cell, (b, w) in shapes.items():
        q = cs._int_or_float((b, cs.D_FULL), False, g)
        ids = cs._score_ids(b, w, cs.N_FULL, g)
        if name == "gather_score":
            run = lambda: gather_score(q, items, ids)
            wit = lambda: cs._scorer_witness(name, q, items, None, ids)
        else:
            run = lambda: quant_score(q, codes, scales, ids)
            wit = lambda: cs._scorer_witness(name, q, codes, scales, ids)
        same = torch.equal(run().view(torch.int32), wit().view(torch.int32))
        cold = [cs.device_ms(cs._cold(f), only=f"{name}_{k}kernel") for f, k in ((run, ""), (wit, "rowwise_"))]
        out.append(f"{name}/{cell}={cs.device_ms(run):.4f}(witness={cs.device_ms(wit):.4f},"
                   f"cold={cold[0]:.4f},witness_cold={cold[1]:.4f}"
                   f"{'' if same else ',NOT_BIT_IDENTICAL'})")
print("RESULT", " ".join(out), flush=True)
'''

ATTN_MERGE_TIMING = r'''
import torch, repro_torch, chip_smoke as cs
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.topk_merge import topk_merge, topk_merge_ref
cs.warm_up_profiler()
g = torch.Generator(device="cuda"); g.manual_seed(0)
out = []
for cell, shape in cs.FLASH_SHAPES.items():
    b, s, t, h, kv, hd, off, win = shape
    q, k, v = cs._flash_inputs(shape, torch.float32, g)
    ms = cs.device_ms(lambda: flash_attention(q, k, v, q_offset=off, window=win), reps=5)
    out.append(f"flash_attn[f32]/{cell}={ms:.4f}")
    del q, k, v
for cell, shape in {**cs.MERGE_SHAPES, **cs.MERGE_WIDE_SHAPES}.items():
    args = cs._merge_inputs(shape, True, g)
    same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(topk_merge(*args), topk_merge_ref(*args)))
    args = cs._merge_inputs(shape, False, g)
    out.append(f"topk_merge/{cell}={cs.device_ms(lambda: topk_merge(*args)):.4f}"
               f"{'' if same else '(NOT_BIT_IDENTICAL)'}")
print("RESULT", " ".join(out), flush=True)
'''

FAULT_CHECKS = {
    "dropped_kv_tile": r'''
import torch, repro_torch, chip_smoke as cs
from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref
g = torch.Generator(device="cuda"); g.manual_seed(0)
for cell in ("granite_3_2b", "gemma3_12b_local"):
    b, s, t, h, kv, hd, off, win = cs.FLASH_SHAPES[cell]
    q, k, v = cs._flash_inputs(cs.FLASH_SHAPES[cell], torch.bfloat16, g)
    got = flash_attention(q, k, v, q_offset=off, window=win)
    want = flash_attention_ref(q, k, v, q_offset=off, window=win)
    try:
        cs._check_flash(cell, got, want, cs._flash_spread(q, k, v, off, win), cs.FLASH_TOL["bfloat16"])
        print("RESULT not caught", cell, flush=True)
    except AssertionError as e:
        print("RESULT caught", cell, str(e)[:200], flush=True)
''',
    "ragged_depth": r'''
import torch, repro_torch, chip_smoke as cs
from repro_torch.kernels.mips_topk import mips_topk, mips_topk_ref
g = torch.Generator(device="cuda"); g.manual_seed(0)
b, n, d, k = cs.MIPS_SHAPES["full"]
for kind in ("int", "float"):
    q = cs._int_or_float((b, d), kind == "int", g); x = cs._int_or_float((n, d), kind == "int", g)
    (s_k, i_k), (s_p, i_p) = mips_topk(q, x, k=k), mips_topk_ref(q, x, k=k)
    try:
        cs._check_topk(f"full/{kind}", i_k, s_k, i_p, s_p, kind == "int")
        print("RESULT not caught", kind, flush=True)
    except AssertionError as e:
        print("RESULT caught", kind, str(e)[:200], flush=True)
''',
    "select_drops_bin_key": r'''
import torch, repro_torch, chip_smoke as cs
from repro_torch.kernels.mips_topk import mips_topk, mips_topk_ref
g = torch.Generator(device="cuda"); g.manual_seed(0)
for cell in ("full_k33", "n5000_kN"):
    b, n, d, k = cs.MIPS_WIDE_SHAPES[cell]
    q = cs._int_or_float((b, d), True, g); x = cs._int_or_float((n, d), True, g)
    (s_k, i_k), (s_p, i_p) = mips_topk(q, x, k=k), mips_topk_ref(q, x, k=k)
    try:
        cs._check_topk(f"{cell}/int", i_k, s_k, i_p, s_p, True)
        print("RESULT not caught", cell, flush=True)
    except AssertionError as e:
        print("RESULT caught", cell, str(e)[:200], flush=True)
''',
    "commit_merge": r'''
import torch, repro_torch, chip_smoke as cs
g = torch.Generator(device="cuda"); g.manual_seed(0)
items = {"int": cs._int_or_float((cs.N_FULL, cs.D_FULL), True, g)}
try:
    cs.phase_commit_merge(items, g)
    print("RESULT not caught", flush=True)
except AssertionError as e:
    print("RESULT caught", str(e)[:200], flush=True)
''',
}
FAULT_CHECKS["commit_keeps_repeated_slot"] = FAULT_CHECKS["commit_merge"]
FAULT_CHECKS["commit_skips_round_2"] = FAULT_CHECKS.pop("commit_merge")
FAULT_CHECKS["score_skips_last_row"] = r'''
import torch, repro_torch, chip_smoke as cs
cs.warm_up_profiler()
g = torch.Generator(device="cuda"); g.manual_seed(0)
items = {kind: cs._int_or_float((cs.N_FULL, cs.D_FULL), kind == "int", g) for kind in ("int", "float")}
stores = {kind: cs._int8_store(x, kind == "int", g) for kind, x in items.items()}
try:
    cs.phase_scorers(items, stores, g)
    print("RESULT not caught", flush=True)
except AssertionError as e:
    print("RESULT caught", str(e)[:200], flush=True)
'''
FAULT_CHECKS["quant_scale_before_sum"] = FAULT_CHECKS["score_skips_last_row"]
FAULT_CHECKS["quant_scores_minus_one"] = FAULT_CHECKS["score_skips_last_row"]
# the fp32 attention: caught where any fp32 cell of phase 3 (model cells and
# edges) fails its check
FAULT_CHECKS["f32_dropped_kv_tile"] = r'''
import torch, repro_torch, chip_smoke as cs
g = torch.Generator(device="cuda"); g.manual_seed(0)
caught = []
for cell, shape in {**cs.FLASH_SHAPES, **cs.FLASH_EDGE_SHAPES}.items():
    try:
        cs.check_flash_cell(cell, shape, torch.float32, g)
    except AssertionError as e:
        caught.append(cell)
        print("RESULT", "failed", cell, str(e)[:160], flush=True)
    torch.cuda.empty_cache()
print("RESULT", f"caught in {caught}" if caught else "not caught", flush=True)
'''
FAULT_CHECKS["f32_skips_corr"] = FAULT_CHECKS["f32_dropped_kv_tile"]
FAULT_CHECKS["f32_unmasked_diagonal"] = FAULT_CHECKS["f32_dropped_kv_tile"]
FAULT_CHECKS["merge_last_occurrence"] = r'''
import torch, repro_torch, chip_smoke as cs
cs.warm_up_profiler()
g = torch.Generator(device="cuda"); g.manual_seed(0)
try:
    cs.phase_topk_merge(g)
    print("RESULT not caught", flush=True)
except AssertionError as e:
    print("RESULT caught", str(e)[:200], flush=True)
'''
FAULT_CHECKS["merge_neg_zero_first"] = FAULT_CHECKS["merge_last_occurrence"]


def tree(name: str) -> Path:
    """A copy of src/ under build/compare/<name> with the named edits."""
    out = ROOT / "build" / "compare" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(ROOT / "src", out / "src", ignore=shutil.ignore_patterns("__pycache__"))
    for source, text, replacement in EDITS[name][1]:
        path = out / source
        code = path.read_text()
        if code.count(text) != 1:
            raise SystemExit(f"{name}: the text to edit is not in {source} exactly once")
        path.write_text(code.replace(text, replacement))
    return out / "src"


def run(src: Path, code: str) -> list:
    """Runs ``code`` in a process that imports the port from ``src``;
    returns its RESULT lines."""
    env = dict(os.environ, PYTHONPATH=f"{src}{os.pathsep}{ROOT}")
    for attempt in range(2):  # the profiler of a card's first processes can lose events
        proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                              text=True, timeout=1800, cwd=ROOT)
        lines = [ln[len("RESULT "):] for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode == 0 and lines:
            return lines
        print(f"{src}: attempt {attempt + 1} exit {proc.returncode}: {proc.stderr[-300:]}",
              flush=True)
    raise SystemExit(f"{src}: exit {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default="", help="comma-separated names of EDITS")
    ap.add_argument("--faults", nargs="?", const=",".join(FAULTS), default="",
                    help="run the planted faults (all, or the comma-separated names given)")
    ap.add_argument("--walk", action="store_true", help="time beam_walk, not the scans")
    ap.add_argument("--scorers", action="store_true",
                    help="time gather_score and quant_score (and their witness), not the scans")
    ap.add_argument("--attn-merge", action="store_true",
                    help="time flash_attn fp32 and topk_merge, not the scans")
    ap.add_argument("--parent", default="",
                    help="a src/ tree of another commit (git archive), timed in turns as 'parent'")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    status = 0
    if args.variants or args.parent:
        names = args.variants.split(",") if args.variants else []
        trees = ([("checkout", ROOT / "src")]
                 + ([("parent", (ROOT / args.parent).resolve())] if args.parent else [])
                 + [(n, tree(n)) for n in names])
        code = (WALK_TIMING if args.walk else SCORER_TIMING if args.scorers
                else ATTN_MERGE_TIMING if args.attn_merge else TIMING)
        for label, src in trees + trees[::-1]:
            lines = run(src, code)
            phases = [ln for ln in lines if ln.startswith("phases")]
            print(f"{label}: {[ln for ln in lines if ln not in phases][-1]}", flush=True)
            if phases:  # an instrumented variant: its last few walks
                print("\n".join(f"{label}: {ln}" for ln in phases[-12:]), flush=True)
    if args.faults:
        for name in args.faults.split(","):
            for line in run(tree(name), FAULT_CHECKS[name]):
                print(f"{name}: {line}", flush=True)
                status |= line.startswith("not caught")
    return status


if __name__ == "__main__":
    sys.exit(main())
