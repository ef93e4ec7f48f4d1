#!/usr/bin/env python3
"""Time and fault-test edited copies of the port's kernels on one card.

  python3 chip_compare.py --variants no_epilogue,flash_one_block
  python3 chip_compare.py --walk --variants walk_prefetch_rows,walk_prefetch_adj
  python3 chip_compare.py --faults

Each variant or fault is a named edit of a CUDA source (EDITS below),
applied to a copy of ``src/`` under ``build/compare/<name>``, which builds
its own kernel library.  ``--variants`` times ``mips_topk`` and the bf16
``flash_attention`` of the checkout and of each variant, one process per
tree, in turns (checkout, variants, variants reversed, checkout), at the
shapes of ``chip_smoke.py``'s phase 3; with ``--walk`` it times
``beam_walk`` instead: at phase 3's search IP walk (random graph, f32 and
int8) and in an IpNSW search of 256 queries at Yahoo!Music's size.  ``--faults`` runs each planted fault
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
FAULTS = ("dropped_kv_tile", "ragged_depth")

TIMING = r'''
import torch, repro_torch, chip_smoke as cs
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
}


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
    ap.add_argument("--faults", action="store_true", help="run the planted faults")
    ap.add_argument("--walk", action="store_true", help="time beam_walk, not the scans")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    status = 0
    if args.variants:
        names = args.variants.split(",")
        trees = [("checkout", ROOT / "src")] + [(n, tree(n)) for n in names]
        for label, src in trees + trees[::-1]:
            lines = run(src, WALK_TIMING if args.walk else TIMING)
            print(f"{label}: {lines[-1]}", flush=True)
            phases = [ln for ln in lines if ln.startswith("phases")]
            if phases:  # an instrumented variant: its last few walks
                print("\n".join(f"{label}: {ln}" for ln in phases[-4:]), flush=True)
    if args.faults:
        for name in FAULTS:
            for line in run(tree(name), FAULT_CHECKS[name]):
                print(f"{name}: {line}", flush=True)
                status |= line.startswith("not caught")
    return status


if __name__ == "__main__":
    sys.exit(main())
