#!/usr/bin/env python3
"""Time and fault-test edited copies of the port's kernels on one card.

  python3 chip_compare.py --variants no_epilogue,flash_one_block
  python3 chip_compare.py --faults

Each variant or fault is a named edit of a CUDA source (EDITS below),
applied to a copy of ``src/`` under ``build/compare/<name>``, which builds
its own kernel library.  ``--variants`` times ``mips_topk`` and the bf16
``flash_attention`` of the checkout and of each variant, one process per
tree, in turns (checkout, variants, variants reversed, checkout), at the
shapes of ``chip_smoke.py``'s phase 3.  ``--faults`` runs each planted fault
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
            print(f"{label}: {run(src, TIMING)[0]}", flush=True)
    if args.faults:
        for name in FAULTS:
            for line in run(tree(name), FAULT_CHECKS[name]):
                print(f"{name}: {line}", flush=True)
                status |= line.startswith("not caught")
    return status


if __name__ == "__main__":
    sys.exit(main())
