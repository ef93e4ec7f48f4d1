"""How far an fp32 run of a random LM at its published widths is from a
float64 run of the same weights, on the CPU (the port's plain versions).

  PYTHONPATH=src python scripts/lm_conditioning.py [--arch gemma3-12b] [--layers 6]

For each arch (the layers cut to one pattern cycle, batch 2, a 256-token
prompt, 3 greedy decode steps) it prints the fp32 logits' distance from the
float64 logits, over the row's largest |logit|, for the prefill and each
step; then each block's fp32 output on the float64 run's input, over its
row's largest |value|.  The first shows how far two correct fp32 runs can
drift apart (JAX's init draws the queries at H**-0.5, so attention scores
run to hundreds and an error grows at every attention layer); the second is
the noise of one block, which ``chip_smoke.py`` phase 10 (b) holds the card
to.  The float64 weights need 8 bytes a parameter: the MoE archs at one
pattern cycle take 40-50 GB.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import layers as L
from repro_torch.models import transformer as tf
from repro_torch.train.tree import tree_map

CYCLE = {"granite-3-2b": 2, "gemma3-12b": 6, "internlm2-20b": 2,
         "qwen3-moe-235b-a22b": 2, "grok-1-314b": 1}
BATCH, PROMPT, STEPS = 2, 256, 3


def _row_err(got, want) -> float:
    return float(((got.double() - want).abs() / want.abs().amax(-1, keepdim=True)).max())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append",
                    help="repeatable; default: granite-3-2b, gemma3-12b, internlm2-20b")
    ap.add_argument("--layers", type=int, default=0, help="default: one pattern cycle")
    args = ap.parse_args(argv)
    for aid in args.arch or ["granite-3-2b", "gemma3-12b", "internlm2-20b"]:
        base = get_arch(aid).cfg
        cfg = dataclasses.replace(base, n_layers=args.layers or CYCLE[aid], dtype=torch.float32)
        cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
        p32 = tf.init(cfg, torch.Generator().manual_seed(3), device="cpu")
        p64 = tree_map(lambda t: t.double(), p32)
        prompt = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab, (BATCH, PROMPT)))

        lg, c32 = tf.serve_prefill(p32, prompt, cfg, max_len=PROMPT + STEPS)
        lg64, c64 = tf.serve_prefill(p64, prompt, cfg64, max_len=PROMPT + STEPS)
        free = [_row_err(lg, lg64)]
        for i in range(STEPS):
            tok = lg.argmax(-1)[:, None]
            lg, c32 = tf.serve_step(p32, c32, tok, PROMPT + i, cfg)
            lg64, c64 = tf.serve_step(p64, c64, tok, PROMPT + i, cfg64)
            free.append(_row_err(lg, lg64))

        x = p64["embed"][prompt]
        pos = torch.arange(PROMPT)
        blocks = []
        for (_, _, w, b64), (_, _, _, b32) in zip(tf._layers(p64, cfg64), tf._layers(p32, cfg)):
            y64 = tf._block_apply(b64, x, pos, cfg64, w)[0]
            blocks.append(_row_err(tf._block_apply(b32, x.float(), pos, cfg, w)[0], y64))
            x = y64
        h = L.rmsnorm(x[:, -1:], p64["final_ln"])
        head = _row_err(L.matmul_f32(h.float(), tf._head(p32, cfg)[0]),
                        h @ tf._head(p64, cfg64)[0])
        print(f"{aid} layers={cfg.n_layers}: fp32 logits from float64, prefill then "
              f"{STEPS} steps: {' '.join(f'{e:.3g}' for e in free)}; each block on the "
              f"float64 input: {' '.join(f'{e:.3g}' for e in blocks)}; the head on the "
              f"float64 last state: {head:.3g}")


if __name__ == "__main__":
    main()
