"""LM serving demo on the PyTorch port (``examples/lm_decode.py`` runs it on
the JAX package): greedy generation through the prefill + ring-buffer
decode path on a reduced gemma3-style hybrid (5 sliding : 1 global
attention), checking decode against the full forward as it goes.

  PYTHONPATH=src python examples/lm_decode_torch.py [--device cpu]

The weights are drawn on a CPU ``torch.Generator`` and then moved, so a CPU
run and a card run start equal.  ``--device`` defaults to the card, where
attention runs on the ``flash_attn`` kernel.
"""
import argparse

import numpy as np
import torch

from repro_torch.models.transformer import (
    TransformerConfig,
    forward,
    init,
    serve_prefill,
    serve_step,
)

WINDOW = 16


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = TransformerConfig(
        name="gemma3-tiny",
        n_layers=6,
        d_model=128,
        n_heads=4,
        n_kv=2,
        head_dim=32,
        d_ff=256,
        vocab=512,
        window_pattern=(WINDOW,) * 5 + (None,),  # 5:1 local:global
        tied_embed=True,
        dtype=torch.float32,
    )
    params = init(cfg, torch.Generator().manual_seed(0), device=device)
    rng = np.random.default_rng(0)
    B, S, STEPS = 2, 32, 16
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32), device=device)

    print(f"prefill {S} tokens (cache: sliding layers keep {WINDOW} slots, "
          f"global layers {S + STEPS})...")
    logits, caches = serve_prefill(params, prompt, cfg, max_len=S + STEPS)
    toks = prompt
    nxt = torch.argmax(logits, -1)[:, None].to(torch.int32)

    max_err = 0.0
    with torch.inference_mode():
        for i in range(STEPS):
            lg, caches = serve_step(params, caches, nxt, S + i, cfg)
            toks = torch.cat([toks, nxt], dim=1)
            # cross-check against the full forward every few steps
            if i % 4 == 0:
                lg_full = forward(params, toks, cfg)[0][:, -1]
                rel = float((lg_full - lg).abs().max()) / float(lg_full.abs().max())
                max_err = max(max_err, rel)
                assert bool((torch.argmax(lg_full, -1) == torch.argmax(lg, -1)).all()), \
                    "decode diverged from forward"
            nxt = torch.argmax(lg, -1)[:, None].to(torch.int32)

    print(f"generated {STEPS} tokens/seq; decode-vs-forward max relative "
          f"logit err = {max_err:.2e} (fp32 reduction-order noise; argmax "
          f"identical at every checked step)")
    print("sequences:", toks[:, -8:].cpu().tolist())
    return {"tokens": toks.cpu().numpy(), "max_err": max_err}


if __name__ == "__main__":
    main()
