"""Training launcher (the JAX package's ``python -m repro.launch.train``)
for the recsys family.

  PYTHONPATH=src python -m repro_torch.launch.train --arch sasrec \\
      --steps 50 --ckpt-dir ckpt [--device cpu]

``--scale tiny`` trains the arch's config with its tables cut to 10,000
rows, on ``SyntheticClickStream`` batches, through ``train.loop.run``:
AdamW, the cosine schedule (warmup a tenth of the steps), a checkpoint
every ``--ckpt-every`` steps and at the end; re-running the same command
resumes from the last committed checkpoint.  ``--device`` defaults to the
card.  An LM id raises ``NotImplementedError`` (the LM family serves on
the port; it trains in the next slice), and so does the GNN id (not ported
yet);
``--arch mind`` fails as the JAX launcher does: the click stream's ``pos``
is SASRec's [B, S], and MIND's loss takes [B].
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_arch
from repro_torch.data import SyntheticClickStream
from repro_torch.train import adamw_init, adamw_update, cosine_schedule, loop, value_and_grad

TINY_ROWS = 10_000


def main(argv=None) -> loop.TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--scale", default="tiny", choices=["tiny"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)  # the LM family's; recsys uses seq_len
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    if arch.family == "lm":
        raise NotImplementedError(f"{args.arch}: the LM family trains in the next slice "
                                  "(ROADMAP Queue 1, item 6)")
    device = torch.device(args.device)
    field = "n_rows" if args.arch == "dlrm-rm2" else "n_items"
    cfg = dataclasses.replace(arch.cfg, **{field: TINY_ROWS})
    params = arch.mod.init(cfg, device=device)
    stream = SyntheticClickStream(TINY_ROWS, args.batch, getattr(cfg, "seq_len", 50))
    loss_fn = arch.loss_fn()
    grad_fn = value_and_grad(lambda p, b: loss_fn(p, b, cfg))

    state = {"params": params, "opt": adamw_init(params)}

    def step_fn(state, batch):
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        loss, grads = grad_fn(state["params"], batch)
        lr = cosine_schedule(state["opt"].step, base_lr=args.lr,
                             warmup=max(args.steps // 10, 1), total=args.steps)
        p, o = adamw_update(grads, state["opt"], state["params"], lr=lr)
        return {"params": p, "opt": o}, {"loss": loss}

    res = loop.run(step_fn, state, stream, n_steps=args.steps,
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    print(f"[train] {args.arch}: loss {res.history[0]['loss']:.4f} -> "
          f"{res.history[-1]['loss']:.4f} over {len(res.history)} steps; "
          f"{len(res.straggler_steps)} straggler steps")
    return res


if __name__ == "__main__":
    main()
