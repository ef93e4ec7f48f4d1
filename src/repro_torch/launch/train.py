"""Training launcher (the JAX package's ``python -m repro.launch.train``)
for the LM, GNN and recsys families.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --steps 50 --ckpt-dir ckpt [--device cpu]

``--scale tiny`` trains, through ``train.loop.run``, an LM arch reduced as
the JAX launcher's ``_tiny_lm`` reduces it (two pattern cycles at d 128,
fp32, windows of 64, no remat) on ``SyntheticLMStream`` batches of
``--batch`` x ``--seq`` tokens, or a recsys arch's config with its tables
cut to 10,000 rows on ``SyntheticClickStream`` batches, or MeshGraphNet
reduced as the JAX launcher reduces it (4 layers at d_hidden 64, d_feat 32)
on ``GraphStream``'s random graphs of 512 nodes and 2,048 edges: AdamW, the cosine
schedule (warmup a tenth of the steps), a checkpoint every
``--ckpt-every`` steps and at the end; re-running the same command resumes
from the last committed checkpoint.  The LM's and the GNN's initial
weights are drawn from a CPU generator (seed 0), so a card run starts where
a CPU run does.  ``--device`` defaults to the card.  ``--arch mind`` fails
as the JAX launcher does: the click stream's ``pos`` is SASRec's [B, S],
and MIND's loss takes [B].
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.data import SyntheticClickStream, SyntheticLMStream
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import transformer as tf
from repro_torch.train import adamw_init, adamw_update, cosine_schedule, loop, value_and_grad

TINY_ROWS = 10_000


def _tiny_lm(cfg: tf.TransformerConfig) -> tf.TransformerConfig:
    """JAX's ``_tiny_lm`` (its ``attn_chunk`` of 64 is an XLA layout knob the
    port does not have)."""
    pat = tuple((64 if w is not None else None) for w in cfg.window_pattern)
    return dataclasses.replace(
        cfg, n_layers=2 * len(pat), d_model=128, n_heads=4, n_kv=2, head_dim=32,
        d_ff=256 if not cfg.is_moe else 128, vocab=1024,
        moe_experts=4 if cfg.is_moe else 0, moe_top_k=2 if cfg.is_moe else 0,
        window_pattern=pat, dtype=torch.float32, remat=False)


def _lm_init(cfg: tf.TransformerConfig, device: torch.device):
    """The tiny LM's initial weights, drawn on the CPU (seed 0)."""
    return tf.init(cfg, torch.Generator().manual_seed(0), device=device)


def _gnn_init(cfg: gnn_mod.GNNConfig, device: torch.device):
    """The reduced GNN's initial weights, drawn on the CPU (seed 0)."""
    return gnn_mod.init(cfg, torch.Generator().manual_seed(0), device=device)


class GraphStream:
    """The JAX launcher's random graphs: each step's features and targets
    from ``default_rng(step)``, its ``src`` and ``dst`` from one generator
    made with the stream (``default_rng(0)``) and advanced at every call, so
    a resumed run sees other edges than an uninterrupted one (a property of
    the reference, kept)."""

    def __init__(self, cfg: gnn_mod.GNNConfig, n_nodes: int = 512, n_edges: int = 2048):
        self.cfg, self.n, self.e = cfg, n_nodes, n_edges
        self.rng = np.random.default_rng(0)

    def batch_at(self, step: int) -> dict:
        r = np.random.default_rng(step)
        n, e = self.n, self.e
        return dict(
            node_feat=r.normal(size=(n, self.cfg.d_feat)).astype(np.float32),
            edge_feat=r.normal(size=(e, self.cfg.d_edge)).astype(np.float32),
            src=self.rng.integers(0, n, e).astype(np.int32),
            dst=self.rng.integers(0, n, e).astype(np.int32),
            targets=r.normal(size=(n, self.cfg.out_dim)).astype(np.float32),
        )


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
    device = torch.device(args.device)
    if arch.family == "lm":
        cfg = _tiny_lm(arch.cfg)
        params = _lm_init(cfg, device)
        stream = SyntheticLMStream(cfg.vocab, args.batch, args.seq)
        grad_fn = value_and_grad(lambda p, b: tf.lm_loss(p, b, cfg))
    elif arch.family == "gnn":
        cfg = dataclasses.replace(arch.base, n_layers=4, d_hidden=64, d_feat=32, d_edge=4)
        params = _gnn_init(cfg, device)
        stream = GraphStream(cfg)
        grad_fn = value_and_grad(lambda p, b: gnn_mod.mse_loss(p, b, cfg))
    else:
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
