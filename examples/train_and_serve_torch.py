"""End-to-end driver on the PyTorch port (the paper's own pipeline, as
``examples/train_and_serve.py`` runs it on the JAX package): train
matrix-factorization embeddings on synthetic user-item interactions with
AdamW through ``train.loop``, build ip-NSW+ over the trained item table
with the scan build driver, and serve top-10 MIPS queries against the exact
scan.

  PYTHONPATH=src python examples/train_and_serve_torch.py [--steps 300] [--device cpu]

The initial values are drawn on a CPU ``torch.Generator`` and then moved, so
a CPU run and a card run start equal.  ``--device`` defaults to the card.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import IpNSWPlus, exact_topk, recall_at_k
from repro_torch.train import adamw_init, adamw_update, loop, value_and_grad

BATCH = 4096
EFS = (20, 40, 80)
SERVED_USERS = 512


def make_interactions(n_users, n_items, d_true, rng):
    """A ground-truth low-rank preference matrix: its user and item factors."""
    u = rng.normal(size=(n_users, d_true)).astype(np.float32) / np.sqrt(d_true)
    v = rng.normal(size=(n_items, d_true)).astype(np.float32) / np.sqrt(d_true)
    return u, v


class InteractionStream:
    def __init__(self, u_true, v_true, batch, seed=0):
        self.u, self.v, self.batch, self.seed = u_true, v_true, batch, seed

    def batch_at(self, step):
        rng = np.random.default_rng((self.seed << 32) + step)
        ui = rng.integers(0, len(self.u), self.batch)
        ii = rng.integers(0, len(self.v), self.batch)
        r = np.einsum("bd,bd->b", self.u[ui], self.v[ii])
        return {
            "users": ui.astype(np.int32),
            "items": ii.astype(np.int32),
            "ratings": r.astype(np.float32),
        }


def init_params(n_users, n_items, dim, device):
    g = torch.Generator().manual_seed(0)
    return {"user": (torch.randn((n_users, dim), generator=g) * 0.1).to(device),
            "item": (torch.randn((n_items, dim), generator=g) * 0.1).to(device)}


def mf_loss(p, batch):
    pu = p["user"][batch["users"].long()]
    pi = p["item"][batch["items"].long()]
    pred = torch.sum(pu * pi, dim=-1)
    return torch.mean((pred - batch["ratings"]) ** 2)


def train(n_users, n_items, dim, steps, *, device, params=None, ckpt_dir=None, verbose=True):
    """MF trained through ``loop.run``: the ``TrainResult``.  ``params``
    (the tree ``init_params`` makes) replaces the drawn initial values."""
    rng = np.random.default_rng(0)
    u_true, v_true = make_interactions(n_users, n_items, dim, rng)
    stream = InteractionStream(u_true, v_true, batch=BATCH)
    if params is None:
        params = init_params(n_users, n_items, dim, device)
    grad_fn = value_and_grad(mf_loss)

    def step_fn(state, batch):
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        loss, grads = grad_fn(state["params"], batch)
        p, o = adamw_update(grads, state["opt"], state["params"], lr=3e-3, weight_decay=0.0)
        return {"params": p, "opt": o}, {"loss": loss}

    state = {"params": params, "opt": adamw_init(params)}
    return loop.run(step_fn, state, stream, n_steps=steps, ckpt_dir=ckpt_dir, log_every=100,
                    verbose=verbose)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--n-users", type=int, default=2000)
    ap.add_argument("--n-items", type=int, default=20000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    print(f"== training MF ({args.n_users}x{args.n_items}, d={args.dim}) ==")
    t0 = time.perf_counter()
    res = train(args.n_users, args.n_items, args.dim, args.steps, device=device,
                ckpt_dir=args.ckpt_dir)
    train_s = time.perf_counter() - t0
    print(f"loss {res.history[0]['loss']:.4f} -> {res.history[-1]['loss']:.4f}")

    item_emb = res.state["params"]["item"].contiguous()
    user_emb = res.state["params"]["user"][:SERVED_USERS].contiguous()

    print("== building ip-NSW+ over trained item embeddings ==")
    t0 = time.perf_counter()
    index = IpNSWPlus(max_degree=16, ef_construction=32, insert_batch=512,
                      build_backend="scan", device=device).build(item_emb)
    if device.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"built in {build_s:.1f}s")

    _, gt = exact_topk(user_emb, item_emb, k=10)
    gt = gt.cpu().numpy()
    print(f"== serving {SERVED_USERS} users, top-10 recommendation ==")
    out = {"loss_first": res.history[0]["loss"], "loss_final": res.history[-1]["loss"],
           "train_s": train_s, "build_s": build_s, "recall": {}, "evals": {}}
    for ef in EFS:
        r = index.search(user_emb, k=10, ef=ef)
        rec = recall_at_k(r.ids.cpu().numpy(), gt)
        ev = float(r.evals.float().mean())
        out["recall"][ef], out["evals"][ef] = rec, ev
        print(f"ef={ef:3d}: recall@10={rec:.3f}  evals/query={ev:.0f} "
              f"({ev/args.n_items:.1%} of corpus)")
    return out


if __name__ == "__main__":
    main()
