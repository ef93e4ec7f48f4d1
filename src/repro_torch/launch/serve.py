"""MIPS serving launcher, one-shot mode: build an index over a seeded
synthetic catalog, answer one timed batch of queries, and report recall@k
against the exact scan.

  PYTHONPATH=src python -m repro_torch.launch.serve --index ipnsw_plus \\
      --n-items 20000 --dim 64 --batch 256 --ef 40 [--storage int8]

The defaults are the JAX package's (``python -m repro.launch.serve``); the
index is ``IpNSW`` / ``IpNSWPlus(max_degree=16, ef_construction=32,
insert_batch=512)`` or the exact scan.  ``--storage int8`` searches the int8
store (quantized walk, exact fp32 rerank; the build stays fp32); the exact
scan ignores it, as the JAX CLI does.  ``--device`` defaults to the card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.brute_force import exact_topk
from repro_torch.core.ipnsw import IpNSW
from repro_torch.core.ipnsw_plus import IpNSWPlus
from repro_torch.core.storage import STORAGE_BACKENDS
from repro_torch.data import mips_dataset, mips_queries
from repro_torch.obs.recall import recall_at_k


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", default="ipnsw_plus",
                    choices=["bruteforce", "ipnsw", "ipnsw_plus"])
    ap.add_argument("--n-items", type=int, default=20_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--ef", type=int, default=40)
    ap.add_argument("--profile", default="lognormal")
    ap.add_argument("--storage", default="f32", choices=STORAGE_BACKENDS,
                    help="item store the search streams (int8 = quantized walk "
                         "+ exact fp32 rerank)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    items = torch.as_tensor(mips_dataset(args.n_items, args.dim, args.profile, seed=0),
                            device=device)
    queries = torch.as_tensor(mips_queries(args.batch, args.dim, seed=1), device=device)
    _, gt = exact_topk(queries, items, k=args.k)
    gt = gt.cpu().numpy()

    if args.index == "bruteforce":
        _sync(device)
        t0 = time.perf_counter()
        _, ids = exact_topk(queries, items, k=args.k)
        _sync(device)
        dt = time.perf_counter() - t0
        evals = float(args.n_items)
    else:
        cls = IpNSWPlus if args.index == "ipnsw_plus" else IpNSW
        index = cls(max_degree=16, ef_construction=32, insert_batch=512,
                    storage=args.storage, device=args.device).build(items)
        index.search(queries, k=args.k, ef=args.ef)  # warm-up
        _sync(device)
        t0 = time.perf_counter()
        r = index.search(queries, k=args.k, ef=args.ef)
        _sync(device)
        dt = time.perf_counter() - t0
        ids = r.ids
        evals = float(r.evals.float().mean())
    rec = recall_at_k(ids.cpu().numpy(), gt)
    print(f"[serve] index={args.index} shards=1 storage={args.storage} "
          f"N={args.n_items} B={args.batch} ef={args.ef}: "
          f"recall@{args.k}={rec:.3f} evals/q={evals:.0f} "
          f"({dt / args.batch * 1e3:.2f} ms/query batch-amortized) device={device}")
    return {"recall": rec, "evals_per_query": evals, "search_seconds": dt}


if __name__ == "__main__":
    main()
