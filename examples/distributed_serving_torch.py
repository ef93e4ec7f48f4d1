"""Distributed MIPS serving on the PyTorch port
(``examples/distributed_serving.py`` runs it on the JAX package): items
row-sharded into 8 shard-local ip-NSW+ sub-indexes, the queries fanned out
to every shard and the per-shard top k merged; a dead shard degrades
recall, not availability.

  PYTHONPATH=src python examples/distributed_serving_torch.py [--device cpu]

The port needs no mesh here: ``sharded_search`` views the stacked shards as
one flat graph and walks all of them in one ``beam_walk`` launch on one
card (the JAX package's ``shard_map`` puts a shard on each device).
Returns the table's rows.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import build_sharded, exact_topk, recall_at_k, sharded_search
from repro_torch.data import mips_dataset, mips_queries

DEAD_SHARD = 3


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-items", type=int, default=16_000)
    ap.add_argument("--dim", type=int, default=48)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--shards", type=int, default=8)
    args = ap.parse_args(argv)
    n, d, b, k, shards = args.n_items, args.dim, args.queries, 10, args.shards
    items = torch.as_tensor(mips_dataset(n, d, profile="lognormal", seed=0), device=args.device)
    queries = torch.as_tensor(mips_queries(b, d, seed=1), device=args.device)
    gt = exact_topk(queries, items, k=k)[1].cpu().numpy()

    print(f"building {shards} shard-local ip-NSW+ indexes ({n // shards} items each; "
          f"scan driver: one captured insertion batch a shard)...")
    index = build_sharded(items, shards, plus=True, build_backend="scan", device=args.device,
                          max_degree=16, ef_construction=32, insert_batch=512)

    rows = []
    ids, _, evals = sharded_search(index, queries, k=k, ef=40)
    rec = recall_at_k(ids.cpu().numpy(), gt)
    ev = float(np.mean(evals.cpu().numpy()))
    print(f"all shards up:   recall@10 = {rec:.3f}  (total evals/query {ev:.0f})")
    rows.append(dict(shards_up=shards, recall=rec, evals=ev))

    # kill one shard: serving continues, recall degrades gracefully
    mask = torch.ones(shards, dtype=torch.bool)
    mask[DEAD_SHARD] = False
    ids, _, evals = sharded_search(index, queries, k=k, ef=40, shard_mask=mask)
    rec = recall_at_k(ids.cpu().numpy(), gt)
    print(f"shard {DEAD_SHARD} down:    recall@10 = {rec:.3f}  (availability preserved; "
          f"the launcher rebuilds the shard from its item partition)")
    rows.append(dict(shards_up=shards - 1, recall=rec, evals=float(np.mean(evals.cpu().numpy()))))
    return rows


if __name__ == "__main__":
    main()
