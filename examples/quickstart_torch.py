"""Quickstart on the PyTorch port (``examples/quickstart.py`` runs it on the
JAX package): build ip-NSW and ip-NSW+ over a synthetic embedding corpus,
run batched MIPS queries, and compare recall / evaluation counts against
the exact linear scan.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] [--n-items 20000]

``--device`` defaults to the card, where the walk is one ``beam_walk``
launch a search, the builds commit with ``commit_merge`` and the exact scan
is ``mips_topk``.  Returns the table's rows.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import IpNSW, IpNSWPlus, exact_topk, recall_at_k
from repro_torch.data import mips_dataset, mips_queries

EFS = (10, 20, 40, 80)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-items", type=int, default=20_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    args = ap.parse_args(argv)
    n, d, b, k = args.n_items, args.dim, args.queries, args.k
    items = torch.as_tensor(mips_dataset(n, d, profile="lognormal", seed=0), device=args.device)
    queries = torch.as_tensor(mips_queries(b, d, seed=1), device=args.device)

    print(f"dataset: {n} items x {d} dims; {b} queries; top-{k} MIPS")
    gt = exact_topk(queries, items, k=k)[1].cpu().numpy()

    knobs = dict(max_degree=16, ef_construction=32, insert_batch=512, device=args.device)
    print("building ip-NSW (baseline)...")
    base = IpNSW(**knobs).build(items)
    print("building ip-NSW+ (the paper's contribution)...")
    plus = IpNSWPlus(**knobs).build(items)

    rows = []
    print(f"{'algo':8s} {'ef':>4s} {'recall@10':>10s} {'evals/query':>12s} {'vs brute':>9s}")
    for ef in EFS:
        for name, index in (("ip-NSW", base), ("ip-NSW+", plus)):
            r = index.search(queries, k=k, ef=ef)
            rec = recall_at_k(r.ids.cpu().numpy(), gt)
            ev = float(np.mean(r.evals.cpu().numpy()))
            print(f"{name:8s} {ef:4d} {rec:10.3f} {ev:12.0f} {ev / n:8.1%}")
            rows.append(dict(algo=name, ef=ef, recall=rec, evals=ev))
    return rows


if __name__ == "__main__":
    main()
