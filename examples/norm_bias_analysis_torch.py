"""The paper's section 2-3 analyses on synthetic data, on the PyTorch port
(``examples/norm_bias_analysis.py`` runs them on the JAX package): norm
bias of the MIPS ground truth (Fig 1), the Theorem-1 curve (Fig 3a), the
cardinality effect (Fig 3b), in-degree concentration (Fig 4) and
computation concentration (Fig 5).

  PYTHONPATH=src python examples/norm_bias_analysis_torch.py [--device cpu]

``--device`` defaults to the card (the exact scans on ``mips_topk``, the
build and search on ``commit_merge`` and ``beam_walk``); the statistics are
host numpy.  Returns the table: each figure's numbers by name.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import IpNSW, exact_topk
from repro_torch.core.graph import in_degrees
from repro_torch.core.norms import (
    group_occupancy,
    norm_group_of,
    tailing_factor,
    theorem1_probability,
    top_group_share,
)
from repro_torch.data import mips_dataset, mips_queries


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-items", type=int, default=20_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--queries", type=int, default=500)
    args = ap.parse_args(argv)
    n, d, b, dev = args.n_items, args.dim, args.queries, args.device
    items = mips_dataset(n, d, profile="lognormal", seed=0)
    queries = mips_queries(b, d, seed=1)
    norms = np.linalg.norm(items, axis=1)
    q = torch.as_tensor(queries, device=dev)
    table = {"tailing_factor": tailing_factor(norms)}

    print(f"== dataset: N={n}, d={d}, tailing factor {table['tailing_factor']:.2f} ==\n")

    gt = exact_topk(q, torch.as_tensor(items, device=dev), k=10)[1].cpu().numpy()
    table["fig1_top5_share"] = top_group_share(gt, norms, 5.0)
    print("Fig 1 — norm bias of exact top-10 MIPS:")
    print(f"  top-5%-norm items hold {table['fig1_top5_share']:.1%} of the result set")
    print("  (paper: 87.5%-100% on its four real datasets)\n")

    print("Fig 3a — Theorem 1, P[qx >= qy] for norm ratio sqrt(alpha):")
    table["fig3a"] = {}
    for a in (1.0, 1.35, 2.0, 4.0):
        table["fig3a"][a] = theorem1_probability(a)
        print(f"  alpha={a:4.2f}: P = {table['fig3a'][a]:.3f}")
    print("  (modest per-pair edge -> cardinality amplifies it, Fig 3b)\n")

    rng = np.random.default_rng(0)
    print("Fig 3b — cardinality effect (same norm profile, smaller N):")
    table["fig3b"] = {}
    for rate in (0.02, 0.1, 1.0):
        m = int(n * rate)
        sub = items[rng.choice(n, m, replace=False)]
        g = exact_topk(q, torch.as_tensor(sub, device=dev), k=10)[1].cpu().numpy()
        table["fig3b"][m] = top_group_share(g, np.linalg.norm(sub, axis=1), 5.0)
        print(f"  N={m:6d}: top-5% share {table['fig3b'][m]:.1%}")
    print()

    print("building ip-NSW for Fig 4/5 ...")
    idx = IpNSW(max_degree=16, ef_construction=32, insert_batch=512, device=dev).build(items)
    ind = in_degrees(idx.graph)
    groups = norm_group_of(norms, 20)
    top5 = ind[groups == 0].mean()
    table["fig4_top5_in_degree_ratio"] = float(top5 / ind.mean())
    print("Fig 4 — in-degree concentration in the ip-NSW graph:")
    print(f"  top-5%-norm avg in-degree {top5:.1f} = {table['fig4_top5_in_degree_ratio']:.1f}x "
          f"dataset avg (paper: 3.2x-19.8x)\n")

    res = idx.search(q, k=10, ef=64)
    occ = group_occupancy(res.visited.cpu().numpy(), groups, 20)
    table["fig5_top5_eval_share"] = float(occ[0])
    print("Fig 5 — where the walk spends its similarity evaluations:")
    print(f"  top-5%-norm items receive {occ[0]:.1%} of evaluations (paper: 80.7%-100%)")
    return table


if __name__ == "__main__":
    main()
