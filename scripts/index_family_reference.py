"""Recall@10 of the rest of the index family -- HierarchicalIpNSW,
NormFilteredIndex and SimpleLSH -- at the serve CLI's default catalog,
measured with the JAX package (the reference) or with the PyTorch port.

  PYTHONPATH=src python scripts/index_family_reference.py                  # JAX, CPU
  PYTHONPATH=src python scripts/index_family_reference.py --package torch --device cpu
  PYTHONPATH=src python scripts/index_family_reference.py --lsh-seeds 10   # and --package torch

The serve default: N = 20,000, d = 64, lognormal norms
(``mips_dataset(..., seed=0)``), 256 queries (``mips_queries(..., seed=1)``),
k = 10, ef = 40, ground truth by exact MIPS; the serve CLI's build knobs
(max_degree 16, ef_construction 32, insert_batch 512).  Each class is built
once with ``storage="int8"`` and searched with the f32 items and the int8
store: ``HierarchicalIpNSW`` (level seed 0), ``NormFilteredIndex(keep_frac
=0.25, plus=True)`` and ``SimpleLSH(n_bits=96)`` (the width of
``benchmarks/fig7_recall_time.py``) at T = 100 and 800 candidates.  The JAX
package runs its reference backends.  Also printed: the norm filter's
bound ``top_group_share(gt, norms, 25.0)`` and the hierarchy's level sizes.
With ``--lsh-seeds S``, only SimpleLSH runs, once for each plane seed 0 ..
S-1: the spread of its recall over the random planes.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

N, D, B, K, EF = 20_000, 64, 256, 10, 40
PARAMS = dict(max_degree=16, ef_construction=32, insert_batch=512)
LSH_BITS, LSH_CANDIDATES = 96, (100, 800)


def recall(ids, gt) -> float:
    ids = np.asarray(ids)
    return float(np.mean([len(set(ids[i][ids[i] >= 0]) & set(gt[i])) / K
                          for i in range(len(gt))]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=["jax", "torch"], default="jax")
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--lsh-seeds", type=int, default=0,
                    help="only SimpleLSH, for plane seeds 0 .. S-1")
    args = ap.parse_args(argv)
    if args.package == "jax":
        import jax.numpy as jnp
        from repro.core import HierarchicalIpNSW, NormFilteredIndex, SimpleLSH
        from repro.core.norms import top_group_share
        from repro.data import mips_dataset, mips_queries

        knobs = dict(backend="reference", commit_backend="reference", **PARAMS)
        put = jnp.asarray
        lsh_knobs = {}
    else:
        import torch
        from repro_torch.core import HierarchicalIpNSW, NormFilteredIndex, SimpleLSH
        from repro_torch.core.norms import top_group_share
        from repro_torch.data import mips_dataset, mips_queries

        knobs = dict(device=args.device, **PARAMS)
        put = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=args.device)  # noqa: E731
        lsh_knobs = dict(device=args.device)
    host = lambda t: t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)  # noqa: E731

    items = mips_dataset(N, D, "lognormal", seed=0).astype(np.float32)
    queries = mips_queries(B, D, seed=1).astype(np.float32)
    gt = np.argsort(-(queries.astype(np.float64) @ items.astype(np.float64).T), axis=1,
                    kind="stable")[:, :K]
    out, seconds = {}, {}
    if args.lsh_seeds:
        for seed in range(args.lsh_seeds):
            lsh = SimpleLSH(n_bits=LSH_BITS, seed=seed, **lsh_knobs).build(put(items))
            for t in LSH_CANDIDATES:
                out[f"lsh_t{t}"] = out.get(f"lsh_t{t}", []) + [
                    recall(host(lsh.search(put(queries), k=K, n_candidates=t).ids), gt)]
        for name, recalls in out.items():
            print(f"[index_family_reference] package={args.package} {name} plane seeds "
                  f"0-{args.lsh_seeds - 1}: recall@10 mean={np.mean(recalls)!r} "
                  f"std={np.std(recalls, ddof=1)!r} min={min(recalls)!r} max={max(recalls)!r} "
                  f"all={recalls!r}")
        return out

    t0 = time.perf_counter()
    hnsw = HierarchicalIpNSW(storage="int8", **knobs).build(put(items))
    seconds["hnsw"] = time.perf_counter() - t0
    sizes = [int(g.size) for g in hnsw.levels]
    for storage in ("f32", "int8"):
        out[f"hnsw_{storage}"] = recall(
            host(hnsw.search(put(queries), k=K, ef=EF, storage=storage).ids), gt)

    t0 = time.perf_counter()
    nf = NormFilteredIndex(keep_frac=0.25, plus=True, storage="int8", **knobs).build(put(items))
    seconds["norm_filter"] = time.perf_counter() - t0
    for storage in ("f32", "int8"):
        out[f"norm_filter_{storage}"] = recall(
            host(nf.search(put(queries), k=K, ef=EF, storage=storage).ids), gt)
    bound = top_group_share(gt, np.linalg.norm(items, axis=1), 25.0)

    t0 = time.perf_counter()
    lsh = SimpleLSH(n_bits=LSH_BITS, **lsh_knobs).build(put(items))
    seconds["lsh"] = time.perf_counter() - t0
    for t in LSH_CANDIDATES:
        out[f"lsh_t{t}"] = recall(host(lsh.search(put(queries), k=K, n_candidates=t).ids), gt)

    print(f"[index_family_reference] package={args.package} N={N} d={D} B={B} ef={EF} "
          f"hnsw_levels={sizes} norm_filter_bound={bound!r} build_seconds="
          + ",".join(f"{k}:{v:.1f}" for k, v in seconds.items()))
    print("[index_family_reference] recall@10 "
          + " ".join(f"{k}={v!r}" for k, v in out.items()))
    return out


if __name__ == "__main__":
    main()
