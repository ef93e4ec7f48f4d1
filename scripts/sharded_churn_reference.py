"""Recall of a norm-banded ``ShardedMutable`` under the JAX package's
banded-churn scenario (``tests/test_mutation.py::
test_sharded_banded_churn_keeps_invariants_and_recall``) scaled to the serve
CLI's default catalog, measured with the JAX package (the reference) or
with the PyTorch port.

  PYTHONPATH=src python scripts/sharded_churn_reference.py                  # JAX, CPU
  PYTHONPATH=src python scripts/sharded_churn_reference.py --package torch --device cpu

The test's scenario at 256 items, P = 4, Nloc = headroom = 64, scaled by
N / 256: N = 20,000, d = 64, lognormal norms (``mips_dataset(..., seed=0)``),
``ShardedMutable(P=4, plus=False, headroom=Nloc, mutation_batch=16)`` over
``IpNSW(max_degree=16, ef_construction=32, insert_batch=512)``; delete
80 / 256 of the catalog (``default_rng(3)``), upsert 96 / 256 of it
(``mips_dataset(..., seed=8)``, its first 1 / 24 scaled by 10: norm
outliers that widen band 0), kill every hub of band 0, relink with budget
64 until no debt is left.  256 queries (``mips_queries(..., seed=77)``),
k = 10, ef = 64, the routed oracle (``sharded_search_reference(route=
"upper_bound")``).  Prints recall@10 against exact MIPS over the live
catalog before the churn, after relinking, and of a fresh banded rebuild
of the live catalog.  The JAX package runs its reference backends.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

N, D, P, K, EF, B = 20_000, 64, 4, 10, 64, 256
PARAMS = dict(max_degree=16, ef_construction=32, insert_batch=512)


def recall(ids, gt) -> float:
    ids = np.asarray(ids)
    return float(np.mean([len(set(ids[i][ids[i] >= 0]) & set(gt[i])) / K
                          for i in range(len(gt))]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=["jax", "torch"], default="jax")
    ap.add_argument("--device", default="cpu", help="the port's device")
    args = ap.parse_args(argv)
    if args.package == "jax":
        import jax.numpy as jnp
        from repro.core.distributed import ShardedMutable, build_sharded, sharded_search_reference
        from repro.data import mips_dataset, mips_queries

        knobs = dict(backend="reference", commit_backend="reference", **PARAMS)
        put = jnp.asarray
    else:
        import torch
        from repro_torch.core.distributed import (
            ShardedMutable,
            build_sharded,
            sharded_search_reference,
        )
        from repro_torch.data import mips_dataset, mips_queries

        knobs = dict(device=args.device, **PARAMS)
        put = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=args.device)  # noqa: E731
    host = lambda t: t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)  # noqa: E731

    items = mips_dataset(N, D, "lognormal", seed=0)
    queries = mips_queries(B, D, seed=77)
    common = dict(k=K, ef=EF, plus=False, route="upper_bound")

    def live_recall(sm) -> float:
        gids, live_items = sm.live_items()
        rows = np.argsort(-(queries @ live_items.T), axis=1, kind="stable")[:, :K]
        ids = sharded_search_reference(sm.snapshot(), put(queries), **common)[0]
        return recall(host(ids), gids[rows])

    t0 = time.perf_counter()
    sm = ShardedMutable(items, P, plus=False, headroom=-(-N // P), **knobs)
    out = {"before": live_recall(sm)}
    rng = np.random.default_rng(3)
    sm.delete(rng.choice(sm.live_gids(), size=N * 80 // 256, replace=False))
    fresh = mips_dataset(N * 96 // 256, D, "lognormal", seed=8).copy()
    fresh[: len(fresh) // 24] *= 10.0
    sm.upsert(fresh)
    killed = sm.kill_hubs(0, k=sm.capacity)
    passes = 0
    while sm.relink_debt():
        sm.relink(64)
        passes += 1
    errs = sm.check_invariants()
    out["after_relink"] = live_recall(sm)
    gids, live_items = sm.live_items()
    rebuilt = build_sharded(put(live_items), P, plus=False, partition="norm_bands", **knobs)
    rows = np.argsort(-(queries @ live_items.T), axis=1, kind="stable")[:, :K]
    out["fresh_rebuild"] = recall(
        host(sharded_search_reference(rebuilt, put(queries), **common)[0]), rows)
    print(f"[sharded_churn_reference] package={args.package} N={N} d={D} P={P} "
          f"killed={len(killed)} relink_passes_to_zero_debt={passes} "
          f"invariant_errors={len(errs)} seconds={time.perf_counter() - t0:.1f}")
    print("[sharded_churn_reference] recall@10 "
          + " ".join(f"{k}={v!r}" for k, v in out.items()))
    return out


if __name__ == "__main__":
    main()
