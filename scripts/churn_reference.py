"""Recall of a mutable ip-NSW+ index under the serve CLI's churn deployment,
measured with the JAX package (the reference) or with the PyTorch port.

  PYTHONPATH=src python scripts/churn_reference.py                  # JAX, CPU
  PYTHONPATH=src python scripts/churn_reference.py --package torch --device cpu

The deployment is ``repro.launch.serve --loop --churn-trace 0.2
--relink-budget 64`` at the CLI's defaults, with the events applied in order
and the 256 queries searched after the trace: N = 20,000, d = 64, lognormal
norms, IpNSWPlus(max_degree=16, ef_construction=32, insert_batch=512),
``MutableIndex(capacity=1.25 N, mutation_batch=32)``,
``ChurnTrace.generate(batch=32, seed=3, hub_kill_at=dur/2, hub_kill_k=8,
relink_every=dur/4, relink_budget=64)`` over ``dur = 1``; search k = 10,
ef = 40.  The JAX package runs its reference backends (its Pallas kernels
need a TPU).  Prints recall@10 against exact MIPS over the live catalog
before the trace, after it and after relinking to zero debt, and the recall
of a fresh rebuild of the compacted live catalog.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

N, D, B, K, EF = 20_000, 64, 256, 10, 40
TURNOVER, DUR = 0.2, 1.0
PARAMS = dict(max_degree=16, ef_construction=32, insert_batch=512)


def recall(ids, items, live, queries) -> float:
    """recall@K of ``ids`` against the exact top K over the live rows."""
    s = queries @ items.T
    s = np.where(live[None, : items.shape[0]], s, -np.inf)
    gt = np.argsort(-s, axis=1, kind="stable")[:, :K]
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
        from repro.core import ChurnTrace, IpNSWPlus, MutableIndex, apply_churn_event
        from repro.data import mips_dataset, mips_queries

        make = lambda: IpNSWPlus(backend="reference", commit_backend="reference",  # noqa: E731
                                 **PARAMS)
        put = jnp.asarray
    else:
        import torch
        from repro_torch.core import ChurnTrace, IpNSWPlus, MutableIndex, apply_churn_event
        from repro_torch.data import mips_dataset, mips_queries

        make = lambda: IpNSWPlus(device=args.device, **PARAMS)  # noqa: E731
        put = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=args.device)  # noqa: E731
    host = lambda t: t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)  # noqa: E731

    items = mips_dataset(N, D, "lognormal", seed=0).astype(np.float32)
    queries = mips_queries(B, D, seed=1)
    t0 = time.perf_counter()
    m = MutableIndex(make().build(put(items)), capacity=int(N * 1.25), mutation_batch=32)
    trace = ChurnTrace.generate(n_items=N, dim=D, duration_s=DUR, turnover=TURNOVER, batch=32,
                                seed=3, profile="lognormal", hub_kill_at=DUR / 2,
                                hub_kill_k=8, relink_every=DUR / 4, relink_budget=64)

    def measure(storage="f32"):
        r = m.search(put(queries), k=K, ef=EF, storage=storage)
        return recall(host(r.ids), host(m.graph.items), m._live_host, queries)

    out = {"before": measure()}
    for ev in trace.events:
        apply_churn_event(m, ev)
    out["after_trace"] = measure()
    errs = m.check_invariants()
    passes = 0
    while m.relink_debt():
        m.relink(64)
        passes += 1
    out["after_relink"] = measure()
    out["after_relink_int8"] = measure("int8")
    live_ids = m.live_ids()
    compact = host(m.graph.items)[live_ids]
    fresh = make().build(put(compact))
    r = fresh.search(put(queries), k=K, ef=EF)
    out["fresh_rebuild"] = recall(host(r.ids), compact, np.ones(len(compact), bool), queries)
    print(f"[churn_reference] package={args.package} N={N} d={D} turnover={TURNOVER} "
          f"events={trace.n_events} relink_passes_to_zero_debt={passes} "
          f"invariant_errors={len(errs)} seconds={time.perf_counter() - t0:.1f}")
    print("[churn_reference] recall@10 " + " ".join(f"{k}={v:.4f}" for k, v in out.items()))
    return out


if __name__ == "__main__":
    main()
