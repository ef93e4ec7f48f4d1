"""The serving loop's reference numbers: ``serve --loop`` of the JAX package
under the virtual clock, with the batch schedule's digest and the summary's
values in full precision.

  PYTHONPATH=src python tools/serve_loop_reference.py [--storage int8] [--churn-trace 0.2]

The deployment is the serve CLI's loop default: N = 20,000, d = 64,
lognormal norms, IpNSWPlus(max_degree=16, ef_construction=32,
insert_batch=512), 256 requests of ``mips_queries(256, 64, seed=1)`` at
2,000 QPS in three deadline classes (``poisson_trace(seed=2)``), the ladder
``_build_ladder(256, 40)`` and ``LinearServiceModel()``; ``--churn-trace``
adds the CLI's churn trace (capacity 1.25 N, batch 32, seed 3, one hub kill
of 8, four relink passes of ``--relink-budget``).  The JAX package runs its
reference backends (its Pallas kernels need a TPU) and the code of
``repro.launch.serve._run_loop``.  Under the virtual clock p50, p99, QPS,
occupancy, the miss fraction and the schedule are the service model's, a
pure function of the trace, so the port's ``serve --loop`` must print the
same values (``chip_smoke.py`` holds it to them); recall is the index's.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np

N, D, B, K, EF, REQUESTS, RATE = 20_000, 64, 256, 10, 40, 256, 2000.0


def schedule_digest(batches) -> str:
    """sha256 of the batch schedule, (dispatch_t, bucket, rids, ef_served)
    per batch with the times in ``repr``: the definition of
    ``repro_torch.launch.serve_loop.schedule_digest``, kept here so that
    this script imports only the JAX package."""
    h = hashlib.sha256()
    for b in batches:
        h.update(repr((float(b.dispatch_t), int(b.bucket.batch), int(b.bucket.ef),
                       tuple(int(r) for r in b.rids), int(b.ef_served))).encode())
    return h.hexdigest()


def _jax_run(storage: str, churn_frac: float, relink_budget: int) -> dict:
    import jax.numpy as jnp

    from repro.core import IpNSWPlus, exact_topk, recall_at_k
    from repro.data import mips_dataset, mips_queries
    from repro.launch import serve_loop as sl
    from repro.launch.serve import _build_ladder

    items = jnp.asarray(mips_dataset(N, D, "lognormal", seed=0))
    index = IpNSWPlus(max_degree=16, ef_construction=32, insert_batch=512,
                      storage=storage).build(items)
    queries = mips_queries(REQUESTS, D, seed=1)
    _, gt = exact_topk(jnp.asarray(queries), items, k=K)
    ladder = _build_ladder(B, EF)
    trace = sl.poisson_trace(queries, rate_qps=RATE, seed=2, ef=EF,
                             classes=("interactive", "standard", "relaxed"))
    churn = None
    if churn_frac > 0:
        from repro.core import ChurnTrace, MutableIndex

        index = MutableIndex(index, capacity=int(N * 1.25))
        dur = max(r.arrival_t for r in trace) + 1e-3
        churn = ChurnTrace.generate(
            n_items=N, dim=D, duration_s=dur, turnover=churn_frac, batch=32, seed=3,
            profile="lognormal", hub_kill_at=dur / 2, hub_kill_k=8,
            relink_every=dur / 4 if relink_budget else None, relink_budget=relink_budget)
    loop = sl.ServeLoop(index, ladder=ladder, clock=sl.VirtualClock(), k=K,
                        service_model=sl.LinearServiceModel())
    stats = loop.run(trace, churn=churn)
    by_rid = sorted(stats.responses, key=lambda r: r.rid)
    rec = recall_at_k(np.stack([r.ids for r in by_rid]), np.asarray(gt))
    return {"recall": rec, "summary": stats.summary(), "batches": stats.batches}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--storage", default="f32", choices=["f32", "int8"])
    ap.add_argument("--churn-trace", type=float, default=0.0)
    ap.add_argument("--relink-budget", type=int, default=64)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    res = _jax_run(args.storage, args.churn_trace, args.relink_budget)
    s = res["summary"]
    keys = ["p50_ms", "p99_ms", "qps", "occupancy", "deadline_miss_frac", "served",
            "batches", "recompiles_warmup", "recompiles_steady", "mutation_events",
            "rejected"] + sorted(k for k in s if k.startswith("health_"))
    out = {"storage": args.storage,
           "churn_trace": args.churn_trace, "recall": res["recall"],
           "schedule_sha256": schedule_digest(res["batches"]),
           **{k: s[k] for k in keys}}
    print(json.dumps(out))
    print(f"seconds={time.perf_counter() - t0:.1f}")
    return out


if __name__ == "__main__":
    main()
