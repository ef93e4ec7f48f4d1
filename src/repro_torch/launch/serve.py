"""MIPS serving launcher: build an index over a seeded synthetic catalog,
then answer one timed batch of queries (one-shot mode) or a Poisson request
trace through the continuous-batching loop (``--loop``), and report
recall@k against the exact scan.

  PYTHONPATH=src python -m repro_torch.launch.serve --index ipnsw_plus \\
      --n-items 20000 --dim 64 --batch 256 --ef 40 [--storage int8]
  PYTHONPATH=src python -m repro_torch.launch.serve --loop [--clock wall] \\
      [--rate 2000] [--requests 256] [--churn-trace 0.2] [--relink-budget 64]

The defaults are the JAX package's (``python -m repro.launch.serve``); the
index is ``IpNSW`` / ``IpNSWPlus(max_degree=16, ef_construction=32,
insert_batch=512)`` or the exact scan.  ``--storage int8`` searches the int8
store (quantized walk, exact fp32 rerank; the build stays fp32); the exact
scan ignores it, as the JAX CLI does.  ``--build-backend scan`` builds every
index with the scan driver (``core/build.py``: on the card one insertion
batch captured as a CUDA graph and replayed).  ``--device`` defaults to the
card.

``--loop`` schedules ``--requests`` queries arriving at ``--rate`` QPS in
three deadline classes through ``launch/serve_loop.py`` on the ladder
``_build_ladder(--batch, --ef)``, with the virtual clock (the
``LinearServiceModel``'s latencies, a pure function of the trace) or the
wall clock, and prints the JAX CLI's loop line without its XLA compile
count.  ``--churn-trace FRAC`` opens the index as a ``MutableIndex``
(capacity 1.25 N) and replays the JAX CLI's churn trace between dispatches;
recall is still measured against the catalog as it was before the churn.
A build of a ladder bucket in steady state exits non-zero.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.brute_force import exact_topk
from repro_torch.core.build import BUILD_BACKENDS
from repro_torch.core.ipnsw import IpNSW
from repro_torch.core.ipnsw_plus import IpNSWPlus
from repro_torch.core.storage import STORAGE_BACKENDS
from repro_torch.data import mips_dataset, mips_queries
from repro_torch.launch import serve_loop as sl
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
    ap.add_argument("--build-backend", default="host", choices=BUILD_BACKENDS,
                    help="insertion driver (build.BUILD_BACKENDS)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--loop", action="store_true",
                    help="continuous-batching serving loop instead of the one-shot "
                         "timed batch (launch/serve_loop.py)")
    ap.add_argument("--clock", default="virtual", choices=["virtual", "wall"],
                    help="loop mode time source: simulated time or real time")
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="loop mode Poisson arrival rate (QPS)")
    ap.add_argument("--requests", type=int, default=256, help="loop mode trace length")
    ap.add_argument("--churn-trace", type=float, default=0.0, metavar="FRAC",
                    help="loop mode: open the index as a MutableIndex and replay a seeded "
                         "churn trace turning over FRAC of the catalog between dispatches")
    ap.add_argument("--relink-budget", type=int, default=64,
                    help="nodes repaired per relink pass of the churn trace (0: none)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    items = torch.as_tensor(mips_dataset(args.n_items, args.dim, args.profile, seed=0),
                            device=device)
    if args.loop:
        if args.index == "bruteforce":
            raise SystemExit("--loop serves ipnsw / ipnsw_plus; pick a graph index")
        return _run_loop(args, items)
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
                    build_backend=args.build_backend, storage=args.storage,
                    device=args.device).build(items)
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


def _build_ladder(batch: int, ef: int) -> sl.BucketLadder:
    """A small ladder bracketing the CLI's (batch, ef): quarter and full batch
    rungs, quarter / half / full ef rungs (deduplicated, floored at 8)."""
    batches = tuple(sorted({max(1, batch // 4), batch}))
    efs = tuple(sorted({max(8, ef // 4), max(8, ef // 2), ef}))
    return sl.BucketLadder(batches=batches, efs=efs)


def _run_loop(args, items: torch.Tensor) -> dict:
    cls = IpNSWPlus if args.index == "ipnsw_plus" else IpNSW
    index = cls(max_degree=16, ef_construction=32, insert_batch=512,
                build_backend=args.build_backend, storage=args.storage,
                device=args.device).build(items)

    queries = mips_queries(args.requests, args.dim, seed=1)
    _, gt = exact_topk(torch.as_tensor(queries, device=items.device), items, k=args.k)
    gt = gt.cpu().numpy()

    ladder = _build_ladder(args.batch, args.ef)
    trace = sl.poisson_trace(queries, rate_qps=args.rate, seed=2, ef=args.ef,
                             classes=("interactive", "standard", "relaxed"))
    churn = None
    if args.churn_trace > 0:
        from repro_torch.core.mutation import ChurnTrace, MutableIndex

        index = MutableIndex(index, capacity=int(args.n_items * 1.25))
        dur = max(r.arrival_t for r in trace) + 1e-3
        churn = ChurnTrace.generate(
            n_items=args.n_items, dim=args.dim, duration_s=dur, turnover=args.churn_trace,
            batch=32, seed=3, profile=args.profile, hub_kill_at=dur / 2, hub_kill_k=8,
            relink_every=dur / 4 if args.relink_budget else None,
            relink_budget=args.relink_budget,
        )

    clock = sl.VirtualClock() if args.clock == "virtual" else sl.WallClock()
    loop = sl.ServeLoop(index, ladder=ladder, clock=clock, k=args.k,
                        service_model=sl.LinearServiceModel())
    stats = loop.run(trace, churn=churn)

    by_rid = sorted(stats.responses, key=lambda r: r.rid)
    rec = recall_at_k(np.stack([r.ids for r in by_rid]), gt)
    s = stats.summary()
    print(f"[serve --loop] index={args.index} storage={args.storage} "
          f"clock={args.clock} N={args.n_items} rate={args.rate:.0f}qps "
          f"requests={args.requests} "
          f"ladder={'/'.join(f'{b.batch}x{b.ef}' for b in ladder.buckets())}: "
          f"recall@{args.k}={rec:.3f} p50={s['p50_ms']:.2f}ms "
          f"p99={s['p99_ms']:.2f}ms qps={s['qps']:.0f} "
          f"occupancy={s['occupancy']:.2f} "
          f"miss_frac={s['deadline_miss_frac']:.3f} "
          f"recompiles(warmup/steady)={s['recompiles_warmup']}"
          f"/{s['recompiles_steady']} device={items.device}")
    if churn is not None:
        print(f"[serve --loop] churn: events={s['mutation_events']} "
              f"rejected={s['rejected']} "
              f"live_frac={s['health_live_fraction']:.3f} "
              f"dead_edge_frac={s['health_dead_edge_frac']:.3f} "
              f"relink_debt={s['health_relink_debt']:.0f}")
    if s["recompiles_steady"]:
        raise SystemExit(f"bucket-ladder regression: {s['recompiles_steady']} "
                         "steady-state program builds (expected 0)")
    return {"recall": rec, "summary": s, "batches": stats.batches}


if __name__ == "__main__":
    main()
