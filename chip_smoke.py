#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

  python3 chip_smoke.py

Phases (each one that fails ends the run with a non-zero exit):
  1. environment: torch / CUDA versions, the card's name and power limit;
     TF32 off for matrix products and convolutions.
  2. build: every CUDA source of src/repro_torch/csrc with nvcc.
  3. each kernel and int8 variant against its plain PyTorch version on the
     card, at the main path's shapes, on integer-valued inputs (queries,
     items and codes integer, scales powers of two: every fp32 dot product
     is exact, so ids, scores and flags must be bit-identical, ties
     included) and on float inputs (scores within rtol=1e-5, atol=1e-6; ids
     identical except at near-ties).  ``ms``, ``plain_ms`` and
     ``library_ms`` are device time per call (torch.profiler), beside
     ``bound_ms``, the least time the card could take for the same work;
     ``call_ms`` is the time a caller waits per back-to-back wrapper call
     (CUDA events).  beam_step also runs with a tombstone mask over about
     half the items (its live variants): n_dead must equal the plain
     version's exactly.  quant_score and gather_score are also held bit for
     bit, on every input, to the witness (the previous one-warp-a-row
     kernel of each, launched only here), at their shapes and at their
     edges (SCORER_EDGES: B 1, W 1, a ragged W 33 with a row all -1, d 37
     and d 512), and timed in turns with it.  topk_merge runs at the walk's merge shapes, at
     a throughput cell of 65,536 rows and at the ef-400 pool (C = 416: the
     kernel's rank route), a pure selection: bit-identical on integer and
     float inputs, +-0 pairs and -inf / -1 slots included, each cell beside
     an empty kernel's device time on the same grid (the launch floor);
     flash_attn at granite-3-2b's attention and gemma3-12b's local layer
     (S = T = 4096, and one q_offset case), fp32 within rtol = atol = 2e-5,
     with the fp32 kernel's registers and spills (ptxas) and its FFMAs per
     shared-memory read in the SASS; bf16 within 2**-7 |plain| + 0.04 spread
     of the plain version in bf16 (spread = sqrt(sum p^2 v^2), the size of
     the weighted sum), and within 2**-8 |plain| + 0.015 spread of the plain
     version in fp32 on the same bf16 values, with p's bf16 rounding showing
     (FLASH_TOL); scaled_dot_product_attention as library_ms.  Both kernels
     are also held to those limits at the edges (FLASH_EDGE_SHAPES: ragged S
     and T, hd 32 and 256 with q_offset, rows with no key in their window,
     which must be 0), and mips_topk at its
     own (MIPS_EDGE_SHAPES: a ragged query tile, k = 1 and 32, a depth not a
     multiple of 4), at the full-size loop's ground truth (4,096 queries)
     and past k = 32 (MIPS_WIDE_SHAPES, the select route: k = 33, 100 and
     1,000 at full size, k = N at N = 5,000, each timed with its select
     kernels' sum, library_ms, bound and candidates per row; and
     MIPS_TIED_SHAPES, every score of a query tied, so each row overflows
     its candidate buffer and is selected from its scores).  commit_merge
     also runs one whole commit (pre-pass and kernel) per cell under
     torch.cuda.set_sync_debug_mode("error"): no read-back from the card.
     A "roofline" line gives each
     redesigned kernel's TFLOP/s, share of its bound and ms over
     library_ms; phase 2 counts the tensor-core instructions of the bf16
     kernel's SASS (cuobjdump).  beam_walk, the whole walk in one launch,
     runs in every variant (f32, int8, each with and without a tombstone
     mask) at the main path's walks (WALK_SHAPES), at pad rows born done,
     a max_steps cut, a walk that ends before max_steps (WALK_LONG), an
     ef of 400 whose visited rows stay in device memory (WALK_LARGE_V) and
     a width of 37 (scalar loads), on integer and float inputs: every output (pool, visited, evals, dead
     evals, per-row and global steps) bit-identical to the host loop of the
     beam_step kernel, and to beam_walk_ref on integer inputs (float: the
     tolerance contract); at the search IP walk ``ms`` beside the per-step
     loop's device and call time.  Then the entry points without a system
     caller (topk_merge, flash_attn, the per-step beam_step, mips_topk's
     int8 select route) are driven once: their launches in the kernels
     line are those.
  4. serve default: the port's launch/serve.py one-shot, --index
     ipnsw_plus, at the JAX package's defaults, with --storage f32 and with
     --storage int8; recall@10 within 0.02 of the JAX package's recall for
     the same command; and with --k 33 (mips_topk's select route).  Every
     system path from here on walks with beam_walk and launches no
     per-step beam_step kernel.
  4b. serve default + churn: the serve default's index, built again and
     opened as a MutableIndex (capacity 1.25 N, mutation_batch 32), takes
     the JAX serve CLI's churn trace (turnover 0.2, one hub kill of 8, four
     relink passes of 64), with a search between events; I1-I6 hold, no
     tombstone surfaces (f32 and int8), recall@10 within 0.02 of the JAX
     package's on the same trace and, after relinking to zero debt, at
     least a fresh rebuild's - 0.02.  The first upsert chunk is captured as
     a CUDA graph and every later one replays it, each under
     set_sync_debug_mode("error"); the first int8 search makes the int8
     stores, and the next upsert captures its chunk again over them (123
     replays of 125 chunks).
  4c. serve default through the serving loop: serve --loop (virtual clock),
     with --storage int8 and with --churn-trace 0.2; the batch schedule's
     digest, p50 / p99 / QPS / occupancy / miss fraction (the service
     model's) and the churn events and health equal to the JAX package's,
     recall@10 within 0.02 of it, no steady-state build, no rejection.
     Every dispatch after warmup is a replay of its bucket's CUDA graph
     (16), and under churn every upsert chunk after the first (124 more),
     each under sync debug mode "error".

From phase 4b on, a kernel's launches count each replay of a CUDA graph
that holds it (the wrapper calls made while a graph was captured launch
nothing then, and are not counted): ``count_graph_launches``.
  5. full size: IpNSWPlus and IpNSW at Yahoo!Music's size (136,736 x 300,
     seeded synthetic lognormal items), ground truth from the mips_topk
     kernel; each index searched with the f32 items and the int8 store, and
     the int8 store's quantized scan; build seconds, search time, QPS,
     recall@10, evals, peak memory, graph invariants I1-I4; every search
     again with per-step walks (the host loop of the beam_step kernel, as
     the port walked before beam_walk): every output equal; IpNSW's f32 and
     int8 searches timed both ways in turns; then a profiled IpNSW build,
     f32 search and int8 search, each with per-step walks and with
     beam_walk: device busy time, idle share, walk steps, host time per
     step; and IpNSW's and IpNSWPlus's builds profiled with the host and
     the scan driver (host time per batch; each graph's walk kernel must
     show once a batch in the trace, replayed or not); and IpNSW's search
     of 256 at ef 40 (f32 and int8) as a captured 256 x 40 bucket, its ids
     equal to the search's, profiled.
  5c. scan build driver (build_backend="scan"), inside phase 5: IpNSWPlus
     and IpNSW built again at full size with one insertion batch captured
     as a CUDA graph and replayed over the schedule (266 replays, each
     counted through CUDAGraph.replay and run under
     set_sync_debug_mode("error"), so no sync in the replay loop); every
     graph's adjacency, size, entry and entry_norm bit-identical to the
     host driver's, each search's ids equal; both drivers timed in turns
     (build s; capture ms, host ms per replay and the replay loop's device
     ms by CUDA events).  Phase 4 also serves with --build-backend scan
     (f32 and int8): recall equal to the host driver's run.
  5b. full-size serving loop: an IpNSWPlus at Yahoo!Music's size serves
     4,096 Poisson requests at 2,000 QPS in three deadline classes on the
     ladder (64, 256) x (10, 20, 40), under the wall clock with the f32 and
     the int8 store and under the virtual clock: p50 / p99 latency, QPS,
     occupancy, miss fraction, degraded share, recall@10, steady builds (0),
     peak memory, launches; a request served at the same ef in the wall and
     the virtual run gets the same ids.  Each bucket is one CUDA graph,
     captured at warmup (capture ms a bucket): every dispatch of a run is a
     replay, under sync debug mode "error", and a replay's ids, score bits
     and evals equal the eager program's (the module-level _plus_bucket on
     the same buffers) bit for bit, in every bucket, f32 and int8, with pad
     rows; peak memory with the graphs and with eager dispatches; a
     profiled 256 x 40 dispatch three ways: eager with per-step walks,
     eager, captured.
  6. full size + churn: a mutable IpNSWPlus at Yahoo!Music's size
     (capacity 170,920) takes a churn trace of turnover 0.1 (427 upsert and
     427 delete batches of 32, one hub kill, four relink passes); ms per
     upsert batch, delete batch and relink pass, search ms with and without
     the tombstone mask on the same index, dead evals per query, recall@10
     before and after the trace and after relinking, health counters, peak
     memory, launches, and one profiled upsert batch eager and captured.
     Every upsert chunk after the first replays its CUDA graph (426
     replays, under sync debug mode "error").  Before the trace, two copies
     of the index (with int8 stores) take the trace's first 64 events, one
     with captured upserts and one eager (``eager_upserts``): both graphs,
     both stores, the live mask, the norms and every entry bit-identical;
     ms per upsert batch both ways.  After it, a bucket ladder over the
     mutable index: a replayed dispatch with the tombstone mask equal to
     the eager program's bit for bit.
The line before the last is the JSON list of kernels; the last line is the
JSON result the run is read by.
"""
from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# `PYTHONPATH=src python -m repro.launch.serve` (the JAX package, on the CPU)
# printed: [serve] index=ipnsw_plus shards=1 storage=f32 N=20000 B=256 ef=40:
# recall@10=0.933 evals/q=540 (0.74 ms/query batch-amortized) xla_compiles=891
JAX_SERVE_RECALL = 0.933
# `PYTHONPATH=src python -m repro.launch.serve --storage int8` (CPU) printed:
# [serve] index=ipnsw_plus shards=1 storage=int8 N=20000 B=256 ef=40:
# recall@10=0.935 evals/q=540 (0.44 ms/query batch-amortized) xla_compiles=970
JAX_SERVE_RECALL_INT8 = 0.935
# `PYTHONPATH=src python scripts/churn_reference.py` (the JAX package, on the
# CPU) printed: recall@10 before=0.9332 after_trace=0.9258 after_relink=0.9258
# after_relink_int8=0.9262 fresh_rebuild=0.9352 (the trace left no relink debt)
JAX_CHURN_RECALL = 0.9258
RECALL_MARGIN = 0.02
# `PYTHONPATH=src python -m repro.launch.serve --loop [--storage int8 |
# --churn-trace 0.2]` (the JAX package, on the CPU) printed for f32:
# [serve --loop] index=ipnsw_plus storage=f32 clock=virtual N=20000 rate=2000qps
# requests=256 ladder=64x10/64x20/64x40/256x10/256x20/256x40: recall@10=0.933
# p50=7.73ms p99=12.47ms qps=2051 occupancy=0.25 miss_frac=0.000
# recompiles(warmup/steady)=6/0 xla_compiles=1587
# and, with the churn trace, `churn: events=255 rejected=0 live_frac=1.000
# dead_edge_frac=0.000 relink_debt=0`.  The unrounded values and the digest of
# the batch schedule come from `PYTHONPATH=src python
# tools/serve_loop_reference.py [--storage int8 | --churn-trace 0.2]` (the same
# runs).  Under the virtual clock the schedule and the latencies are the
# LinearServiceModel's, a pure function of the trace: the port must print
# them exactly; recall@10 is the index's (the churn run's ground truth is the
# catalog before the churn, as in the JAX CLI).
JAX_LOOP_RECALL = {"f32": 0.9332031250000001, "int8": 0.934765625, "churn": 0.776953125}
JAX_LOOP_SUMMARY = {"p50_ms": 7.728291443464242, "p99_ms": 12.474367708361871,
                    "qps": 2051.2348791342347, "occupancy": 0.25, "deadline_miss_frac": 0.0,
                    "served": 256, "batches": 16, "recompiles_warmup": 6,
                    "recompiles_steady": 0, "rejected": 0}
JAX_LOOP_SCHEDULE_SHA256 = "b9a4f4e5473c23af7c4c8d147eaf15d81cb08e58293bc6c52540013b47aece78"
JAX_LOOP_CHURN = {"mutation_events": 255, "health_live_fraction": 1.000,
                  "health_dead_edge_frac": 0.000, "health_relink_debt": 0.0}  # as printed

PROFILER_SESSIONS = 8      # sessions device_ms tries before it gives up
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_FLOP_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12   # H100 SXM dense bf16 on the tensor cores

N_FULL, D_FULL = 136_736, 300  # Yahoo!Music (paper §5 dataset table)
# the full-size loop: 4,096 queries at 2,000 QPS on _build_ladder(256, 40)
LOOP_FULL_REQUESTS, LOOP_FULL_RATE = 4096, 2000.0
BEAM_SHAPES = {  # walk: (B, L, M, S, V) on the main path, d = 300
    "build_angular": (512, 10, 10, 1, 201),
    "build_ip": (512, 32, 16, 161, 1185),
    "search_angular": (256, 10, 10, 1, 201),
    "search_ip": (256, 40, 16, 160, 1440),
}
# beam_walk: (B, L, M, S, max_steps) of the main path's walks, d = 300; V = S +
# max_steps * M (ef 40 on ip-NSW+: 160 + 80 * 16 = 1,440 visited ids)
WALK_SHAPES = {
    "build_angular": (512, 10, 10, 1, 20),
    "build_ip": (512, 32, 16, 161, 64),
    "search_angular": (256, 10, 10, 1, 20),
    "search_ip": (256, 40, 16, 160, 80),
}
# on a random graph new candidates keep entering the pool, so these walks run
# to max_steps; with 400 steps the search IP walk ends on its own
WALK_LONG = (256, 40, 16, 160, 400)
# ef 400: V = 160 + 800 * 16 = 12,960 ids, past VISITED_SHARED_MAX, so the
# walk scans its visited rows in device memory
WALK_LARGE_V = (64, 400, 16, 160, 800)
COMMIT_SHAPES = {"ip": (512, 16), "angular": (512, 10)}  # (insert batch, M)
# gathered scorers: (B, W) on the main path, d = 300
QUANT_SHAPES = {"seed_ip": (256, 160), "seed_angular": (256, 1)}
GATHER_SHAPES = {"seed_ip": (256, 160), "build_seed_ip": (512, 161), "rerank_ip": (256, 40),
                 "rerank_angular": (256, 10), "build_seed_angular": (512, 1)}
# the scorers' edges, checked only: (B, W, d, row 0 all -1) -- one query, one
# slot a query, a ragged last tile with a dead row, the scalar loads (d 37)
# and two rounds of loads (d 512)
SCORER_EDGES = {"b1": (1, 160, D_FULL, False), "w1": (256, 1, D_FULL, False),
                "w33_dead_row": (256, 33, D_FULL, True), "d37": (256, 160, 37, False),
                "d512": (64, 160, 512, True)}
MIPS_SHAPES = {"full": (256, N_FULL, D_FULL, 10), "serve_default": (256, 20_000, 64, 10),
               # the full-size loop's ground truth: 4,096 queries in one call
               "loop_ground_truth": (LOOP_FULL_REQUESTS, N_FULL, D_FULL, 10)}
# mips_topk's edges, checked only: a ragged query tile with k = 1 and with the
# largest k, and a depth that is not a multiple of 4 (the scalar loads)
MIPS_EDGE_SHAPES = {"b100_k1": (100, 20_000, 64, 1), "b100_k32": (100, 20_000, D_FULL, 32),
                    "b100_d37": (100, 5_000, 37, 10)}
# the select route (k > 32) at full size, and k = N at a small N
MIPS_WIDE_SHAPES = {"full_k33": (256, N_FULL, D_FULL, 33), "full_k100": (256, N_FULL, D_FULL, 100),
                    "full_k1000": (256, N_FULL, D_FULL, 1000),
                    "n5000_kN": (100, 5_000, 64, 5_000)}
# the select route where one bin holds every key (all scores of a query tie):
# each row overflows its candidate buffer and is selected from its scores
MIPS_TIED_SHAPES = {"tied_k33": (64, N_FULL, 64, 33)}
# topk_merge at the walk's merge shapes: (B, L, M)
MERGE_SHAPES = {"search_ip": (256, 40, 16), "build_ip": (512, 32, 16),
                "search_angular": (256, 10, 10)}
# topk_merge past the walk's batches: a throughput cell (75.5 MB moved) and
# the ef-400 pool, whose C = 416 takes the kernel's rank route (C > 64)
MERGE_WIDE_SHAPES = {"throughput": (65_536, 40, 16), "ef400_pool": (256, 400, 16)}
# flash_attn at two model widths (src/repro/configs/granite_3_2b.py, the local
# layer of gemma3_12b.py): (B, S, T, H, KV, hd, q_offset, window)
FLASH_SHAPES = {"granite_3_2b": (1, 4096, 4096, 32, 8, 64, 0, None),
                "granite_3_2b_offset": (1, 2048, 4096, 32, 8, 64, 2048, None),
                "gemma3_12b_local": (1, 4096, 4096, 16, 8, 256, 0, 1024)}
# the kernels' edges (tiles past the end, q_offset, hd 32 / 256, rows with no
# key, which must be 0), checked only, fp32 and bf16, under the limits below
FLASH_EDGE_SHAPES = {"ragged_gqa": (2, 1000, 1000, 4, 2, 128, 0, None),
                     "hd32_offset": (1, 300, 700, 4, 2, 32, 400, None),
                     "hd256_offset_window": (1, 300, 700, 4, 2, 256, 400, 100),
                     "fully_masked": (1, 64, 64, 2, 1, 64, 100, 8)}
# flash_attn: |out - plain| <= atol + rtol * |plain| + c * spread, where spread =
# sqrt(sum_t p_t^2 v_t^2) is the size of the weighted sum each output is (a
# relative error e in every weight p_t moves it by about e * spread).  The
# bf16 limits come from the readings phase 3 logs (largest error by |out| bin
# and by row, beside rtol * |out| and over the spread; PERF.md, PR 14).
FLASH_TOL = {"float32": (2e-5, 2e-5, 0.0),   # (rtol, atol, c): the JAX tests' fp32 limit
             "bfloat16": (2**-7, 0.0, 0.04)}  # one ulp of the output's rounding, and the
#   plain version's own rounding of q.k to bf16 before its softmax (largest
#   excess 0.022 spread)
# bf16 held a second time, against the plain version in fp32 on the same bf16
# values: half an ulp for the output's rounding, and the rounding of p to bf16
# (kernel.py:69; largest excess 0.008 spread), which must show somewhere
FLASH_BF16_VS_FP32 = (2**-8, 0.0, 0.015)
FLASH_P_ROUNDED = 1e-4  # least largest excess over the spread: p was rounded to bf16
# the JAX serve CLI's churn deployment (src/repro/launch/serve.py:309-321)
CHURN = dict(batch=32, seed=3, profile="lognormal", duration_s=1.0, hub_kill_at=0.5,
             hub_kill_k=8, relink_every=0.25, relink_budget=64)
RELINK_PASS_CAP = 64  # full size: relink passes after the trace, at most


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` as its caller sees them, by CUDA
    events around back-to-back calls: where the host enqueues slower than
    the card runs, this is host time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, only: str = "", once: bool = False) -> float:
    """Mean device milliseconds per call of ``fn``: the time its kernels
    (those whose name contains ``only``) ran on the card, from
    torch.profiler's device-side events; host gaps are not counted.
    ``once``: ``fn`` launches the one kernel named by ``only`` once a call,
    so its mean over the launches a session recorded is the time a call
    (a session may drop a launch's event)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # A session can come back without device events, or with some of them
    # lost: every kernel that carries a twentieth of the time runs on each
    # call, so each must show at least ``reps`` launches.  (A plain version
    # may launch a small kernel on some calls only: the library's choice.)
    for attempt in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and only in e.key
                   and e.self_device_time_total > 0]
        total = sum(e.self_device_time_total for e in kernels)
        if once and len(kernels) == 1 and kernels[0].count >= reps // 2:
            return total / kernels[0].count / 1e3
        fewest = min((e for e in kernels if e.self_device_time_total >= total / 20),
                     key=lambda e: e.count, default=None)
        if fewest is not None and fewest.count >= reps:
            return total / reps / 1e3
        log(f"profiler session {attempt + 1} saw {0 if fewest is None else fewest.count} of "
            f"{reps} launches of {'no kernel' if fewest is None else fewest.key[:80]}; "
            f"measuring again")
    raise RuntimeError(f"the profiler lost device events in {PROFILER_SESSIONS} sessions")


def warm_up_profiler() -> None:
    """Throwaway profiler sessions until one sees every launch: the first
    sessions of a process can miss the card's events while the tracer
    starts up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device="cuda")
    for _ in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                x = x * 1.0
            torch.cuda.synchronize()
        seen = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        if seen >= 10:
            return


def bound(nbytes: float, flops: float, flop_rate: float = FP32_FLOP_PER_S):
    """(ms, what bounds it): the larger of bytes over the memory rate and
    flops over ``flop_rate`` (the fp32 rate unless named)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------- phases


def phase_env() -> str:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    print(card, flush=True)
    return card


def phase_build() -> None:
    from repro_torch.kernels import _lib

    t0 = time.perf_counter()
    path = _lib.build()
    _lib.lib()
    log(f"built {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in _lib.build_log().splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"ptxas {line.strip()}")
    log_kernel_sass(path)


def ptxas_usage(name: str) -> dict:
    """Registers and spill bytes of the kernels whose mangled name contains
    ``name``, from the build's ptxas output: {mangled name: (registers,
    spill stores, spill loads)}."""
    import re

    from repro_torch.kernels import _lib

    usage, entry, spills = {}, None, (0, 0)
    for line in _lib.build_log().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            spills = (int(m.group(1)), int(m.group(2)))
        elif entry and (m := re.search(r"Used (\d+) registers", line)):
            if name in entry:
                usage[entry] = (int(m.group(1)), *spills)
            entry, spills = None, (0, 0)
    return usage


# SASS opcodes counted in the attention kernels: the tensor-core products of
# the bf16 kernel (HGMMA: wgmma, HMMA: mma.sync); the fp32 kernel's FMAs and
# shared-memory traffic (LDS.128: float4 reads)
SASS_OPS = {"flash_attn_bf16_kernel": ("HGMMA", "HMMA"),
            "flash_attn_f32_kernel": ("FFMA", "LDS.128", "LDS", "STS.128", "STS", "SHFL",
                                      "MUFU.EX2")}


def _is_op(word: str, op: str) -> bool:
    """``word`` is the opcode ``op`` with any modifiers; "LDS" / "STS" are the
    shared-memory accesses that are not 128-bit, "LDS.128" / "STS.128" those
    that are."""
    base, wide = op.split(".")[0], op.endswith(".128")
    if base in ("LDS", "STS"):
        return (word == base or word.startswith(base + ".")) and word.endswith(".128") == wide
    return word == op or word.startswith(op + ".")


def log_kernel_sass(library: Path) -> None:
    """Counts SASS_OPS in the attention kernels' SASS (static counts: the
    unrolled loop bodies), by cuobjdump where the toolkit has it.  The bf16
    kernel must have tensor-core instructions; for the fp32 kernel the FFMAs
    per shared-memory read instruction are logged."""
    import shutil

    from repro_torch.kernels import _lib

    tool = shutil.which("cuobjdump") or str(Path(_lib.nvcc()).parent / "cuobjdump")
    if not Path(tool).exists():
        log("cuobjdump not found: the attention kernels' SASS not counted")
        return
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, name, ops = {}, None, ()
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            ops = next((o for k, o in SASS_OPS.items() if k in name), ())
        elif ops:
            c = counts.setdefault(name, dict.fromkeys(ops, 0))
            words = line.replace(";", " ").split()
            for op in ops:
                c[op] += any(_is_op(w, op) for w in words)
    for fn, c in counts.items():
        line = " ".join(f"{op}={n}" for op, n in c.items())
        if "FFMA" in c:
            line += f" ffma_per_lds={c['FFMA'] / max(c['LDS.128'] + c['LDS'], 1):.2f}"
        log(f"sass {fn}: {line}")
        if "HGMMA" in c:
            assert c["HGMMA"] + c["HMMA"] > 0, f"{fn} has no tensor-core instruction"
    assert any("flash_attn_bf16_kernel" in fn for fn in counts), (
        "no flash_attn_bf16_kernel in the library's SASS")


def _int_or_float(shape, integer: bool, g):
    import torch

    if integer:
        return torch.randint(-3, 4, shape, generator=g, device="cuda").float()
    return torch.randn(shape, generator=g, device="cuda") / shape[-1] ** 0.5


def _int8_store(items, integer: bool, g):
    """(codes, scales) of the int8 store: for integer items, small integer
    codes and power-of-two scales (every quantized score exact); for float
    items, the port's quantizer."""
    import torch

    from repro_torch.core.storage import quantize_items

    if not integer:
        return tuple(quantize_items(items))
    n, d = items.shape
    codes = torch.randint(-3, 4, (n, d), generator=g, device=items.device).to(torch.int8)
    exps = torch.randint(-3, 4, (n,), generator=g, device=items.device).float()
    return codes, torch.pow(2.0, exps)


def _plain_scorer(scales):
    """The plain scorer of one store: the fp32 dot, or quant_score_ref."""
    from repro_torch.core.similarity import gather_scores
    from repro_torch.kernels.quant_score import quant_score_ref

    if scales is None:
        return gather_scores
    return lambda q, codes, ids: quant_score_ref(q, codes, scales, ids)


def _beam_state(shape, rows, scales, integer: bool, g):
    """A valid walk state at ``shape`` over ``rows`` (fp32 items, or int8
    codes with ``scales``): pools sorted by the plain scorer, empty tail
    slots, checked slots, rows done on input and rows with nothing left
    unchecked, visited buffers that hit the adjacency rows."""
    import torch

    from repro_torch.core.similarity import top_l

    b, l, m, _, v = shape
    n, d = rows.shape
    dev = rows.device
    queries = _int_or_float((b, d), integer, g)
    adj = torch.randint(0, n, (n, m), generator=g, device=dev, dtype=torch.int32)
    adj[torch.rand((n, m), generator=g, device=dev) < 0.1] = -1
    ids = torch.randint(0, n, (b, l), generator=g, device=dev, dtype=torch.int32)
    n_empty = torch.randint(0, l // 2 + 1, (b, 1), generator=g, device=dev)
    ids[torch.arange(l, device=dev) >= l - n_empty] = -1
    scores = torch.where(ids >= 0, _plain_scorer(scales)(queries, rows, ids), float("-inf"))
    scores, order = top_l(scores, l)
    ids = ids.gather(1, order)
    checked = (torch.rand((b, l), generator=g, device=dev) < 0.5) | (ids < 0)
    checked[: b // 16] = True
    done = torch.rand(b, generator=g, device=dev) < 0.1
    visited = torch.randint(0, n, (b, v), generator=g, device=dev, dtype=torch.int32)
    visited[torch.rand((b, v), generator=g, device=dev) < 0.3] = -1
    # every pool id was scored, so it is in the visited buffer, as in a walk
    hits = adj[ids.clamp_min(0).long()][:, :, : m // 2].reshape(b, -1)
    h = min(v // 2 - l, hits.shape[1])
    visited[:, :l] = ids
    visited[:, l: l + h] = hits[:, :h]
    return (ids, scores.contiguous(), checked.contiguous(), visited, done, queries, adj, rows)


def _check_topk(name, ids_k, s_k, ids_p, s_p, integer: bool) -> int:
    """Integer inputs: bit-identical.  Float inputs: the tolerance contract;
    returns the rows that needed the near-tie exception."""
    import torch

    from repro_torch.testing import assert_topk_match

    if integer:
        assert torch.equal(ids_k, ids_p), f"{name}: ids differ on integer inputs"
        assert torch.equal(s_k, s_p), f"{name}: scores differ on integer inputs"
        return 0
    return len(assert_topk_match(ids_k.cpu().numpy(), s_k.cpu().numpy(),
                                 ids_p.cpu().numpy(), s_p.cpu().numpy()))


def _max_abs_err(a, b) -> float:
    import torch

    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def phase_beam_step(items_by_kind, stores_by_kind, g) -> dict:
    """beam_step over the fp32 items and over the int8 store, each without
    and with a tombstone mask (about half the items dead); returns the
    timings of the four variants at the search IP shape, float inputs."""
    import torch

    from repro_torch.kernels.beam_step import beam_step, beam_step_ref

    out = {}
    counters = {"f32": "launches", "int8": "launches_int8", "f32_live": "launches_live",
                "int8_live": "launches_int8_live"}
    for variant in ("f32", "int8"):
        for walk, shape in BEAM_SHAPES.items():
            for kind, items in items_by_kind.items():
                rows, scales = (items, None) if variant == "f32" else stores_by_kind[kind]
                args = _beam_state(shape, rows, scales, kind == "int", g)
                live = torch.rand(rows.shape[0], generator=g, device=rows.device) >= 0.5
                for mask in (None, live):
                    tag = variant if mask is None else f"{variant}_live"
                    run = lambda: beam_step(*args, scales, mask)  # noqa: E731
                    plain = lambda: beam_step_ref(  # noqa: E731
                        *args, score_fn=_plain_scorer(scales), live=mask)
                    k, p = run(), plain()
                    torch.cuda.synchronize()
                    name = f"beam_step[{tag}] {walk}/{kind}"
                    assert torch.equal(k.nbr_ids, p.nbr_ids), f"{name}: nbr_ids"
                    assert torch.equal(k.done, p.done), f"{name}: done"
                    assert torch.equal(k.n_scored, p.n_scored), f"{name}: n_scored"
                    if mask is None:
                        assert k.n_dead is None and p.n_dead is None, f"{name}: n_dead"
                    else:
                        assert torch.equal(k.n_dead, p.n_dead), f"{name}: n_dead"
                        assert int(k.n_dead.sum()) > 0, f"{name}: no tombstone was scored"
                    rows_tied = _check_topk(name, k.pool_ids, k.pool_scores, p.pool_ids,
                                            p.pool_scores, kind == "int")
                    if kind == "int":
                        assert torch.equal(k.pool_checked, p.pool_checked), f"{name}: checked"
                    err = _max_abs_err(k.pool_scores, p.pool_scores)
                    ms = device_ms(run)
                    plain_ms = device_ms(plain)
                    call_ms = cuda_ms(run)
                    b, l, m, _, v = shape
                    d = items.shape[1]
                    row_bytes = d * 4 if variant == "f32" else d + 4  # codes + scale
                    n_upd, n_scored = int((~k.done).sum()), int(k.n_scored.sum())
                    nbytes = (b * l * 9 + b + n_upd * (v * 4 + d * 4 + m * 4)
                              + n_scored * row_bytes + b * l * 9 + b * m * 4 + b * 5)
                    if mask is not None:
                        nbytes += n_scored + b * 4  # a live byte per valid neighbour, n_dead
                    bound_ms, by = bound(nbytes, 2.0 * d * n_scored)
                    launches = getattr(beam_step, counters[tag])
                    log(f"kernel=beam_step variant={tag} walk={walk} inputs={kind} B={b} "
                        f"L={l} M={m} V={v} d={d} ms={ms:.4f} call_ms={call_ms:.4f} "
                        f"plain_ms={plain_ms:.4f} library_ms=None bound_ms={bound_ms:.5f} "
                        f"bound_by={by} near_tie_rows={rows_tied} max_abs_err={err:.3g} "
                        f"n_dead={0 if k.n_dead is None else int(k.n_dead.sum())} "
                        f"launches={launches}")
                    if walk == "search_ip" and kind == "float":
                        out[tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                        bound_by=by, library_ms=None, max_abs_err=err)
    return out


def _walk_inputs(shape, rows, scales, integer: bool, live, g, *, pad_rows: bool = False):
    """A walk's seeded state as core/search.beam_search makes it, over a
    random graph (10% empty slots) of the ``rows`` store: deduplicated
    seeds (10% -1), the seed pool sorted by the plain scorer, visited with
    the seeds then -1, about 10% of the rows born done (``pad_rows``: a
    third are pad rows, seedless and done), seed evals and dead evals.
    Returns (args, kwargs) of beam_walk, with ``max_steps``."""
    import torch

    from repro_torch.core.search import _dedup_ids
    from repro_torch.core.similarity import top_l

    b, l, m, s, max_steps = shape
    n, d = rows.shape
    dev = rows.device
    queries = _int_or_float((b, d), integer, g)
    adj = torch.randint(0, n, (n, m), generator=g, device=dev, dtype=torch.int32)
    adj[torch.rand((n, m), generator=g, device=dev) < 0.1] = -1
    seeds = torch.randint(0, n, (b, s), generator=g, device=dev, dtype=torch.int32)
    seeds[torch.rand((b, s), generator=g, device=dev) < 0.1] = -1
    done = torch.rand(b, generator=g, device=dev) < 0.1
    if pad_rows:
        done = torch.arange(b, device=dev) % 3 == 1
        seeds[done] = -1
    seeds = _dedup_ids(seeds)
    ok = seeds >= 0
    scores = torch.where(ok, _plain_scorer(scales)(queries, rows, seeds), float("-inf"))
    top, idx = top_l(scores, min(l, s))
    pool_ids = torch.full((b, l), -1, dtype=torch.int32, device=dev)
    pool_scores = torch.full((b, l), float("-inf"), device=dev)
    pool_ids[:, : idx.shape[1]] = seeds.gather(1, idx)
    pool_scores[:, : idx.shape[1]] = top
    visited = torch.full((b, s + max_steps * m), -1, dtype=torch.int32, device=dev)
    visited[:, :s] = seeds
    evals = ok.sum(-1, dtype=torch.int32)
    dead = None if live is None else (ok & ~live[seeds.clamp_min(0).long()]).sum(
        -1, dtype=torch.int32)
    args = (pool_ids, pool_scores, pool_ids < 0, visited, done, evals, queries, adj, rows,
            scales, live, dead)
    return args, dict(max_steps=max_steps)


def _fresh(args):
    """The walk's arguments with a fresh visited buffer (a walk writes its
    visited in place)."""
    return (*args[:3], args[3].clone(), *args[4:])


def per_step_walk(pool_ids, pool_scores, pool_checked, visited, done, evals, queries, adj,
                  items, scales=None, live=None, dead_evals=None, *, max_steps,
                  capturable=False):
    """The yardstick: beam_walk as a host loop of the beam_step kernel (one
    launch and one done.all() read a step), the walk the port ran before
    beam_walk.  Same arguments and result; it reads back every step, so a
    capturable walk cannot take it."""
    from repro_torch.kernels.beam_step import beam_step, host_walk

    if capturable:
        raise ValueError("the per-step loop reads back every step: it cannot be captured")

    def step(ids, scores, checked, vis, dn):
        return beam_step(ids, scores, checked, vis, dn, queries, adj, items, scales, live)

    return host_walk(step, pool_ids, pool_scores, pool_checked, visited, done, evals,
                     dead_evals if live is not None else None, max_steps=max_steps)


def _walk_plain(args, kw):
    """beam_walk_ref on the same arguments (the plain scorer of the store)."""
    from repro_torch.kernels.beam_step import beam_walk_ref

    (pool_ids, pool_scores, checked, visited, done, evals, queries, adj, rows, scales, live,
     dead) = args
    return beam_walk_ref(pool_ids, pool_scores, checked, visited, done, evals, queries, adj,
                         rows, score_fn=_plain_scorer(scales), live=live, dead_evals=dead, **kw)


WALK_FIELDS = ("pool_ids", "pool_scores", "pool_checked", "visited", "evals", "dead_evals",
               "row_steps")


def _check_walk(name, got, want, exact: bool):
    """Every output of two walks bit-identical, steps included (``exact``);
    else (float inputs against the plain version, whose scores differ in
    the last bits) the final pools within the tolerance contract: a near-tie
    ordered the other way can send a row's walk elsewhere on its way to the
    same pool, so visited and the counts are held on integer inputs only.
    Returns (near-tie rows, rows whose visited differs)."""
    import torch

    if exact:
        assert got.steps == want.steps, f"{name}: steps {got.steps} != {want.steps}"
        for field in WALK_FIELDS:
            x, y = getattr(got, field), getattr(want, field)
            assert (x is None) == (y is None), f"{name}: {field}"
            if x is not None:
                assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                                   y.view(torch.int32) if y.dtype == torch.float32 else y), \
                    f"{name}: {field} differs"
        return 0, 0
    tied = _check_topk(name, got.pool_ids, got.pool_scores, want.pool_ids, want.pool_scores,
                       False)
    return tied, int((got.visited != want.visited).any(-1).sum())


def _walk_bound(args, res, max_steps: int, expanded: int):
    """(ms, by) for one walk: each distinct adjacency row it expanded and
    each distinct item row it scored read once (int8: codes and scale; with
    a mask one live byte), the queries, pools and seed evals read, the pools
    and counts written, and the visited columns of the steps the rows ran
    written once; 2 d flops per scored neighbour."""
    import torch

    pool_ids, queries, adj, rows, scales, live = (args[0], args[6], args[7], args[8], args[9],
                                                  args[10])
    b, l = pool_ids.shape
    d = rows.shape[1]
    m = adj.shape[1]
    cols = res.visited[:, res.visited.shape[1] - max_steps * m:]
    scored = torch.unique(cols[cols >= 0]).numel()
    row_bytes = d * 4 if scales is None else d + 4
    nbytes = (expanded * m * 4 + scored * (row_bytes + (live is not None))
              + b * d * 4 + 2 * b * l * 9 + b * (1 + 4 + 4 + 4)
              + int(res.row_steps.sum()) * m * 4)
    n_scored = int((res.evals - args[5]).sum())
    return bound(nbytes, 2.0 * d * n_scored)


def _expanded_nodes(args, kw) -> int:
    """Distinct nodes whose adjacency rows the walk read: the chosen slot's
    id of every step that advanced, from a host loop of the plain version."""
    import torch

    from repro_torch.kernels.beam_step import beam_step_ref, host_walk

    (_, _, _, _, _, _, queries, adj, rows, scales, live, _) = args
    chosen = []

    def step(ids, scores, checked, vis, dn):
        unchecked = ~checked & (ids >= 0)
        slot = torch.where(unchecked, torch.arange(ids.shape[1], device=ids.device),
                           ids.shape[1]).min(-1).values
        upd = ~dn & (slot < ids.shape[1])
        chosen.append(ids.gather(1, slot.clamp_max(ids.shape[1] - 1)[:, None])[upd, 0])
        return beam_step_ref(ids, scores, checked, vis, dn, queries, adj, rows,
                             score_fn=_plain_scorer(scales), live=live)

    fresh = _fresh(args)
    host_walk(step, *fresh[:6], fresh[11] if live is not None else None, **kw)
    return torch.unique(torch.cat(chosen)).numel() if chosen else 0


def phase_beam_walk(items_by_kind, stores_by_kind, g) -> dict:
    """beam_walk in every variant (f32, int8, each without and with a
    tombstone mask over about half the items) at the main path's walks, and
    at pad rows, a max_steps cut and a large ef whose visited rows stay in
    device memory: every output bit-identical to the host loop of the
    beam_step kernel on any input, and to beam_walk_ref on integer inputs
    (float inputs: the tolerance contract).  Returns the timings of the
    four variants at the search IP shape, float inputs."""
    import torch

    from repro_torch.kernels.beam_step import beam_walk
    from repro_torch.kernels.beam_step.ops import VISITED_SHARED_MAX

    out = {}
    # d = 37: the scalar loads (repro::row_score) instead of the 16-byte ones
    narrow = {kind: _int_or_float((20_000, 37), kind == "int", g) for kind in items_by_kind}
    narrow_stores = {kind: _int8_store(x, kind == "int", g) for kind, x in narrow.items()}
    cells = [(variant, walk, shape, {}) for variant in ("f32", "int8")
             for walk, shape in WALK_SHAPES.items()]
    cells += [("f32", "search_ip_pad_rows", WALK_SHAPES["search_ip"], {"pad_rows": True}),
              ("int8", "search_ip_max_steps_cut", (*WALK_SHAPES["search_ip"][:4], 6), {}),
              ("f32", "search_ip_long", WALK_LONG, {}),
              ("f32", "large_v_ef400", WALK_LARGE_V, {}),
              ("f32", "search_ip_d37", WALK_SHAPES["search_ip"], {}),
              ("int8", "search_ip_d37", WALK_SHAPES["search_ip"], {})]
    for variant, walk, shape, opts in cells:
        for kind in items_by_kind:
            items, stores = ((narrow, narrow_stores) if walk.endswith("d37")
                             else (items_by_kind, stores_by_kind))
            items = items[kind]
            rows, scales = (items, None) if variant == "f32" else stores[kind]
            half_dead = torch.rand(rows.shape[0], generator=g, device=rows.device) >= 0.5
            for mask in (None, half_dead):
                tag = variant if mask is None else f"{variant}_live"
                args, kw = _walk_inputs(shape, rows, scales, kind == "int", mask, g, **opts)
                got = beam_walk(*_fresh(args), **kw)
                loop = per_step_walk(*_fresh(args), **kw)
                plain = _walk_plain(_fresh(args), kw)
                torch.cuda.synchronize()
                name = f"beam_walk[{tag}] {walk}/{kind}"
                _check_walk(f"{name} vs the beam_step loop", got, loop, True)
                tied, strayed = _check_walk(f"{name} vs beam_walk_ref", got, plain,
                                            kind == "int")
                assert got.steps == int(got.row_steps.max()), f"{name}: steps"
                b, l, m, s, max_steps = shape
                v = s + max_steps * m
                done = args[4]
                assert got.steps > 0 and bool((got.row_steps[done] == 0).all()), \
                    f"{name}: a row done on entry took a step"
                if mask is not None:
                    assert int((got.dead_evals - args[11]).sum()) > 0, f"{name}: no dead eval"
                if opts.get("pad_rows"):
                    assert bool((got.visited[done] == -1).all()) and bool(
                        (got.evals[done] == 0).all()), f"{name}: a pad row was walked"
                if walk.endswith("max_steps_cut"):
                    assert got.steps == max_steps, f"{name}: the walk was not cut"
                if walk.endswith("long"):
                    assert got.steps < max_steps, f"{name}: max_steps cut the walk"
                err = _max_abs_err(got.pool_scores, plain.pool_scores)
                line = (f"kernel=beam_walk variant={tag} walk={walk} inputs={kind} B={b} L={l} "
                        f"M={m} S={s} V={v} d={rows.shape[1]} max_steps={max_steps} "
                        f"visited_in_shared={v <= VISITED_SHARED_MAX} steps={got.steps} "
                        f"mean_row_steps={float(got.row_steps.float().mean()):.2f} "
                        f"near_tie_rows={tied} rows_walked_elsewhere_than_plain={strayed} "
                        f"max_abs_err={err:.3g}")
                timed = walk == "search_ip" or (walk == "large_v_ef400" and mask is None)
                if kind == "float" and timed:
                    reps = 10 if walk == "search_ip" else 3
                    run = lambda: beam_walk(*_fresh(args), **kw)  # noqa: E731
                    ms = device_ms(run, reps=reps, only="beam_walk_kernel", once=True)
                    loop_ms = device_ms(lambda: per_step_walk(*_fresh(args), **kw), reps=reps,
                                        only="beam_step")
                    call_ms = cuda_ms(run, reps=reps)
                    loop_call_ms = cuda_ms(lambda: per_step_walk(*_fresh(args), **kw), reps=reps)
                    bound_ms, by = _walk_bound(args, got, max_steps, _expanded_nodes(args, kw))
                    line += (f" ms={ms:.4f} call_ms={call_ms:.4f} step_loop_ms={loop_ms:.4f} "
                             f"step_loop_call_ms={loop_call_ms:.4f} library_ms=None "
                             f"bound_ms={bound_ms:.5f} bound_by={by} "
                             f"us_per_step={ms / got.steps * 1e3:.3f}")
                    if walk == "search_ip":
                        plain_ms = device_ms(lambda: _walk_plain(_fresh(args), kw), reps=3)
                        line += f" plain_ms={plain_ms:.4f}"
                        out[tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                        bound_by=by, library_ms=None, max_abs_err=err)
                log(line + f" launches={getattr(beam_walk, _WALK_COUNTERS[tag])}")
    return out


_WALK_COUNTERS = {"f32": "launches", "int8": "launches_int8", "f32_live": "launches_live",
                  "int8_live": "launches_int8_live"}


def _score_ids(b: int, w: int, n: int, g):
    """[B, W] ids as the walk gives them: hub-skewed repeats and 10% -1."""
    import torch

    ids = torch.randint(0, n, (b, w), generator=g, device="cuda", dtype=torch.int32)
    hubs = torch.rand((b, w), generator=g, device="cuda") < 0.2
    ids[hubs] = torch.randint(0, 64, (int(hubs.sum()),), generator=g, device="cuda",
                              dtype=torch.int32)
    ids[torch.rand((b, w), generator=g, device="cuda") < 0.1] = -1
    return ids


def _check_scores(name, got, want, integer: bool) -> float:
    """Integer inputs: bit-identical; float inputs: the tolerance contract.
    -inf where and only where the plain version has it."""
    import torch

    from repro_torch.testing import scores_close

    if integer:
        assert torch.equal(got, want), f"{name}: scores differ on integer inputs"
    else:
        ok = scores_close(got.cpu().numpy(), want.cpu().numpy())
        assert ok.all(), f"{name}: {int((~ok).sum())} scores outside the tolerance"
    assert torch.equal(torch.isinf(got), torch.isinf(want)), f"{name}: -inf slots differ"
    return _max_abs_err(got, want)


def _scorer_witness(name: str, q, rows, scales, ids):
    """The previous one-warp-a-row kernel on the same inputs
    (gather_score_rowwise_f32 / quant_score_rowwise_i8): the yardstick the
    redesigned scorer is held to bit for bit and timed against.  Launched
    here only, through no wrapper, so it counts in no launch counter."""
    import torch

    from repro_torch.kernels import _lib

    (b, d), w = q.shape, ids.shape[1]
    out = torch.empty((b, w), dtype=torch.float32, device=q.device)
    stream = _lib.stream(q.device)
    if name == "quant_score":
        rc = _lib.lib().quant_score_rowwise_i8(q.data_ptr(), rows.data_ptr(), scales.data_ptr(),
                                               ids.data_ptr(), b, w, d, out.data_ptr(), stream)
    else:
        rc = _lib.lib().gather_score_rowwise_f32(q.data_ptr(), rows.data_ptr(), ids.data_ptr(),
                                                 b, w, d, out.data_ptr(), stream)
    _lib.check(rc, f"{name} witness")
    return out


def _poisoned(fn, shape):
    """``fn()`` right after a NaN-filled block of ``shape`` was freed: the
    output the wrapper allocates is that block, so a slot the kernel does
    not write reads NaN, not an earlier run's score."""
    import torch

    torch.full(shape, float("nan"), device="cuda")
    return fn()


_L2_FLUSH = []  # a 128 MB buffer, written before each cold launch (the L2 holds 50 MB)


def _cold(fn):
    """``fn`` with 128 MB written before each call: the rows it gathers come
    from device memory, as for a caller that has not just touched them.
    Time it with ``device_ms(..., only=<its kernel>)``, which leaves the
    fill out."""
    import torch

    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(1 << 25, device="cuda"))
    return lambda: (_L2_FLUSH[0].zero_(), fn())[1]


def _scorer_bound(name: str, ids, d: int):
    """(ms, by): each distinct row read once -- a -1 id reads no row of the
    int8 store (quant_score) or row 0 (gather_score clamps) -- plus ids,
    scores and queries; 2 d flops a scored slot."""
    import torch

    b, w = ids.shape
    distinct = torch.unique(ids[ids >= 0] if name == "quant_score" else ids.clamp_min(0))
    row_bytes = d + 4 if name == "quant_score" else d * 4
    n_scored = int((ids >= 0).sum()) if name == "quant_score" else b * w
    return bound(b * w * 8 + distinct.numel() * row_bytes + b * d * 4, 2.0 * d * n_scored)


def phase_scorers(items_by_kind, stores_by_kind, g) -> dict:
    """quant_score at the int8 seed shapes and gather_score at the f32 seed
    and rerank shapes, and both at their edges (SCORER_EDGES): on every
    input bit-identical to the witness, the previous one-warp-a-row kernel
    (``_scorer_witness``), and held to the plain version (integer inputs
    bit-identical, float inputs the tolerance contract, -inf slots equal).
    At the main shapes, float inputs, the kernel and the witness are timed
    in turns (kernel, witness, witness, kernel), back to back as the other
    kernels are (rows that fit the L2 stay there between calls), and again
    with the L2 flushed before each call (``_cold``: cold_ms).  Returns the
    timings at the IP seed shape, float."""
    import torch

    from repro_torch.kernels.gather_score import gather_score, gather_score_ref
    from repro_torch.kernels.quant_score import quant_score, quant_score_ref

    out = {}
    # d = 37 (scalar loads) and d = 512 (two rounds of loads) over their own rows
    other_d = {dd: {kind: _int_or_float((20_000, dd), kind == "int", g) for kind in items_by_kind}
               for dd in {d for _, _, d, _ in SCORER_EDGES.values()} - {D_FULL}}
    cases = [("quant_score", cell, (b, w, D_FULL, False), True)
             for cell, (b, w) in QUANT_SHAPES.items()]
    cases += [("gather_score", cell, (b, w, D_FULL, False), True)
              for cell, (b, w) in GATHER_SHAPES.items()]
    cases += [(name, cell, shape, False) for name in ("quant_score", "gather_score")
              for cell, shape in SCORER_EDGES.items()]
    for name, cell, (b, w, d, dead_row), timed in cases:
        for kind in items_by_kind:
            items = items_by_kind[kind] if d == D_FULL else other_d[d][kind]
            codes, scales = (stores_by_kind[kind] if d == D_FULL
                             else _int8_store(items, kind == "int", g))
            q = _int_or_float((b, d), kind == "int", g)
            ids = _score_ids(b, w, items.shape[0], g)
            if dead_row:
                ids[0] = -1
            if name == "quant_score":
                run = lambda: quant_score(q, codes, scales, ids)  # noqa: E731
                plain = lambda: quant_score_ref(q, codes, scales, ids)  # noqa: E731
                witness = lambda: _scorer_witness(name, q, codes, scales, ids)  # noqa: E731
                fn = quant_score
            else:
                run = lambda: gather_score(q, items, ids)  # noqa: E731
                plain = lambda: gather_score_ref(q, items, ids)  # noqa: E731
                witness = lambda: _scorer_witness(name, q, items, None, ids)  # noqa: E731
                fn = gather_score
            got = _poisoned(run, (b, w))
            wit, want = witness(), plain()
            torch.cuda.synchronize()
            tag = f"{name} {cell}/{kind} B={b} W={w} d={d}"
            assert torch.equal(got.view(torch.int32), wit.view(torch.int32)), \
                f"{tag}: {int((got.view(torch.int32) != wit.view(torch.int32)).sum())} " \
                f"scores differ from the witness's bits"
            err = _check_scores(tag, got, want, kind == "int")
            line = (f"kernel={name} cell={cell} inputs={kind} B={b} W={w} d={d} "
                    f"witness_bit_identical=True max_abs_err={err:.3g}")
            if timed and kind == "float":
                turns = [device_ms(f) for f in (run, witness, witness, run)]
                ms, witness_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
                cold = [device_ms(_cold(f), only=f"{name}_{k}kernel")
                        for f, k in ((run, ""), (witness, "rowwise_"), (witness, "rowwise_"),
                                     (run, ""))]
                cold_ms, witness_cold_ms = (cold[0] + cold[3]) / 2, (cold[1] + cold[2]) / 2
                plain_ms = device_ms(plain)
                call_ms = cuda_ms(run)
                bound_ms, by = _scorer_bound(name, ids, d)
                line += (f" ms={ms:.4f} witness_ms={witness_ms:.4f} turns={turns[0]:.4f}/"
                         f"{turns[1]:.4f}/{turns[2]:.4f}/{turns[3]:.4f} call_ms={call_ms:.4f} "
                         f"plain_ms={plain_ms:.4f} library_ms=None bound_ms={bound_ms:.5f} "
                         f"bound_by={by} share_of_bound={bound_ms / ms:.3f} "
                         f"over_witness={witness_ms / ms:.3f} cold_ms={cold_ms:.4f} "
                         f"witness_cold_ms={witness_cold_ms:.4f} cold_turns="
                         f"{'/'.join(f'{t:.4f}' for t in cold)} "
                         f"cold_share_of_bound={bound_ms / cold_ms:.3f}")
                if cell == "seed_ip":
                    out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                                     library_ms=None, max_abs_err=err)
            log(line + f" launches={fn.launches}")
    return out


def _commit_inputs(items, batch: int, m: int, g):
    """One build batch's reverse-link proposals: the last ``batch`` items
    propose themselves to M distinct, hub-skewed targets each (10% -1); a
    tenth of the proposals repeat an edge their target already has."""
    import torch

    n = items.shape[0]
    dev = items.device
    adj = torch.randint(0, n - batch, (n, m), generator=g, device=dev, dtype=torch.int32)
    adj[torch.rand((n, m), generator=g, device=dev) < 0.1] = -1
    weights = 1.0 / torch.arange(1, n - batch + 1, device=dev, dtype=torch.float32)
    targets = torch.multinomial(weights.expand(batch, -1), m, replacement=False,
                                generator=g).to(torch.int32)
    targets[torch.rand((batch, m), generator=g, device=dev) < 0.1] = -1
    bids = torch.arange(n - batch, n, device=dev, dtype=torch.int32)
    adj[bids.long()] = torch.where(targets >= 0, targets, -1)  # forward rows first
    cands = bids[:, None].expand(-1, m)
    repeat = (targets >= 0) & (torch.rand((batch, m), generator=g, device=dev) < 0.1)
    slot = torch.randint(0, m, (batch, m), generator=g, device=dev)
    adj[targets[repeat].long(), slot[repeat]] = cands[repeat]
    scores = (items[targets.clamp_min(0).long()] * items[cands.long()]).sum(-1)
    return adj, targets.reshape(-1), cands.reshape(-1).contiguous(), scores.reshape(-1)


def phase_commit_merge(items_by_kind, g) -> dict:
    """commit_merge at each COMMIT_SHAPES cell: the kernel against its plain
    version on the same sorted proposals (and, on integer items, the whole
    commit against the two-sort oracle), no foreign row written, and one
    whole commit under torch.cuda.set_sync_debug_mode("error"): a read-back
    from the card anywhere in the pre-pass or the launch fails the run."""
    import torch

    from repro_torch.kernels.commit_merge import (
        commit_merge, commit_merge_ref, commit_rows, commit_rows_ref, sort_proposals,
    )

    out = {}
    for graph, (batch, m) in COMMIT_SHAPES.items():
        for kind, items in items_by_kind.items():
            adj0, targets, cands, scores = _commit_inputs(items, batch, m, g)
            props = sort_proposals(adj0.shape[0], targets, cands, scores)
            work = adj0.clone()
            commit_rows(work, items, props)
            tgt, rows_p = commit_rows_ref(adj0, items, *props)
            rows_k = work[tgt]
            torch.cuda.synchronize()
            untouched = torch.ones(adj0.shape[0], dtype=torch.bool, device=adj0.device)
            untouched[tgt] = False
            assert torch.equal(work[untouched], adj0[untouched]), "commit_merge wrote a foreign row"
            rs = lambda r: torch.where(  # noqa: E731 -- plain scores of a row's ids
                r >= 0, (items[tgt][:, None, :] * items[r.clamp_min(0).long()]).sum(-1),
                float("-inf"))
            near = _check_topk(f"commit_merge {graph}/{kind}", rows_k, rs(rows_k),
                               rows_p, rs(rows_p), kind == "int")
            full = adj0.clone()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                commit_merge(full, items, targets, cands, scores)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert torch.equal(full, work), f"commit_merge {graph}: the commit != its kernel's rows"
            if kind == "int":
                assert torch.equal(full, commit_merge_ref(adj0, items, targets, cands, scores)), \
                    f"commit_merge {graph}: kernel path != two-sort commit_merge_ref"
            # each launch merges into a fresh copy of the rows (copy time excluded)
            ms = device_ms(lambda: (work.copy_(adj0), commit_rows(work, items, props)),
                           only="commit_merge_kernel")
            kernel_call_ms = cuda_ms(lambda: commit_rows(work, items, props))
            call_ms = cuda_ms(lambda: commit_merge(work, items, targets, cands, scores))
            plain_ms = device_ms(lambda: commit_rows_ref(adj0, items, *props))
            # the existing edges the kernel rescores: >= 0, not repeating an
            # earlier slot, not repeated by a proposal of the same target
            t_s, c_s = props.targets.long(), props.cands.long()
            pair = torch.cat([torch.ones(1, dtype=torch.bool, device=t_s.device),
                              (t_s[1:] != t_s[:-1]) | (c_s[1:] != c_s[:-1])])
            prop = (t_s >= 0) & (c_s >= 0) & pair
            u, p, d = tgt.shape[0], int(prop.sum()), items.shape[1]
            run = torch.bincount(t_s[t_s >= 0])
            ex = adj0[tgt].long()
            seg = torch.searchsorted(tgt, t_s[prop])
            live = ex >= 0
            for j in range(m):
                live[:, j] &= ~(ex[:, :j] == ex[:, j: j + 1]).any(-1)
                live[seg[c_s[prop] == ex[seg, j]], j] = False
            n_rescored = int(live.sum())
            # the sorted proposals, the touched rows and target vectors, the rescored
            # neighbour rows read; the touched rows written
            nbytes = targets.shape[0] * 12 + u * m * 4 + u * d * 4 + n_rescored * d * 4 + u * m * 4
            bound_ms, by = bound(nbytes, 2.0 * d * n_rescored)
            err = _max_abs_err(rs(rows_k), rs(rows_p))
            log(f"kernel=commit_merge graph={graph} inputs={kind} E={targets.shape[0]} U={u} "
                f"P={p} P_per_U={p / max(u, 1):.2f} longest_run={int(run.max())} M={m} d={d} "
                f"ms={ms:.4f} kernel_call_ms={kernel_call_ms:.4f} call_ms={call_ms:.4f} "
                f"plain_ms={plain_ms:.4f} "
                f"library_ms=None bound_ms={bound_ms:.5f} bound_by={by} near_tie_rows={near} "
                f"max_abs_err={err:.3g} launches={commit_merge.launches} "
                f"no_read_back=True")
            if graph == "ip" and kind == "float":
                out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                           library_ms=None, max_abs_err=err)
    # a width that is no multiple of 4: the rescore's scalar loads
    batch, m = COMMIT_SHAPES["ip"]
    for kind, items in items_by_kind.items():
        items = items[:, :37].contiguous()
        adj0, targets, cands, scores = _commit_inputs(items, batch, m, g)
        work = commit_merge(adj0.clone(), items, targets, cands, scores)
        tgt, rows_p = commit_rows_ref(adj0, items, *sort_proposals(adj0.shape[0], targets, cands,
                                                                   scores))
        want = adj0.clone()
        want[tgt] = rows_p
        if kind == "int":
            assert torch.equal(work, want), "commit_merge d=37: kernel != plain version"
            assert torch.equal(work, commit_merge_ref(adj0, items, targets, cands, scores))
        rs = lambda r: torch.where(  # noqa: E731
            r >= 0, (items[tgt][:, None, :] * items[r.clamp_min(0).long()]).sum(-1),
            float("-inf"))
        near = _check_topk(f"commit_merge d=37/{kind}", work[tgt], rs(work[tgt]), rows_p,
                           rs(rows_p), kind == "int")
        log(f"kernel=commit_merge edge=d37 inputs={kind} near_tie_rows={near}")
    return out


def phase_mips_topk(g) -> dict:
    """mips_topk over fp32 items and over the int8 store (the quantized
    scan), at both MIPS_SHAPES."""
    import torch

    from repro_torch.kernels.mips_topk import mips_topk, mips_topk_ref, mips_topk_select
    from repro_torch.kernels.mips_topk.ops import select_plan

    out = {}
    for variant in ("f32", "int8"):
        for cell, (b, n, d, k) in MIPS_SHAPES.items():
            for kind in ("int", "float"):
                q = _int_or_float((b, d), kind == "int", g)
                x = _int_or_float((n, d), kind == "int", g)
                if variant == "f32":
                    scales = None
                    library = lambda: torch.topk(torch.matmul(q, x.T), k, dim=1)  # noqa: E731
                else:
                    x, scales = _int8_store(x, kind == "int", g)
                    library = None
                run = lambda: mips_topk(q, x, scales, k=k)  # noqa: E731
                plain = lambda: mips_topk_ref(q, x, k=k, scales=scales)  # noqa: E731
                (s_k, i_k), (s_p, i_p) = run(), plain()
                torch.cuda.synchronize()
                rows = _check_topk(f"mips_topk[{variant}] {cell}/{kind}", i_k, s_k, i_p, s_p,
                                   kind == "int")
                err = _max_abs_err(s_k, s_p)
                ms = device_ms(run)
                call_ms = cuda_ms(run)
                plain_ms = device_ms(plain)
                library_ms = device_ms(library) if library is not None else None
                row_bytes = d * 4 if variant == "f32" else d + 4
                flops = 2.0 * b * n * d + (b * n if variant == "int8" else 0)
                bound_ms, by = bound(b * d * 4 + n * row_bytes + b * k * 8, flops)
                launches = mips_topk.launches if variant == "f32" else mips_topk.launches_int8
                log(f"kernel=mips_topk variant={variant} cell={cell} inputs={kind} B={b} N={n} "
                    f"d={d} k={k} ms={ms:.4f} call_ms={call_ms:.4f} plain_ms={plain_ms:.4f} "
                    f"library_ms={library_ms if library_ms is None else f'{library_ms:.4f}'} "
                    f"bound_ms={bound_ms:.5f} bound_by={by} near_tie_rows={rows} "
                    f"max_abs_err={err:.3g} launches={launches}")
                if kind == "float" and cell != "serve_default":
                    _log_roofline(f"mips_topk[{variant}] {cell}", flops, ms, bound_ms,
                                  library_ms, pass2_ms=device_ms(run, only="merge"))
                if cell == "full" and kind == "float":
                    out[variant] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                        bound_by=by, library_ms=library_ms, max_abs_err=err)
                del q, x, scales
        for cell, (b, n, d, k) in MIPS_EDGE_SHAPES.items():
            for kind in ("int", "float"):
                q = _int_or_float((b, d), kind == "int", g)
                x = _int_or_float((n, d), kind == "int", g)
                scales = None
                if variant == "int8":
                    x, scales = _int8_store(x, kind == "int", g)
                (s_k, i_k), (s_p, i_p) = mips_topk(q, x, scales, k=k), mips_topk_ref(
                    q, x, k=k, scales=scales)
                torch.cuda.synchronize()
                rows = _check_topk(f"mips_topk[{variant}] {cell}/{kind}", i_k, s_k, i_p, s_p,
                                   kind == "int")
                log(f"kernel=mips_topk variant={variant} edge={cell} inputs={kind} B={b} N={n} "
                    f"d={d} k={k} near_tie_rows={rows} max_abs_err={_max_abs_err(s_k, s_p):.3g}")
        for cell, (b, n, d, k) in {**MIPS_WIDE_SHAPES, **MIPS_TIED_SHAPES}.items():
            for kind in ("int", "float"):
                q = _int_or_float((b, d), kind == "int", g)
                x = _int_or_float((n, d), kind == "int", g)
                if cell in MIPS_TIED_SHAPES:  # one row repeated: every score of a query ties
                    x = x[:1].expand(n, d).contiguous()
                scales = None
                if variant == "int8":
                    x, scales = _int8_store(x, kind == "int", g)
                run = lambda: mips_topk(q, x, scales, k=k)  # noqa: E731
                plain = lambda: mips_topk_ref(q, x, k=k, scales=scales)  # noqa: E731
                (s_k, i_k), (s_p, i_p) = run(), plain()
                _, _, cands = mips_topk_select(q, x, scales, k=k)
                torch.cuda.synchronize()
                rows = _check_topk(f"mips_topk[{variant}] {cell}/{kind}", i_k, s_k, i_p, s_p,
                                   kind == "int")
                err = _max_abs_err(s_k, s_p)
                cands = cands.float()
                line = (f"kernel=mips_topk variant={variant} route=select cell={cell} "
                        f"inputs={kind} B={b} N={n} d={d} k={k} near_tie_rows={rows} "
                        f"max_abs_err={err:.3g} candidates_median={cands.median().item():.0f} "
                        f"candidates_max={cands.max().item():.0f} "
                        f"rows_from_scores={int((cands > select_plan(n, k)[1]).sum())}")
                if kind == "float":
                    library = None if variant == "int8" else (
                        lambda: torch.topk(torch.matmul(q, x.T), k, dim=1))
                    ms = device_ms(run)
                    select_ms = device_ms(run, only="select")  # the four select kernels
                    call_ms = cuda_ms(run)
                    plain_ms = device_ms(plain)
                    library_ms = device_ms(library) if library is not None else None
                    row_bytes = d * 4 if variant == "f32" else d + 4
                    flops = 2.0 * b * n * d + (b * n if variant == "int8" else 0)
                    bound_ms, by = bound(b * d * 4 + n * row_bytes + b * k * 8, flops)
                    # the select alone: two reads of the scratch, candidates and out written
                    select_bound_ms, _ = bound(2 * b * n * 4 + cands.sum().item() * 8 + b * k * 8, 0)
                    line += (f" ms={ms:.4f} select_ms={select_ms:.4f} "
                             f"select_bound_ms={select_bound_ms:.5f} call_ms={call_ms:.4f} "
                             f"plain_ms={plain_ms:.4f} "
                             f"library_ms={library_ms if library_ms is None else f'{library_ms:.4f}'}"
                             f" bound_ms={bound_ms:.5f} bound_by={by}")
                    _log_roofline(f"mips_topk[{variant}] select {cell}", flops, ms, bound_ms,
                                  library_ms, select_ms=select_ms)
                    if cell == "full_k33":
                        out[f"select_{variant}"] = dict(ms=ms, plain_ms=plain_ms,
                                                        bound_ms=bound_ms, bound_by=by,
                                                        library_ms=library_ms, max_abs_err=err)
                log(line)
                del q, x, scales
    return out


def _log_roofline(name: str, flops: float, ms: float, bound_ms: float, library_ms, **extra):
    """The redesigned kernels' line: achieved TFLOP/s, share of the bound,
    and time over one PyTorch call's."""
    ratio = "none" if library_ms is None else f"{ms / library_ms:.3f}"
    log(f"roofline {name}: tflops={flops / ms / 1e9:.2f} share_of_bound={bound_ms / ms:.4f} "
        f"ms_over_library_ms={ratio} " + " ".join(f"{k}={v:.4f}" for k, v in extra.items()))


def _merge_inputs(shape, integer: bool, g):
    """A walk's merge at ``shape``: a pool sorted as lax.top_k sorts it with
    an empty (-inf, -1) tail, and M new candidates with about a quarter
    invalid (-inf, -1); integer scores with exact ties and +-0 pairs, or
    float scores."""
    import torch

    from repro_torch.core.similarity import top_l

    b, l, m = shape

    def scores(cols):
        if integer:
            s = torch.randint(-4, 5, (b, cols), generator=g, device="cuda").float()
            neg = torch.rand((b, cols), generator=g, device="cuda") < 0.5
            return torch.where((s == 0) & neg, -0.0, s)
        return torch.randn((b, cols), generator=g, device="cuda")

    pool_s = scores(l)
    pool_i = torch.randint(0, N_FULL, (b, l), generator=g, device="cuda", dtype=torch.int32)
    n_empty = torch.randint(0, l // 2 + 1, (b, 1), generator=g, device="cuda")
    empty = torch.arange(l, device="cuda") >= l - n_empty
    pool_s = torch.where(empty, float("-inf"), pool_s)
    pool_i = torch.where(empty, -1, pool_i)
    pool_s, order = top_l(pool_s, l)
    pool_i = pool_i.gather(1, order)
    pool_c = ((torch.rand((b, l), generator=g, device="cuda") < 0.5) | (pool_i < 0)).int()
    new_s = scores(m)
    new_i = torch.randint(0, N_FULL, (b, m), generator=g, device="cuda", dtype=torch.int32)
    bad = torch.rand((b, m), generator=g, device="cuda") < 0.25
    new_s = torch.where(bad, float("-inf"), new_s)
    new_i = torch.where(bad, -1, new_i)
    return pool_s, pool_i, pool_c, new_s, new_i, bad.int()


def _merge_grid(b: int, c: int):
    """topk_merge's route and launch grid (blocks, threads) for B rows of C
    candidates, as csrc/topk_merge.cu launches them: up to C = 64 the sort
    route, a warp a row and 8 rows a block; past 64 the rank route, a block
    of 128 threads a row."""
    if c > 64:
        return "rank", (b, 128)
    return "sort", ((b + 7) // 8, 256)


def phase_topk_merge(g) -> dict:
    """topk_merge at the walk's merge shapes and at MERGE_WIDE_SHAPES against
    topk_merge_ref: a pure selection, so ids, flags and score bits are equal
    on integer and float inputs alike.  Beside each cell, the device time of
    an empty kernel on the same grid: the launch floor."""
    import torch

    from repro_torch.kernels import _lib
    from repro_torch.kernels.topk_merge import topk_merge, topk_merge_ref

    out = {}
    for cell, (b, l, m) in {**MERGE_SHAPES, **MERGE_WIDE_SHAPES}.items():
        route, grid = _merge_grid(b, l + m)
        floor_ms = None
        for kind in ("int", "float"):
            args = _merge_inputs((b, l, m), kind == "int", g)
            run = lambda: topk_merge(*args)  # noqa: E731
            plain = lambda: topk_merge_ref(*args)  # noqa: E731
            got, want = run(), plain()
            torch.cuda.synchronize()
            name = f"topk_merge {cell}/{kind}"
            for x, y, what in zip(got, want, ("scores", "ids", "checked")):
                assert torch.equal(x.view(torch.int32), y.view(torch.int32)), f"{name}: {what}"
            if kind == "int":
                zeros = want[0] == 0
                assert bool((zeros & torch.signbit(want[0])).any()) and bool(
                    (zeros & ~torch.signbit(want[0])).any()), f"{name}: no +-0 pair kept"
            assert bool((args[1] < 0).any()) and bool((args[4] < 0).any()), f"{name}: no -1 slot"
            err = _max_abs_err(got[0], want[0])
            if floor_ms is None:
                stream = _lib.stream(torch.device("cuda"))
                floor_ms = device_ms(lambda: _lib.check(_lib.lib().empty_launch(*grid, stream),
                                                        "empty_launch"))
            ms = device_ms(run)
            plain_ms = device_ms(plain)
            call_ms = cuda_ms(run)
            bound_ms, by = bound(b * (l + m) * 12 + b * l * 12, 0.0)
            log(f"kernel=topk_merge cell={cell} inputs={kind} B={b} L={l} M={m} "
                f"route={route} ms={ms:.4f} call_ms={call_ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms=None bound_ms={bound_ms:.5f} bound_by={by} "
                f"share_of_bound={bound_ms / ms:.4f} floor_ms={floor_ms:.4f} "
                f"(empty kernel, {grid[0]} x {grid[1]}) max_abs_err={err:.3g} "
                f"launches={topk_merge.launches}")
            if cell == "search_ip" and kind == "float":
                out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                           library_ms=None, max_abs_err=err)
            del args, got, want
    return out


def _flash_pairs(s: int, t: int, q_offset: int, window) -> int:
    """(query, key) pairs inside the causal (and window) mask: the work the
    inputs need."""
    import numpy as np

    pos = q_offset + np.arange(s)
    hi = np.minimum(pos, t - 1)
    lo = np.zeros_like(pos) if window is None else np.maximum(pos - window + 1, 0)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _sdpa(q, k, v, q_offset: int, window):
    """The library yardstick: one scaled_dot_product_attention call on the
    same inputs (heads first, grouped heads by ``enable_gqa``), causal by
    flag where the mask is plain causal, else by a boolean mask."""
    import torch
    import torch.nn.functional as F

    s, t = q.shape[1], k.shape[1]
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    mask = None
    if q_offset or window is not None or s != t:
        qi = q_offset + torch.arange(s, device=q.device)[:, None]
        ki = torch.arange(t, device=q.device)[None, :]
        mask = ki <= qi
        if window is not None:
            mask &= ki > qi - window
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                  is_causal=mask is None, enable_gqa=True)


def _flash_spread(q, k, v, q_offset: int, window):
    """sqrt(sum_t p_t^2 v_t^2) per output, [B, S, H, hd], in fp32 from the
    same inputs: p from fp32 scores, masked as the plain version masks."""
    import torch

    s, t, hd = q.shape[1], k.shape[1], q.shape[3]
    g = q.shape[2] // k.shape[2]
    qh = q.float().transpose(1, 2)
    kh, vh = (x.float().repeat_interleave(g, 2).transpose(1, 2) for x in (k, v))
    qi = q_offset + torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(t, device=q.device)[None, :]
    ok = ki <= qi
    if window is not None:
        ok &= ki > qi - window
    p = torch.softmax((qh @ kh.transpose(-1, -2) / hd ** 0.5).masked_fill(~ok, float("-inf")),
                      dim=-1).nan_to_num_(0.0)
    return (p.square_() @ vh.square()).sqrt_().transpose(1, 2)


def _flash_readings(name: str, diff, want, spread, rtol: float) -> None:
    """Logs the largest error, and its excess over ``rtol * |want|`` (alone
    and over the spread), by bin of |want| and by query row: the readings
    the tolerance is set from."""
    import torch

    a = want.abs()
    excess = diff - rtol * a
    ratio = excess / spread.clamp_min(1e-30)
    edges = (0.0, 2**-10, 2**-8, 2**-6, 2**-4, 2**-2, 1.0, 2.0, 4.0, float("inf"))
    bins = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (a >= lo) & (a < hi)
        if bool(m.any()):
            bins.append(f"[{lo:g},{hi:g}):n={int(m.sum())},err={float(diff[m].max()):.3g},"
                        f"excess={float(excess[m].max()):.3g}")
    s = want.shape[1]
    cuts = sorted({min(max(x, 0), s) for x in (0, 16, 256, s - 64, s)})
    rows = [f"rows[{lo},{hi}):excess={float(excess[:, lo:hi].max()):.3g},"
            f"excess/spread={float(ratio[:, lo:hi].max()):.3g}"
            for lo, hi in zip(cuts[:-1], cuts[1:])]
    log(f"flash_attn readings {name} rtol={rtol:g}: " + " ".join(bins + rows)
        + f" values_differing={int((diff > 0).sum())} of {diff.numel()}"
        + f" median_abs_out={float(torch.median(a.flatten()[::97])):.3g}"
        + f" median_spread={float(torch.median(spread.flatten()[::97])):.3g}")


def _check_flash(name: str, got, want, spread, tol):
    """Asserts |got - want| <= atol + rtol * |want| + c * spread everywhere
    (and got finite); logs the readings; returns the largest error and the
    largest excess over ``rtol * |want|`` divided by the spread."""
    import torch

    rtol, atol, c = tol
    assert bool(torch.isfinite(got).all()), f"flash_attn {name}: not finite"
    want = want.float()
    diff = (got.float() - want).abs()
    _flash_readings(name, diff, want, spread, rtol)
    bad = diff > atol + rtol * want.abs() + c * spread
    err = float(diff.max())
    assert not bool(bad.any()), (f"flash_attn {name}: {int(bad.sum())} values outside "
                                 f"rtol={rtol:g} atol={atol:g} c={c:g}, max_abs_err={err}")
    return err, float(((diff - rtol * want.abs()) / spread.clamp_min(1e-30)).max())


def _flash_inputs(shape, dtype, g):
    import torch

    b, s, t, h, kv, hd = shape[:6]
    return tuple(torch.randn(dims, generator=g, device="cuda").to(dtype)
                 for dims in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd)))


def _rows_without_keys(s: int, t: int, q_offset: int, window):
    """[S] bool: the query rows with no key in their window."""
    import torch

    pos = q_offset + torch.arange(s, device="cuda")
    seen = torch.minimum(pos, torch.tensor(t - 1, device="cuda")) + 1
    if window is not None:
        seen -= torch.clamp(pos - window + 1, min=0)
    return seen <= 0


def check_flash_cell(cell: str, shape, dtype, g):
    """flash_attention on seeded inputs at ``shape`` held to the plain version
    in the same dtype (FLASH_TOL), bf16 also to the plain version in fp32 on
    the same values, with p's bf16 rounding showing (FLASH_BF16_VS_FP32);
    rows with no key in their window must be exactly 0.  Returns (q, k, v,
    largest error, rows without keys)."""
    import torch

    from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref

    b, s, t, h, kv, hd, off, win = shape
    q, k, v = _flash_inputs(shape, dtype, g)
    got = flash_attention(q, k, v, q_offset=off, window=win)
    want = flash_attention_ref(q, k, v, q_offset=off, window=win)
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    spread = _flash_spread(q, k, v, off, win)
    err, _ = _check_flash(f"{cell}/{dname}", got, want, spread, FLASH_TOL[dname])
    empty = _rows_without_keys(s, t, off, win)
    assert bool((got[:, empty] == 0).all()), (
        f"flash_attn {cell}/{dname}: a row with no key is not 0")
    if dtype == torch.bfloat16:
        exact = flash_attention_ref(q.float(), k.float(), v.float(), q_offset=off, window=win)
        _, rounded = _check_flash(f"{cell}/{dname} vs fp32 plain", got, exact, spread,
                                  FLASH_BF16_VS_FP32)
        if not bool(empty.all()):
            assert rounded >= FLASH_P_ROUNDED, (
                f"flash_attn {cell}/{dname}: within {rounded:.3g} spread of fp32 arithmetic, "
                f"p was not rounded to bf16")
    return q, k, v, err, int(empty.sum())


def phase_flash_attn(g) -> dict:
    """flash_attention at granite-3-2b's and gemma3-12b's local attention
    widths, fp32 and bf16, and at the edges, against flash_attention_ref in
    the same dtype (check_flash_cell); each model cell timed beside SDPA and
    its bound, the fp32 kernel with its registers and spills."""
    import torch

    from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref

    out = {}
    for cell, shape in FLASH_SHAPES.items():
        b, s, t, h, kv, hd, off, win = shape
        for dtype in (torch.float32, torch.bfloat16):
            if cell.endswith("_offset") and dtype == torch.bfloat16:
                continue
            q, k, v, err, _ = check_flash_cell(cell, shape, dtype, g)
            run = lambda: flash_attention(q, k, v, q_offset=off, window=win)  # noqa: E731
            plain = lambda: flash_attention_ref(q, k, v, q_offset=off, window=win)  # noqa: E731
            dname = str(dtype).split(".")[-1]
            library = _sdpa(q, k, v, off, win)
            ms = device_ms(run, reps=5)
            plain_ms = device_ms(plain, reps=5)
            library_ms = device_ms(library, reps=5)
            call_ms = cuda_ms(run, reps=5)
            itemsize = q.element_size()
            nbytes = 2 * q.numel() * itemsize + (k.numel() + v.numel()) * itemsize
            flops = 4.0 * hd * _flash_pairs(s, t, off, win) * b * h
            rate = FP32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
            bound_ms, by = bound(nbytes, flops, rate)
            usage = ""
            if dtype == torch.float32:
                regs = ptxas_usage(f"flash_attn_f32_kernelILi{hd}E")
                usage = " ".join(f"registers={r} spill_stores={st} spill_loads={ld}"
                                 for r, st, ld in regs.values())
            log(f"kernel=flash_attn cell={cell} dtype={dname} B={b} S={s} T={t} H={h} KV={kv} "
                f"hd={hd} q_offset={off} window={win} flops={flops:.4g} ms={ms:.4f} "
                f"call_ms={call_ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
                f"bound_ms={bound_ms:.5f} bound_by={by} (rate {rate / 1e12:.0f} TFLOP/s) "
                f"share_of_bound={bound_ms / ms:.4f} rtol, atol, c={FLASH_TOL[dname]} "
                f"max_abs_err={err:.3g} {usage}")
            _log_roofline(f"flash_attn[{dname}] {cell}", flops, ms, bound_ms, library_ms)
            if cell == "granite_3_2b":
                key = "flash_attn" if dtype == torch.float32 else "flash_attn_bf16"
                out[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                                library_ms=library_ms, max_abs_err=err)
            del q, k, v
            torch.cuda.empty_cache()
    for cell, shape in FLASH_EDGE_SHAPES.items():
        b, s, t, h, kv, hd, off, win = shape
        for dtype in (torch.float32, torch.bfloat16):
            *_, err, n_empty = check_flash_cell(cell, shape, dtype, g)
            log(f"kernel=flash_attn edge={cell} dtype={str(dtype).split('.')[-1]} B={b} S={s} "
                f"T={t} H={h} KV={kv} hd={hd} q_offset={off} window={win} "
                f"rows_without_keys={n_empty} max_abs_err={err:.3g}")
    return out


def phase_entry_points(g) -> dict:
    """topk_merge, flash_attn, the per-step beam_step kernels (the walks
    launch beam_walk) and the int8 select route of mips_topk have no system
    caller: their path is their own public entry point.  Each is driven
    once (topk_merge and flash_attn at every shape above, beam_step in its
    four variants at the search IP step, mips_topk at k = 33 over an int8
    store), with the counts set to 0 just before; returns the counts read
    just after."""
    import torch

    from repro_torch.kernels.beam_step import beam_step
    from repro_torch.kernels.flash_attn import flash_attention, flash_attention_head
    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.kernels.topk_merge import topk_merge

    merges = [_merge_inputs(shape, False, g) for shape in MERGE_SHAPES.values()]
    items = _int_or_float((N_FULL, D_FULL), False, g)
    codes, scales = _int8_store(items, False, g)
    half_dead = torch.rand(N_FULL, generator=g, device="cuda") >= 0.5
    steps = [(_beam_state(BEAM_SHAPES["search_ip"], rows, sc, False, g), sc, live)
             for rows, sc in ((items, None), (codes, scales)) for live in (None, half_dead)]
    q = _int_or_float((256, 64), False, g)
    wide = _int8_store(_int_or_float((20_000, 64), False, g), False, g)
    _zero_counts()
    for args in merges:
        topk_merge(*args)
    for args, sc, live in steps:
        beam_step(*args, sc, live)
    mips_topk(q, *wide, k=33)
    for (b, s, t, h, kv, hd, off, win) in FLASH_SHAPES.values():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _flash_inputs((b, s, t, h, kv, hd), dtype, g)
            out = flash_attention(q, k, v, q_offset=off, window=win)
            assert out.shape == q.shape and bool(torch.isfinite(out).all())
            head = flash_attention_head(*(x[0, :, 0].contiguous() for x in (q, k, v)),
                                        q_offset=off, window=win)
            assert head.shape == (s, hd) and bool(torch.isfinite(head).all())
    torch.cuda.synchronize()
    counts = _read_counts()
    log(f"entry points topk_merge / flash_attention / flash_attention_head / beam_step / "
        f"mips_topk (k 33, int8): launches={counts}")
    for name in ENTRY_ONLY:
        assert counts[name] > 0, f"{name} was not launched: {counts}"
    return {name: counts[name] for name in ENTRY_ONLY}


def phase_kernels() -> dict:
    import torch

    warm_up_profiler()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    items_by_kind = {kind: _int_or_float((N_FULL, D_FULL), kind == "int", g)
                     for kind in ("int", "float")}
    stores_by_kind = {kind: _int8_store(items, kind == "int", g)
                      for kind, items in items_by_kind.items()}
    beam = phase_beam_step(items_by_kind, stores_by_kind, g)
    scorers = phase_scorers(items_by_kind, stores_by_kind, g)
    commit = phase_commit_merge(items_by_kind, g)
    mips = phase_mips_topk(g)
    merge = phase_topk_merge(g)
    flash = phase_flash_attn(g)
    walk = phase_beam_walk(items_by_kind, stores_by_kind, g)
    torch.cuda.empty_cache()
    timings = {
        "beam_step": beam["f32"],
        "beam_step_int8": beam["int8"],
        "beam_step_live": beam["f32_live"],
        "beam_step_int8_live": beam["int8_live"],
        "beam_walk": walk["f32"],
        "beam_walk_int8": walk["int8"],
        "beam_walk_live": walk["f32_live"],
        "beam_walk_int8_live": walk["int8_live"],
        "commit_merge": commit,
        "mips_topk": mips["f32"],
        "mips_topk_int8": mips["int8"],
        "mips_topk_select": mips["select_f32"],
        "mips_topk_select_int8": mips["select_int8"],
        "quant_score": scorers["quant_score"],
        "gather_score": scorers["gather_score"],
        "topk_merge": merge,
        "flash_attn": flash["flash_attn"],
        "flash_attn_bf16": flash["flash_attn_bf16"],
    }
    log(f"kernels: {', '.join(timings)} -- each equal to its plain version")
    return timings, phase_entry_points(g)


def _kernel_counters():
    """name -> (wrapper, attribute of its launch count)."""
    from repro_torch.kernels.beam_step import beam_step, beam_walk
    from repro_torch.kernels.commit_merge import commit_merge
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.gather_score import gather_score
    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.kernels.quant_score import quant_score
    from repro_torch.kernels.topk_merge import topk_merge

    return {"beam_step": (beam_step, "launches"),
            "beam_step_int8": (beam_step, "launches_int8"),
            "beam_step_live": (beam_step, "launches_live"),
            "beam_step_int8_live": (beam_step, "launches_int8_live"),
            "beam_walk": (beam_walk, "launches"),
            "beam_walk_int8": (beam_walk, "launches_int8"),
            "beam_walk_live": (beam_walk, "launches_live"),
            "beam_walk_int8_live": (beam_walk, "launches_int8_live"),
            "commit_merge": (commit_merge, "launches"),
            "mips_topk": (mips_topk, "launches"),
            "mips_topk_int8": (mips_topk, "launches_int8"),
            "mips_topk_select": (mips_topk, "launches_select"),
            "mips_topk_select_int8": (mips_topk, "launches_select_int8"),
            "quant_score": (quant_score, "launches"),
            "gather_score": (gather_score, "launches"),
            "topk_merge": (topk_merge, "launches"),
            "flash_attn": (flash_attention, "launches"),
            "flash_attn_bf16": (flash_attention, "launches_bf16")}


def _zero_counts() -> None:
    from repro_torch.kernels.beam_step import beam_walk

    for fn, attr in _kernel_counters().values():
        setattr(fn, attr, 0)
    beam_walk.steps = 0
    for by_width in _widths().values():
        by_width.clear()
    for tally in _IN_GRAPHS.values():
        tally.clear()


def _widths() -> dict:
    """The gathered scorers' launches by W, the ids' width (plain dicts)."""
    from repro_torch.kernels.gather_score import gather_score
    from repro_torch.kernels.quant_score import quant_score

    return {"gather_score": gather_score.launches_by_width,
            "quant_score": quant_score.launches_by_width}


def _wrapper_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _kernel_counters().items()}


# A wrapper called while a CUDA graph is captured records its kernel into the
# graph, which launches it at every replay.  So a kernel's launches are its
# wrapper's calls outside captures, plus its calls inside each capture times
# that graph's replays.
_GRAPH_KERNELS: dict = {}  # id(graph) -> {kernel: wrapper calls inside its capture}
_IN_GRAPHS = {"recorded": {}, "replayed": {}}  # since the last _zero_counts


def _tally(into: dict, counts: dict) -> None:
    for name, n in counts.items():
        into[name] = into.get(name, 0) + n


def count_graph_launches() -> None:
    """Patch torch.cuda.CUDAGraph so that each capture records the wrapper
    calls made inside it and each replay adds them to the launch counts."""
    import torch

    cls = torch.cuda.CUDAGraph
    begin, end, replay = cls.capture_begin, cls.capture_end, cls.replay

    def capture_begin(graph, *args, **kwargs):
        _GRAPH_KERNELS[id(graph)] = _wrapper_counts()
        begin(graph, *args, **kwargs)

    def capture_end(graph):
        end(graph)
        before, after = _GRAPH_KERNELS[id(graph)], _wrapper_counts()
        inside = {name: after[name] - before[name] for name in after
                  if after[name] != before[name]}
        _GRAPH_KERNELS[id(graph)] = inside
        _tally(_IN_GRAPHS["recorded"], inside)

    def counted_replay(graph):
        replay(graph)
        _tally(_IN_GRAPHS["replayed"], _GRAPH_KERNELS.get(id(graph), {}))

    cls.capture_begin, cls.capture_end, cls.replay = capture_begin, capture_end, counted_replay


def _read_counts() -> dict:
    """Each kernel's launches since the last ``_zero_counts``: its
    wrapper's calls, less those made while a graph was captured (they
    launched nothing), plus the launches of every graph replay."""
    counts = _wrapper_counts()
    for name in counts:
        counts[name] += (_IN_GRAPHS["replayed"].get(name, 0)
                         - _IN_GRAPHS["recorded"].get(name, 0))
    return counts


# the per-step kernels: the walks launch beam_walk, these only their entry
# point (and the per-step loop that phase 3 and the before/after runs time)
STEP_KERNELS = ("beam_step", "beam_step_int8", "beam_step_live", "beam_step_int8_live")


def _walk_steps() -> int:
    """Walk steps so far: beam_walk's step counts, and one a launch of the
    per-step kernel (the per-step loop)."""
    from repro_torch.kernels.beam_step import beam_walk

    counts = _read_counts()
    return beam_walk.steps + sum(counts[name] for name in STEP_KERNELS)


def _assert_path(label: str, counts: dict, path) -> None:
    """Every kernel of ``path`` launched, and no per-step kernel: a system
    path walks with beam_walk."""
    assert all(counts[name] > 0 for name in path), f"{label}: a kernel was not launched: {counts}"
    assert not any(counts[name] for name in STEP_KERNELS), \
        f"{label}: a per-step kernel was launched: {counts}"


# kernels each serve path must launch (the exact scan runs once, the walks
# score their seeds with gather_score or quant_score); --k 33 takes the
# select route of the exact scan
SERVE_PATHS = {
    "f32": (JAX_SERVE_RECALL, [], ("beam_walk", "commit_merge", "mips_topk", "gather_score")),
    "int8": (JAX_SERVE_RECALL_INT8, [], ("beam_walk", "beam_walk_int8", "commit_merge",
                                         "mips_topk", "quant_score", "gather_score")),
    "f32_k33": (None, ["--k", "33"], ("beam_walk", "commit_merge", "mips_topk_select",
                                      "gather_score")),
    # the scan build driver: the graph is the host driver's, so the recall
    # must be the host run's exactly
    "f32_scan": (JAX_SERVE_RECALL, ["--build-backend", "scan"],
                 ("beam_walk", "commit_merge", "mips_topk", "gather_score")),
    "int8_scan": (JAX_SERVE_RECALL_INT8, ["--build-backend", "scan"],
                  ("beam_walk", "beam_walk_int8", "commit_merge", "mips_topk", "quant_score",
                   "gather_score")),
}


def phase_serve_default() -> dict:
    """The serve one-shots; returns the launches of the --k 33 run.  A
    ``_scan`` run (``--build-backend scan``) must give its host run's
    recall exactly."""
    from repro_torch.launch import serve

    recalls, launches = {}, {}
    for name, (jax_recall, flags, path) in SERVE_PATHS.items():
        storage = name.split("_")[0]
        _zero_counts()
        res = serve.main(["--index", "ipnsw_plus", "--storage", storage, *flags])
        counts = launches[name] = _read_counts()
        recalls[name] = res["recall"]
        if name.endswith("_scan"):
            assert res["recall"] == recalls[storage], \
                f"serve {name}: recall {res['recall']} != the host driver's {recalls[storage]}"
        log(f"serve default {name}: recall@k={res['recall']:.4f} "
            f"(JAX {jax_recall}) evals/q={res['evals_per_query']:.1f} "
            f"search_ms={res['search_seconds'] * 1e3:.3f} launches={counts}")
        if jax_recall is not None:
            assert abs(res["recall"] - jax_recall) <= RECALL_MARGIN, \
                f"serve {storage} recall {res['recall']} not within {RECALL_MARGIN} of JAX {jax_recall}"
        else:
            assert res["recall"] > 0.5, f"serve {name}: recall {res['recall']}"
        _assert_path(f"serve {name}", counts, path)
    return launches["f32_k33"]


def phase_full_size() -> dict:
    import torch

    from repro_torch.core.brute_force import exact_topk
    from repro_torch.core.invariants import assert_graph_invariants
    from repro_torch.core.ipnsw import IpNSW
    from repro_torch.core.ipnsw_plus import IpNSWPlus
    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.obs.recall import recall_at_k
    from repro_torch.data import mips_dataset, mips_queries

    items = torch.as_tensor(mips_dataset(N_FULL, D_FULL, "lognormal", seed=0), device="cuda")
    queries = torch.as_tensor(mips_queries(256, D_FULL, seed=1), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    _, gt = exact_topk(queries, items, k=10)
    gt = gt.cpu().numpy()
    searched = {}
    for name, cls in (("ipnsw_plus", IpNSWPlus), ("ipnsw", IpNSW)):
        t0 = time.perf_counter()
        index = cls(max_degree=16, ef_construction=32, insert_batch=512).build(items)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        graphs = ([("ang", index.ang_graph), ("ip", index.ip_graph)]
                  if name == "ipnsw_plus" else [("ip", index.graph)])
        for gname, graph in graphs:
            assert_graph_invariants(graph, name=f"{name}/{gname}")
        recall = {}
        for storage in ("f32", "int8"):
            index.search(queries, k=10, ef=40, storage=storage)  # warm-up (int8: the store)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = index.search(queries, k=10, ef=40, storage=storage)
            torch.cuda.synchronize()
            search_s = time.perf_counter() - t0
            recall[storage] = recall_at_k(r.ids.cpu().numpy(), gt)
            searched[name, storage] = (index, r, recall[storage])
            log(f"full size {name}: storage={storage} N={N_FULL} d={D_FULL} B=256 k=10 ef=40 "
                f"build_s={build_s:.2f} search_ms={search_s * 1e3:.3f} "
                f"qps={256 / search_s:.0f} recall@10={recall[storage]:.4f} "
                f"evals/q={float(r.evals.float().mean()):.1f} invariants I1-I4 hold")
        assert recall["f32"] > 0.5, f"{name} recall@10 {recall['f32']} at full size"
        assert recall["int8"] >= recall["f32"] - RECALL_MARGIN, \
            f"{name} int8 recall@10 {recall['int8']} below f32 {recall['f32']} - {RECALL_MARGIN}"
    # the int8 store's linear scan: quantized scores, no rerank
    store = index.store
    t0 = time.perf_counter()
    _, scan_ids = mips_topk(queries, store.codes, store.scales, k=10)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    scan_recall = recall_at_k(scan_ids.cpu().numpy(), gt)
    log(f"full size int8 quantized scan: recall@10={scan_recall:.4f} "
        f"ms={scan_s * 1e3:.3f} (first call)")
    assert scan_recall > 0.5, f"quantized scan recall@10 {scan_recall}"
    counts = _read_counts()
    log(f"full size peak_memory_bytes={torch.cuda.max_memory_allocated()} launches={counts}")
    log("full size launches by width: " + " ".join(
        f"{name}={dict(sorted(by_width.items()))}" for name, by_width in _widths().items()))
    live = [name for name in counts if name.endswith("_live")]
    _assert_path("full size", counts, [name for name in counts
                                       if name not in live + list(ENTRY_ONLY) + list(K33_PATH)])
    assert not any(counts[name] for name in live), f"a frozen index launched a live kernel: {counts}"
    phase_walk_before_after(searched, queries, gt)
    phase_scan_build(items, queries, searched)
    phase_profile(items, queries, index)
    return counts


def phase_walk_before_after(searched, queries, gt) -> None:
    """The before and after of the fused walk on one card: a full-size
    search launches one walk kernel a walk (two for ip-NSW+); each search
    again with per-step walks (the host loop of the beam_step kernel),
    every output equal to the fused walk's, recall@10 equal; then
    IpNSW's f32 and int8 searches timed with each, in turns (fused first in
    even pairs)."""
    import numpy as np
    import torch

    from repro_torch.obs.recall import recall_at_k

    walks = ("beam_walk", "beam_walk_int8")
    for (name, storage), (index, fused, recall) in searched.items():
        before = _read_counts()
        index.search(queries, k=10, ef=40, storage=storage)
        launched = sum(_read_counts()[w] - before[w] for w in walks)
        assert launched == (2 if name == "ipnsw_plus" else 1), \
            f"full size {name} {storage}: a search launched {launched} walk kernels"
        with per_step_walks():
            looped = index.search(queries, k=10, ef=40, storage=storage)
        torch.cuda.synchronize()
        for field, x in zip(fused._fields, fused):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, getattr(looped, field)), \
                    f"full size {name} {storage}: {field} differs from the per-step loop's"
            else:
                assert x == getattr(looped, field), f"full size {name} {storage}: {field}"
        rec = recall_at_k(looped.ids.cpu().numpy(), gt)
        assert rec == recall, f"full size {name} {storage}: recall {rec} != {recall}"
        log(f"full size {name} storage={storage}: one search, {launched} walk launch(es); the "
            f"per-step loop's outputs equal the fused walk's, recall@10={rec:.4f} both")
    for storage in ("f32", "int8"):
        index = searched["ipnsw", storage][0]
        times = {"fused": [], "per_step": []}
        for pair in range(6):
            for mode in (("fused", "per_step") if pair % 2 == 0 else ("per_step", "fused")):
                with per_step_walks() if mode == "per_step" else contextlib.nullcontext():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    index.search(queries, k=10, ef=40, storage=storage)
                    torch.cuda.synchronize()
                times[mode].append((time.perf_counter() - t0) * 1e3)
        log(f"full size ipnsw search storage={storage} B=256 ef=40 ms " + " ".join(
            f"{mode}_median={np.median(t):.4f} {mode}={['%.4f' % x for x in t]}"
            for mode, t in times.items())
            + f" speedup={np.median(times['per_step']) / np.median(times['fused']):.2f}")


@contextlib.contextmanager
def watch_replays():
    """Inside, every ``torch.cuda.CUDAGraph.replay`` is counted, with the
    sync debug mode it ran under (2: "error")."""
    import torch

    seen = {"replays": 0, "modes": set()}
    replay = torch.cuda.CUDAGraph.replay

    def counted(graph):
        seen["replays"] += 1
        seen["modes"].add(torch.cuda.get_sync_debug_mode())
        replay(graph)

    torch.cuda.CUDAGraph.replay = counted
    try:
        yield seen
    finally:
        torch.cuda.CUDAGraph.replay = replay


def phase_scan_build(items, queries, searched) -> None:
    """Phase 5c: the scan build driver at full size, for IpNSWPlus and
    IpNSW.  One insertion batch is captured as a CUDA graph and replayed for
    rows 1 .. T-1 of the schedule (row 0 is the eager warm-up), every
    replay under set_sync_debug_mode("error"); adjacency, size, entry and
    entry_norm of every graph equal to the host driver's bit for bit (phase
    5's indexes), and so every search's ids and recall@10; then both drivers
    timed in turns (host, scan, scan, host): build wall s, and for the scan
    its capture ms, host ms per replay and the replay loop's device ms (CUDA
    events)."""
    import numpy as np
    import torch

    from repro_torch.core.build import batch_schedule, replay_schedule
    from repro_torch.core.ipnsw import IpNSW
    from repro_torch.core.ipnsw_plus import IpNSWPlus

    rows = batch_schedule(N_FULL, 512)[1].shape[0]
    for name, cls in (("ipnsw_plus", IpNSWPlus), ("ipnsw", IpNSW)):
        def build(driver):
            return cls(max_degree=16, ef_construction=32, insert_batch=512,
                       build_backend=driver).build(items)

        host = searched[name, "f32"][0]
        _zero_counts()
        with watch_replays() as seen:
            scan = build("scan")
        torch.cuda.synchronize()
        counts = _read_counts()
        n_graphs = 2 if name == "ipnsw_plus" else 1
        assert seen == {"replays": rows - 1, "modes": {2}}, \
            f"scan build {name}: replays {seen}, expected {rows - 1} under sync debug mode 2"
        assert replay_schedule.last.replays == rows - 1
        _assert_path(f"scan build {name}", counts, ("beam_walk", "commit_merge", "gather_score"))
        # row 0's eager warm-up and the replays launch a walk a graph each
        assert counts["beam_walk"] == rows * n_graphs, counts
        gnames = ("ang_graph", "ip_graph") if name == "ipnsw_plus" else ("graph",)
        for gname in gnames:
            for field in ("adj", "size", "entry", "entry_norm"):
                assert torch.equal(getattr(getattr(host, gname), field),
                                   getattr(getattr(scan, gname), field)), \
                    f"scan build {name}: {gname}.{field} differs from the host driver's"
        for storage in ("f32", "int8"):
            _, host_res, host_recall = searched[name, storage]
            res = scan.search(queries, k=10, ef=40, storage=storage)
            assert torch.equal(res.ids, host_res.ids), f"scan build {name} {storage}: ids differ"
            log(f"scan build {name}: storage={storage} recall@10={host_recall:.4f}, ids equal to "
                f"the host driver's index")
        log(f"scan build {name}: {rows} batches of 512, {seen['replays']} graph replays, all "
            f"under sync debug mode error (0 syncs in the replay loop); {', '.join(gnames)} "
            f"adj, size, entry, entry_norm bit-identical to the host driver's; launches={counts}")
        walls = {"host": [], "scan": []}
        runs = []
        for driver in ("host", "scan", "scan", "host"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            build(driver)
            torch.cuda.synchronize()
            walls[driver].append(time.perf_counter() - t0)
            if driver == "scan":
                run = replay_schedule.last
                runs.append((run.capture_ms, run.loop_host_ms / run.replays,
                             run.loop_events[0].elapsed_time(run.loop_events[1])))
        log(f"scan build {name} timings (turns host, scan, scan, host): "
            f"host_build_s={['%.4f' % x for x in walls['host']]} "
            f"scan_build_s={['%.4f' % x for x in walls['scan']]} "
            f"capture_ms={['%.2f' % r[0] for r in runs]} "
            f"host_ms_per_replay={['%.4f' % r[1] for r in runs]} "
            f"replay_loop_device_ms={['%.2f' % r[2] for r in runs]} "
            f"speedup={np.median(walls['host']) / np.median(walls['scan']):.2f}")


class _WatchedClock:
    """A loop clock that records how far each sleep overshot its target
    (the host's scheduling, not the loop's work)."""

    def __init__(self, clock):
        self.clock, self.virtual = clock, clock.virtual
        self.sleeps, self.overshoot_ms, self.overshoot_at = 0, 0.0, 0.0

    def now(self) -> float:
        return self.clock.now()

    def sleep_until(self, t: float) -> None:
        self.clock.sleep_until(t)
        self.sleeps += 1
        late = (self.clock.now() - t) * 1e3
        if late > self.overshoot_ms:
            self.overshoot_ms, self.overshoot_at = late, t


@contextlib.contextmanager
def gc_pauses():
    """Inside, every garbage collection is recorded: (generation, ms)."""
    pauses, t0 = [], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            t0[0] = time.perf_counter()
        else:
            pauses.append((info["generation"], round((time.perf_counter() - t0[0]) * 1e3, 4)))

    gc.callbacks.append(on_gc)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(on_gc)


def _loop_report(label: str, stats, gt) -> dict:
    """Print and return a loop run's metrics: latency percentiles, QPS,
    occupancy, misses, degraded share and recall@10, by request id."""
    import numpy as np

    from repro_torch.obs.recall import recall_at_k

    by_rid = sorted(stats.responses, key=lambda r: r.rid)
    s = stats.summary()
    out = dict(p50_ms=s["p50_ms"], p99_ms=s["p99_ms"], qps=s["qps"], occupancy=s["occupancy"],
               deadline_miss_frac=s["deadline_miss_frac"],
               degraded_share=float(np.mean([r.degraded for r in by_rid])),
               recall=recall_at_k(np.stack([r.ids for r in by_rid]), gt),
               batches=s["batches"], served=s["served"],
               recompiles_warmup=s["recompiles_warmup"],
               recompiles_steady=s["recompiles_steady"],
               ef_served={e: sum(r.ef_served == e for r in by_rid)
                          for e in sorted({r.ef_served for r in by_rid})})
    log(f"loop full {label}: " + " ".join(f"{k}={v!r}" for k, v in out.items()))
    # each dispatch's duration on the loop's clock, and where the longest was
    took = np.asarray([(b.finish_t - b.dispatch_t) * 1e3 for b in stats.batches])
    worst = int(np.argmax(took))
    first = {}
    for b, t in zip(stats.batches, took):
        first.setdefault(f"{b.bucket.batch}x{b.bucket.ef}", (b.seq, round(float(t), 4)))
    log(f"loop full {label}: dispatch_ms median={np.median(took):.4f} p99="
        f"{np.percentile(took, 99):.4f} max={took[worst]:.4f} at seq {worst} "
        f"({stats.batches[worst].bucket}); each bucket's first dispatch (seq, ms)={first}")
    # the longest a batch's first request waited while the loop did not
    # dispatch: after the previous batch finished and after it arrived
    arrival = {r.rid: r.arrival_t for r in by_rid}
    held = [(b.dispatch_t - max(prev.finish_t, min(arrival[i] for i in b.rids))) * 1e3
            for prev, b in zip(stats.batches, stats.batches[1:])]
    if held:
        i = int(np.argmax(held))
        b = stats.batches[i + 1]
        log(f"loop full {label}: longest wait before a dispatch {held[i]:.4f} ms, before seq "
            f"{i + 1} ({len(b.rids)} requests, dispatched at {b.dispatch_t:.4f} s); the first "
            f"dispatch at {stats.batches[0].dispatch_t:.4f} s")
    return out


def phase_loop_full() -> dict:
    """The serving loop at Yahoo!Music's size: an IpNSWPlus over 136,736 x
    300 items, 4,096 Poisson requests at 2,000 QPS in three deadline
    classes, _build_ladder(256, 40); wall clock with the f32 and the int8
    store, and the virtual clock with f32.  Every bucket is a CUDA graph:
    each dispatch of a run replays one."""
    import functools

    import numpy as np
    import torch

    from repro_torch.core.brute_force import exact_topk
    from repro_torch.core.ipnsw_plus import IpNSWPlus
    from repro_torch.data import mips_dataset, mips_queries
    from repro_torch.launch import serve_loop as sl
    from repro_torch.launch.serve import _build_ladder

    items = torch.as_tensor(mips_dataset(N_FULL, D_FULL, "lognormal", seed=0), device="cuda")
    queries = mips_queries(LOOP_FULL_REQUESTS, D_FULL, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    index = IpNSWPlus(max_degree=16, ef_construction=32, insert_batch=512).build(items)
    _zero_counts()  # the serving path: the ground truth, then the three runs
    _, gt = exact_topk(torch.as_tensor(queries, device="cuda"), items, k=10)
    gt = gt.cpu().numpy()
    ladder = _build_ladder(256, 40)
    trace = sl.poisson_trace(queries, rate_qps=LOOP_FULL_RATE, seed=2, ef=40,
                             classes=("interactive", "standard", "relaxed"))
    runs, stats_by, executors, peaks = {}, {}, {}, {}
    for label, storage, clock in (("wall_f32", "f32", sl.WallClock),
                                  ("wall_int8", "int8", sl.WallClock),
                                  ("virtual_f32", "f32", sl.VirtualClock)):
        index.storage = storage
        executor = sl.BucketExecutor(index, ladder, k=10)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        executor.warmup()  # before the clock starts: the trace meets a warm server
        torch.cuda.synchronize()
        graphs_bytes = torch.cuda.memory_allocated() - held
        # set-up, before the clock starts: the earlier phases' garbage (the
        # profiler's events hold one another in cycles) is collected here,
        # not inside the timed run
        t0 = time.perf_counter()
        freed = gc.collect()
        log(f"loop full {label}: before the run, {freed} objects of garbage collected in "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        loop = sl.ServeLoop(index, ladder=ladder, clock=_WatchedClock(clock()),
                            executor=executor, service_model=sl.LinearServiceModel())
        with watch_replays() as seen, gc_pauses() as pauses:
            stats = loop.run(trace)
        log(f"loop full {label}: clock sleeps {loop.clock.sleeps}, longest overshoot "
            f"{loop.clock.overshoot_ms:.4f} ms waking at {loop.clock.overshoot_at:.4f} s")
        log(f"loop full {label}: garbage collections in the run {len(pauses)}, ms "
            f"total={sum(ms for _, ms in pauses):.4f} longest={max(pauses, key=lambda x: x[1])}"
            if pauses else f"loop full {label}: no garbage collection in the run")
        stats_by[label], executors[label] = stats, executor
        runs[label] = _loop_report(label, stats, gt)
        assert runs[label]["served"] == LOOP_FULL_REQUESTS, f"{label}: a request was not answered"
        assert runs[label]["recompiles_steady"] == 0, f"{label}: a steady-state build"
        assert runs[label]["recall"] > 0.5, f"{label}: recall {runs[label]['recall']}"
        _assert_replays(f"loop full {label}", seen, runs[label]["batches"])
        peaks[label] = torch.cuda.max_memory_allocated()
        log(f"loop full {label}: the six bucket graphs hold {graphs_bytes} bytes")
    counts = _read_counts()
    peak = max(peaks.values())
    # the same buckets dispatched eagerly, in a fresh peak window
    for label in ("wall_f32", "wall_int8"):
        index.storage = label.split("_")[1]
        _check_replays_equal_eager(f"loop full {label}", executors[label], queries)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for bucket in ladder.buckets():
        _eager_bucket(executors["wall_int8"], bucket)
    index.storage = "f32"
    for bucket in ladder.buckets():
        _eager_bucket(executors["wall_f32"], bucket)
    log(f"loop full: peak_memory_bytes with captured buckets {peaks}; eager dispatches of "
        f"every bucket, f32 and int8: {torch.cuda.max_memory_allocated()}")
    # A response depends only on its query and its served ef (padding and
    # batch composition do not change a row), so the virtual and the wall
    # f32 runs must agree on every request served at the same ef.
    wall = {r.rid: r for r in stats_by["wall_f32"].responses}
    virt = {r.rid: r for r in stats_by["virtual_f32"].responses}
    same = [rid for rid in wall if wall[rid].ef_served == virt[rid].ef_served]
    assert all(np.array_equal(wall[r].ids, virt[r].ids) for r in same), \
        "wall and virtual runs differ on a request served at the same ef"
    log(f"loop full: requests served at the same ef in the wall and virtual f32 runs "
        f"{len(same)} of {LOOP_FULL_REQUESTS}, ids identical on all of them; "
        f"peak_memory_bytes={peak} launches={counts}")
    _assert_path("loop full", counts, ("beam_walk", "beam_walk_int8", "mips_topk", "quant_score",
                                       "gather_score"))
    full = sl.Bucket(256, 40)
    executor = executors["wall_f32"]
    dispatch = functools.partial(executor.run, full, queries[:256], np.ones(256, bool))
    dispatch()  # the program's buffers now hold what the eager runs search
    label = "loop dispatch of a full 256x40 bucket, f32"
    with per_step_walks():
        _profiled(f"{label} [eager, per-step loop]",
                  lambda: _eager_bucket(executor, full, capturable=False), batches=1, reps=20)
    _profiled(f"{label} [eager]", lambda: _eager_bucket(executor, full), batches=1, reps=20)
    _profiled(f"{label} [captured]", dispatch, batches=1, reps=20)
    return runs


# kernels whose only path is their own entry point (phase_entry_points)
ENTRY_ONLY = ("topk_merge", "flash_attn", "flash_attn_bf16", *STEP_KERNELS,
              "mips_topk_select_int8")
# kernels whose path is serve --k 33 (phase 4)
K33_PATH = ("mips_topk_select",)

# kernels each serving-loop path must launch: the build, the ground truth,
# the walks' steps and seeds (f32: gather_score; int8: quant_score, and
# gather_score for the rerank); under churn the live walks of the searches
# and the upserts, and their commits
LOOP_PATHS = {
    "f32": ([], ("beam_walk", "commit_merge", "mips_topk", "gather_score")),
    "int8": (["--storage", "int8"], ("beam_walk", "beam_walk_int8", "commit_merge",
                                     "mips_topk", "quant_score", "gather_score")),
    "churn": (["--churn-trace", "0.2"], ("beam_walk", "beam_walk_live", "commit_merge",
                                         "mips_topk", "gather_score")),
}


def phase_serve_loop_default() -> None:
    """serve --loop at the JAX CLI's defaults, virtual clock: the schedule,
    the service model's latencies, the churn events and health equal to the
    JAX package's; recall@10 within 0.02 of it."""
    from repro_torch.launch import serve
    from repro_torch.launch.serve_loop import schedule_digest

    for name, (flags, path) in LOOP_PATHS.items():
        _zero_counts()
        t0 = time.perf_counter()
        with watch_replays() as seen:
            res = serve.main(["--loop", *flags])
        wall = time.perf_counter() - t0
        counts = _read_counts()
        s, digest = res["summary"], schedule_digest(res["batches"])
        log(f"serve --loop {name}: recall@10={res['recall']!r} (JAX "
            f"{JAX_LOOP_RECALL[name]!r}) schedule_sha256={digest} summary={s} "
            f"wall_s={wall:.2f} launches={counts}")
        # every dispatch replays its bucket's graph (warmup captured them),
        # and under churn every upsert chunk after the first replays its own
        _assert_replays(f"loop {name}", seen, s["batches"] + (
            LOOP_CHURN_UPSERTS - 1 if name == "churn" else 0))
        assert abs(res["recall"] - JAX_LOOP_RECALL[name]) <= RECALL_MARGIN, \
            f"loop {name} recall {res['recall']} not within {RECALL_MARGIN} of JAX"
        assert digest == JAX_LOOP_SCHEDULE_SHA256, f"loop {name}: the schedule differs from JAX's"
        for key, want in JAX_LOOP_SUMMARY.items():
            assert s[key] == want, f"loop {name}: {key}={s[key]!r}, JAX {want!r}"
        if name == "churn":
            assert s["mutation_events"] == JAX_LOOP_CHURN["mutation_events"], s
            for key in ("health_live_fraction", "health_dead_edge_frac"):
                assert f"{s[key]:.3f}" == f"{JAX_LOOP_CHURN[key]:.3f}", f"loop churn: {key}"
            assert s["health_relink_debt"] == JAX_LOOP_CHURN["health_relink_debt"], s
        else:
            assert s["mutation_events"] == 0, s
        _assert_path(f"loop {name}", counts, path)


# serve --loop --churn-trace 0.2: round(0.2 * 20,000 / 32) upsert events of
# 32 rows, one chunk each at mutation_batch 32
LOOP_CHURN_UPSERTS = 125


def _upsert_chunks(events, mutation_batch: int) -> int:
    return sum(-(-len(ev.items) // mutation_batch) for ev in events if ev.kind == "upsert")


def _assert_replays(label: str, seen: dict, want: int) -> None:
    """``want`` graph replays, every one under sync debug mode "error"."""
    assert seen["replays"] == want and seen["modes"] <= {2}, \
        f"{label}: {seen['replays']} replays under modes {seen['modes']}, expected {want} " \
        f"under sync debug mode 2"
    log(f"{label}: {want} CUDA graph replays, every one under sync debug mode error")


@contextlib.contextmanager
def eager_upserts():
    """Inside, every upsert chunk of a MutableIndex runs eagerly on the card
    (``upsert_step`` on the chunk), not as a replay of its captured graph."""
    from repro_torch.core import mutation

    captured = mutation.MutableIndex._upsert_chunk

    def eager(m, slots, pay, valid):
        mutation.upsert_step(m.index, m.norms, m.live)(slots, pay, valid)

    mutation.MutableIndex._upsert_chunk = eager
    try:
        yield
    finally:
        mutation.MutableIndex._upsert_chunk = captured


def _eager_bucket(executor, bucket, capturable: bool = True):
    """A bucket's search run eagerly: the module-level ``_ipnsw_bucket`` /
    ``_plus_bucket`` that its program captured, over the executor's
    operands and on the buffers its program holds (the latest dispatch's
    inputs); the host (ids, scores, evals)."""
    import functools

    import torch

    from repro_torch.core.ipnsw_plus import IpNSWPlus
    from repro_torch.launch import serve_loop as sl

    prog, idx = executor._programs[bucket][1], executor.index
    fn = (functools.partial(sl._plus_bucket, ang_ef=idx.ang_ef, k_angular=idx.k_angular)
          if isinstance(idx, IpNSWPlus) else sl._ipnsw_bucket)
    ids, scores, evals = fn(*executor._consts(), prog.q_buf, prog.v_buf, k=executor.k,
                            ef=bucket.ef, storage=idx.storage, capturable=capturable)
    host = torch.cat([ids, scores.view(torch.int32), evals[:, None]], dim=1).cpu().numpy()
    k = executor.k
    return host[:, :k], host[:, k: 2 * k].view("float32"), host[:, 2 * k]


def _check_replays_equal_eager(label: str, executor, queries) -> None:
    """Each bucket of the executor's ladder dispatched (a replay) with three
    pad rows, against the eager program on the same buffers: ids, score
    bits and evals bit-identical."""
    import numpy as np

    for bucket in executor.ladder.buckets():
        valid = np.arange(bucket.batch) < bucket.batch - 3
        got = executor.run(bucket, queries[:bucket.batch], valid)
        want = _eager_bucket(executor, bucket)
        for field, g, w in zip(("ids", "scores", "evals"), got, want):
            assert np.array_equal(np.asarray(g).view(np.int32), np.asarray(w).view(np.int32)), \
                f"{label} {bucket}: the replay's {field} differ from the eager program's"
    capture_ms = {f"{b.batch}x{b.ef}": round(executor._programs[b][1].captured.capture_ms, 2)
                  for b in executor.ladder.buckets()}
    log(f"{label}: every bucket's replay (3 pad rows) equals the eager program bit for bit "
        f"(ids, score bits, evals); capture_ms={capture_ms}")


# kernels each churn phase must launch: the live walks of upserts, relinks
# and searches (f32 and int8), the commits, the seeds' scorers and the
# ground truth over the live catalog
CHURN_PATH = ("beam_walk_live", "beam_walk_int8_live", "commit_merge", "gather_score",
              "quant_score", "mips_topk")


def _live_ground_truth(queries, m, k: int = 10):
    """Exact top k over the live rows (the mips_topk kernel), as slot ids."""
    import torch

    from repro_torch.core.brute_force import exact_topk

    live_ids = torch.nonzero(m.live).flatten()
    _, pos = exact_topk(queries, m.graph.items[live_ids], k=k)
    return live_ids[pos.long()].cpu().numpy()


def _assert_no_tombstone(m, ids, what: str) -> None:
    hit = (ids >= 0) & ~m.live[ids.clamp_min(0).long()]
    assert not bool(hit.any()), f"{what}: a tombstoned id surfaced"


def _dead_evals(m, res) -> float:
    """Evaluations per query spent on tombstones: the dead ids among the
    scored ids of both ip-NSW+ walks (each scored id is in a visited buffer
    once)."""
    dead = 0
    for vis in (res.visited_ang, res.visited_ip):
        dead = dead + ((vis >= 0) & ~m.live[vis.clamp_min(0).long()]).sum(-1)
    return float(dead.float().mean())


def phase_churn_default() -> dict:
    """The serve default opened for mutation, under the JAX serve CLI's churn
    trace, with a search between events; held to the JAX package's recall
    on the same trace and to a fresh rebuild of the live catalog."""
    import torch

    from repro_torch.core import ChurnTrace, IpNSWPlus, MutableIndex, apply_churn_event
    from repro_torch.core.brute_force import exact_topk
    from repro_torch.data import mips_dataset, mips_queries
    from repro_torch.obs.recall import recall_at_k

    n, d = 20_000, 64
    items = torch.as_tensor(mips_dataset(n, d, "lognormal", seed=0), dtype=torch.float32,
                            device="cuda")
    queries = torch.as_tensor(mips_queries(256, d, seed=1), device="cuda")
    index = IpNSWPlus(max_degree=16, ef_construction=32, insert_batch=512).build(items)
    _zero_counts()
    m = MutableIndex(index, capacity=int(n * 1.25), mutation_batch=32)
    trace = ChurnTrace.generate(n_items=n, dim=d, turnover=0.2, **CHURN)
    recall = {"before": recall_at_k(m.search(queries, k=10, ef=40).ids.cpu().numpy(),
                                    _live_ground_truth(queries, m))}
    with watch_replays() as seen:
        for i, ev in enumerate(trace.events):
            apply_churn_event(m, ev)
            storage = "int8" if i % 16 == 15 else "f32"
            _assert_no_tombstone(m, m.search(queries, k=10, ef=40, storage=storage).ids,
                                 f"search after event {i} ({ev.kind}, {storage})")
    # the first int8 search made the stores after the first upsert: the
    # next upsert captured its chunk again, over them
    _assert_replays("churn default", seen, _upsert_chunks(trace.events, 32) - 2)
    errs = m.check_invariants()
    assert not errs, "invariants I1-I6 after the trace:\n  " + "\n  ".join(errs)
    gt = _live_ground_truth(queries, m)
    for storage in ("f32", "int8"):
        r = m.search(queries, k=10, ef=40, storage=storage)
        _assert_no_tombstone(m, r.ids, f"search after the trace ({storage})")
        recall[f"after_trace_{storage}"] = recall_at_k(r.ids.cpu().numpy(), gt)
    passes = 0
    while m.relink_debt():
        m.relink(64)
        passes += 1
    r = m.search(queries, k=10, ef=40)
    _assert_no_tombstone(m, r.ids, "search after relinking")
    recall["after_relink"] = recall_at_k(r.ids.cpu().numpy(), gt)
    counts = _read_counts()
    live_ids = torch.nonzero(m.live).flatten()
    compact = m.graph.items[live_ids].contiguous()
    fresh = IpNSWPlus(max_degree=16, ef_construction=32, insert_batch=512).build(compact)
    _, gt_f = exact_topk(queries, compact, k=10)
    recall["fresh_rebuild"] = recall_at_k(
        fresh.search(queries, k=10, ef=40).ids.cpu().numpy(), gt_f.cpu().numpy())
    log(f"churn default: N={n} d={d} capacity={m.capacity} events={trace.n_events} "
        f"relink_passes_after_trace={passes} invariants I1-I6 hold, no tombstone surfaced "
        f"recall@10 " + " ".join(f"{k}={v:.4f}" for k, v in recall.items())
        + f" (JAX {JAX_CHURN_RECALL}) health={m.health()} launches={counts}")
    for key in ("after_trace_f32", "after_relink"):
        assert abs(recall[key] - JAX_CHURN_RECALL) <= RECALL_MARGIN, \
            f"churn recall {key}={recall[key]} not within {RECALL_MARGIN} of JAX {JAX_CHURN_RECALL}"
    assert recall["after_relink"] >= recall["fresh_rebuild"] - RECALL_MARGIN, \
        f"churn recall {recall['after_relink']} below a fresh rebuild's {recall['fresh_rebuild']}"
    _assert_path("churn default", counts, CHURN_PATH)
    return counts


def phase_churn_full() -> dict:
    """A mutable IpNSWPlus at Yahoo!Music's size under a churn trace of
    turnover 0.1: the slice's main path at full width."""
    import numpy as np
    import torch

    from repro_torch.core import ChurnTrace, IpNSWPlus, MutableIndex, apply_churn_event
    from repro_torch.data import mips_dataset, mips_queries
    from repro_torch.launch.serve import _build_ladder
    from repro_torch.launch.serve_loop import BucketExecutor
    from repro_torch.obs.recall import recall_at_k

    items = torch.as_tensor(mips_dataset(N_FULL, D_FULL, "lognormal", seed=0), device="cuda")
    queries = torch.as_tensor(mips_queries(256, D_FULL, seed=1), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    index = IpNSWPlus(max_degree=16, ef_construction=32, insert_batch=512).build(items)
    del items
    trace = ChurnTrace.generate(n_items=N_FULL, dim=D_FULL, turnover=0.1, **CHURN)
    phase_upsert_twins(index, trace)
    _zero_counts()
    m = MutableIndex(index, capacity=int(N_FULL * 1.25), mutation_batch=32)
    recall = {}
    gt = _live_ground_truth(queries, m)
    recall["before"] = recall_at_k(m.search(queries, k=10, ef=40).ids.cpu().numpy(), gt)
    recall["before_int8"] = recall_at_k(
        m.search(queries, k=10, ef=40, storage="int8").ids.cpu().numpy(), gt)
    ms = {"upsert": [], "delete": [], "relink": [], "hub_kill": []}
    with watch_replays() as seen:
        for i, ev in enumerate(trace.events):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            apply_churn_event(m, ev)
            torch.cuda.synchronize()
            ms[ev.kind].append((time.perf_counter() - t0) * 1e3)
            if i % 64 == 63:
                _assert_no_tombstone(m, m.search(queries, k=10, ef=40).ids,
                                     f"search after event {i}")
    # the int8 search above made the stores before the first upsert: one capture
    _assert_replays("churn full upserts", seen, _upsert_chunks(trace.events, 32) - 1)
    log(f"churn full: upsert chunk capture_ms={m.upsert_capture_ms:.2f}")
    errs = m.check_invariants()
    assert not errs, "invariants I1-I6 after the trace:\n  " + "\n  ".join(errs)
    for kind, t in ms.items():
        log(f"churn full: {kind} n={len(t)} ms_mean={np.mean(t):.3f} ms_median="
            f"{np.median(t):.3f} ms_max={np.max(t):.3f}")
    # search with and without the tombstone mask, same index, ten pairs in
    # turns (live first in even pairs)
    times = {"live": [], "plain": []}
    for pair in range(10):
        for order in (("live", "plain") if pair % 2 == 0 else ("plain", "live")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if order == "live":
                m.search(queries, k=10, ef=40)
            else:
                m.index.search(queries, k=10, ef=40)
            torch.cuda.synchronize()
            times[order].append((time.perf_counter() - t0) * 1e3)
    log("churn full: search B=256 ef=40 ms " + " ".join(
        f"{name}_median={np.median(t):.3f} {name}={['%.3f' % x for x in t]}"
        for name, t in times.items()))
    gt = _live_ground_truth(queries, m)
    for storage in ("f32", "int8"):
        r = m.search(queries, k=10, ef=40, storage=storage)
        _assert_no_tombstone(m, r.ids, f"search after the trace ({storage})")
        recall[f"after_trace_{storage}"] = recall_at_k(r.ids.cpu().numpy(), gt)
        log(f"churn full: after the trace storage={storage} dead_evals/q={_dead_evals(m, r):.2f} "
            f"evals/q={float(r.evals.float().mean()):.1f}")
    debt0, passes = m.relink_debt(), 0
    t0 = time.perf_counter()
    while passes < RELINK_PASS_CAP and m.relink_debt():
        m.relink(64)
        passes += 1
    torch.cuda.synchronize()
    relink_s = time.perf_counter() - t0
    r = m.search(queries, k=10, ef=40)
    _assert_no_tombstone(m, r.ids, "search after relinking")
    recall["after_relink"] = recall_at_k(r.ids.cpu().numpy(), gt)
    log(f"churn full: relink debt after the trace {debt0}, {passes} passes of 64 in "
        f"{relink_s:.2f} s (cap {RELINK_PASS_CAP}), debt left {m.relink_debt()}; "
        f"after relinking dead_evals/q={_dead_evals(m, r):.2f}")
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()  # the mutable index's, before the rebuild
    live_ids = torch.nonzero(m.live).flatten()
    compact = m.graph.items[live_ids].contiguous()
    t0 = time.perf_counter()
    fresh = IpNSWPlus(max_degree=16, ef_construction=32, insert_batch=512).build(compact)
    torch.cuda.synchronize()
    fresh_s = time.perf_counter() - t0
    pos = fresh.search(queries, k=10, ef=40).ids.long()
    recall["fresh_rebuild"] = recall_at_k(
        torch.where(pos >= 0, live_ids[pos.clamp_min(0)], -1).cpu().numpy(), gt)
    del fresh, compact
    log(f"churn full: fresh rebuild of the live catalog build_s={fresh_s:.2f}")
    log(f"churn full: N={N_FULL} d={D_FULL} capacity={m.capacity} events={trace.n_events} "
        f"recall@10 " + " ".join(f"{k}={v:.4f}" for k, v in recall.items())
        + f" health={m.health()} peak_memory_bytes={peak} "
        f"launches={counts}")
    assert recall["after_relink"] > 0.5, f"churn full recall@10 {recall['after_relink']}"
    _assert_path("churn full", counts, CHURN_PATH)
    executor = BucketExecutor(m, _build_ladder(256, 40), k=10)
    executor.warmup()
    _check_replays_equal_eager("churn full, the live mask", executor,
                               mips_queries(256, D_FULL, seed=1))
    payload = mips_dataset(32, D_FULL, "lognormal", seed=4)
    with eager_upserts():
        _profiled("churn upsert batch of 32 [eager]", lambda: m.upsert(payload), batches=1,
                  reps=20)
    _profiled("churn upsert batch of 32 [captured]", lambda: m.upsert(payload), batches=1,
              reps=20)
    return counts


# the churn prefix that the eager and the captured upsert both take
TWIN_EVENTS = 64


def phase_upsert_twins(index, trace) -> None:
    """Two copies of a built IpNSWPlus (int8 stores made), each opened as a
    MutableIndex, take the trace's first TWIN_EVENTS events: one with
    captured upserts (every chunk after the first a replay under sync debug
    mode "error"), one with eager upserts.  Both graphs, both stores, the
    live mask, the norms and the carries are then bit-identical; ms per
    upsert batch each way."""
    import copy

    import numpy as np
    import torch

    from repro_torch.core import MutableIndex, apply_churn_event

    twins, ms = {}, {}
    for mode in ("captured", "eager"):
        m = MutableIndex(copy.deepcopy(index), capacity=int(N_FULL * 1.25), mutation_batch=32)
        m.index._make_stores("int8")
        ms[mode] = []
        with eager_upserts() if mode == "eager" else watch_replays() as seen:
            for ev in trace.events[:TWIN_EVENTS]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                apply_churn_event(m, ev)
                torch.cuda.synchronize()
                if ev.kind == "upsert":
                    ms[mode].append((time.perf_counter() - t0) * 1e3)
        if mode == "captured":
            _assert_replays("upsert twins, captured", seen,
                            _upsert_chunks(trace.events[:TWIN_EVENTS], 32) - 1)
        twins[mode] = m
    a, b = twins["captured"], twins["eager"]
    fields = {"live": (a.live, b.live), "norms": (a.norms, b.norms)}
    for gname in ("ang_graph", "ip_graph"):
        for field in ("adj", "items", "size", "entry", "entry_norm"):
            fields[f"{gname}.{field}"] = (getattr(getattr(a.index, gname), field),
                                          getattr(getattr(b.index, gname), field))
    for sname in ("ang_store", "ip_store"):
        for field in ("codes", "scales"):
            fields[f"{sname}.{field}"] = (getattr(getattr(a.index, sname), field),
                                          getattr(getattr(b.index, sname), field))
    for name, (x, y) in fields.items():
        assert torch.equal(x, y), f"upsert twins: {name} differs between captured and eager"
    assert a.operands() != b.operands() and a._free == b._free
    log(f"upsert twins: {TWIN_EVENTS} churn events on two copies of the full-size IpNSWPlus "
        f"(int8 stores): captured and eager upserts leave {len(fields)} tensors bit-identical "
        f"(both graphs, both stores, live, norms, entries); capture_ms={a.upsert_capture_ms:.2f} "
        f"ms per upsert batch of 32 captured median={np.median(ms['captured']):.3f} "
        f"{['%.3f' % x for x in ms['captured']]} eager median={np.median(ms['eager']):.3f} "
        f"{['%.3f' % x for x in ms['eager']]}")
    del twins, a, b
    torch.cuda.empty_cache()


def _profiled(label: str, fn, batches: int = 0, reps: int = 0) -> list:
    """Run ``fn`` under torch.profiler; print wall time, the device time
    its kernels took (one stream, so they do not overlap), the idle share,
    the walk steps and the host time per step (per insertion batch, given
    ``batches``), and the top device ops; return the device events.  With
    ``reps``, ``fn`` then runs that many times unprofiled (the profiler
    slows the host, most of all a graph replay, whose every kernel node it
    traces): the median wall, and the idle share and host ms of that wall
    beside the profiled device time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps0 = _walk_steps()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = _walk_steps() - steps0
    # device-side events only: a CPU op's entry repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_s = sum(e.self_device_time_total for e in events) * 1e-6
    # a captured walk keeps its steps on the card: none is counted here
    per_step = (f"walk_steps={steps} host_ms_per_step={(wall - device_s) / steps * 1e3:.4f}"
                if steps else "walk_steps=not read back")
    per_batch = (f" host_ms_per_batch={(wall - device_s) / batches * 1e3:.4f}" if batches
                 else "")
    log(f"profile {label}: wall_s={wall:.3f} device_busy_s={device_s:.3f} "
        f"idle_share={1 - device_s / wall:.3f} {per_step}{per_batch} "
        f"wall_ms={wall * 1e3:.4f} device_busy_ms={device_s * 1e3:.4f}")
    if reps:
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        med = float(np.median(walls))
        log(f"profile {label}: unprofiled wall_ms median={med:.4f} of {reps} "
            f"[{min(walls):.4f}, {max(walls):.4f}] idle_share={1 - device_s * 1e3 / med:.3f} "
            f"host_ms={med - device_s * 1e3:.4f}")
    for e in events[:6]:
        log(f"profile {label}: {e.self_device_time_total * 1e-3:10.2f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    return events


def _profiled_both(label: str, fn, reps: int = 0) -> None:
    """``_profiled`` with per-step walks (before), then with the fused walk
    (after), in one run."""
    with per_step_walks():
        _profiled(f"{label} [per-step loop]", fn, reps=reps)
    _profiled(label, fn, reps=reps)


@contextlib.contextmanager
def per_step_walks():
    """Inside, every walk of core/search runs as the host loop of the
    beam_step kernel (``per_step_walk``), as the port walked before
    beam_walk."""
    from repro_torch.core import search

    fused = search.beam_walk
    search.beam_walk = per_step_walk
    try:
        yield
    finally:
        search.beam_walk = fused


def phase_profile(items, queries, ipnsw) -> None:
    """Where the time goes at full size (profiler on: the walls here are
    longer than the unprofiled ones above), with per-step walks and with
    the fused walk; the builds with the host and the scan driver.  A scan
    build's walks keep their steps on the card (walk_steps counts none of
    them), and its replayed kernels must show in the trace: each graph's
    walk kernel once a batch.  IpNSW's searches also run as a captured
    256 x 40 bucket."""
    import numpy as np

    from repro_torch.core.build import batch_schedule, replay_schedule
    from repro_torch.core.ipnsw import IpNSW
    from repro_torch.core.ipnsw_plus import IpNSWPlus
    from repro_torch.launch.serve_loop import Bucket, BucketExecutor, BucketLadder

    batches = 1 + batch_schedule(N_FULL, 512)[1].shape[0]
    _profiled_both("ipnsw build", lambda: IpNSW(max_degree=16, ef_construction=32,
                                                insert_batch=512).build(items))
    for name, cls in (("ipnsw", IpNSW), ("ipnsw_plus", IpNSWPlus)):
        for driver in ("host", "scan"):
            events = _profiled(
                f"{name} build [{driver} driver]",
                lambda: cls(max_degree=16, ef_construction=32, insert_batch=512,
                            build_backend=driver).build(items), batches=batches)
            walks = sum(e.count for e in events if "beam_walk_kernel" in e.key)
            assert walks == (batches - 1) * (2 if name == "ipnsw_plus" else 1), \
                f"profile {name} build [{driver}]: the trace shows {walks} walk kernels"
            if driver == "scan":
                run = replay_schedule.last
                log(f"profile {name} build [scan driver]: capture_ms={run.capture_ms:.2f} "
                    f"replay_loop_device_ms="
                    f"{run.loop_events[0].elapsed_time(run.loop_events[1]):.2f} (CUDA events) "
                    f"host_ms_per_replay={run.loop_host_ms / run.replays:.4f}")
    _profiled_both("ipnsw search", lambda: ipnsw.search(queries, k=10, ef=40), reps=20)
    _profiled_both("ipnsw search int8",
                   lambda: ipnsw.search(queries, k=10, ef=40, storage="int8"), reps=20)
    # the same searches as a captured 256 x 40 bucket
    bucket, host_q, ones = Bucket(256, 40), queries.cpu().numpy(), np.ones(256, bool)
    for storage in ("f32", "int8"):
        ipnsw.storage = storage
        executor = BucketExecutor(ipnsw, BucketLadder(batches=(256,), efs=(40,)), k=10)
        executor.warmup()
        with watch_replays() as seen:
            ids, scores, _ = executor.run(bucket, host_q, ones)
        want = ipnsw.search(queries, k=10, ef=40)
        assert seen["replays"] == 1 and np.array_equal(ids, want.ids.cpu().numpy()) and \
            np.array_equal(scores, want.scores.cpu().numpy()), f"captured search {storage}"
        log(f"ipnsw search {storage} as a captured bucket: ids and scores equal the search's; "
            f"capture_ms={executor._programs[bucket][1].captured.capture_ms:.2f}")
        _profiled(f"ipnsw search {storage} [captured bucket]",
                  lambda: executor.run(bucket, host_q, ones), batches=1, reps=20)
    ipnsw.storage = "f32"


# kernel -> (its source, the TPU kernel it replaces)
SOURCES = {
    "beam_step": ("src/repro_torch/csrc/beam_step.cu",
                  "src/repro/kernels/beam_step/kernel.py:50"),
    "beam_step_int8": ("src/repro_torch/csrc/beam_step.cu",
                       "src/repro/kernels/beam_step/kernel.py:151"),
    "beam_step_live": ("src/repro_torch/csrc/beam_step.cu",
                       "src/repro/kernels/beam_step/kernel.py:178"),
    "beam_step_int8_live": ("src/repro_torch/csrc/beam_step.cu",
                            "src/repro/kernels/beam_step/kernel.py:178"),
    "beam_walk": ("src/repro_torch/csrc/beam_step.cu",
                  "src/repro/kernels/beam_step/kernel.py:50"),
    "beam_walk_int8": ("src/repro_torch/csrc/beam_step.cu",
                       "src/repro/kernels/beam_step/kernel.py:151"),
    "beam_walk_live": ("src/repro_torch/csrc/beam_step.cu",
                       "src/repro/kernels/beam_step/kernel.py:178"),
    "beam_walk_int8_live": ("src/repro_torch/csrc/beam_step.cu",
                            "src/repro/kernels/beam_step/kernel.py:178"),
    "commit_merge": ("src/repro_torch/csrc/commit_merge.cu",
                     "src/repro/kernels/commit_merge/kernel.py:78"),
    "mips_topk": ("src/repro_torch/csrc/mips_topk.cu",
                  "src/repro/kernels/mips_topk/kernel.py:48"),
    "mips_topk_int8": ("src/repro_torch/csrc/mips_topk.cu",
                       "src/repro/kernels/mips_topk/kernel.py:69"),
    "mips_topk_select": ("src/repro_torch/csrc/mips_topk.cu",
                         "src/repro/kernels/mips_topk/kernel.py:48"),
    "mips_topk_select_int8": ("src/repro_torch/csrc/mips_topk.cu",
                              "src/repro/kernels/mips_topk/kernel.py:69"),
    "quant_score": ("src/repro_torch/csrc/quant_score.cu",
                    "src/repro/kernels/quant_score/kernel.py:23"),
    "gather_score": ("src/repro_torch/csrc/gather_score.cu",
                     "src/repro/kernels/gather_score/kernel.py:34"),
    "topk_merge": ("src/repro_torch/csrc/topk_merge.cu",
                   "src/repro/kernels/topk_merge/kernel.py:55"),
    "flash_attn": ("src/repro_torch/csrc/flash_attn.cu",
                   "src/repro/kernels/flash_attn/kernel.py:34"),
    "flash_attn_bf16": ("src/repro_torch/csrc/flash_attn.cu",
                        "src/repro/kernels/flash_attn/kernel.py:34"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs the card",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401 -- fails here when run without the repository

    count_graph_launches()
    card = phase_env()
    phase_build()
    timings, entry_counts = phase_kernels()
    k33_counts = phase_serve_default()
    phase_churn_default()
    phase_serve_loop_default()
    counts = phase_full_size()
    phase_loop_full()
    # each kernel's launches on the full-size path that runs it
    counts.update({name: n for name, n in phase_churn_full().items() if name.endswith("_live")})
    counts.update(entry_counts)
    counts.update({name: k33_counts[name] for name in K33_PATH})
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=counts[name], **timings[name])
               for name, (src, rep) in SOURCES.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
