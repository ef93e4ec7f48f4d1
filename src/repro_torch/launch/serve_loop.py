"""Continuous-batching serving loop: the multi-user layer over the index,
ported from the JAX package's ``launch/serve_loop.py`` with the same names,
order and semantics.

  request queue  -- ``Request``s carry a query, an arrival time, a deadline
                    and an ``ef`` preference (the paper's per-request
                    recall / latency dial, fig 8c); ``poisson_trace`` builds
                    the open-loop Poisson load.
  scheduler      -- coalesces queued requests into dynamic batches, earliest
                    deadline first (FIFO within a deadline class), pads the
                    batch up to a ``BucketLadder`` shape and serves it at the
                    largest ladder ``ef`` that no member asked to exceed and
                    that the ``ServiceModel`` predicts meets the tightest
                    deadline: a smaller ``ef`` rather than a rejection, the
                    ladder floor (late) when nothing fits.  Requests are never
                    rejected.
  bucket ladder  -- the fixed set of (batch, ef) shapes.  Each bucket is one
                    program of the ``BucketExecutor``: the bucket's search
                    over the index's graphs, stores and live mask, with k, ef
                    and storage bound in, on one device query buffer and one
                    ``valid`` buffer of the bucket's batch.  On the card the
                    program is one CUDA graph, captured at the bucket's first
                    dispatch (``core/capture.py``) and replayed by every
                    later one; on the CPU it runs eagerly.  A dispatch copies
                    into the buffers; pad rows ride the ``valid=`` mask of
                    ``core.search.beam_search`` (born done, ids -1, no
                    evals), so a valid row's result is bit-identical to an
                    unpadded search.
  clock          -- every time read goes through an injectable clock.
                    ``VirtualClock`` and a deterministic service model make a
                    run a pure function of the arrival trace; ``WallClock``
                    serves real traffic.  ``ServeLoop`` never reads wall time.
  response demux -- each request gets its row of the bucket's result, stamped
                    with dispatch and finish times and the ef it was served at.

Churn: ``run(churn=)`` replays a ``core.mutation.ChurnTrace`` against a
``MutableIndex``-backed executor between dispatches, when the loop's clock
passes each event's time; ``ServeStats`` carries the index's health after it.

``BucketExecutor.compile_log`` records each program build, split into warmup
and steady state as the JAX executor records its compiles: the ladder builds
its buckets once at warmup, and a build in steady state
(``recompiles_steady > 0``) is a ladder regression.

Observability (``repro_torch.obs``), off by default: ``trace_ctx`` traces
every bucket's walk inside its program (one CUDA graph and one copy back a
dispatch still), and ``registry`` receives the walk aggregates, each
dispatch and response, churn events and health, all stamped with the loop's
clock, as the JAX loop records them.
"""
from __future__ import annotations

import functools
import hashlib
import time  # WallClock only -- the loop itself never reads wall time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.capture import capture, data_ptrs, no_sync
from repro_torch.core.ipnsw import IpNSW
from repro_torch.core.ipnsw_plus import IpNSWPlus, _search_plus
from repro_torch.core.mutation import MutableIndex, apply_churn_event
from repro_torch.core.search import beam_search

# --------------------------------------------------------------------------
# Clocks
# --------------------------------------------------------------------------


class VirtualClock:
    """Simulated time: advances only when the loop sleeps.  With a
    deterministic service model a serve run is a pure function of the
    arrival trace."""

    virtual = True

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def sleep_until(self, t: float) -> None:
        self._t = max(self._t, float(t))


class WallClock:
    """Real time, zeroed at construction so traces can start at t=0."""

    virtual = False

    def __init__(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def sleep_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)


# --------------------------------------------------------------------------
# Requests / responses / deadline classes
# --------------------------------------------------------------------------

# Per-class latency budgets (seconds past arrival); admission works on the
# absolute ``deadline_t`` each request carries.
DEADLINE_CLASSES: Dict[str, float] = {
    "interactive": 0.020,
    "standard": 0.100,
    "relaxed": 1.000,
}


@dataclass(frozen=True)
class Request:
    rid: int
    query: np.ndarray       # [d] fp32
    arrival_t: float
    deadline_t: float       # absolute time the response should exist by
    ef: int                 # requested recall dial (served ef never exceeds)
    klass: str = "standard"


@dataclass(frozen=True)
class Response:
    rid: int
    ids: np.ndarray         # [k] int32, -1 padded
    scores: np.ndarray      # [k] fp32
    ef_request: int
    ef_served: int
    bucket: "Bucket"
    arrival_t: float
    dispatch_t: float
    finish_t: float
    deadline_t: float
    deadline_met: bool
    degraded: bool          # served below the preferred ladder ef

    @property
    def latency_s(self) -> float:
        return self.finish_t - self.arrival_t


@dataclass(frozen=True)
class BatchRecord:
    seq: int
    dispatch_t: float
    finish_t: float
    bucket: "Bucket"
    rids: Tuple[int, ...]
    ef_served: int

    @property
    def occupancy(self) -> float:
        return len(self.rids) / self.bucket.batch


def schedule_digest(batches: Sequence[BatchRecord]) -> str:
    """sha256 of the batch schedule, (dispatch_t, bucket, rids, ef_served)
    per batch with the times in ``repr`` (exact): equal digests mean equal
    schedules, whichever package's loop made them."""
    h = hashlib.sha256()
    for b in batches:
        h.update(repr((float(b.dispatch_t), int(b.bucket.batch), int(b.bucket.ef),
                       tuple(int(r) for r in b.rids), int(b.ef_served))).encode())
    return h.hexdigest()


# --------------------------------------------------------------------------
# Bucket ladder
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Bucket:
    batch: int
    ef: int


@dataclass(frozen=True)
class BucketLadder:
    """The fixed (batch, ef) shapes the loop may run, one program each.
    Both axes must be strictly ascending."""

    batches: Tuple[int, ...] = (4, 16)
    efs: Tuple[int, ...] = (16, 32, 64)

    def __post_init__(self):
        for name, axis in (("batches", self.batches), ("efs", self.efs)):
            if not axis or any(v <= 0 for v in axis):
                raise ValueError(f"ladder {name} must be positive: {axis}")
            if any(b >= a for a, b in zip(axis[1:], axis)):
                raise ValueError(f"ladder {name} must be strictly ascending: {axis}")

    @property
    def max_batch(self) -> int:
        return self.batches[-1]

    def buckets(self) -> List[Bucket]:
        return [Bucket(b, e) for b in self.batches for e in self.efs]

    def batch_for(self, n: int) -> int:
        """Smallest ladder batch that holds n requests (n <= max_batch)."""
        for b in self.batches:
            if b >= n:
                return b
        raise ValueError(f"batch of {n} exceeds ladder max {self.max_batch}")

    def ef_pref(self, requested_ef: int) -> int:
        """Largest ladder ef not exceeding the request's dial (the ladder
        floor when the request asks below every rung)."""
        fitting = [e for e in self.efs if e <= requested_ef]
        return fitting[-1] if fitting else self.efs[0]


# --------------------------------------------------------------------------
# Service model
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class LinearServiceModel:
    """Deterministic bucket-cost prediction the scheduler plans with, and the
    amount a VirtualClock advances per dispatch.  A pure function of the
    bucket; the constants are a knob, not a measurement."""

    base_s: float = 1e-3          # per-dispatch overhead
    per_row_s: float = 1e-5       # per padded batch row
    per_ef_s: float = 0.0         # per ef unit, batch-independent
    per_ef_row_s: float = 1e-6    # per (row x ef) unit -- the walk itself

    def service_s(self, bucket: Bucket) -> float:
        return (self.base_s
                + self.per_row_s * bucket.batch
                + self.per_ef_s * bucket.ef
                + self.per_ef_row_s * bucket.batch * bucket.ef)


# --------------------------------------------------------------------------
# Bucket executor -- one program per bucket, build accounting
# --------------------------------------------------------------------------


def _ipnsw_bucket(graph, store, live, queries, valid, *, k, ef, storage, capturable=False,
                  trace=None):
    init = graph.entry.expand(queries.shape[0], 1)
    r = beam_search(graph, queries, init, pool_size=max(ef, k), max_steps=2 * ef, k=k,
                    storage=storage, store=store, valid=valid, live=live, capturable=capturable,
                    trace=trace)
    return r.ids, r.scores, r.evals, r.trace


def _plus_bucket(ang_graph, ip_graph, ang_store, ip_store, live, queries, valid, *, k, ef,
                 ang_ef, k_angular, storage, capturable=False, trace=None):
    r = _search_plus(ang_graph, ip_graph, queries, k=k, ef=ef, ang_ef=ang_ef,
                     k_angular=k_angular, max_steps=2 * ef,
                     ang_max_steps=2 * max(ang_ef, k_angular), storage=storage,
                     ang_store=ang_store, ip_store=ip_store, live=live, valid=valid,
                     capturable=capturable, trace=trace)
    return r.ids, r.scores, r.evals, r.trace


def _pack(ids, scores, evals, walk) -> torch.Tensor:
    """A bucket's outputs as one int32 tensor, for one device-to-host copy:
    [batch, 2k + 1] ids, score bits and evals, and with a trace its
    band_hist, hub_evals and steps_to_converge after them (n_bands + 2
    columns more)."""
    cols = [ids, scores.view(torch.int32), evals[:, None]]
    if walk is not None:
        cols += [walk.band_hist, walk.hub_evals[:, None], walk.steps_to_converge[:, None]]
    return torch.cat(cols, dim=1)


class _Program:
    """A bucket's program on the CPU: ``body`` run eagerly on the device
    query buffer ``q_buf`` [batch, d] and ``valid`` buffer ``v_buf``
    [batch] that every dispatch copies into; host arrays in, the packed
    host array out."""

    captured = None

    def __init__(self, body: Callable, q_buf: torch.Tensor, v_buf: torch.Tensor):
        self.body, self.q_buf, self.v_buf = body, q_buf, v_buf

    def __call__(self, queries: np.ndarray, valid: np.ndarray) -> np.ndarray:
        self.q_buf.copy_(torch.from_numpy(queries))
        self.v_buf.copy_(torch.from_numpy(valid))
        return self.body(self.q_buf, self.v_buf).numpy()


class _CapturedProgram(_Program):
    """A bucket's program on the card.  The inputs are staged in pinned
    memory and copied to the buffers asynchronously; the first call runs
    ``body`` eagerly (the capture's warm-up, whose output it returns) and
    captures it as a CUDA graph (``captured``, a ``capture.Captured``);
    every later call replays the graph.  The copies and the replay run
    under ``no_sync()``; the one device-to-host copy of the packed output,
    and its wait, follow."""

    def __init__(self, body: Callable, q_buf: torch.Tensor, v_buf: torch.Tensor):
        super().__init__(body, q_buf, v_buf)
        self.q_host = torch.empty(q_buf.shape, dtype=q_buf.dtype, pin_memory=True)
        self.v_host = torch.empty(v_buf.shape, dtype=v_buf.dtype, pin_memory=True)

    def __call__(self, queries: np.ndarray, valid: np.ndarray) -> np.ndarray:
        # the staging buffers are free: the previous dispatch waited for its copies
        self.q_host.numpy()[...] = queries
        self.v_host.numpy()[...] = valid
        with no_sync():
            self.q_buf.copy_(self.q_host, non_blocking=True)
            self.v_buf.copy_(self.v_host, non_blocking=True)
            if self.captured is not None:
                self.captured.graph.replay()
                out = self.captured.out
        if self.captured is None:
            self.captured = capture(self.body, self.q_buf, self.v_buf)
            out = self.captured.warm
            self.out_host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        self.out_host.copy_(out, non_blocking=True)
        torch.cuda.current_stream(out.device).synchronize()
        return self.out_host.numpy().copy()


class BucketExecutor:
    """One program per ladder bucket.

    A program is the bucket's search over the index's graphs, stores and
    live mask as they are when it is built, with k, ef and storage bound
    in, on one device query buffer ``[batch, d]`` and one ``valid`` buffer
    ``[batch]`` that every dispatch of the bucket copies into.  On the card
    it is one CUDA graph (seeds, walks, int8 rerank, live cut and the
    packing of the output), captured at the bucket's first dispatch and
    replayed by the others; on the CPU it runs eagerly.  It is built at the
    bucket's first dispatch and logged in ``compile_log`` as "warmup"
    (before ``warmup()`` returns) or "steady" (a ladder regression).

    Takes a ``core.mutation.MutableIndex`` too: its mutations write the
    graphs, stores and live mask in place at a fixed capacity, so churn
    applied between dispatches is served at once, no shape changes and no
    program is rebuilt.  A dispatch whose operands were replaced since its
    program was built (a graph, a store, the live mask or a table of the
    trace context at another address) raises: the program would read the
    old ones.

    ``trace_ctx`` (an ``obs.TraceContext`` over the index's nodes, a
    MutableIndex's full capacity) traces every walk: it is fixed for the
    executor's lifetime, so warmup builds the traced programs and steady
    state builds none.  A program then packs each row's band histogram, hub
    evaluations and steps to converge into its output, and ``last_walk``
    holds the latest dispatch's batch sums.  ``registry`` receives those
    aggregates every dispatch (``_record_walk``); the executor reads no
    clock.  Both default off: the programs are then exactly the untraced
    ones.
    """

    def __init__(self, index, ladder: BucketLadder, *, k: int = 10, trace_ctx=None,
                 registry=None):
        self.mutable = index if isinstance(index, MutableIndex) else None
        if self.mutable is not None:
            index = index.index
        if not isinstance(index, (IpNSW, IpNSWPlus)):
            raise TypeError(
                f"BucketExecutor serves IpNSW, IpNSWPlus or MutableIndex, got {type(index)}")
        self.index = index
        self.ladder = ladder
        self.k = k
        self.trace_ctx = trace_ctx
        self.registry = registry
        self.last_walk: Optional[Dict[str, object]] = None
        self._programs: Dict[Bucket, Tuple[tuple, _Program]] = {}
        self.compile_log: List[Tuple[Bucket, str]] = []
        self._steady = False

    # -- accounting --------------------------------------------------------

    @property
    def recompiles_warmup(self) -> int:
        return sum(1 for _, phase in self.compile_log if phase == "warmup")

    @property
    def recompiles_steady(self) -> int:
        return sum(1 for _, phase in self.compile_log if phase == "steady")

    @property
    def warmed(self) -> bool:
        return self._steady

    # -- programs ----------------------------------------------------------

    def _graph(self):
        g = self.index.ip_graph if isinstance(self.index, IpNSWPlus) else self.index.graph
        if g is None:
            raise RuntimeError("index must be built before serving")
        return g

    def dim(self) -> int:
        return self._graph().items.shape[1]

    def _consts(self):
        """The graph / store / live operands of a program (the int8 stores
        are made here when missing, before any program reads them)."""
        idx = self.index
        live = None if self.mutable is None else self.mutable.live
        if isinstance(idx, IpNSWPlus):
            if idx.storage == "int8" and idx.ip_store is None:
                idx._make_stores(idx.storage)
            return (idx.ang_graph, idx.ip_graph,
                    idx.ang_store if idx.storage == "int8" else None,
                    idx.ip_store if idx.storage == "int8" else None, live)
        return idx.graph, idx._resolve_store(idx.storage), live

    def _ptrs(self, consts: tuple) -> tuple:
        """The addresses a program over ``consts`` reads: the operands' and
        the trace context's tables."""
        return data_ptrs(*consts, None if self.trace_ctx is None else self.trace_ctx.tensors())

    def _body(self, bucket: Bucket, consts: tuple) -> Callable:
        """The bucket's program over ``consts`` (``_consts()``): the search,
        traced with ``trace_ctx`` when there is one, and the packing of its
        outputs into one int32 tensor (``_pack``) for one device-to-host
        copy.  Nothing is read back, so on the card it can be captured."""
        idx = self.index
        if isinstance(idx, IpNSWPlus):
            fn = functools.partial(_plus_bucket, k=self.k, ef=bucket.ef, ang_ef=idx.ang_ef,
                                   k_angular=idx.k_angular, storage=idx.storage, capturable=True,
                                   trace=self.trace_ctx)
        else:
            fn = functools.partial(_ipnsw_bucket, k=self.k, ef=bucket.ef, storage=idx.storage,
                                   capturable=True, trace=self.trace_ctx)

        def body(queries: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
            return _pack(*fn(*consts, queries, valid))

        return body

    def _build_program(self, bucket: Bucket) -> Tuple[tuple, _Program]:
        """(the addresses it reads, the bucket's program)."""
        consts = self._consts()
        dev = self._graph().items.device
        q_buf = torch.zeros((bucket.batch, self.dim()), dtype=torch.float32, device=dev)
        v_buf = torch.zeros((bucket.batch,), dtype=torch.bool, device=dev)
        program = _CapturedProgram if dev.type == "cuda" else _Program
        return self._ptrs(consts), program(self._body(bucket, consts), q_buf, v_buf)

    def warmup(self) -> None:
        """Build every ladder bucket on an all-pad batch (every row is born
        done, so no walk step runs); everything after counts as steady
        state."""
        d = self.dim()
        for bucket in self.ladder.buckets():
            self.run(bucket, np.zeros((bucket.batch, d), np.float32),
                     np.zeros((bucket.batch,), bool))
        self._steady = True

    def run(self, bucket: Bucket, queries: np.ndarray, valid: np.ndarray):
        """Dispatch one padded bucket; returns (ids, scores, evals) as host
        arrays.  ``queries`` is [bucket.batch, d] fp32, ``valid`` [batch]
        bool."""
        built = self._programs.get(bucket)
        if built is None:
            built = self._build_program(bucket)
            self._programs[bucket] = built
            self.compile_log.append((bucket, "steady" if self._steady else "warmup"))
        ptrs, program = built
        if self._ptrs(self._consts()) != ptrs:
            raise RuntimeError(
                f"bucket {bucket}: a graph, store, live mask or trace table was replaced "
                "since the bucket's program was built over it; build a new executor")
        valid = np.asarray(valid, bool)
        host = program(np.asarray(queries, np.float32), valid)
        k = self.k
        self._record_walk(None if self.trace_ctx is None else host[:, 2 * k + 1:], valid)
        return (np.ascontiguousarray(host[:, :k]),
                np.ascontiguousarray(host[:, k: 2 * k]).view(np.float32),
                np.ascontiguousarray(host[:, 2 * k]))

    def _record_walk(self, walk, valid: np.ndarray) -> None:
        """Keep this dispatch's walk telemetry in ``last_walk`` (the band
        histogram summed over the batch, hub evals, mean steps to converge
        of the valid rows) and fold it into the registry's vector and
        counters.  ``walk`` is the packed output's walk columns [B, n_bands
        + 2] (band_hist, hub_evals, steps_to_converge), or None untraced.
        Pad rows are born done and add zero, so one column sum gives every
        total, and the steps' sum over n valid rows is their mean's (whole
        numbers: exact in float64, one division, as numpy's mean).  Nothing
        here reads a clock."""
        if walk is None:
            self.last_walk = None
            return
        nb = walk.shape[1] - 2
        sums = walk.sum(axis=0)  # int64
        band, hub, n = sums[:nb], int(sums[nb]), int(np.count_nonzero(valid))
        self.last_walk = {
            "band_hist": band,
            "hub_evals": hub,
            "steps_mean": float(sums[nb + 1]) / n if n else 0.0,
            "n": n,
        }
        reg = self.registry
        if reg is not None:
            reg.vector(
                "walk_evals_by_band", band.shape[0],
                "similarity evaluations per catalog norm band (Fig-5)",
                label="band",
            ).add(band)
            reg.counter(
                "walk_hub_evals_total",
                "evaluations landing on the top-in-degree hub set (Fig-4)",
            ).inc(hub)
            reg.counter(
                "walk_evals_total", "total similarity evaluations",
            ).inc(float(band.sum()))


# --------------------------------------------------------------------------
# The serving loop
# --------------------------------------------------------------------------


@dataclass
class ServeStats:
    responses: List[Response]
    batches: List[BatchRecord]
    recompiles_warmup: int
    recompiles_steady: int
    # churn (zeros / None without a churn trace); ``rejected`` pins the
    # never-reject contract: the loop has no rejection path
    mutation_events: int = 0
    rejected: int = 0
    health: Optional[Dict[str, float]] = None

    def latencies_ms(self) -> np.ndarray:
        return np.asarray([r.latency_s * 1e3 for r in self.responses])

    def percentile_ms(self, q: float) -> float:
        lat = self.latencies_ms()
        return float(np.percentile(lat, q)) if lat.size else 0.0

    def qps(self) -> float:
        if not self.responses:
            return 0.0
        t0 = min(r.arrival_t for r in self.responses)
        t1 = max(r.finish_t for r in self.responses)
        return len(self.responses) / max(t1 - t0, 1e-12)

    def occupancy(self) -> float:
        if not self.batches:
            return 0.0
        return float(np.mean([b.occupancy for b in self.batches]))

    def deadline_miss_frac(self) -> float:
        if not self.responses:
            return 0.0
        return float(np.mean([not r.deadline_met for r in self.responses]))

    def summary(self) -> Dict[str, float]:
        out = {
            "served": len(self.responses),
            "batches": len(self.batches),
            "p50_ms": self.percentile_ms(50),
            "p99_ms": self.percentile_ms(99),
            "qps": self.qps(),
            "occupancy": self.occupancy(),
            "deadline_miss_frac": self.deadline_miss_frac(),
            "recompiles_warmup": self.recompiles_warmup,
            "recompiles_steady": self.recompiles_steady,
            "mutation_events": self.mutation_events,
            "rejected": self.rejected,
        }
        if self.health is not None:
            out.update({f"health_{k}": v for k, v in self.health.items()})
        return out


class _DispatchEvents:
    """The timeline records of folded dispatches (``ServeLoop.
    _fold_dispatches``), built when the registry's events are read: for
    each dispatch its response events, then its dispatch event -- the JAX
    loop's records, fields and order.  ``rid``, ``latency``, ``wait`` and
    ``met`` hold every response of the dispatches, in order."""

    def __init__(self, todo, rid, latency, wait, met):
        self.todo, self.columns = todo, (rid, latency, wait, met)

    def dicts(self) -> List[dict]:
        rid, latency, wait, met = (c.tolist() for c in self.columns)
        out, stop = [], 0
        for bucket, batch, now, finish, degraded, walk in self.todo:
            start, stop = stop, stop + len(batch)
            finish = float(finish)
            out.extend({"event": "response", "t": finish, "rid": rid[i], "latency_s": latency[i],
                        "queue_wait_s": wait[i], "deadline_met": met[i]}
                       for i in range(start, stop))
            ev = {"event": "dispatch", "t": float(now), "batch": bucket.batch, "ef": bucket.ef,
                  "n": len(batch), "degraded": degraded}
            if walk is not None:
                ev["band_hist"] = [int(v) for v in walk["band_hist"]]
                ev["hub_evals"] = walk["hub_evals"]
                ev["steps_mean"] = walk["steps_mean"]
            out.append(ev)
        return out


class ServeLoop:
    """Single-threaded, event-driven continuous-batching loop.

    Time advances only through ``clock.sleep_until``; with a VirtualClock the
    service model supplies each dispatch's duration, so a run is a pure
    function of (index, ladder, model, trace).

    Scheduling policy:
      * the queue is kept in (deadline_t, arrival_t, rid) order -- earliest
        deadline first, FIFO within a deadline class;
      * the loop waits for further arrivals only while the queue is smaller
        than the largest ladder batch and the head request could still be
        served at its preferred ef after the wait (its dispatch-by point,
        ``deadline_t - service(max_batch bucket at preferred ef)``);
      * at dispatch, up to ``max_batch`` head requests form the batch, padded
        up to the smallest fitting ladder rung, and served at the largest
        rung no member's dial forbids that the model predicts meets the
        tightest deadline -- else the next smaller rung, else the ladder
        floor (late, never rejected).
    """

    def __init__(self, index, *, ladder: Optional[BucketLadder] = None, clock=None,
                 k: int = 10, service_model=None, executor: Optional[BucketExecutor] = None,
                 assert_invariants: bool = False, registry=None, trace_ctx=None):
        self.ladder = ladder if ladder is not None else BucketLadder()
        self.clock = clock if clock is not None else VirtualClock()
        self.service_model = (service_model if service_model is not None
                              else LinearServiceModel())
        # registry / trace_ctx (repro_torch.obs): None is the untraced,
        # unrecorded path.  Every record carries the loop clock's times and
        # values only: the loop never reads wall time (the registry's span()
        # is the build's, never used here).
        self.registry = registry
        self.executor = (executor if executor is not None
                         else BucketExecutor(index, self.ladder, k=k, trace_ctx=trace_ctx,
                                             registry=registry))
        self.k = self.executor.k
        self._unfolded: list = []  # dispatches not yet folded into the registry
        # re-check I1-I6 after every applied churn event (a host sweep per
        # event; tests and debugging)
        self.assert_invariants = assert_invariants

    # -- policy helpers ----------------------------------------------------

    @staticmethod
    def _order(r: Request):
        return (r.deadline_t, r.arrival_t, r.rid)

    def _choose_ef(self, batch: Sequence[Request], bucket_batch: int,
                   now: float) -> Tuple[int, bool]:
        """Largest ladder ef within every member's dial that fits the
        tightest deadline; degrade down the ladder, floor as last resort."""
        pref = self.ladder.ef_pref(min(r.ef for r in batch))
        slack = min(r.deadline_t for r in batch) - now
        for ef in reversed([e for e in self.ladder.efs if e <= pref]):
            if self.service_model.service_s(Bucket(bucket_batch, ef)) <= slack:
                return ef, ef < pref
        return self.ladder.efs[0], True

    # -- the loop ----------------------------------------------------------

    def _apply_churn(self, churn_q: deque, now: float, applied: List) -> None:
        """Apply every due churn event to the executor's MutableIndex.
        Mutations land between dispatches only."""
        m = self.executor.mutable
        while churn_q and churn_q[0].t <= now:
            ev = churn_q.popleft()
            applied.append(apply_churn_event(m, ev))
            if self.registry is not None:
                self._fold_dispatches()  # the dispatches before it, first
                self.registry.counter(
                    "index_churn_events_total", "applied churn events",
                ).inc()
                self.registry.event("churn", now, kind=ev.kind)
                self._record_health(m)
            if self.assert_invariants:
                errs = m.check_invariants()
                if errs:
                    raise AssertionError(
                        f"graph invariants violated after churn event {ev.kind!r} "
                        f"at t={ev.t}:\n" + "\n".join(errs))

    def _record_health(self, m) -> None:
        """Mirror ``MutableIndex.health()`` into registry gauges (tombstone
        ratio, relink debt, dead edges, headroom after a churn event)."""
        for key, val in m.health().items():
            self.registry.gauge(
                f"index_{key}", "MutableIndex.health() gauge",
            ).set(val)

    def _record_dispatch(self, bucket: Bucket, batch, now: float, finish: float,
                         degraded: bool) -> None:
        """Queue one dispatch (its bucket, requests, loop-clock times,
        degrade flag and the executor's ``last_walk``) for
        ``_fold_dispatches``: a list append, where the JAX loop's
        per-response records would cost the dispatch more host time than
        the card's replay takes."""
        self._unfolded.append((bucket, batch, now, finish, degraded, self.executor.last_walk))

    def _fold_dispatches(self) -> None:
        """Fold the queued dispatches into the registry, in dispatch order:
        the records the JAX loop makes at each dispatch (counters, the
        coalesce / occupancy / queue-wait / latency histograms, the response
        events and the dispatch event), equal in names, values and order,
        made for many dispatches at once (``Histogram.observe_many``, one
        ``_DispatchEvents`` block).  The loop folds before it records a
        churn event and when its run ends, so the registry is complete
        whenever the loop is not running."""
        todo, self._unfolded = self._unfolded, []
        if not todo:
            return
        reg = self.registry
        ns = [len(batch) for _, batch, *_ in todo]
        # whole-valued floats: one sum adds what one inc() a dispatch adds
        reg.counter("serve_requests_total", "requests served").inc(sum(ns))
        reg.counter("serve_batches_total", "bucket dispatches").inc(len(todo))
        degraded = sum(1 for *_, deg, _ in todo if deg)
        if degraded:
            reg.counter(
                "serve_degraded_total",
                "dispatches served below the preferred ladder ef",
            ).inc(degraded)
        reg.histogram(
            "serve_coalesce_size", "requests coalesced per dispatch",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
        ).observe_many(ns)
        reg.histogram(
            "serve_occupancy", "live rows / bucket batch per dispatch",
            buckets=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0),
        ).observe_many([n / bucket.batch for (bucket, *_), n in zip(todo, ns)])
        reqs = [r for _, batch, *_ in todo for r in batch]
        arrival = np.fromiter((r.arrival_t for r in reqs), np.float64, len(reqs))
        deadline = np.fromiter((r.deadline_t for r in reqs), np.float64, len(reqs))
        rid = np.fromiter((r.rid for r in reqs), np.int64, len(reqs))
        now = np.repeat([t[2] for t in todo], ns)
        finish = np.repeat([t[3] for t in todo], ns)
        wait, latency, met = now - arrival, finish - arrival, finish <= deadline
        reg.histogram(
            "serve_queue_wait_seconds", "arrival -> dispatch (loop clock)",
        ).observe_many(wait)
        reg.histogram(
            "serve_latency_seconds", "arrival -> finish (loop clock)",
        ).observe_many(latency)
        reg.counter("serve_deadline_miss_total", "late responses").inc(
            float(np.count_nonzero(finish > deadline)))
        reg.event_block(_DispatchEvents(todo, rid, latency, wait, met))

    def run(self, requests: Iterable[Request], churn=None) -> ServeStats:
        """``churn`` (optional) is a ``core.mutation.ChurnTrace`` -- or any
        sequence of ``ChurnEvent`` -- replayed against the loop's
        MutableIndex: events apply when the loop's clock passes their
        timestamps, never mid-batch, and events dated past the last response
        are drained at the end."""
        trace = sorted(requests, key=lambda r: (r.arrival_t, r.rid))
        d = self.executor.dim()
        for r in trace:
            if np.asarray(r.query).shape != (d,):
                raise ValueError(
                    f"request {r.rid}: query shape {np.asarray(r.query).shape} != ({d},)")
        if not self.executor.warmed:
            self.executor.warmup()

        events = list(getattr(churn, "events", churn or ()))
        if events and self.executor.mutable is None:
            raise TypeError("churn traces need a MutableIndex-backed executor "
                            "(core.mutation.MutableIndex)")
        churn_q = deque(sorted(events, key=lambda e: (e.t, e.kind)))
        applied: List[Dict] = []

        pending = deque(trace)
        queue: List[Request] = []
        responses: List[Response] = []
        batches: List[BatchRecord] = []
        max_b = self.ladder.max_batch

        try:
            while pending or queue:
                now = self.clock.now()
                self._apply_churn(churn_q, now, applied)
                while pending and pending[0].arrival_t <= now:
                    queue.append(pending.popleft())
                if not queue:
                    # wake for the next arrival or the next churn event
                    t = pending[0].arrival_t
                    if churn_q:
                        t = min(t, churn_q[0].t)
                    self.clock.sleep_until(t)
                    continue

                queue.sort(key=self._order)
                head = queue[0]
                next_arrival = pending[0].arrival_t if pending else None
                dispatch_by = head.deadline_t - self.service_model.service_s(
                    Bucket(max_b, self.ladder.ef_pref(head.ef)))
                if (len(queue) < max_b and next_arrival is not None
                        and next_arrival <= dispatch_by and now < dispatch_by):
                    # coalesce: sleep to the earliest of the next arrival, the
                    # head's dispatch-by point and the next churn event
                    t = min(next_arrival, dispatch_by)
                    if churn_q:
                        t = min(t, churn_q[0].t)
                    self.clock.sleep_until(max(t, now))
                    continue

                batch = queue[:max_b]
                del queue[:len(batch)]
                bucket_batch = self.ladder.batch_for(len(batch))
                ef, degraded = self._choose_ef(batch, bucket_batch, now)
                bucket = Bucket(bucket_batch, ef)

                padded = np.zeros((bucket.batch, d), np.float32)
                for i, r in enumerate(batch):
                    padded[i] = r.query
                valid = np.arange(bucket.batch) < len(batch)
                ids, scores, _ = self.executor.run(bucket, padded, valid)

                if self.clock.virtual:
                    finish = now + self.service_model.service_s(bucket)
                    self.clock.sleep_until(finish)
                else:
                    finish = self.clock.now()  # after the host copy: the work is done

                for i, r in enumerate(batch):
                    responses.append(Response(
                        rid=r.rid, ids=ids[i], scores=scores[i], ef_request=r.ef,
                        ef_served=ef, bucket=bucket, arrival_t=r.arrival_t, dispatch_t=now,
                        finish_t=finish, deadline_t=r.deadline_t,
                        deadline_met=finish <= r.deadline_t, degraded=degraded))
                batches.append(BatchRecord(
                    seq=len(batches), dispatch_t=now, finish_t=finish, bucket=bucket,
                    rids=tuple(r.rid for r in batch), ef_served=ef))
                if self.registry is not None:
                    self._record_dispatch(bucket, batch, now, finish, degraded)

            # drain churn events dated past the last response
            while churn_q:
                self.clock.sleep_until(churn_q[0].t)
                self._apply_churn(churn_q, self.clock.now(), applied)
        finally:
            if self.registry is not None:
                self._fold_dispatches()

        m = self.executor.mutable
        if self.registry is not None:
            self.registry.gauge(
                "serve_recompiles_warmup", "program builds during warmup",
            ).set(self.executor.recompiles_warmup)
            self.registry.gauge(
                "serve_recompiles_steady",
                "program builds after warmup (ladder regression if > 0)",
            ).set(self.executor.recompiles_steady)
        return ServeStats(
            responses=responses, batches=batches,
            recompiles_warmup=self.executor.recompiles_warmup,
            recompiles_steady=self.executor.recompiles_steady,
            mutation_events=len(applied), rejected=0,
            health=None if m is None else m.health(),
        )


# --------------------------------------------------------------------------
# Arrival sources
# --------------------------------------------------------------------------


def poisson_trace(
    queries: np.ndarray,
    *,
    rate_qps: float,
    seed: int = 0,
    ef: int = 64,
    classes: Sequence[str] = ("standard",),
    budgets: Optional[Dict[str, float]] = None,
    start_t: float = 0.0,
) -> List[Request]:
    """Open-loop Poisson arrivals: one request per query row, exponential
    inter-arrival gaps at ``rate_qps``, deadline classes drawn uniformly
    from ``classes``.  Pure ``numpy.random.default_rng(seed)``, so a trace
    is reproducible byte for byte (and equals the JAX package's)."""
    budgets = dict(DEADLINE_CLASSES if budgets is None else budgets)
    q = np.asarray(queries, np.float32)
    n = q.shape[0]
    rng = np.random.default_rng(seed)
    ts = start_t + np.cumsum(rng.exponential(1.0 / rate_qps, size=n))
    efs = np.broadcast_to(np.asarray(ef, np.int64), (n,))
    cls = rng.integers(0, len(classes), size=n)
    out = []
    for i in range(n):
        klass = classes[int(cls[i])]
        out.append(Request(
            rid=i, query=q[i], arrival_t=float(ts[i]),
            deadline_t=float(ts[i]) + budgets[klass], ef=int(efs[i]), klass=klass))
    return out
