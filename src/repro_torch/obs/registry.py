"""Host-side metrics registry: counters, gauges, histograms, vectors,
timing spans and an event timeline, exportable as Prometheus text or JSONL.

A copy of the JAX package's ``obs/registry.py`` (the port imports nothing
of that package): the same classes, metric names, ``DEFAULT_BUCKETS``, float
arithmetic and export text, so equal inputs give equal ``collect()``,
``events`` and exports.  The serving loop, the build drivers and the
mutation layer report into it.

  wall-clock free by default -- every value the serving loop records comes
      from the loop's injected clock (``launch/serve_loop.py`` never reads
      wall time), so a VirtualClock run gives an equal registry every time.
      Only ``span()`` reads ``time.perf_counter``, and only the build
      drivers use it.
  cheap enough to leave on -- a dispatch of the card's serving loop takes
      about half a millisecond, so the loop records many dispatches'
      responses at once: ``Histogram.observe_many`` (the ``observe`` of
      each value, in order, its sum a float64 cumulative sum: the same adds
      in the same order) and ``MetricsRegistry.event_block`` (records kept
      in the caller's arrays, their dicts built when ``events`` is read).
      Neither records less, changes a value or reorders anything.
  dependency-free -- numpy and the standard library; nothing in
      ``repro_torch.obs`` imports ``repro_torch.core``, so every layer may
      report here without an import cycle.

Metric types:
  Counter       -- monotonically increasing float (``_total`` names).
  Gauge         -- last-write-wins float (health ratios, debts).
  Histogram     -- fixed upper-bound buckets (Prometheus ``le``, +Inf
                   implied) with count and sum.
  VectorCounter -- a fixed-length vector of counts with a label per index
                   (the per-norm-band evaluation histogram: band -> evals).

The timeline (``event(name, t, **fields)``) keeps what a scalar snapshot
cannot: dispatches, responses, churn events and walk aggregates, one JSONL
line each; ``python -m repro_torch.obs.report`` renders it.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Default latency-style buckets (seconds): ~exponential, 100us .. 10s.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0,
)


class Counter:
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {v})")
        self.value += v

    def collect(self) -> dict:
        return {"kind": self.kind, "name": self.name, "help": self.help,
                "value": self.value}


class Gauge:
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def collect(self) -> dict:
        return {"kind": self.kind, "name": self.name, "help": self.help,
                "value": self.value}


class Histogram:
    """Prometheus-style cumulative-bucket histogram (uppers + implicit
    +Inf), tracking count and sum alongside."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        if not buckets or any(b >= a for a, b in zip(buckets[1:], buckets)):
            raise ValueError(f"histogram {name} buckets must be strictly "
                             f"ascending and non-empty: {buckets}")
        self.name, self.help = name, help
        self.uppers = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.uppers) + 1)  # last = +Inf overflow
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        for i, ub in enumerate(self.uppers):
            if v <= ub:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def observe_many(self, values) -> None:
        """``observe(v)`` for each value in order, in one call: the sum is
        the float64 cumulative sum from the current one (the same adds, in
        the same order), and each value lands in the first bucket whose
        upper bound it does not exceed (NaN and values above every bound in
        +Inf), as ``observe`` puts it."""
        v = np.asarray(values, np.float64).reshape(-1)
        if not v.size:
            return
        self.count += int(v.size)
        self.sum = float(np.cumsum(np.concatenate(([self.sum], v)))[-1])
        slot = np.searchsorted(np.asarray(self.uppers), v, side="left")
        for i, c in enumerate(np.bincount(slot, minlength=len(self.counts)).tolist()):
            self.counts[i] += c

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def collect(self) -> dict:
        return {"kind": self.kind, "name": self.name, "help": self.help,
                "count": self.count, "sum": self.sum,
                "buckets": list(self.uppers), "counts": list(self.counts)}


class VectorCounter:
    """Fixed-length vector of counts with one label value per index --
    e.g. ``walk_evals_by_band`` maps norm-band -> total evaluations."""

    kind = "vector"

    def __init__(self, name: str, length: int, help: str = "",
                 label: str = "index"):
        if length <= 0:
            raise ValueError(f"vector {name} needs a positive length")
        self.name, self.help, self.label = name, help, label
        self.values = np.zeros(length, np.float64)

    def add(self, values) -> None:
        v = np.asarray(values, np.float64)
        if v.shape != self.values.shape:
            raise ValueError(
                f"vector {self.name} expects shape {self.values.shape}, "
                f"got {v.shape}"
            )
        self.values += v

    def inc(self, index: int, v: float = 1.0) -> None:
        self.values[index] += v

    def collect(self) -> dict:
        return {"kind": self.kind, "name": self.name, "help": self.help,
                "label": self.label, "values": self.values.tolist()}


class MetricsRegistry:
    """Name -> metric store + event timeline.  Metric constructors are
    get-or-create (idempotent per name); asking for an existing name with a
    different type is a hard error -- silent type drift would corrupt the
    export."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._timeline: list = []  # event dicts and event blocks, in record order
        self._blocks = 0

    # -- constructors ------------------------------------------------------

    def _get_or_create(self, cls, name: str, *args, **kwargs):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, *args, **kwargs)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {type(m).__name__}, "
                f"requested {cls.__name__}"
            )
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets)

    def vector(self, name: str, length: int, help: str = "",
               label: str = "index") -> VectorCounter:
        return self._get_or_create(VectorCounter, name, length, help, label)

    # -- spans (host wall time -- build drivers only, never the serve loop) -

    @contextmanager
    def span(self, name: str, help: str = ""):
        """Time a host-side phase into ``{name}_seconds``.  Measures the
        driver's wall time; CUDA launches are asynchronous, so device work
        may overlap the span unless the caller synchronizes -- documented
        per site."""
        h = self.histogram(f"{name}_seconds", help)
        t0 = time.perf_counter()
        try:
            yield h
        finally:
            h.observe(time.perf_counter() - t0)

    # -- timeline ----------------------------------------------------------

    def event(self, name: str, t: float, **fields) -> None:
        """Append one timestamped timeline record.  ``t`` is whatever clock
        the caller lives on (the serve loop passes its injected clock's
        times, so virtual runs replay identically)."""
        self._timeline.append({"event": name, "t": float(t), **fields})

    def event_block(self, block) -> None:
        """Append the records ``block.dicts()`` returns (each an ``event()``
        record: ``{"event": name, "t": float, **fields}``, in order), built
        when ``events`` is first read after this."""
        self._timeline.append(block)
        self._blocks += 1

    @property
    def events(self) -> List[dict]:
        """Every timeline record, in record order."""
        if self._blocks:
            flat: List[dict] = []
            for rec in self._timeline:
                if isinstance(rec, dict):
                    flat.append(rec)
                else:
                    flat.extend(rec.dicts())
            self._timeline, self._blocks = flat, 0
        return self._timeline

    # -- export ------------------------------------------------------------

    def collect(self) -> List[dict]:
        return [m.collect() for _, m in sorted(self._metrics.items())]

    def get(self, name: str):
        return self._metrics.get(name)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (text/plain; version 0.0.4)."""
        out: List[str] = []
        for m in self.collect():
            name, kind = m["name"], m["kind"]
            if m["help"]:
                out.append(f"# HELP {name} {m['help']}")
            if kind in ("counter", "gauge"):
                out.append(f"# TYPE {name} {kind}")
                out.append(f"{name} {_fmt(m['value'])}")
            elif kind == "histogram":
                out.append(f"# TYPE {name} histogram")
                cum = 0
                for ub, c in zip(m["buckets"], m["counts"]):
                    cum += c
                    out.append(f'{name}_bucket{{le="{_fmt(ub)}"}} {cum}')
                cum += m["counts"][-1]
                out.append(f'{name}_bucket{{le="+Inf"}} {cum}')
                out.append(f"{name}_sum {_fmt(m['sum'])}")
                out.append(f"{name}_count {m['count']}")
            elif kind == "vector":
                out.append(f"# TYPE {name} counter")
                for i, v in enumerate(m["values"]):
                    out.append(f'{name}{{{m["label"]}="{i}"}} {_fmt(v)}')
        return "\n".join(out) + "\n"

    def export_jsonl(self, path: str, meta: Optional[dict] = None) -> None:
        """One JSON object per line: a ``meta`` header, every metric
        snapshot, then the event timeline in record order -- the format
        ``repro_torch.obs.report`` renders."""
        with open(path, "w") as f:
            f.write(json.dumps({"kind": "meta", **(meta or {})}) + "\n")
            for m in self.collect():
                # the record kind is "metric"; the metric's own kind
                # (counter/gauge/...) rides in "type" to avoid a key clash
                rec = {"kind": "metric", "type": m["kind"]}
                rec.update((k, v) for k, v in m.items() if k != "kind")
                f.write(json.dumps(rec) + "\n")
            for e in self.events:
                f.write(json.dumps({"kind": "event", **e}) + "\n")


def _fmt(v: float) -> str:
    """Prometheus number formatting: integers without the trailing .0."""
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


# ---------------------------------------------------------------------------
# Process-global default registry (build-phase spans and other sites without
# an injected registry report here; serve.py snapshots it into --metrics-out)
# ---------------------------------------------------------------------------

_GLOBAL = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _GLOBAL


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry (tests); returns the previous one."""
    global _GLOBAL
    prev, _GLOBAL = _GLOBAL, registry
    return prev
