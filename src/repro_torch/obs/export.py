"""Snapshot export + report rendering for the metrics registry: a copy of
the JAX package's ``obs/export.py``.

Two wire formats, dispatched on file extension by :func:`write_metrics`:

  ``*.prom``  -- Prometheus text exposition (scalar snapshot; scrape-shaped).
  anything else -- JSONL: one ``meta`` header line, one line per metric, one
      line per timeline event (``MetricsRegistry.export_jsonl``).  JSONL is
      the lossless format: it keeps the event timeline, which is what the
      report renderers below need.

The renderers are plain-string functions (no terminal deps), so
``repro_torch.obs.report`` stays a thin wrapper and tests can pin the
rendering directly:

  render_band_table    -- the norm-band eval histogram as a heat table: the
      paper's Fig-5 recomputed from served traffic.
  render_latency_timeline -- per-time-bin p50/p99 from ``response`` events:
      "why did p99 spike at t=3s" becomes answerable from the export alone.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np


def write_metrics(registry, path: str, meta: Optional[dict] = None) -> str:
    """Write a registry snapshot; format chosen by extension.  Returns the
    format written ("prometheus" | "jsonl")."""
    if path.endswith(".prom"):
        with open(path, "w") as f:
            f.write(registry.to_prometheus())
        return "prometheus"
    registry.export_jsonl(path, meta=meta)
    return "jsonl"


def load_jsonl(path: str) -> dict:
    """Parse a JSONL export back into ``{meta, metrics: {name: rec},
    events: [rec]}`` -- the inverse of ``export_jsonl``."""
    meta: dict = {}
    metrics: Dict[str, dict] = {}
    events: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.pop("kind", None)
            if kind == "meta":
                meta = rec
            elif kind == "metric":
                rec["kind"] = rec.pop("type")  # restore the metric's kind
                metrics[rec["name"]] = rec
            elif kind == "event":
                events.append(rec)
            else:
                raise ValueError(f"{path}: unknown record kind {kind!r}")
    return {"meta": meta, "metrics": metrics, "events": events}


def top_band_share(values: Sequence[float]) -> float:
    """Fraction of all band counts that landed in the top (last) band --
    the paper's norm-bias concentration number."""
    v = np.asarray(values, np.float64)
    total = v.sum()
    return float(v[-1] / total) if total > 0 else 0.0


def render_band_table(
    values: Sequence[float],
    edges: Optional[Sequence[float]] = None,
    *,
    label: str = "band",
    width: int = 40,
) -> str:
    """Render a norm-band eval histogram as an aligned heat table.

    values: per-band counts (band 0 = smallest norms .. last = largest).
    edges:  optional n_bands+1 norm edges for a (lo, hi] range column.
    """
    v = np.asarray(values, np.float64)
    total = v.sum()
    peak = v.max() if v.size else 0.0
    lines = [f"{label:>8}  {'norm range':>17}  {'evals':>12}  share"]
    for i, count in enumerate(v):
        if edges is not None and len(edges) == len(v) + 1:
            rng = f"({edges[i]:7.3f},{edges[i + 1]:7.3f}]"
        else:
            rng = f"{'—':>17}"
        share = count / total if total > 0 else 0.0
        bar = "#" * int(round(width * (count / peak))) if peak > 0 else ""
        lines.append(
            f"{i:>8}  {rng:>17}  {count:>12.0f}  {share:6.1%} {bar}"
        )
    lines.append(
        f"{'total':>8}  {'':>17}  {total:>12.0f}  top-{label} share "
        f"{top_band_share(v):.1%}"
    )
    return "\n".join(lines)


def render_latency_timeline(
    events: List[dict],
    *,
    n_bins: int = 12,
    width: int = 40,
) -> str:
    """Render ``response`` events (fields: t, latency_s) as a binned p50/p99
    timeline.  Timestamps are whatever clock the loop ran on (virtual runs
    render deterministically)."""
    resp = [e for e in events if e.get("event") == "response"]
    if not resp:
        return "(no response events)"
    t = np.array([e["t"] for e in resp])
    lat_ms = np.array([e["latency_s"] for e in resp]) * 1e3
    t0, t1 = t.min(), t.max()
    span = max(t1 - t0, 1e-9)
    bins = np.minimum((n_bins * (t - t0) / span).astype(int), n_bins - 1)
    peak = lat_ms.max()
    lines = [
        f"{'t (s)':>14}  {'n':>5}  {'p50 ms':>8}  {'p99 ms':>8}",
    ]
    for i in range(n_bins):
        sel = lat_ms[bins == i]
        lo = t0 + span * i / n_bins
        hi = t0 + span * (i + 1) / n_bins
        if sel.size == 0:
            lines.append(f"[{lo:5.2f},{hi:5.2f})  {0:>5}  {'—':>8}  {'—':>8}")
            continue
        p50, p99 = np.percentile(sel, [50, 99])
        bar = "#" * int(round(width * (p99 / peak))) if peak > 0 else ""
        lines.append(
            f"[{lo:5.2f},{hi:5.2f})  {sel.size:>5}  {p50:>8.2f}  "
            f"{p99:>8.2f} {bar}"
        )
    lines.append(
        f"{'overall':>14}  {len(lat_ms):>5}  "
        f"{np.percentile(lat_ms, 50):>8.2f}  {np.percentile(lat_ms, 99):>8.2f}"
    )
    return "\n".join(lines)
