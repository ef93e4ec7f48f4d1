"""Render a serve run's JSONL metrics export: the paper's Fig-4/5
recomputed from served (or simulated) traffic.

Input: the JSONL written by ``python -m repro_torch.launch.serve --loop
--trace --metrics-out run.jsonl`` (or any ``MetricsRegistry.export_jsonl``
snapshot).  Output:

  norm-band heat table -- evals per catalog norm decile from the
      ``walk_evals_by_band`` vector; on heavy-tailed (lognormal) catalogs
      the top decile carries most of the evals (the paper's Fig-5 norm-bias
      claim, printed as ``top_decile_share`` for scripting).
  latency timeline -- per-time-bin p50/p99 from the ``response`` events.
  scalar summary -- requests / batches / degrades / misses, the hub-eval
      share, and the churn health gauges when present.

  PYTHONPATH=src python -m repro_torch.obs.report run.jsonl [--bins 20]

The JAX package's ``scripts/obs_report.py``, on the port's copy of the
export module: the same sections and the same summary dict.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs.export import (
    load_jsonl,
    render_band_table,
    render_latency_timeline,
    top_band_share,
)


def report(path: str, *, n_bins: int = 12, out=sys.stdout) -> dict:
    """Render all sections to ``out``; returns the scalar summary."""
    snap = load_jsonl(path)
    meta, metrics, events = snap["meta"], snap["metrics"], snap["events"]

    w = out.write
    if meta:
        kv = " ".join(f"{k}={v}" for k, v in meta.items()
                      if k != "band_edges")
        w(f"# meta: {kv}\n")

    summary: dict = {}
    band = metrics.get("walk_evals_by_band")
    if band is not None:
        share = top_band_share(band["values"])
        summary["top_decile_share"] = share
        w("\n== evals by catalog norm band (band 0 = smallest norms) ==\n")
        w(render_band_table(band["values"], meta.get("band_edges"),
                            label="band") + "\n")
        w(f"top_decile_share={share:.4f}\n")
    else:
        w("\n(no walk_evals_by_band vector — run with --trace to get the "
          "norm-bias table)\n")

    w("\n== latency timeline (loop clock) ==\n")
    w(render_latency_timeline(events, n_bins=n_bins) + "\n")

    w("\n== scalars ==\n")
    for name in sorted(metrics):
        m = metrics[name]
        if m["kind"] in ("counter", "gauge"):
            summary[name] = m["value"]
            w(f"{name} = {m['value']:g}\n")
        elif m["kind"] == "histogram" and m["count"]:
            mean = m["sum"] / m["count"]
            summary[name] = mean
            w(f"{name}: count={m['count']} mean={mean:g}\n")

    ev_total = metrics.get("walk_evals_total")
    hub = metrics.get("walk_hub_evals_total")
    if ev_total and hub and ev_total["value"] > 0:
        frac = hub["value"] / ev_total["value"]
        summary["hub_eval_share"] = frac
        w(f"hub_eval_share = {frac:.4f}\n")
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render a repro_torch.obs JSONL export (see module docstring)"
    )
    ap.add_argument("jsonl", help="path written by serve --metrics-out")
    ap.add_argument("--bins", type=int, default=12,
                    help="latency-timeline time bins")
    args = ap.parse_args(argv)
    report(args.jsonl, n_bins=args.bins)
    return 0


if __name__ == "__main__":
    sys.exit(main())
