"""Observability: walk tracing on the device, a host-side metrics registry,
and snapshot / report exporters -- the JAX package's ``repro.obs``.

Nothing here imports ``repro_torch.core`` or ``repro_torch.launch``, so the
search, the build drivers and the serving loop can all report into it
without an import cycle.  ``python -m repro_torch.obs.report run.jsonl``
renders a run's JSONL export.
"""
from repro_torch.obs.export import (
    load_jsonl,
    render_band_table,
    render_latency_timeline,
    top_band_share,
    write_metrics,
)
from repro_torch.obs.recall import recall_at_k, recall_curve
from repro_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    VectorCounter,
    get_registry,
    set_registry,
)
from repro_torch.obs.trace import (
    TraceContext,
    WalkTrace,
    make_trace_context,
    step_of_column,
    walk_trace,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "TraceContext",
    "VectorCounter",
    "WalkTrace",
    "get_registry",
    "load_jsonl",
    "make_trace_context",
    "recall_at_k",
    "recall_curve",
    "render_band_table",
    "render_latency_timeline",
    "set_registry",
    "step_of_column",
    "top_band_share",
    "walk_trace",
    "write_metrics",
]
