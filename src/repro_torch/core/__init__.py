"""Proximity-graph MIPS (ip-NSW / ip-NSW+) in PyTorch.

The names below are exported lazily: ``from repro_torch.core import IpNSW``
imports its submodule at first use.  The kernels import ``core.similarity``,
so importing this package itself must import nothing.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "GraphIndex": "graph",
    "in_degrees": "graph",
    "out_degrees": "graph",
    "Similarity": "similarity",
    "beam_search": "search",
    "SearchResult": "search",
    "BUILD_BACKENDS": "build",
    "build_graph": "build",
    "IpNSW": "ipnsw",
    "IpNSWPlus": "ipnsw_plus",
    "PlusResult": "ipnsw_plus",
    "exact_topk": "brute_force",
    "check_graph_invariants": "invariants",
    "dead_edge_fraction": "invariants",
    "MutableIndex": "mutation",
    "ChurnEvent": "mutation",
    "ChurnTrace": "mutation",
    "apply_churn_event": "mutation",
    "STORAGE_BACKENDS": "storage",
    "ItemStore": "storage",
    "dequantize": "storage",
    "make_store": "storage",
    "quantize_items": "storage",
    "store_scores": "storage",
    "update_store_rows": "storage",
    "validate_storage": "storage",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
