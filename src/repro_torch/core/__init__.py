"""Proximity-graph MIPS (ip-NSW / ip-NSW+) in PyTorch.

The names below are exported lazily: ``from repro_torch.core import IpNSW``
imports its submodule at first use.  The kernels import ``core.similarity``,
so importing this package itself must import nothing.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "GraphIndex": "graph",
    "empty_graph": "graph",
    "in_degrees": "graph",
    "out_degrees": "graph",
    "Similarity": "similarity",
    "normalize": "similarity",
    "beam_search": "search",
    "SearchResult": "search",
    "BUILD_BACKENDS": "build",
    "build_graph": "build",
    "IpNSW": "ipnsw",
    "IpNSWPlus": "ipnsw_plus",
    "PlusResult": "ipnsw_plus",
    "exact_topk": "brute_force",
    "assert_graph_invariants": "invariants",
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
    "recall_at_k": "recall",
    "recall_curve": "recall",
    "ShardedIndex": "distributed",
    "RouteStats": "distributed",
    "ShardedMutable": "distributed",
    "build_sharded": "distributed",
    "norm_band_partition": "distributed",
    "shard_visit_mask": "distributed",
    "sharded_search": "distributed",
    "sharded_search_reference": "distributed",
    "HierarchicalIpNSW": "hnsw",
    "SimpleLSH": "lsh",
    "LSHResult": "lsh",
    "NormFilteredIndex": "norm_filter",
}
# the recall helpers live in the observability layer (repro_torch.obs.recall),
# as the JAX package's do; every other name in a submodule of this package
_PACKAGE = {"recall": "repro_torch.obs"}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = _EXPORTS[name]
    return getattr(importlib.import_module(f"{_PACKAGE.get(module, __name__)}.{module}"), name)
