"""Graph-invariant checker for a built index (host side).

  I1  adjacency ids are in ``[-1, capacity)``.
  I2  edges only point at used slots (``id < size``).
  I3  no self-loops.
  I4  the entry vertex is a used slot.

I5 and I6 concern the tombstone mask of a mutable index and come with it.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.graph import GraphIndex


def check_graph_invariants(graph: GraphIndex, *, name: str = "graph") -> List[str]:
    """Validate I1-I4; returns the violations (empty = healthy)."""
    adj = graph.adj.cpu().numpy()
    n, _ = adj.shape
    size = int(graph.size)
    entry = int(graph.entry)
    errs: List[str] = []

    if size < 0 or size > n:
        errs.append(f"{name}: size {size} outside [0, capacity={n}]")
        size = max(0, min(size, n))

    used = adj[:size]
    if used.size:
        amin, amax = int(used.min()), int(used.max())
        if amin < -1 or amax >= n:                                      # I1
            errs.append(
                f"{name}: adjacency ids span [{amin}, {amax}], outside [-1, {n})"
            )
        elif amax >= size:                                              # I2
            bad = int((used >= size).sum())
            errs.append(f"{name}: {bad} edges point at never-used slots >= size={size}")
        loops = int((used == np.arange(size)[:, None]).sum())           # I3
        if loops:
            errs.append(f"{name}: {loops} self-loop edges")

    if size > 0 and not (0 <= entry < size):                            # I4
        errs.append(f"{name}: entry {entry} is not a used slot (< {size})")
    return errs


def assert_graph_invariants(graph: GraphIndex, *, name: str = "graph") -> None:
    errs = check_graph_invariants(graph, name=name)
    if errs:
        raise AssertionError("graph invariants violated:\n  " + "\n  ".join(errs))
