"""Graph-invariant checker for a built or mutating index.

  I1  adjacency ids are in ``[-1, capacity)``.
  I2  edges only point at used slots (``id < size``).
  I3  no self-loops.
  I4  the entry vertex is a used slot and, with a live mask, a live one.
  I5  live rows exist only among used slots (``live[size:]`` is all False).
  I6  the dead-edge fraction -- edges from live rows into tombstones over
      all edges from live rows -- stays under ``max_dead_edge_frac``: the
      navigability budget churn spends and ``relink`` repays.

The checker runs on the host and returns the violations (empty = healthy),
with the JAX package's messages.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.core.graph import GraphIndex


def dead_edge_fraction(adj, live, size: int) -> float:
    """Fraction of the out-edges of live used rows whose target is not live
    (-1 pads are not edges; edges out of dead rows do not count).  Takes
    tensors, on their device, or numpy arrays."""
    adj = torch.as_tensor(adj)[:size]
    live = torch.as_tensor(live, device=adj.device).bool()
    edge = (adj >= 0) & live[:size, None]
    n_edges = int(edge.sum())
    if n_edges == 0:
        return 0.0
    dead = edge & ~live[adj.clamp_min(0).long()]
    return int(dead.sum()) / n_edges


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def check_graph_invariants(
    graph: GraphIndex,
    live=None,
    *,
    max_dead_edge_frac: float = 1.0,
    name: str = "graph",
) -> List[str]:
    """Validate I1-I4 and, given the ``[capacity]`` bool ``live`` mask, the
    live half of I4, I5 and I6; returns the violations."""
    adj = _host(graph.adj)
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

    if live is not None:
        live = _host(live).astype(bool)
        if live.shape != (n,):
            errs.append(f"{name}: live mask shape {live.shape} != ({n},)")
            return errs
        if size > 0 and live.any() and not live[entry]:                 # I4
            errs.append(f"{name}: entry {entry} is tombstoned")
        tail_live = int(live[size:].sum())                              # I5
        if tail_live:
            errs.append(f"{name}: {tail_live} live rows beyond size={size}")
        frac = dead_edge_fraction(adj, live, size)                      # I6
        if frac > max_dead_edge_frac:
            errs.append(
                f"{name}: dead-edge fraction {frac:.3f} exceeds {max_dead_edge_frac:.3f}"
            )
    return errs


def assert_graph_invariants(
    graph: GraphIndex,
    live=None,
    *,
    max_dead_edge_frac: float = 1.0,
    name: str = "graph",
) -> None:
    errs = check_graph_invariants(graph, live, max_dead_edge_frac=max_dead_edge_frac,
                                  name=name)
    if errs:
        raise AssertionError("graph invariants violated:\n  " + "\n  ".join(errs))
