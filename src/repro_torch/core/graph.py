"""Dense-adjacency proximity graph.

A graph over N items with max out-degree M is one ``[N, M]`` int32 tensor
(-1 = empty slot).  Out-degree is bounded by construction; in-degree is not,
which is the quantity the paper's Figure 4 analyses.  Unlike the JAX
package's functional updates, the build writes ``adj`` in place
(``core/build.py``), so one ``[N, M]`` buffer lives on the device for the
whole build; a mutable index (``core/mutation.py``) writes its padded copy
in place too.  ``dataclasses.replace(graph, entry=..., entry_norm=...)``
takes the place of the JAX NamedTuple's ``_replace``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class GraphIndex:
    """Proximity graph and the vectors it indexes.

    adj:        [N, M] int32 out-neighbor ids, -1 padded.
    items:      [N, d] fp32 vectors the similarity is computed against
                (normalized for the angular graph).
    size:       [] int64, number of inserted items (rows >= size are empty).
    entry:      [] int64, entry vertex of every walk.
    entry_norm: [] fp32, norm of the entry vertex (-inf while empty), carried
                so each commit advances the max-norm entry with an O(B)
                compare against its batch.
    """

    adj: torch.Tensor
    items: torch.Tensor
    size: torch.Tensor
    entry: torch.Tensor
    entry_norm: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.adj.shape[0]

    @property
    def max_degree(self) -> int:
        return self.adj.shape[1]


def empty_graph(items: torch.Tensor, max_degree: int) -> GraphIndex:
    n, dev = items.shape[0], items.device
    return GraphIndex(
        adj=torch.full((n, max_degree), -1, dtype=torch.int32, device=dev),
        items=items,
        size=torch.zeros((), dtype=torch.int64, device=dev),
        entry=torch.zeros((), dtype=torch.int64, device=dev),
        entry_norm=torch.full((), float("-inf"), dtype=torch.float32, device=dev),
    )


def pad_graph(graph: GraphIndex, capacity: int) -> GraphIndex:
    """A copy of ``graph`` with ``capacity`` rows: adjacency rows padded
    with -1, item rows with 0.  Always a copy, so in-place mutation of the
    result never writes the caller's tensors."""
    n, m = graph.adj.shape
    pad = capacity - n
    adj, items = graph.adj, graph.items
    return GraphIndex(
        adj=torch.cat([adj, adj.new_full((pad, m), -1)]),
        items=torch.cat([items, items.new_zeros((pad, items.shape[1]))]),
        size=graph.size.clone(),
        entry=graph.entry.clone(),
        entry_norm=graph.entry_norm.clone(),
    )


def in_degrees(graph: GraphIndex) -> np.ndarray:
    """In-degree of every vertex (host side; the Fig-4 statistic)."""
    adj = graph.adj.cpu().numpy()
    flat = adj[: int(graph.size)].reshape(-1)
    return np.bincount(flat[flat >= 0], minlength=graph.capacity)


def out_degrees(graph: GraphIndex) -> np.ndarray:
    return (graph.adj.cpu().numpy() >= 0).sum(axis=1)
