"""Uniform fanout neighbor sampler (GraphSAGE-style) for the
``minibatch_lg`` shape, a copy of the JAX package's ``models/sampler.py``:
the same ``np.random.Generator`` calls in the same order, so the same seed
gives the same arrays.

Host-side numpy (samplers are data-pipeline work, not accelerator work);
returns fixed-shape padded arrays, so the GNN step sees the same shapes at
every step:

  sample_subgraph(csr, seeds, fanouts) ->
    {node_feat-gatherable local ids, src, dst, n_nodes, n_edges}

Local relabeling: sampled nodes get contiguous local ids (seeds first), the
edge index is local, padding is -1.  Deterministic per (seed, step) via the
provided rng.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np


class CSRGraph(NamedTuple):
    indptr: np.ndarray   # [N+1]
    indices: np.ndarray  # [nnz]

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1


def random_csr(n_nodes: int, avg_degree: int, rng: np.random.Generator) -> CSRGraph:
    """Synthetic power-law-ish CSR graph for tests/benchmarks."""
    deg = np.clip(
        rng.zipf(1.6, n_nodes) + avg_degree // 2, 1, 16 * avg_degree
    ).astype(np.int64)
    scale = (avg_degree * n_nodes) / max(deg.sum(), 1)
    deg = np.maximum((deg * scale).astype(np.int64), 1)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    indices = rng.integers(0, n_nodes, size=int(indptr[-1]), dtype=np.int64)
    return CSRGraph(indptr=indptr, indices=indices)


def sample_subgraph(
    graph: CSRGraph,
    seeds: np.ndarray,
    fanouts: Sequence[int],
    rng: np.random.Generator,
    pad_to: tuple | None = None,
):
    """Layered uniform sampling.  Returns dict with local-id edge index.

    pad_to = (max_nodes, max_edges) fixes the output shapes."""
    seeds = np.asarray(seeds, dtype=np.int64)
    local_of = {int(s): i for i, s in enumerate(seeds)}
    nodes = list(seeds)
    src_l, dst_l = [], []
    frontier = seeds

    for fanout in fanouts:
        next_frontier = []
        for u in frontier:
            lo, hi = graph.indptr[u], graph.indptr[u + 1]
            nbrs = graph.indices[lo:hi]
            if len(nbrs) == 0:
                continue
            take = rng.choice(nbrs, size=min(fanout, len(nbrs)), replace=False)
            for v in take:
                v = int(v)
                if v not in local_of:
                    local_of[v] = len(nodes)
                    nodes.append(v)
                    next_frontier.append(v)
                # message v -> u (aggregate from sampled neighbor into seed)
                src_l.append(local_of[v])
                dst_l.append(local_of[int(u)])
        frontier = np.asarray(next_frontier, dtype=np.int64)

    node_ids = np.asarray(nodes, dtype=np.int64)
    src = np.asarray(src_l, dtype=np.int32)
    dst = np.asarray(dst_l, dtype=np.int32)

    if pad_to is not None:
        max_nodes, max_edges = pad_to
        assert len(node_ids) <= max_nodes and len(src) <= max_edges, (
            len(node_ids),
            len(src),
            pad_to,
        )
        node_ids = np.pad(node_ids, (0, max_nodes - len(node_ids)), constant_values=0)
        src = np.pad(src, (0, max_edges - len(src)), constant_values=-1)
        dst = np.pad(dst, (0, max_edges - len(dst)), constant_values=-1)

    return {
        "node_ids": node_ids,
        "src": src,
        "dst": dst,
        "n_nodes": len(nodes),
        "n_edges": len(src_l),
    }


def fanout_budget(batch_nodes: int, fanouts: Sequence[int]) -> tuple:
    """Worst-case (max_nodes, max_edges) for padding."""
    n, e, layer = batch_nodes, 0, batch_nodes
    for f in fanouts:
        e += layer * f
        layer = layer * f
        n += layer
    return n, e
