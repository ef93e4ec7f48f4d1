"""Batched NSW construction (paper Algorithm 2), host driver.

Items are inserted in mini-batches: every item of a batch searches the
frozen current graph for its top-M neighbors (``find_neighbors``, the
parallel-HNSW approximation), then ``commit_batch`` writes the batch:

  forward edges  adj[new] = its top-M search results
  reverse edges  "add the reverse link and shrink to M" as a segmented top-M
                 merge (``commit_merge``: the CUDA kernel for CUDA tensors,
                 its plain version for CPU tensors)

``adj`` is updated in place: one ``[N, M]`` buffer for the whole build.
``reverse_links=False`` reproduces Algorithm 2 as printed (directed edges
only), which is not navigable from a fixed entry vertex (DESIGN.md §2).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.graph import GraphIndex, empty_graph
from repro_torch.core.search import beam_search
from repro_torch.core.similarity import NEG_INF, Similarity, pair_scores, prepare_items, top_l
from repro_torch.kernels.commit_merge import commit_merge


def commit_batch(
    graph: GraphIndex,
    batch_ids: torch.Tensor,   # [B] distinct ids being inserted, in any order
    nbr_ids: torch.Tensor,     # [B, M] int32 chosen neighbors (-1 padded)
    nbr_scores: torch.Tensor,  # [B, M] fp32
    norms: torch.Tensor,       # [N] fp32 (for the entry vertex)
    reverse_links: bool = True,
) -> GraphIndex:
    """Write one insertion batch into ``graph.adj`` (in place) and advance
    size and entry.  The entry follows the largest norm: an O(B) compare of
    the batch's best against the carried ``entry_norm``.  A build inserts
    ascending ids; a mutable index commits reused slots in FIFO order, and
    the first maximum in batch order wins, as in the JAX package."""
    m = graph.adj.shape[1]
    adj = graph.adj
    batch_ids = batch_ids.long()
    adj[batch_ids] = nbr_ids.to(adj.dtype)
    size = torch.maximum(graph.size, batch_ids.max() + 1)
    if reverse_links:
        commit_merge(
            adj, graph.items,
            nbr_ids.reshape(-1).to(torch.int32),
            batch_ids[:, None].expand(-1, m).reshape(-1).to(torch.int32),
            nbr_scores.reshape(-1).float(),
        )
    b_norms = norms[batch_ids]
    best = torch.argmax(b_norms)  # the first max in batch order
    take = b_norms[best] > graph.entry_norm
    return GraphIndex(
        adj=adj,
        items=graph.items,
        size=size,
        entry=torch.where(take, batch_ids[best], graph.entry),
        entry_norm=torch.where(take, b_norms[best], graph.entry_norm),
    )


def _bootstrap_neighbors(batch_items: torch.Tensor, max_degree: int):
    """Exact neighbors inside the first batch, item i linking only to items
    0..i-1 (sequential insertion)."""
    b = batch_items.shape[0]
    s = pair_scores(batch_items, batch_items)
    i = torch.arange(b, device=batch_items.device)
    s = torch.where(i[None, :] < i[:, None], s, NEG_INF)
    k = min(max_degree, b)
    vals, idxs = top_l(s, k)
    ids = torch.where(vals > NEG_INF, idxs, -1).to(torch.int32)
    pad = max_degree - k
    if pad:
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        vals = torch.nn.functional.pad(vals, (0, pad), value=NEG_INF)
    return ids, vals


def find_neighbors(
    graph: GraphIndex,
    batch_items: torch.Tensor,
    *,
    max_degree: int,
    ef: int,
    max_steps: int,
    live: Optional[torch.Tensor] = None,
):
    """Algorithm-1 search of the current graph for each batch item's top M.
    ``live`` is a mutable index's tombstone mask: the walk routes through
    dead nodes but never returns one, so no new edge points at a tombstone."""
    init = graph.entry.expand(batch_items.shape[0], 1)
    res = beam_search(graph, batch_items, init, pool_size=ef,
                      max_steps=max_steps, k=max_degree, live=live)
    return torch.where(res.scores > NEG_INF, res.ids, -1), res.scores


def batch_schedule(n: int, insert_batch: int):
    """The insertion schedule: ``(first, batch_ids, batch_valid)`` -- the
    bootstrap batch size and the ``[num_batches, insert_batch]`` ids (tail
    clamped) and validity of the remaining batches."""
    first = min(insert_batch, n)
    starts = np.arange(first, n, insert_batch, dtype=np.int64)
    ids = starts[:, None] + np.arange(insert_batch, dtype=np.int64)[None, :]
    valid = ids < n
    return first, np.minimum(ids, n - 1), valid


def bootstrap_graph(
    prepared: torch.Tensor,
    norms: torch.Tensor,
    *,
    max_degree: int,
    insert_batch: int,
    reverse_links: bool,
) -> GraphIndex:
    """Empty graph plus the sequential-prefix first batch."""
    graph = empty_graph(prepared, max_degree)
    first = min(insert_batch, prepared.shape[0])
    ids0 = torch.arange(first, device=prepared.device)
    nbr0, sc0 = _bootstrap_neighbors(prepared[:first], max_degree)
    return commit_batch(graph, ids0, nbr0, sc0, norms, reverse_links=reverse_links)


def build_graph(
    items: torch.Tensor,
    *,
    similarity: Similarity = Similarity.INNER_PRODUCT,
    max_degree: int = 16,
    ef_construction: int = 32,
    insert_batch: int = 128,
    reverse_links: bool = True,
) -> GraphIndex:
    """Build an NSW graph over ``items`` (on their device) under
    ``similarity``; insertion walks take up to ``2 * ef_construction``
    steps."""
    prepared = prepare_items(items.float(), similarity).contiguous()
    norms = torch.linalg.vector_norm(prepared, dim=-1)
    graph = bootstrap_graph(prepared, norms, max_degree=max_degree,
                            insert_batch=insert_batch, reverse_links=reverse_links)
    _, batch_ids, batch_valid = batch_schedule(prepared.shape[0], insert_batch)
    for row, valid in zip(batch_ids, batch_valid):
        bids = torch.as_tensor(row[valid], device=prepared.device)
        nbr, sc = find_neighbors(graph, prepared[bids], max_degree=max_degree,
                                 ef=ef_construction, max_steps=2 * ef_construction)
        graph = commit_batch(graph, bids, nbr, sc, norms, reverse_links=reverse_links)
    return graph
