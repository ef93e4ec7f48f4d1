"""Batched NSW construction (paper Algorithm 2).

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

Build drivers (``build_backend=``, BUILD_BACKENDS):
  "host"  a Python loop over the schedule's batches, each of its own size
          (the tail ragged); every walk reads its step count back.
  "scan"  the JAX package's ``lax.scan`` over fixed-shape batches: every
          batch has ``insert_batch`` rows, the tail's pad rows masked by
          ``valid=`` (born done in the walk, dropped by the commit), and
          the carry (adj, size, entry, entry_norm) is written in place.  On
          the card one batch is captured as a CUDA graph and replayed for
          every row of the schedule, with no read-back between batches
          (``replay_schedule``); on the CPU the same batch runs eagerly, row
          by row.  The graph is bit-identical to the host driver's.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.capture import capture, no_sync
from repro_torch.core.graph import GraphIndex, empty_graph
from repro_torch.core.search import beam_search
from repro_torch.core.similarity import NEG_INF, Similarity, pair_scores, prepare_items, top_l
from repro_torch.kernels.commit_merge import commit_merge

BUILD_BACKENDS = ("host", "scan")


def validate_build_backend(build_backend: str, neighbor_fn: Optional[Callable] = None) -> None:
    """Raise for an unknown driver, or for a custom finder under "scan"."""
    if build_backend not in BUILD_BACKENDS:
        raise ValueError(f"build_backend must be one of {BUILD_BACKENDS}, got {build_backend!r}")
    if build_backend == "scan" and neighbor_fn is not None:
        raise ValueError("build_backend='scan' runs the standard Algorithm-2 finder in its "
                         "fixed-shape batch and cannot honor neighbor_fn; use "
                         "build_backend='host' for custom finders")


def commit_batch(
    graph: GraphIndex,
    batch_ids: torch.Tensor,   # [B] ids being inserted, in any order
    nbr_ids: torch.Tensor,     # [B, M] int32 chosen neighbors (-1 padded)
    nbr_scores: torch.Tensor,  # [B, M] fp32
    norms: torch.Tensor,       # [N] fp32 (for the entry vertex)
    valid: Optional[torch.Tensor] = None,  # [B] bool, False = pad row
    reverse_links: bool = True,
) -> GraphIndex:
    """Write one insertion batch into ``graph.adj`` (in place) and return
    the graph with its new size and entry.  The entry follows the largest
    norm: an O(B) compare of the batch's best against the carried
    ``entry_norm``.  A build inserts ascending ids; a mutable index commits
    reused slots in FIFO order, and the first maximum in batch order wins,
    as in the JAX package.  The valid ids of a batch are distinct.

    ``valid`` masks the pad rows of a fixed-shape batch (the scan driver's
    tail): a pad row adds no edge, does not advance ``size`` and cannot
    become the entry, so a padded batch commits bit-identically to its
    ragged slice.  A pad id may repeat a valid one (the schedule clamps
    them to n - 1), and a scatter to repeated rows keeps any one of their
    values on the card; so every row is written with the values of the
    valid batch row of its id, or with its own where there is none.
    Nothing is read back: the commit can be captured in a CUDA graph."""
    m = graph.adj.shape[1]
    adj = graph.adj
    batch_ids = batch_ids.long()
    nbr_ids = nbr_ids.to(adj.dtype)
    if valid is None:
        adj[batch_ids] = nbr_ids
        ids_or_pad = batch_ids
    else:
        valid = valid.to(device=adj.device, dtype=torch.bool)
        nbr_ids = torch.where(valid[:, None], nbr_ids, -1)
        owner = (batch_ids[:, None] == batch_ids[None, :]) & valid[None, :]  # [B, B]
        rows = torch.where(owner.any(dim=1)[:, None], nbr_ids[owner.int().argmax(dim=1)],
                           adj[batch_ids])
        adj[batch_ids] = rows
        ids_or_pad = torch.where(valid, batch_ids, -1)
    size = torch.maximum(graph.size, ids_or_pad.max() + 1)
    if reverse_links:
        # a pad row's proposals all have target -1: the merge skips them
        commit_merge(
            adj, graph.items,
            nbr_ids.reshape(-1).to(torch.int32),
            batch_ids[:, None].expand(-1, m).reshape(-1).to(torch.int32),
            nbr_scores.reshape(-1).float(),
        )
    b_norms = norms[batch_ids]
    if valid is not None:
        b_norms = torch.where(valid, b_norms, NEG_INF)
    # the first max in batch order, as a 1-element index: indexing with a
    # 0-dim tensor would read it back
    best = torch.argmax(b_norms, dim=0, keepdim=True)
    best_norm = b_norms.gather(0, best).squeeze(0)
    take = best_norm > graph.entry_norm
    return GraphIndex(
        adj=adj,
        items=graph.items,
        size=size,
        entry=torch.where(take, batch_ids.gather(0, best).squeeze(0), graph.entry),
        entry_norm=torch.where(take, best_norm, graph.entry_norm),
    )


def write_carry(graph: GraphIndex, new: GraphIndex) -> None:
    """Copy ``new``'s size, entry and entry_norm into ``graph``'s tensors:
    the in-place carry a replayed batch needs, whose tensors keep their
    addresses.  (``adj`` is written in place already.)"""
    graph.size.copy_(new.size)
    graph.entry.copy_(new.entry)
    graph.entry_norm.copy_(new.entry_norm)


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
    valid: Optional[torch.Tensor] = None,
    capturable: bool = False,
):
    """Algorithm-1 search of the current graph for each batch item's top M.
    ``live`` is a mutable index's tombstone mask: the walk routes through
    dead nodes but never returns one, so no new edge points at a tombstone.
    ``valid`` masks pad rows (born done, ids -1) and ``capturable`` reads
    nothing back (``search.beam_search``)."""
    init = graph.entry.expand(batch_items.shape[0], 1)
    res = beam_search(graph, batch_items, init, pool_size=ef, max_steps=max_steps,
                      k=max_degree, live=live, valid=valid, capturable=capturable)
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


class ScanRun(NamedTuple):
    """What ``replay_schedule`` did on the card, for its caller to read."""

    replays: int         # graph replays: rows 1 .. T-1
    capture_ms: float    # host time of the capture (its synchronize included)
    loop_host_ms: float  # host time of the replay loop, before any wait
    loop_events: tuple   # (start, end) CUDA events around the replay loop


def replay_schedule(
    step: Callable[[torch.Tensor, torch.Tensor], None],
    batch_ids: torch.Tensor,    # [T, B] int64
    batch_valid: torch.Tensor,  # [T, B] bool
) -> None:
    """Run ``step(ids, valid)``, a fixed-shape batch that writes its carry
    in place, for every row of the schedule, in order.

    On the CPU each row runs eagerly.  On the card row 0 runs eagerly (the
    warm-up of ``capture.capture``: it is a real batch and inserts its ids),
    then ``step`` is captured once as a CUDA graph on two static buffers,
    and every later row is copied into them on the device and replayed, the
    replay loop under ``capture.no_sync()``: a read-back in it raises.  A
    capture or replay that fails raises; nothing falls back to the eager
    loop.  ``replay_schedule.last`` is the ``ScanRun`` of the latest
    schedule replayed."""
    rows = batch_ids.shape[0]
    if batch_ids.device.type != "cuda" or rows < 2:
        for t in range(rows):
            step(batch_ids[t], batch_valid[t])
        return
    ids, valid = batch_ids[0].clone(), batch_valid[0].clone()
    cap = capture(step, ids, valid)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with no_sync():
        t0 = time.perf_counter()
        start.record()
        for t in range(1, rows):
            ids.copy_(batch_ids[t])
            valid.copy_(batch_valid[t])
            cap.graph.replay()
        end.record()
        loop_host_ms = (time.perf_counter() - t0) * 1e3
    replay_schedule.last = ScanRun(rows - 1, cap.capture_ms, loop_host_ms, (start, end))


replay_schedule.last = None


def insert_batch_step(
    graph: GraphIndex,
    norms: torch.Tensor,
    *,
    max_degree: int,
    ef: int,
    max_steps: int,
    reverse_links: bool,
) -> Callable[[torch.Tensor, torch.Tensor], None]:
    """The scan driver's batch (the body of the JAX package's
    ``_scan_insert``): find the ``[B]`` ids' neighbors with pad rows masked,
    commit them, and write the carry into ``graph`` in place."""

    def step(bids: torch.Tensor, vmask: torch.Tensor) -> None:
        nbr, sc = find_neighbors(graph, graph.items[bids], max_degree=max_degree, ef=ef,
                                 max_steps=max_steps, valid=vmask, capturable=True)
        write_carry(graph, commit_batch(graph, bids, nbr, sc, norms, valid=vmask,
                                        reverse_links=reverse_links))

    return step


def scan_build_arrays(
    prepared: torch.Tensor,
    norms: torch.Tensor,
    batch_ids: torch.Tensor,    # [T, B] int64 (tail clamped)
    batch_valid: torch.Tensor,  # [T, B] bool
    *,
    max_degree: int,
    ef: int,
    max_steps: int,
    insert_batch: int,
    reverse_links: bool,
):
    """The scan build (bootstrap, then ``replay_schedule`` over the
    fixed-shape batch) -> ``(adj, size, entry, entry_norm)``."""
    graph = bootstrap_graph(prepared, norms, max_degree=max_degree,
                            insert_batch=insert_batch, reverse_links=reverse_links)
    replay_schedule(insert_batch_step(graph, norms, max_degree=max_degree, ef=ef,
                                      max_steps=max_steps, reverse_links=reverse_links),
                    batch_ids, batch_valid)
    return graph.adj, graph.size, graph.entry, graph.entry_norm


def build_graph(
    items: torch.Tensor,
    *,
    similarity: Similarity = Similarity.INNER_PRODUCT,
    max_degree: int = 16,
    ef_construction: int = 32,
    insert_batch: int = 128,
    reverse_links: bool = True,
    max_steps: Optional[int] = None,
    neighbor_fn: Optional[Callable] = None,
    build_backend: str = "host",
    progress: bool = False,
) -> GraphIndex:
    """Build an NSW graph over ``items`` (on their device) under
    ``similarity``; insertion walks take up to ``max_steps`` steps
    (``2 * ef_construction`` unless given).  ``neighbor_fn(graph,
    batch_items) -> (ids, scores)`` replaces the neighbor search (host
    driver only); ``build_backend`` picks the driver (BUILD_BACKENDS).
    Both are validated before any build work."""
    validate_build_backend(build_backend, neighbor_fn)
    prepared = prepare_items(items.float(), similarity).contiguous()
    n = prepared.shape[0]
    norms = torch.linalg.vector_norm(prepared, dim=-1)
    steps = max_steps if max_steps is not None else 2 * ef_construction
    _, batch_ids, batch_valid = batch_schedule(n, insert_batch)
    if build_backend == "scan":
        adj, size, entry, entry_norm = scan_build_arrays(
            prepared, norms, torch.as_tensor(batch_ids, device=prepared.device),
            torch.as_tensor(batch_valid, device=prepared.device), max_degree=max_degree,
            ef=ef_construction, max_steps=steps, insert_batch=insert_batch,
            reverse_links=reverse_links)
        return GraphIndex(adj=adj, items=prepared, size=size, entry=entry, entry_norm=entry_norm)

    graph = bootstrap_graph(prepared, norms, max_degree=max_degree,
                            insert_batch=insert_batch, reverse_links=reverse_links)
    for row, valid in zip(batch_ids, batch_valid):
        bids = torch.as_tensor(row[valid], device=prepared.device)
        if neighbor_fn is None:
            nbr, sc = find_neighbors(graph, prepared[bids], max_degree=max_degree,
                                     ef=ef_construction, max_steps=steps)
        else:
            nbr, sc = neighbor_fn(graph, prepared[bids])
        graph = commit_batch(graph, bids, nbr, sc, norms, reverse_links=reverse_links)
        if progress and (int(row[0]) // insert_batch) % 20 == 0:
            print(f"  inserted {int(row[valid][-1]) + 1}/{n}")
    return graph
