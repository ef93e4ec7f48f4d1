"""Batched graph-walk search (paper Algorithm 1).

B queries advance in lock-step.  Per query:
  pool    -- fixed-size candidate pool (ids, scores, checked), sorted by score
             descending (the paper's candidate pool C of size l);
  visited -- append-only buffer of every id scored; each step appends exactly
             M slots per query, so the write offset is one scalar
             (seeds + step * M);
  evals   -- similarity evaluations (the paper's Fig-5/8a metric).

A query is done when every slot of its pool is checked.  The walk ends
when every query is done or ``max_steps`` is reached (the condition of the
JAX package's ``lax.while_loop``).  It is one ``beam_walk`` call: on the
card one kernel launch that runs every row's steps and reads back only the
step count; on the CPU the host loop of ``beam_step``'s plain version.

Storage (``storage=``, ``core/storage.py``): "int8" walks on the quantized
store -- seeds by ``store_scores`` (the ``quant_score`` kernel), steps by the
int8 walk -- and re-scores the final pool exactly in fp32
(``gather_score``) before the top-k cut, so returned scores are exact inner
products.

Tombstones (``live=``, ``core/mutation.py``): walks route through dead
nodes, which keep their scores in the pool and their adjacency rows, and
count the evaluations spent on them (``SearchResult.dead_evals``); the final
cut never returns one.

Bucket padding (``valid=``, ``launch/serve_loop.py``): pad rows lose their
seeds and are born done, so they take no step, spend no evaluation and come
back as ids -1 / scores -inf; the walk ends once every valid row is done.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.graph import GraphIndex
from repro_torch.core.similarity import NEG_INF, top_l
from repro_torch.core.storage import ItemStore, quantize_items, store_scores, validate_storage
from repro_torch.kernels.beam_step import beam_walk
from repro_torch.kernels.gather_score import gather_score


class SearchResult(NamedTuple):
    ids: torch.Tensor      # [B, k] int32, -1 padded
    scores: torch.Tensor   # [B, k] fp32
    evals: torch.Tensor    # [B] int32 similarity evaluations
    steps: int             # loop iterations executed
    visited: torch.Tensor  # [B, V] int32 every scored id (-1 padded)
    dead_evals: Optional[torch.Tensor] = None  # [B] int32 evals on tombstones
    #   (None without a live mask)


def _dedup_ids(ids: torch.Tensor) -> torch.Tensor:
    """Sort each row and replace repeated ids by -1."""
    s = torch.sort(ids, dim=-1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[..., 1:] = s[..., 1:] == s[..., :-1]
    return torch.where(dup, -1, s)


def beam_search(
    graph: GraphIndex,
    queries: torch.Tensor,
    init_ids: torch.Tensor,
    *,
    pool_size: int,
    max_steps: int,
    k: int,
    storage: str = "f32",
    store: Optional[ItemStore] = None,
    live: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
) -> SearchResult:
    """Run the batched walk.

    queries:  [B, d] fp32.
    init_ids: [B, S] int32 seed ids (-1 padded, repeats allowed): the entry
              vertex for ip-NSW, the G_s neighborhood of the angular results
              for ip-NSW+ (Algorithm 3).
    storage:  "f32" | "int8" -- the item representation the walk streams.
              "int8" scores seeds and steps with ``store`` (quantized from
              ``graph.items`` here when not given; the index classes pass
              their cached store), counts quantized evaluations, and cuts the
              top k of the final pool by its exact fp32 scores; ids whose
              exact score is -inf come back as -1.
    live:     [N] bool tombstone mask of a mutable index, or None.  Dead
              nodes route the walk but are cut from the results (ids -1 when
              fewer than k live ids remain), and ``dead_evals`` counts the
              evaluations spent on them.  ``None`` runs the frozen-index path
              unchanged.
    valid:    [B] bool bucket-padding mask of the serving loop, or None.
              Pad rows (False) are born done with an empty pool: no step, 0
              evals and 0 dead evals, ids -1 and scores -inf.  Every step is
              row-wise and done rows are frozen, so a valid row's result is
              bit-identical to the same query searched without padding.  Pad
              query rows are ignored but must hold finite values.
    """
    validate_storage(storage)
    adj, items = graph.adj, graph.items
    if storage == "int8" and store is None:
        store = quantize_items(items)
    elif storage == "f32":
        store = None
    queries = queries.float().contiguous()
    B, S = init_ids.shape
    M = adj.shape[1]
    L = pool_size
    V = S + max_steps * M

    init_ids = _dedup_ids(init_ids.to(torch.int32))
    if valid is not None:
        # pad rows lose their seeds: an all -1 seed row gives an all-checked
        # -inf pool below, and done keeps every step from advancing it
        valid = valid.to(device=init_ids.device, dtype=torch.bool)
        init_ids = torch.where(valid[:, None], init_ids, -1)
    valid0 = init_ids >= 0
    # seeds are scored by the walk's own scorer, so the pool order is one
    # convention throughout
    if store is None:
        seed_scores = gather_score(queries, items, init_ids)
    else:
        seed_scores = store_scores(queries, store, init_ids)
    scores0 = torch.where(valid0, seed_scores, NEG_INF)
    evals = valid0.sum(dim=-1, dtype=torch.int32)
    dead_evals = None
    if live is not None:
        live = live.bool()
        dead_evals = (valid0 & ~live[init_ids.clamp_min(0).long()]).sum(
            dim=-1, dtype=torch.int32)

    # seed pool: the top L seeds, sorted; empty slots are born checked
    top0, idx0 = top_l(scores0, min(L, S))
    pool_ids = torch.full((B, L), -1, dtype=torch.int32, device=adj.device)
    pool_scores = torch.full((B, L), NEG_INF, dtype=torch.float32, device=adj.device)
    pool_ids[:, : idx0.shape[1]] = init_ids.gather(1, idx0)
    pool_scores[:, : idx0.shape[1]] = top0
    pool_checked = pool_ids < 0

    visited = torch.full((B, V), -1, dtype=torch.int32, device=adj.device)
    visited[:, :S] = init_ids
    done = (torch.zeros(B, dtype=torch.bool, device=adj.device) if valid is None
            else ~valid)

    rows, scales = (items, None) if store is None else store
    walk = beam_walk(pool_ids, pool_scores, pool_checked, visited, done, evals, queries,
                     adj, rows, scales, live, dead_evals, max_steps=max_steps)
    pool_ids, pool_scores, evals, dead_evals, step = (
        walk.pool_ids, walk.pool_scores, walk.evals, walk.dead_evals, walk.steps)

    if store is not None:
        # Exact fp32 rerank of the final pool: the quantized walk chose which
        # L candidates survive, the fp32 scores decide their order and the
        # cut.  evals stay the quantized counts.  Tombstones routed the walk
        # but are masked out of the cut.
        keep = pool_ids >= 0
        if live is not None:
            keep &= live[pool_ids.clamp_min(0).long()]
        exact = torch.where(keep, gather_score(queries, items, pool_ids), NEG_INF)
        vals, sel = top_l(exact, k)
        ids = pool_ids.gather(1, sel)
        return SearchResult(
            ids=torch.where(vals > NEG_INF, ids, -1),
            scores=vals,
            evals=evals,
            steps=step,
            visited=visited,
            dead_evals=dead_evals,
        )

    if live is not None:
        # The pool is sorted, so a masked top k (the first index winning
        # ties) returns the best k live entries in their pool order.
        keep = (pool_ids >= 0) & live[pool_ids.clamp_min(0).long()]
        vals, sel = top_l(torch.where(keep, pool_scores, NEG_INF), k)
        ids = pool_ids.gather(1, sel)
        return SearchResult(
            ids=torch.where(vals > NEG_INF, ids, -1),
            scores=vals,
            evals=evals,
            steps=step,
            visited=visited,
            dead_evals=dead_evals,
        )

    return SearchResult(
        ids=pool_ids[:, :k],
        scores=pool_scores[:, :k],
        evals=evals,
        steps=step,
        visited=visited,
    )
