"""Batched graph-walk search (paper Algorithm 1).

B queries advance in lock-step.  Per query:
  pool    -- fixed-size candidate pool (ids, scores, checked), sorted by score
             descending (the paper's candidate pool C of size l);
  visited -- append-only buffer of every id scored; each step appends exactly
             M slots per query, so the write offset is one scalar
             (seeds + step * M);
  evals   -- similarity evaluations (the paper's Fig-5/8a metric).

A query is done when every slot of its pool is checked.  The host loop ends
when every query is done or ``max_steps`` is reached; it reads ``done`` back
once per step (the condition of the JAX package's ``lax.while_loop``).  Each
step is one ``beam_step`` call: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.graph import GraphIndex
from repro_torch.core.similarity import NEG_INF, gather_scores, top_l
from repro_torch.kernels.beam_step import beam_step


class SearchResult(NamedTuple):
    ids: torch.Tensor      # [B, k] int32, -1 padded
    scores: torch.Tensor   # [B, k] fp32
    evals: torch.Tensor    # [B] int32 similarity evaluations
    steps: int             # loop iterations executed
    visited: torch.Tensor  # [B, V] int32 every scored id (-1 padded)


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
) -> SearchResult:
    """Run the batched walk.

    queries:  [B, d] fp32.
    init_ids: [B, S] int32 seed ids (-1 padded, repeats allowed): the entry
              vertex for ip-NSW, the G_s neighborhood of the angular results
              for ip-NSW+ (Algorithm 3).
    """
    adj, items = graph.adj, graph.items
    queries = queries.float().contiguous()
    B, S = init_ids.shape
    M = adj.shape[1]
    L = pool_size
    V = S + max_steps * M

    init_ids = _dedup_ids(init_ids.to(torch.int32))
    valid0 = init_ids >= 0
    scores0 = torch.where(valid0, gather_scores(queries, items, init_ids), NEG_INF)
    evals = valid0.sum(dim=-1, dtype=torch.int32)

    # seed pool: the top L seeds, sorted; empty slots are born checked
    top0, idx0 = top_l(scores0, min(L, S))
    pool_ids = torch.full((B, L), -1, dtype=torch.int32, device=adj.device)
    pool_scores = torch.full((B, L), NEG_INF, dtype=torch.float32, device=adj.device)
    pool_ids[:, : idx0.shape[1]] = init_ids.gather(1, idx0)
    pool_scores[:, : idx0.shape[1]] = top0
    pool_checked = pool_ids < 0

    visited = torch.full((B, V), -1, dtype=torch.int32, device=adj.device)
    visited[:, :S] = init_ids
    done = torch.zeros(B, dtype=torch.bool, device=adj.device)

    step = 0
    while step < max_steps and not bool(done.all()):
        res = beam_step(pool_ids, pool_scores, pool_checked, visited, done,
                        queries, adj, items)
        visited[:, S + step * M : S + (step + 1) * M] = res.nbr_ids
        evals += res.n_scored
        pool_ids, pool_scores, pool_checked, done = (
            res.pool_ids, res.pool_scores, res.pool_checked, res.done
        )
        step += 1

    return SearchResult(
        ids=pool_ids[:, :k],
        scores=pool_scores[:, :k],
        evals=evals,
        steps=step,
        visited=visited,
    )
