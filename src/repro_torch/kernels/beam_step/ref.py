"""Plain PyTorch versions of beam_step, one Algorithm-1 iteration ported
from the JAX package's ``beam_step_ref``, and of beam_walk, the host loop
of those steps that the JAX package runs as a ``lax.while_loop``
(``src/repro/core/search.py:335-357``).  They define the semantics that the
CUDA kernels (``csrc/beam_step.cu``) are held to, and run every walk on the
CPU."""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.similarity import NEG_INF, gather_scores, top_l


class StepResult(NamedTuple):
    """State delta of one walk iteration (the caller owns the visited
    buffer's write offset and the eval counts)."""

    pool_ids: torch.Tensor      # [B, L] int32, sorted desc by score
    pool_scores: torch.Tensor   # [B, L] fp32
    pool_checked: torch.Tensor  # [B, L] bool
    nbr_ids: torch.Tensor       # [B, M] int32 newly scored ids (-1 masked)
    done: torch.Tensor          # [B] bool (sticky)
    n_scored: torch.Tensor      # [B] int32 similarity evaluations this step
    n_dead: Optional[torch.Tensor] = None  # [B] int32 evaluations on tombstones
    #   (None when the walk carries no live mask: mutation off)


def beam_step_ref(
    pool_ids: torch.Tensor,
    pool_scores: torch.Tensor,
    pool_checked: torch.Tensor,
    visited: torch.Tensor,
    done: torch.Tensor,
    queries: torch.Tensor,
    adj: torch.Tensor,
    items: torch.Tensor,
    *,
    score_fn=gather_scores,
    live: Optional[torch.Tensor] = None,
) -> StepResult:
    """Select the best unchecked pool slot, expand its adjacency row, mask
    visited and invalid neighbors, score the rest, merge into the pool.
    ``score_fn(queries, items, ids)`` scores the neighbors: the fp32 dot by
    default, the int8 store's scorer for a quantized walk.

    ``live`` ([N] bool, the mutation layer's tombstone mask) does not change
    which neighbors are scored or merged: dead nodes stay routing vertices.
    Its only effect is ``n_dead``, the valid neighbors that are tombstones;
    without it ``n_dead`` is None, not zeros."""
    B, L = pool_ids.shape
    rows = torch.arange(B, device=pool_ids.device)
    iota = torch.arange(L, device=pool_ids.device)

    unchecked = ~pool_checked & (pool_ids >= 0)
    new_done = done | ~unchecked.any(dim=-1)
    upd = ~new_done

    # The pool is sorted, so the first unchecked slot is the best one; min
    # over the slot index of unchecked slots (L when there is none).
    cur_slot = torch.where(unchecked, iota, L).min(dim=-1).values
    cur_id = pool_ids[rows, cur_slot.clamp_max(L - 1)]
    cur_id = torch.where(upd, cur_id, 0).clamp_min(0)
    checked = pool_checked | ((iota == cur_slot[:, None]) & upd[:, None])

    nbrs = adj[cur_id]                                               # [B, M]
    seen = (nbrs[:, :, None] == visited[:, None, :]).any(dim=-1)
    valid = (nbrs >= 0) & upd[:, None] & ~seen

    nbr_scores = torch.where(valid, score_fn(queries, items, nbrs), NEG_INF)
    nbr_ids = torch.where(valid, nbrs, -1).to(torch.int32)

    n_dead = None
    if live is not None:
        dead = valid & ~live.bool()[nbrs.clamp_min(0).long()]
        n_dead = dead.sum(dim=-1, dtype=torch.int32)

    cand_ids = torch.cat([pool_ids, nbr_ids], dim=-1)
    cand_scores = torch.cat([pool_scores, nbr_scores], dim=-1)
    cand_checked = torch.cat([checked, ~valid], dim=-1)
    new_scores, sel = top_l(cand_scores, L)
    return StepResult(
        pool_ids=cand_ids.gather(1, sel),
        pool_scores=new_scores,
        pool_checked=cand_checked.gather(1, sel),
        nbr_ids=nbr_ids,
        done=new_done,
        n_scored=valid.sum(dim=-1, dtype=torch.int32),
        n_dead=n_dead,
    )


class WalkResult(NamedTuple):
    """A whole walk: the final pool, the visited buffer (written in place),
    the eval counts (seed values plus every step's), each row's step count
    and the loop's."""

    pool_ids: torch.Tensor      # [B, L] int32, sorted desc by score
    pool_scores: torch.Tensor   # [B, L] fp32
    pool_checked: torch.Tensor  # [B, L] bool
    visited: torch.Tensor       # [B, V] int32, the caller's buffer
    evals: torch.Tensor         # [B] int32
    dead_evals: Optional[torch.Tensor]  # [B] int32, None without a live mask
    row_steps: torch.Tensor     # [B] int32 steps each row ran
    steps: int                  # loop iterations: the largest row count


def host_walk(
    step: Callable[..., StepResult],
    pool_ids: torch.Tensor,
    pool_scores: torch.Tensor,
    pool_checked: torch.Tensor,
    visited: torch.Tensor,
    done: torch.Tensor,
    evals: torch.Tensor,
    dead_evals: Optional[torch.Tensor] = None,
    *,
    max_steps: int,
) -> WalkResult:
    """The host loop of ``step(pool_ids, pool_scores, pool_checked, visited,
    done)``: the condition of the JAX package's ``while_loop``, ``(step <
    max_steps) & any(~done)``, read back once a step.  Step t writes its M
    neighbour ids into columns ``S + t*M`` of ``visited``, where ``S = V -
    max_steps * M`` seed columns come first; the columns from S on must be -1
    on entry.  A row's count is the steps it ran, including the one that
    found no unchecked slot; a row done on entry counts 0."""
    b, v = visited.shape
    row_steps = torch.zeros(b, dtype=torch.int32, device=visited.device)
    t = 0
    while t < max_steps and not bool(done.all()):
        row_steps += (~done).int()
        res = step(pool_ids, pool_scores, pool_checked, visited, done)
        m = res.nbr_ids.shape[1]
        col = v - max_steps * m + t * m
        visited[:, col: col + m] = res.nbr_ids
        evals = evals + res.n_scored
        if dead_evals is not None:
            dead_evals = dead_evals + res.n_dead
        pool_ids, pool_scores, pool_checked, done = (
            res.pool_ids, res.pool_scores, res.pool_checked, res.done)
        t += 1
    return WalkResult(pool_ids, pool_scores, pool_checked, visited, evals, dead_evals,
                      row_steps, t)


def beam_walk_ref(
    pool_ids: torch.Tensor,
    pool_scores: torch.Tensor,
    pool_checked: torch.Tensor,
    visited: torch.Tensor,
    done: torch.Tensor,
    evals: torch.Tensor,
    queries: torch.Tensor,
    adj: torch.Tensor,
    items: torch.Tensor,
    *,
    max_steps: int,
    score_fn=gather_scores,
    live: Optional[torch.Tensor] = None,
    dead_evals: Optional[torch.Tensor] = None,
) -> WalkResult:
    """The walk as a host loop of ``beam_step_ref`` (``host_walk``).
    ``dead_evals`` is required with ``live`` and ignored without it."""
    def step(ids, scores, checked, vis, dn):
        return beam_step_ref(ids, scores, checked, vis, dn, queries, adj, items,
                             score_fn=score_fn, live=live)

    return host_walk(step, pool_ids, pool_scores, pool_checked, visited, done, evals,
                     dead_evals if live is not None else None, max_steps=max_steps)
