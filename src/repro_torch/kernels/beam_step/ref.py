"""Plain PyTorch version of beam_step: one Algorithm-1 iteration, ported
from the JAX package's ``beam_step_ref``.  It defines the semantics that the
CUDA kernel (``csrc/beam_step.cu``) is held to, and runs every walk on the
CPU."""
from __future__ import annotations

from typing import NamedTuple, Optional

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
