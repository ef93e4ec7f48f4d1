"""beam_step wrapper: a CPU tensor runs the plain version, a CUDA tensor
launches a kernel of ``csrc/beam_step.cu`` or raises.

``items`` holds the fp32 rows, or the int8 store's codes when ``scales`` is
given (the ``beam_step_i8`` entry; scores ``(q . codes[id]) * scales[id]``).
``live`` ([N] bool, the mutation layer's tombstone mask) adds ``n_dead``,
the valid neighbors that are tombstones; it changes nothing else.

Launch counts (plain runs count in none): ``beam_step.launches`` and
``beam_step.launches_int8`` count the fp32 and int8 kernels without a live
mask, ``beam_step.launches_live`` and ``beam_step.launches_int8_live`` the
same kernels with one."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.beam_step.ref import StepResult, beam_step_ref
from repro_torch.kernels.quant_score.ref import quant_score_ref


def beam_step(
    pool_ids: torch.Tensor,      # [B, L] int32, sorted desc by score
    pool_scores: torch.Tensor,   # [B, L] fp32
    pool_checked: torch.Tensor,  # [B, L] bool
    visited: torch.Tensor,       # [B, V] int32, -1 padded
    done: torch.Tensor,          # [B] bool
    queries: torch.Tensor,       # [B, d] fp32
    adj: torch.Tensor,           # [N, M] int32, -1 padded
    items: torch.Tensor,         # [N, d] fp32, or int8 codes with scales
    scales: "torch.Tensor | None" = None,  # [N] fp32: items are int8 codes
    live: "torch.Tensor | None" = None,    # [N] bool tombstone mask
) -> StepResult:
    """One Algorithm-1 iteration for every query; the result equals
    ``beam_step_ref`` (ids bit-identical on exact scores)."""
    if not _lib.on_cuda(pool_ids):
        if scales is None:
            return beam_step_ref(pool_ids, pool_scores, pool_checked, visited, done,
                                 queries, adj, items, live=live)
        return beam_step_ref(pool_ids, pool_scores, pool_checked, visited, done,
                             queries, adj, items, live=live,
                             score_fn=lambda q, c, ids: quant_score_ref(q, c, scales, ids))
    dev = pool_ids.device
    B, L = pool_ids.shape
    V = visited.shape[1]
    N, M = adj.shape
    d = queries.shape[1]
    _lib.expect(pool_ids, "pool_ids", torch.int32, (B, L), dev)
    _lib.expect(pool_scores, "pool_scores", torch.float32, (B, L), dev)
    _lib.expect(pool_checked, "pool_checked", torch.bool, (B, L), dev)
    _lib.expect(visited, "visited", torch.int32, (B, V), dev)
    _lib.expect(done, "done", torch.bool, (B,), dev)
    _lib.expect(queries, "queries", torch.float32, (B, d), dev)
    _lib.expect(adj, "adj", torch.int32, (N, M), dev)
    if scales is None:
        _lib.expect(items, "items", torch.float32, (N, d), dev)
    else:
        _lib.expect(items, "codes", torch.int8, (N, d), dev)
        _lib.expect(scales, "scales", torch.float32, (N,), dev)
    if live is not None:
        _lib.expect(live, "live", torch.bool, (N,), dev)
    out = StepResult(
        pool_ids=torch.empty((B, L), dtype=torch.int32, device=dev),
        pool_scores=torch.empty((B, L), dtype=torch.float32, device=dev),
        pool_checked=torch.empty((B, L), dtype=torch.bool, device=dev),
        nbr_ids=torch.empty((B, M), dtype=torch.int32, device=dev),
        done=torch.empty((B,), dtype=torch.bool, device=dev),
        n_scored=torch.empty((B,), dtype=torch.int32, device=dev),
        n_dead=None if live is None else torch.empty((B,), dtype=torch.int32, device=dev),
    )
    if B == 0:
        return out
    state = (pool_ids.data_ptr(), pool_scores.data_ptr(), pool_checked.data_ptr(),
             visited.data_ptr(), done.data_ptr(), queries.data_ptr(), adj.data_ptr())
    # a null live pointer turns the tombstone count off
    mask = (None, None) if live is None else (live.data_ptr(), out.n_dead.data_ptr())
    tail = (B, L, V, M, d, *(t.data_ptr() for t in out[:6]), *mask, _lib.stream(dev))
    if scales is None:
        rc = _lib.lib().beam_step_f32(*state, items.data_ptr(), *tail)
        _lib.check(rc, "beam_step")
        counter = "launches" if live is None else "launches_live"
    else:
        rc = _lib.lib().beam_step_i8(*state, items.data_ptr(), scales.data_ptr(), *tail)
        _lib.check(rc, "beam_step (int8)")
        counter = "launches_int8" if live is None else "launches_int8_live"
    setattr(beam_step, counter, getattr(beam_step, counter) + 1)
    return out


beam_step.launches = 0
beam_step.launches_int8 = 0
beam_step.launches_live = 0
beam_step.launches_int8_live = 0
