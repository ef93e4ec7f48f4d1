"""beam_step and beam_walk wrappers: a CPU tensor runs the plain version, a
CUDA tensor launches a kernel of ``csrc/beam_step.cu`` or raises.

``beam_walk`` runs a whole walk in one launch (the walks of ``core/search``
take it); ``beam_step``, one iteration, stays as its own entry point and as
the yardstick the walk is held to.

``items`` holds the fp32 rows, or the int8 store's codes when ``scales`` is
given (the ``beam_step_i8`` entry; scores ``(q . codes[id]) * scales[id]``).
``live`` ([N] bool, the mutation layer's tombstone mask) adds ``n_dead``,
the valid neighbors that are tombstones; it changes nothing else.

Launch counts (plain runs count in none): ``beam_step.launches`` and
``beam_step.launches_int8`` count the fp32 and int8 kernels without a live
mask, ``beam_step.launches_live`` and ``beam_step.launches_int8_live`` the
same kernels with one; ``beam_walk`` has the same four counters and
``beam_walk.steps``, the sum of its walks' step counts."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.beam_step.ref import (
    StepResult,
    WalkResult,
    beam_step_ref,
    beam_walk_ref,
)
from repro_torch.kernels.quant_score.ref import quant_score_ref

# visited ids a walk keeps in shared memory (32 KiB); a longer visited row is
# scanned in device memory
VISITED_SHARED_MAX = 8192


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


def check_walk_inputs(pool_ids, pool_scores, pool_checked, visited, done, evals, queries, adj,
                      items, scales=None, live=None, dead_evals=None, *, max_steps: int) -> int:
    """Raise unless the walk's tensors are what a ``beam_walk`` kernel takes
    (types, shapes, contiguity, one device; ``dead_evals`` beside ``live``;
    ``max_steps * M`` columns of ``visited`` after its seeds); returns the
    seed columns S."""
    dev = pool_ids.device
    B, L = pool_ids.shape
    V = visited.shape[1]
    N, M = adj.shape
    d = queries.shape[1]
    S = V - max_steps * M
    if max_steps < 0 or S < 0:
        raise ValueError(f"visited has {V} columns, fewer than max_steps={max_steps} x M={M}")
    _lib.expect(pool_ids, "pool_ids", torch.int32, (B, L), dev)
    _lib.expect(pool_scores, "pool_scores", torch.float32, (B, L), dev)
    _lib.expect(pool_checked, "pool_checked", torch.bool, (B, L), dev)
    _lib.expect(visited, "visited", torch.int32, (B, V), dev)
    _lib.expect(done, "done", torch.bool, (B,), dev)
    _lib.expect(evals, "evals", torch.int32, (B,), dev)
    _lib.expect(queries, "queries", torch.float32, (B, d), dev)
    _lib.expect(adj, "adj", torch.int32, (N, M), dev)
    if scales is None:
        _lib.expect(items, "items", torch.float32, (N, d), dev)
    else:
        _lib.expect(items, "codes", torch.int8, (N, d), dev)
        _lib.expect(scales, "scales", torch.float32, (N,), dev)
    if live is not None:
        _lib.expect(live, "live", torch.bool, (N,), dev)
        if dead_evals is None:
            raise ValueError("a walk with a live mask needs its seeds' dead_evals")
        _lib.expect(dead_evals, "dead_evals", torch.int32, (B,), dev)
    return S


def beam_walk(
    pool_ids: torch.Tensor,      # [B, L] int32, sorted desc by score
    pool_scores: torch.Tensor,   # [B, L] fp32
    pool_checked: torch.Tensor,  # [B, L] bool
    visited: torch.Tensor,       # [B, V] int32: S seed columns, then -1
    done: torch.Tensor,          # [B] bool
    evals: torch.Tensor,         # [B] int32 seed evaluations
    queries: torch.Tensor,       # [B, d] fp32
    adj: torch.Tensor,           # [N, M] int32, -1 padded
    items: torch.Tensor,         # [N, d] fp32, or int8 codes with scales
    scales: "torch.Tensor | None" = None,      # [N] fp32: items are int8 codes
    live: "torch.Tensor | None" = None,        # [N] bool tombstone mask
    dead_evals: "torch.Tensor | None" = None,  # [B] int32 seed dead evaluations, with live
    *,
    max_steps: int,
) -> WalkResult:
    """A whole Algorithm-1 walk: ``beam_step`` until every row is done or
    ``max_steps`` steps ran; ``visited`` is written in place, ``S = V -
    max_steps * M`` seed columns first.  The result equals ``beam_walk_ref``
    (the host loop of the step), and on the card the host loop of the
    ``beam_step`` kernel bit for bit; ``steps`` is the one value read back."""
    if not _lib.on_cuda(pool_ids):
        kw = {} if scales is None else {
            "score_fn": lambda q, c, ids: quant_score_ref(q, c, scales, ids)}
        return beam_walk_ref(pool_ids, pool_scores, pool_checked, visited, done, evals,
                             queries, adj, items, max_steps=max_steps, live=live,
                             dead_evals=dead_evals, **kw)
    S = check_walk_inputs(pool_ids, pool_scores, pool_checked, visited, done, evals, queries,
                          adj, items, scales, live, dead_evals, max_steps=max_steps)
    dev = pool_ids.device
    B, L = pool_ids.shape
    V = visited.shape[1]
    M = adj.shape[1]
    d = queries.shape[1]
    ids = torch.empty((B, L), dtype=torch.int32, device=dev)
    scores = torch.empty((B, L), dtype=torch.float32, device=dev)
    checked = torch.empty((B, L), dtype=torch.bool, device=dev)
    evals_out = torch.empty((B,), dtype=torch.int32, device=dev)
    dead_out = None if live is None else torch.empty((B,), dtype=torch.int32, device=dev)
    row_steps = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return WalkResult(ids, scores, checked, visited, evals_out, dead_out, row_steps, 0)
    # a null live pointer turns the tombstone count off
    mask = (0, 0) if live is None else (dead_evals.data_ptr(), dead_out.data_ptr())
    head = (pool_ids.data_ptr(), pool_scores.data_ptr(), pool_checked.data_ptr(),
            visited.data_ptr(), done.data_ptr(), evals.data_ptr(), mask[0],
            queries.data_ptr(), adj.data_ptr(), items.data_ptr())
    tail = (B, L, V, M, d, S, max_steps, int(V <= VISITED_SHARED_MAX), ids.data_ptr(),
            scores.data_ptr(), checked.data_ptr(), evals_out.data_ptr(), mask[1],
            row_steps.data_ptr(), 0 if live is None else live.data_ptr(), _lib.stream(dev))
    if scales is None:
        rc = _lib.lib().beam_walk_f32(*head, *tail)
        _lib.check(rc, "beam_walk")
        counter = "launches" if live is None else "launches_live"
    else:
        rc = _lib.lib().beam_walk_i8(*head, scales.data_ptr(), *tail)
        _lib.check(rc, "beam_walk (int8)")
        counter = "launches_int8" if live is None else "launches_int8_live"
    setattr(beam_walk, counter, getattr(beam_walk, counter) + 1)
    steps = int(row_steps.max())  # the walk's one read-back
    beam_walk.steps += steps
    return WalkResult(ids, scores, checked, visited, evals_out, dead_out, row_steps, steps)


beam_walk.launches = 0
beam_walk.launches_int8 = 0
beam_walk.launches_live = 0
beam_walk.launches_int8_live = 0
beam_walk.steps = 0
