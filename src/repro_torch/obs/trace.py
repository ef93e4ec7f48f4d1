"""Walk tracing: per-hop traces and norm-bias reductions of a finished walk.

The paper's argument is diagnostic: MIPS walks spend their similarity
evaluations on large-norm, high-in-degree hub nodes (Figs 1, 4, 5).  Pass a
:class:`TraceContext` to ``core.search.beam_search`` (or an index's
``search``) and the result carries a :class:`WalkTrace`:

  ids / scores / step -- the first ``trace_cap`` visited ids of each query,
      their walk scores, and the column -> step map (step 0 = seeds, step
      t >= 1 = the t-th expansion round);
  band_hist -- evaluations per norm band (default: deciles of the catalog's
      norms), the Fig-5 histogram of the batch;
  hub_evals -- evaluations that landed on the top-in-degree hub set (Fig 4);
  steps_to_converge -- expansion rounds in which the query scored at least
      one new node.

The trace is derived after the walk, from its ``visited`` buffer: columns
``< S`` are the seeds and column ``S + t*M + j`` is neighbour ``j`` of round
``t`` (-1 where nothing was scored).  The walk itself never sees the
context, so ``trace=None`` leaves every search output unchanged, and a
traced search equals an untraced one bit for bit.  Trace scores come from
the walk's own scorer (``gather_score`` under f32, the ``quant_score``
kernel under int8), so they are the scores the walk ranked by.

Every shape is a function of ``(trace_cap, n_bands)`` and the walk's
geometry, and nothing is read back: a traced search can be captured in a
CUDA graph.  ``band_hist`` is a ``scatter_add_`` of the visited ids' bands
(``one_hot`` checks its values on the host).  ``WalkTrace.step`` is a host
(CPU) tensor, made from shapes only: building it on the card would copy a
host array inside a capture.  This module is the JAX package's
``obs/trace.py`` in torch ops; ``make_trace_context`` does its numpy work
line for line, so its tables equal JAX's bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class WalkTrace(NamedTuple):
    """Per-query walk telemetry (fixed shapes; see the module docstring)."""

    ids: torch.Tensor                # [B, C] int32 first C visited ids (-1 pad)
    scores: torch.Tensor             # [B, C] fp32 walk scores (-inf at pads)
    step: torch.Tensor               # [C] int32 column -> step map, on the host
    band_hist: torch.Tensor          # [B, n_bands] int32 evals per norm band
    hub_evals: torch.Tensor          # [B] int32 evals on the hub set
    steps_to_converge: torch.Tensor  # [B] int32 rounds with >= 1 new eval


class TraceContext:
    """The catalog-side tables a trace reduces against, on one device:
    ``band_ids`` [N] int32 (node -> norm band), ``hub_mask`` [N] bool (node
    in the top-in-degree set), ``band_edges`` [n_bands + 1] fp32.  Build one
    with :func:`make_trace_context`."""

    def __init__(self, band_ids: torch.Tensor, hub_mask: torch.Tensor,
                 band_edges: torch.Tensor, *, trace_cap: int, n_bands: int):
        self.band_ids = band_ids
        self.hub_mask = hub_mask
        self.band_edges = band_edges
        self.trace_cap = int(trace_cap)
        self.n_bands = int(n_bands)

    def tensors(self) -> tuple:
        return self.band_ids, self.hub_mask, self.band_edges

    def to(self, device) -> "TraceContext":
        """The same context with its tables on ``device``."""
        return TraceContext(*(t.to(device) for t in self.tensors()),
                            trace_cap=self.trace_cap, n_bands=self.n_bands)

    def __repr__(self):
        return (f"TraceContext(n={self.band_ids.shape[0]}, n_bands={self.n_bands}, "
                f"trace_cap={self.trace_cap})")


def make_trace_context(
    norms,
    adj=None,
    *,
    size: Optional[int] = None,
    trace_cap: int = 128,
    n_bands: int = 10,
    hub_frac: float = 0.01,
    device="cuda",
) -> TraceContext:
    """Build a :class:`TraceContext` from catalog norms (and, optionally,
    the adjacency) on ``device``.

    norms:     [N] item norms (N = catalog size, or the mutable capacity:
               pool slots included so upserted nodes stay in range).
    adj:       optional [N, M] adjacency; when given, the hub set is the top
               ``ceil(hub_frac * size)`` nodes by in-degree (the paper's
               Fig-4 axis).  Without it ``hub_evals`` reads all zero.
    size:      number of real nodes (defaults to N); band edges are fitted
               on ``norms[:size]`` so unused capacity slots don't skew the
               deciles.
    trace_cap: per-query visited-prefix length carried in the trace.
    n_bands:   norm bands (10 = the paper's deciles).

    Host-side numpy, once per index, as the JAX package's.
    """
    if isinstance(norms, torch.Tensor):
        norms = norms.detach().cpu().numpy()
    if isinstance(adj, torch.Tensor):
        adj = adj.detach().cpu().numpy()
    norms = np.asarray(norms, np.float32).reshape(-1)
    n = norms.shape[0]
    size = n if size is None else int(size)
    if not 0 < size <= n:
        raise ValueError(f"size must be in (0, {n}], got {size}")
    if trace_cap <= 0 or n_bands <= 0:
        raise ValueError(
            f"trace_cap and n_bands must be positive, got "
            f"trace_cap={trace_cap} n_bands={n_bands}"
        )
    edges = np.quantile(norms[:size], np.linspace(0.0, 1.0, n_bands + 1))
    edges = edges.astype(np.float32)
    # Interior edges only: band i covers (edges[i], edges[i+1]], clamped to
    # [0, n_bands-1] so out-of-range norms (churned-in items) still land in
    # an end band instead of indexing out of bounds.
    band_ids = np.searchsorted(edges[1:-1], norms, side="left")
    band_ids = np.clip(band_ids, 0, n_bands - 1).astype(np.int32)

    hub_mask = np.zeros(n, bool)
    if adj is not None:
        adj = np.asarray(adj)
        flat = adj[adj >= 0]
        indeg = np.bincount(flat, minlength=n)[:n]
        n_hubs = max(1, int(np.ceil(hub_frac * size)))
        hub_mask[np.argsort(indeg)[::-1][:n_hubs]] = True

    return TraceContext(
        torch.as_tensor(band_ids, device=device),
        torch.as_tensor(hub_mask, device=device),
        torch.as_tensor(edges, device=device),
        trace_cap=trace_cap,
        n_bands=n_bands,
    )


def step_of_column(n_cols: int, *, seeds: int, degree: int) -> np.ndarray:
    """The static visited-column -> walk-step map: columns ``< seeds`` are
    step 0, column ``seeds + t*degree + j`` is step ``t + 1``."""
    cols = np.arange(n_cols)
    return np.where(
        cols < seeds, 0, 1 + (cols - seeds) // max(degree, 1)
    ).astype(np.int32)


def walk_trace(
    ctx: TraceContext,
    visited: torch.Tensor,
    queries: torch.Tensor,
    items,
    score_fn,
    *,
    seeds: int,
    degree: int,
) -> WalkTrace:
    """Reduce a finished walk's [B, V] ``visited`` buffer into a WalkTrace,
    in torch ops on its device, with no read-back.  ``score_fn(queries,
    items, ids)`` must be the scorer the walk used, so trace scores match
    the walk's ranking (the quantized scorer under int8 storage)."""
    b, v = visited.shape
    valid = visited >= 0
    safe = visited.clamp_min(0).long()

    # Per-hop prefix: the first trace_cap visited columns.  The buffer is
    # append-only in step order, so a prefix is the first hops.
    c = min(ctx.trace_cap, v)
    ids = visited[:, :c]
    tr_valid = valid[:, :c]
    scores = torch.where(tr_valid, score_fn(queries, items, ids.clamp_min(0)).float(),
                         float("-inf"))
    step = torch.from_numpy(step_of_column(c, seeds=seeds, degree=degree))

    # reductions over the whole buffer, not just the traced prefix
    band_hist = torch.zeros((b, ctx.n_bands), dtype=torch.int32, device=visited.device)
    band_hist.scatter_add_(1, ctx.band_ids[safe].long(), valid.int())
    hub_evals = (ctx.hub_mask[safe] & valid).sum(dim=-1, dtype=torch.int32)

    n_steps = (v - seeds) // max(degree, 1)
    per_round = valid[:, seeds:seeds + n_steps * degree]
    per_round = per_round.reshape(b, n_steps, degree).any(dim=-1)
    steps_to_converge = per_round.sum(dim=-1, dtype=torch.int32)

    return WalkTrace(
        ids=torch.where(tr_valid, ids, -1).to(torch.int32),
        scores=scores,
        step=step,
        band_hist=band_hist,
        hub_evals=hub_evals,
        steps_to_converge=steps_to_converge,
    )
