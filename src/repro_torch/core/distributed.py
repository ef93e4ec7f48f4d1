"""Sharded MIPS index on one card: the JAX package's multi-device serving
path (``core/distributed.py`` there) with the shards as a leading axis.

Items are row-sharded into P shards; every shard builds its own proximity
graph(s) over its local items, and graph edges never cross shards, so a
shard is a self-contained index.  A query walks every shard's graph and the
per-shard top-k are merged.

Two partition policies (``build_sharded(partition=)``):

  "roundrobin"  contiguous global-id blocks of ceil(N/P) rows: every shard
                sees the same norm distribution.
  "norm_bands"  the Norm-Range partition: the catalog sorted by ||x|| and
                cut into P count-balanced bands, band 0 the largest norms,
                each with its ``max_norm``; ``max_norm_s * ||q||`` bounds
                every score of shard s (Cauchy-Schwarz).

Routing (``route="upper_bound"``): a shard whose bound is strictly below the
query's current k-th score cannot enter its top k, so its walk is skipped.
``sharded_search_reference`` defines the semantics: a sequential fold over
the shards in descending ``max_norm``, one walk of B rows a shard, the k-th
score tightening after every shard.  ``sharded_search`` is the JAX
package's shard_map driver on one card: an exhaustive fan-out, or the
two-phase masked walk (the hottest shard first, then every other shard
masked per query by its k-th score).

The fan-out views the stack as one flat graph of P * Nloc nodes: row
``s * B + b`` of a walk of P * B rows is query b on shard s, seeded at
``entry[s] + s * Nloc`` over ``flat_adj = adj + s * Nloc`` (-1 kept).  Edges
never cross shards, a walk is row-wise, seeds are deduplicated by a row sort
that a constant offset does not reorder and the walk breaks ties by pool
position, not by id; so each row equals its shard-local walk bit for bit,
and a stage of the search is one ``beam_walk`` launch whatever P.  Skipped
(shard, query) rows ride ``beam_search(valid=)``: born done, 0 evaluations.

``storage="tiered"`` walks the hottest shard's f32 items and every colder
shard's int8 store (each walk ends in its exact fp32 rerank).
``shard_mask`` drops dead shards at the merge.  ``ShardedMutable`` keeps one
``MutableIndex`` per band for streaming churn and snapshots back into a
``ShardedIndex`` whose ``live`` masks thread through the banded merge.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.build import replay_schedule, validate_build_backend
from repro_torch.core.graph import GraphIndex
from repro_torch.core.ipnsw import IpNSW
from repro_torch.core.ipnsw_plus import IpNSWPlus, _seed_from_angular
from repro_torch.core.mutation import MutableIndex
from repro_torch.core.search import beam_search
from repro_torch.core.similarity import NEG_INF, top_l
from repro_torch.core.storage import ItemStore, quantize_items

PARTITION_BACKENDS = ("roundrobin", "norm_bands")
ROUTE_MODES = ("none", "upper_bound")
# The sharded path accepts one storage value beyond STORAGE_BACKENDS:
# "tiered" = f32 on the hottest (max ``max_norm``) shard, int8 elsewhere.
SHARD_STORAGE = ("f32", "int8", "tiered")


def validate_partition(partition: str) -> None:
    if partition not in PARTITION_BACKENDS:
        raise ValueError(
            f"partition must be one of {PARTITION_BACKENDS}, got {partition!r}")


def validate_route(route: str) -> None:
    if route not in ROUTE_MODES:
        raise ValueError(f"route must be one of {ROUTE_MODES}, got {route!r}")


def _validate_shard_storage(storage: str) -> None:
    if storage not in SHARD_STORAGE:
        raise ValueError(f"sharded storage must be one of {SHARD_STORAGE}, got {storage!r}")


@dataclass
class ShardedIndex:
    """Stacked per-shard graphs (leading axis = shard).

    ip:       GraphIndex with adj [P, Nloc, M], items [P, Nloc, d], size /
              entry / entry_norm [P].
    ang:      the same for the angular graph, or None for plain ip-NSW.
    offset:   [P] int32 global-id offset of every shard (roundrobin; banded
              partitions carry ``gid``).
    count:    [P] int32 real items a shard, or None.  The tail shard is
              zero-padded to Nloc; the merge drops local ids >= count, whose
              0.0 scores would outrank negative-score items.
    store / ang_store: stacked int8 stores (codes [P, Nloc, d], scales
              [P, Nloc]), or None.
    live:     [P, Nloc] bool tombstone masks (``ShardedMutable``), or None:
              dead nodes route the walks but never surface, and the merge
              masks them again.
    gid:      [P, Nloc] int32 global id of every local row (banded
              partitions; pad rows -1), or None: global id = local + offset.
    max_norm: [P] fp32 max ||x|| over each shard's real rows, rounded up to
              fp32, or None.  Routing rests on it being a true upper bound;
              it is only ever widened (``ShardedMutable``).
    flat_adj / flat_ang_adj: [P * Nloc, M] int32, ``adj[s] + s * Nloc``
              with -1 kept: the stack as one flat graph for the fan-out
              (``flat_adjacency``).  Made once with the index; an index
              without them (or after ``ip`` / ``ang`` were replaced, which
              must pass None) has them derived at every search.
    """

    ip: GraphIndex
    ang: Optional[GraphIndex]
    offset: torch.Tensor
    count: Optional[torch.Tensor] = None
    store: Optional[ItemStore] = None
    ang_store: Optional[ItemStore] = None
    live: Optional[torch.Tensor] = None
    gid: Optional[torch.Tensor] = None
    max_norm: Optional[torch.Tensor] = None
    flat_adj: Optional[torch.Tensor] = None
    flat_ang_adj: Optional[torch.Tensor] = None

    @property
    def n_shards(self) -> int:
        return self.ip.adj.shape[0]

    @property
    def device(self) -> torch.device:
        return self.ip.adj.device


class RouteStats(NamedTuple):
    """Per-query routing telemetry (``return_stats=True``).

    shards_visited: [B] int32 shards whose walk ran for the query.
    bound_skips:    [B] int32 live shards skipped because ``max_norm_s *
                    ||q|| < kth_score`` (shards dead under ``shard_mask``
                    count in neither column).
    """

    shards_visited: torch.Tensor
    bound_skips: torch.Tensor


def norm_band_partition(norms, n_shards: int) -> Tuple[List[np.ndarray], np.ndarray]:
    """Cut the catalog into ``n_shards`` contiguous norm bands, balanced by
    item count (host side, build time only).

    Returns ``(bands, band_max)``: ``bands[s]`` the int32 global ids of band
    s (band 0 the largest norms), ``band_max[s]`` its max norm (0.0 for an
    empty band), rounded up to fp32.  The sort is stable, ties by id; the
    bands are a permutation of ``arange(N)`` and ``band_max`` bounds every
    member.  Bit-identical to the JAX package's."""
    norms = np.asarray(norms, np.float64)
    n = norms.shape[0]
    if n_shards <= 0:
        raise ValueError(f"n_shards must be positive, got {n_shards}")
    per = -(-n // n_shards)
    order = np.argsort(-norms, kind="stable")
    bands = [np.asarray(order[s * per: (s + 1) * per], np.int32) for s in range(n_shards)]
    band_max64 = np.asarray([float(norms[b].max()) if len(b) else 0.0 for b in bands],
                            np.float64)
    # the fp32 cast must round UP: a band_max half an ulp below the true max
    # would let the skip rule discard a shard that holds the best answer
    band_max = band_max64.astype(np.float32)
    low = band_max.astype(np.float64) < band_max64
    band_max[low] = np.nextafter(band_max[low], np.float32(np.inf))
    return bands, band_max


def flat_adjacency(adj: torch.Tensor) -> torch.Tensor:
    """[P, Nloc, M] shard-local adjacency -> [P * Nloc, M] int32 ids of the
    flat graph: ``adj[s] + s * Nloc``, -1 kept."""
    p, nloc, m = adj.shape
    if p * nloc > torch.iinfo(torch.int32).max:
        raise ValueError(f"P * Nloc = {p * nloc} nodes do not fit int32 ids")
    off = torch.arange(p, device=adj.device, dtype=torch.int32).mul_(nloc)
    return torch.where(adj >= 0, adj + off[:, None, None], -1).reshape(p * nloc, m)


def with_flat_adjacency(index: ShardedIndex) -> ShardedIndex:
    return dataclasses.replace(
        index, flat_adj=flat_adjacency(index.ip.adj),
        flat_ang_adj=None if index.ang is None else flat_adjacency(index.ang.adj))


def _stack_graphs(graphs: Sequence[GraphIndex]) -> GraphIndex:
    return GraphIndex(*(torch.stack([getattr(g, f.name) for g in graphs])
                        for f in dataclasses.fields(GraphIndex)))


def _pad_gids(gids: Sequence[np.ndarray], nloc: int) -> np.ndarray:
    padded = np.full((len(gids), nloc), -1, np.int32)
    for s, rows in enumerate(gids):
        padded[s, : len(rows)] = rows
    return padded


def stack_shards(
    ip_graphs: Sequence[GraphIndex],
    ang_graphs: Optional[Sequence[GraphIndex]] = None,
    counts: Optional[Sequence[int]] = None,
    gids: Optional[Sequence[np.ndarray]] = None,
    max_norms: Optional[Sequence[float]] = None,
) -> ShardedIndex:
    """One ``ShardedIndex`` over per-shard graphs of equal size (and its
    flat adjacency)."""
    dev = ip_graphs[0].adj.device
    sizes = [int(g.items.shape[0]) for g in ip_graphs]

    def as_t(x, dtype) -> Optional[torch.Tensor]:
        return None if x is None else torch.as_tensor(np.asarray(x, dtype), device=dev)

    return with_flat_adjacency(ShardedIndex(
        ip=_stack_graphs(ip_graphs),
        ang=None if ang_graphs is None else _stack_graphs(ang_graphs),
        offset=as_t([sum(sizes[:i]) for i in range(len(sizes))], np.int32),
        count=as_t(None if counts is None else list(counts), np.int32),
        gid=as_t(None if gids is None else _pad_gids(gids, sizes[0]), np.int32),
        max_norm=as_t(max_norms, np.float32),
    ))


def _attach_stores(index: ShardedIndex, storage: str) -> ShardedIndex:
    """Stacked int8 stores from the frozen shard items (``quantize_items``
    reduces over the feature axis only, so the stack quantizes as its
    shards do).  ``tiered`` needs them too: every shard but the hottest
    walks them.  A new index: the caller's is not written."""
    if storage not in ("int8", "tiered"):
        return index
    return dataclasses.replace(
        index, store=quantize_items(index.ip.items),
        ang_store=None if index.ang is None else quantize_items(index.ang.items))


def build_sharded(
    items,
    n_shards: int,
    *,
    plus: bool = True,
    build_backend: str = "host",
    storage: str = "f32",
    partition: str = "roundrobin",
    device: str = "cuda",
    **index_kwargs,
) -> ShardedIndex:
    """Split ``items`` into ``n_shards`` row shards and build one local index
    per shard, in turn, on ``device``.

    ``partition="roundrobin"`` is the contiguous uniform split;
    ``"norm_bands"`` cuts count-balanced bands of descending ||x|| and
    records the ``gid`` map.  ``max_norm`` is recorded for both.  The ragged
    tail shard is zero-padded to Nloc = ceil(N / P).  ``build_backend`` is
    each shard's insertion driver (``build.BUILD_BACKENDS``): "scan"
    captures one insertion batch a shard as a CUDA graph and replays it
    over that shard's schedule (P captures; ``build_sharded.last`` holds
    each shard's ``build.ScanRun`` on the card).  Every shard's graphs equal
    the host driver's bit for bit.  ``index_kwargs`` are the ``IpNSW`` /
    ``IpNSWPlus`` fields.  ``storage="int8"`` / ``"tiered"`` derive stacked
    int8 stores after the build (builds stay fp32)."""
    _validate_shard_storage(storage)
    validate_partition(partition)
    validate_build_backend(build_backend)
    if isinstance(items, torch.Tensor):
        items_t = items.to(device=device, dtype=torch.float32)
    else:
        items_t = torch.as_tensor(np.asarray(items, np.float32), device=device)
    n, d = items_t.shape
    per = -(-n // n_shards)
    norms_np = np.linalg.norm(items_t.cpu().numpy(), axis=-1)
    if partition == "norm_bands":
        bands, band_max = norm_band_partition(norms_np, n_shards)
    else:
        bands = [np.arange(s * per, min((s + 1) * per, n), dtype=np.int32)
                 for s in range(n_shards)]
        band_max = np.asarray([float(norms_np[b].max()) if len(b) else 0.0 for b in bands],
                              np.float32)

    cls = IpNSWPlus if plus else IpNSW
    ip_graphs, ang_graphs, runs = [], [], []
    for rows in bands:
        local = items_t[torch.as_tensor(rows, dtype=torch.int64, device=device)]
        if local.shape[0] < per:  # pad the ragged tail shard with zeros
            local = torch.cat([local, local.new_zeros((per - local.shape[0], d))])
        replay_schedule.last = None
        idx = cls(build_backend=build_backend, device=device, **index_kwargs).build(local)
        if replay_schedule.last is not None:
            runs.append(replay_schedule.last)
        ip_graphs.append(idx.ip_graph if plus else idx.graph)
        if plus:
            ang_graphs.append(idx.ang_graph)
    build_sharded.last = tuple(runs)
    index = stack_shards(ip_graphs, ang_graphs if plus else None, [len(b) for b in bands],
                         gids=bands if partition == "norm_bands" else None,
                         max_norms=band_max)
    return _attach_stores(index, storage)


build_sharded.last = ()


# ---------------------------------------------------------------------------
# Walks: one view of the graphs (flat, or one shard's), one stage a call
# ---------------------------------------------------------------------------


class _View(NamedTuple):
    """The tensors one walk reads: the whole stack as a flat graph, or one
    shard's own graphs.  Only ``adj`` and ``items`` of the graphs are read."""

    ip: GraphIndex
    ang: Optional[GraphIndex]
    store: Optional[ItemStore]
    ang_store: Optional[ItemStore]
    live: Optional[torch.Tensor]


class _Walked(NamedTuple):
    ids: torch.Tensor         # [R, k] ids of the view (-1 padded)
    scores: torch.Tensor      # [R, k]
    evals: torch.Tensor       # [R] int32 (both walks of ip-NSW+)
    dead_evals: Optional[torch.Tensor]  # [R] int32, with a live mask


def _flat_view(index: ShardedIndex) -> _View:
    def flat(g: GraphIndex, adj: Optional[torch.Tensor]) -> GraphIndex:
        return dataclasses.replace(
            g, adj=flat_adjacency(g.adj) if adj is None else adj,
            items=g.items.reshape(-1, g.items.shape[-1]))

    def flat_store(s: Optional[ItemStore]) -> Optional[ItemStore]:
        return None if s is None else ItemStore(s.codes.reshape(-1, s.codes.shape[-1]),
                                                s.scales.reshape(-1))

    return _View(flat(index.ip, index.flat_adj),
                 None if index.ang is None else flat(index.ang, index.flat_ang_adj),
                 flat_store(index.store), flat_store(index.ang_store),
                 None if index.live is None else index.live.reshape(-1))


def _shard_view(index: ShardedIndex, s: int) -> _View:
    def shard(g: Optional[GraphIndex]) -> Optional[GraphIndex]:
        return None if g is None else GraphIndex(*(getattr(g, f.name)[s]
                                                   for f in dataclasses.fields(GraphIndex)))

    def shard_store(st: Optional[ItemStore]) -> Optional[ItemStore]:
        return None if st is None else ItemStore(st.codes[s], st.scales[s])

    return _View(shard(index.ip), shard(index.ang), shard_store(index.store),
                 shard_store(index.ang_store), None if index.live is None else index.live[s])


def _add(a: Optional[torch.Tensor], b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if a is None else a + b


def _walk(view: _View, queries: torch.Tensor, entries: Tuple[torch.Tensor, Optional[torch.Tensor]],
          *, plus: bool, k: int, ef: int, max_steps: int, ang_ef: int, k_angular: int,
          storage: str, valid: Optional[torch.Tensor], capturable: bool = False) -> _Walked:
    """The JAX package's ``_local_ipnsw`` / ``_local_ipnsw_plus`` on one view:
    ``entries`` are the [R, 1] seeds of the ip walk and of the angular walk
    (ip-NSW+).  One ``beam_walk`` launch a walk; ``capturable`` reads
    nothing back (``search.beam_search``)."""
    int8 = storage == "int8"
    kw = dict(storage=storage, live=view.live, valid=valid, capturable=capturable)
    if not plus:
        r = beam_search(view.ip, queries, entries[0], pool_size=max(ef, k), max_steps=max_steps,
                        k=k, store=view.store if int8 else None, **kw)
        return _Walked(r.ids, r.scores, r.evals, r.dead_evals)
    a = beam_search(view.ang, queries, entries[1], pool_size=max(ang_ef, k_angular),
                    max_steps=2 * max(ang_ef, k_angular), k=k_angular,
                    store=view.ang_store if int8 else None, **kw)
    seeds = _seed_from_angular(view.ip.adj, a.ids)
    r = beam_search(view.ip, queries, seeds, pool_size=max(ef, k), max_steps=max_steps, k=k,
                    store=view.store if int8 else None, **kw)
    return _Walked(r.ids, r.scores, a.evals + r.evals, _add(a.dead_evals, r.dead_evals))


def fanout(index: ShardedIndex, queries: torch.Tensor, shards: torch.Tensor, *,
           valid: Optional[torch.Tensor] = None, **walk) -> _Walked:
    """Every query on each of ``shards`` ([S] int64 shard ids on the index's
    device) as ONE walk of S * B rows over the flat graph: row ``i * B + b``
    is query b on shard ``shards[i]``.  ``valid`` is [S * B] bool or None.
    Returns shard-local ids (-1 padded) shaped [S, B, k], scores [S, B, k],
    evals and dead evals [S, B]; each row equals the shard's own walk bit
    for bit.  Nothing is read back (the walks' step counts stay on the
    device), so the host enqueues on while the walks run.  ``walk`` takes
    ``_walk``'s knobs."""
    b = queries.shape[0]
    s_n = shards.shape[0]
    nloc = index.ip.adj.shape[1]
    base = (shards * nloc).repeat_interleave(b)[:, None]          # [S * B, 1]
    entries = (index.ip.entry[shards].repeat_interleave(b)[:, None] + base,
               None if index.ang is None
               else index.ang.entry[shards].repeat_interleave(b)[:, None] + base)
    w = _walk(_flat_view(index), queries.repeat(s_n, 1), entries, valid=valid, capturable=True,
              **walk)
    ids = torch.where(w.ids >= 0, w.ids - base.to(w.ids.dtype), -1)
    shape = (s_n, b)
    return _Walked(ids.reshape(*shape, -1), w.scores.reshape(*shape, -1),
                   w.evals.reshape(shape),
                   None if w.dead_evals is None else w.dead_evals.reshape(shape))


def _globalize(index: ShardedIndex, shards: torch.Tensor, ids: torch.Tensor,
               scores: torch.Tensor):
    """[S, B, k] local ids of ``shards`` -> global ids, dropping pad rows of
    the tail shard (``count``), tombstones (``live``) and pad gids; dropped
    slots become (-1, -inf)."""
    s_n = ids.shape[0]
    flat = ids.clamp_min(0).long().reshape(s_n, -1)

    def at(table: torch.Tensor) -> torch.Tensor:  # table[shards][s, ids[s, ...]]
        return table[shards].gather(1, flat).reshape(ids.shape)

    keep = ids >= 0
    if index.count is not None:
        keep &= ids < index.count[shards][:, None, None]
    if index.live is not None:
        keep &= at(index.live.bool())
    if index.gid is not None:
        gids = at(index.gid)
        keep &= gids >= 0
    else:
        gids = ids + index.offset[shards][:, None, None]
    return torch.where(keep, gids, -1).to(torch.int32), torch.where(keep, scores, NEG_INF)


def _merge_topk(all_ids: torch.Tensor, all_scores: torch.Tensor, k: int,
                shard_mask: Optional[torch.Tensor] = None):
    """[P, B, k] global candidates -> the top k [B, k], flattened shard-major
    a row (``lax.top_k``'s order: the first occurrence wins a tie)."""
    p, b, _ = all_ids.shape
    if shard_mask is not None:
        all_scores = torch.where(shard_mask[:, None, None], all_scores, NEG_INF)
    ids = all_ids.permute(1, 0, 2).reshape(b, -1)
    scores = all_scores.permute(1, 0, 2).reshape(b, -1)
    vals, sel = top_l(scores, k)
    return torch.where(vals > NEG_INF, ids.gather(1, sel), -1), vals


def _merge_pair(run_ids, run_scores, new_ids, new_scores, k: int):
    """Fold one shard's [B, k] candidates into the running top k; ties keep
    the running entries (first occurrence), so a skipped shard's (-1, -inf)
    rows never perturb the carry."""
    vals, sel = top_l(torch.cat([run_scores, new_scores], dim=-1), k)
    out = torch.cat([run_ids, new_ids], dim=-1).gather(1, sel)
    return torch.where(vals > NEG_INF, out, -1), vals


def shard_visit_mask(max_norm_s, qnorm, kth_score):
    """The routing decision: visit shard s for query q iff its bound
    ``max_norm_s * ||q||`` is not strictly below q's current k-th score (a
    bound equal to it still visits: an item could tie it)."""
    return max_norm_s * qnorm >= kth_score


def query_norms(queries: torch.Tensor) -> torch.Tensor:
    """||q|| as XLA computes ``jnp.linalg.norm``: sqrt(sum(q * q)) in fp32."""
    return torch.sqrt((queries * queries).sum(dim=-1))


def _tier_storage(storage: str, is_hot: bool) -> str:
    """Per-shard storage under tiering: the hottest shard walks f32, every
    colder one its int8 store."""
    if storage != "tiered":
        return storage
    return "f32" if is_hot else "int8"


def _require_route_index(index: ShardedIndex, route: str, storage: str) -> None:
    if (route != "none" or storage == "tiered") and index.max_norm is None:
        raise ValueError(
            "routing/tiering need per-shard max_norm bounds -- rebuild with "
            "build_sharded(...) (any partition records them) or attach "
            "dataclasses.replace(index, max_norm=...)")


def _check(index: ShardedIndex, storage: str, route: str) -> None:
    _validate_shard_storage(storage)
    validate_route(route)
    _require_route_index(index, route, storage)


def _prepare(index: ShardedIndex, queries, storage: str, shard_mask):
    if storage in ("int8", "tiered") and index.store is None:
        index = _attach_stores(index, storage)  # per call, as the JAX drivers do
    dev = index.device
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev).contiguous()
    mask = (torch.ones(index.n_shards, dtype=torch.bool, device=dev) if shard_mask is None
            else torch.as_tensor(shard_mask, dtype=torch.bool, device=dev))
    return index, q, mask


def _int32_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return x.sum(dim=dim, dtype=torch.int32)


def sharded_search(
    index: ShardedIndex,
    queries,
    *,
    k: int = 10,
    ef: int = 64,
    max_steps: Optional[int] = None,
    plus: bool = True,
    shard_mask=None,
    ang_ef: int = 10,
    k_angular: int = 10,
    storage: str = "f32",
    route: str = "none",
    return_stats: bool = False,
):
    """The JAX package's shard_map driver on one card: the fan-out over every
    shard, then the merge.  Returns ``(ids, scores, evals)`` [B, k], [B, k],
    [B], and a ``RouteStats`` with ``return_stats``.

    ``route="none"``: one fan-out of P * B rows (every shard walked, also
    one dead under ``shard_mask``, whose results the merge drops).
    ``route="upper_bound"``: phase 1 walks the hottest shard (max
    ``max_norm``; no rows if ``shard_mask`` kills it), phase 2 every other
    live shard masked per query by ``shard_visit_mask(max_norm_s, ||q||,
    kth_phase1)``: P * B rows, the masked ones born done.  The merge takes
    the hot shard's results first, then the others in shard order, as the
    JAX merge of [phase 1; phase 2] does.  ``storage="tiered"`` walks phase
    1 in f32 and phase 2 in int8 (it needs routing).  Each stage is one
    ``beam_walk`` launch (two for ip-NSW+).  An index without int8 stores
    searched with "int8" / "tiered" derives them for the call."""
    _check(index, storage, route)
    if storage == "tiered" and route == "none":
        raise ValueError(
            "storage='tiered' on the fan-out path requires route='upper_bound' (the hot/cold "
            "walk phases ARE the routing phases); use sharded_search_reference for unrouted "
            "tiering")
    index, q, mask = _prepare(index, queries, storage, shard_mask)
    steps = max_steps if max_steps is not None else 2 * ef
    p, b = index.n_shards, q.shape[0]
    walk = dict(plus=plus, k=k, ef=ef, max_steps=steps, ang_ef=ang_ef, k_angular=k_angular)
    every = torch.arange(p, device=index.device)

    if route == "none":
        f = fanout(index, q, every, storage=storage, **walk)
        out_ids, out_scores = _merge_topk(*_globalize(index, every, f.ids, f.scores), k, mask)
        evals = _int32_sum(f.evals)
        visited = _int32_sum(mask).expand(b)
        skips = torch.zeros(b, dtype=torch.int32, device=index.device)
    else:
        order = torch.argsort(-index.max_norm, stable=True)
        hot_shard = order[:1]
        hot = (every == order[0]) & mask                              # [P]
        v1 = mask[hot_shard].expand(b)
        f1 = fanout(index, q, hot_shard, valid=v1,
                    storage=_tier_storage(storage, True), **walk)
        g1, s1 = _globalize(index, hot_shard, f1.ids, f1.scores)
        kth = _merge_topk(g1, s1, k, mask[hot_shard])[1][:, k - 1]    # [B]
        v2 = ((~hot & mask)[:, None]
              & shard_visit_mask(index.max_norm[:, None], query_norms(q)[None, :], kth[None, :]))
        f2 = fanout(index, q, every, valid=v2.reshape(-1),
                    storage=_tier_storage(storage, False), **walk)
        g2, s2 = _globalize(index, every, f2.ids, f2.scores)
        out_ids, out_scores = _merge_topk(torch.cat([g1, g2]), torch.cat([s1, s2]), k,
                                          torch.cat([mask[hot_shard], mask]))
        evals = f1.evals[0] + _int32_sum(f2.evals)
        visited = v1.to(torch.int32) + _int32_sum(v2)
        skips = _int32_sum((~hot & mask)[:, None] & ~v2)
    if return_stats:
        return out_ids, out_scores, evals, RouteStats(visited.contiguous(), skips)
    return out_ids, out_scores, evals


def sharded_search_reference(
    index: ShardedIndex,
    queries,
    *,
    k: int = 10,
    ef: int = 64,
    max_steps: Optional[int] = None,
    plus: bool = True,
    shard_mask=None,
    ang_ef: int = 10,
    k_angular: int = 10,
    storage: str = "f32",
    route: str = "none",
    return_stats: bool = False,
):
    """The oracle: one walk of B rows a shard, on the shard's own graphs.

    With ``route="none"`` and no tiering: every shard walked, the results
    merged shard-major (``sharded_search(route="none")``'s answer).  With
    ``route="upper_bound"`` or ``storage="tiered"`` it DEFINES the semantics:
    a sequential pass over the shards in descending ``max_norm``, carrying
    the running top k; before each shard, query q's walk is masked out iff
    ``shard_visit_mask`` says the shard's bound is strictly below q's
    current k-th score.  That k-th score tightens after every shard, so this
    oracle skips at least as many shards as the two-phase driver.
    ``storage="tiered"`` walks the first (hottest) shard f32, the rest int8."""
    _check(index, storage, route)
    index, q, mask = _prepare(index, queries, storage, shard_mask)
    steps = max_steps if max_steps is not None else 2 * ef
    p, b = index.n_shards, q.shape[0]
    walk = dict(plus=plus, k=k, ef=ef, max_steps=steps, ang_ef=ang_ef, k_angular=k_angular)
    dev = index.device

    def one(s: int, storage: str, valid=None):
        view = _shard_view(index, s)
        entries = (view.ip.entry.expand(b, 1),
                   None if view.ang is None else view.ang.entry.expand(b, 1))
        w = _walk(view, q, entries, storage=storage, valid=valid, **walk)
        shard = torch.tensor([s], device=dev)
        gids, scores = _globalize(index, shard, w.ids[None], w.scores[None])
        return gids[0], scores[0], w.evals

    if route == "none" and storage != "tiered":
        outs = [one(s, storage) for s in range(p)]
        out_ids, out_scores = _merge_topk(torch.stack([o[0] for o in outs]),
                                          torch.stack([o[1] for o in outs]), k, mask)
        evals = _int32_sum(torch.stack([o[2] for o in outs]))
        if return_stats:
            stats = RouteStats(_int32_sum(mask).expand(b).contiguous(),
                               torch.zeros(b, dtype=torch.int32, device=dev))
            return out_ids, out_scores, evals, stats
        return out_ids, out_scores, evals

    use_bound = route == "upper_bound"
    qnorm = query_norms(q)
    order = torch.argsort(-index.max_norm, stable=True).tolist()
    run_ids = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    run_scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    evals = torch.zeros(b, dtype=torch.int32, device=dev)
    visited = torch.zeros(b, dtype=torch.int32, device=dev)
    skips = torch.zeros(b, dtype=torch.int32, device=dev)
    for i, s in enumerate(order):
        live_shard = mask[s].expand(b)
        visit = live_shard
        if use_bound:
            visit = live_shard & shard_visit_mask(index.max_norm[s], qnorm, run_scores[:, k - 1])
        gids, scores, ev = one(s, _tier_storage(storage, i == 0), valid=visit)
        run_ids, run_scores = _merge_pair(run_ids, run_scores, gids, scores, k)
        evals = evals + ev
        visited = visited + visit.to(torch.int32)
        skips = skips + (live_shard & ~visit).to(torch.int32)
    if return_stats:
        return run_ids, run_scores, evals, RouteStats(visited, skips)
    return run_ids, run_scores, evals


# ---------------------------------------------------------------------------
# Streaming churn on the banded path
# ---------------------------------------------------------------------------


class ShardedMutable:
    """A norm-banded sharded index opened for streaming mutation: one
    ``MutableIndex`` per band, plus the global-id bookkeeping the banded
    merge needs.

    * Upserts route each new item to the band whose norm range covers it
      (band edges = the build-time per-band min norms); a full band falls
      back to the nearest band with free slots, and the band that takes the
      item has its ``max_norm`` widened to cover it, so the routing bound
      stays a true upper bound under churn.
    * Deletes map global ids to (band, slot) tombstones; slots are reused
      FIFO per band by the ``MutableIndex`` pools.
    * ``snapshot()`` restacks the padded per-band graphs into a
      ``ShardedIndex`` (live, gid, max_norm, count and the flat adjacency)
      for either search driver.

    Every band is padded to ``capacity = ceil(N / P) + headroom`` rows.  A
    band's upserts replay its captured chunk on the card, so every write
    here (``_force_in_edge`` too) goes into the bands' tensors in place.
    """

    def __init__(self, items, n_shards: int, *, plus: bool = False, headroom: int = 64,
                 mutation_batch: int = 16, relink_threshold: float = 0.3,
                 device: str = "cuda", **index_kwargs):
        if isinstance(items, torch.Tensor):
            items = items.cpu().numpy()
        items = np.asarray(items, np.float32)
        n = items.shape[0]
        if n < n_shards:
            raise ValueError(f"need at least one item per band: n={n} < P={n_shards}")
        norms = np.linalg.norm(items, axis=-1)
        bands, band_max = norm_band_partition(norms, n_shards)
        self.n_shards = n_shards
        self.plus = plus
        self.capacity = -(-n // n_shards) + int(headroom)
        self.max_norm = np.asarray(band_max, np.float32).copy()
        # band lower edges (min member norm): the routing table of upserts,
        # descending like the bands
        self.band_lo = np.asarray([float(norms[bnd].min()) if len(bnd) else 0.0
                                   for bnd in bands], np.float32)
        self.shards: List[MutableIndex] = []
        self._gids: List[np.ndarray] = []
        self._slot_of: dict = {}      # global id -> (band, slot)
        self._next_gid = n
        cls = IpNSWPlus if plus else IpNSW
        for bnd in bands:
            idx = cls(device=device, **index_kwargs).build(items[bnd])
            self.shards.append(MutableIndex(idx, capacity=self.capacity,
                                            mutation_batch=mutation_batch,
                                            relink_threshold=relink_threshold))
            gid = np.full(self.capacity, -1, np.int32)
            gid[: len(bnd)] = bnd
            self._gids.append(gid)
            for slot, g in enumerate(bnd):
                self._slot_of[int(g)] = (len(self.shards) - 1, slot)

    # -- routing -----------------------------------------------------------

    def _route_band(self, norm: float, need: int = 1) -> int:
        """The hottest band whose lower edge covers ``norm``; else outward
        to the nearest band with ``need`` free slots."""
        fits = np.flatnonzero(self.band_lo <= norm)
        pref = int(fits[0]) if len(fits) else self.n_shards - 1
        for s in sorted(range(self.n_shards), key=lambda s: (abs(s - pref), s)):
            if self.shards[s].free_slots() >= need:
                return s
        raise RuntimeError("every band's free-slot pool is exhausted -- grow headroom= or "
                           "delete first")

    # -- mutations ---------------------------------------------------------

    def upsert(self, new_items) -> np.ndarray:
        """Insert a batch; returns the new GLOBAL ids, in payload order."""
        if isinstance(new_items, torch.Tensor):
            new_items = new_items.cpu().numpy()
        new_items = np.asarray(new_items, np.float32)
        norms = np.linalg.norm(new_items, axis=-1)
        by_band: dict = {}
        gids = np.empty(len(new_items), np.int32)
        for i, v in enumerate(norms):
            s = self._route_band(float(v))
            # account for rows already queued on this band this batch
            while self.shards[s].free_slots() <= len(by_band.get(s, [])):
                nxt = [t for t in range(self.n_shards)
                       if self.shards[t].free_slots() > len(by_band.get(t, []))]
                if not nxt:
                    raise RuntimeError("every band's free-slot pool is exhausted -- grow "
                                       "headroom= or delete first")
                s = min(nxt, key=lambda t: (abs(t - s), t))
            gids[i] = self._next_gid
            self._next_gid += 1
            by_band.setdefault(s, []).append(i)
        for s, rows in by_band.items():
            slots = self.shards[s].upsert(new_items[rows])
            self.max_norm[s] = max(float(self.max_norm[s]), float(norms[rows].max()))
            for i, slot in zip(rows, slots):
                slot = int(slot)
                self._gids[s][slot] = gids[i]
                self._slot_of[int(gids[i])] = (s, slot)
        return gids

    def delete(self, global_ids) -> None:
        """Tombstone a batch of live global ids (any mix of bands)."""
        by_band: dict = {}
        for g in np.unique(np.asarray(global_ids, np.int64).ravel()):
            loc = self._slot_of.get(int(g))
            if loc is None:
                raise ValueError(f"global id {int(g)} is not live")
            by_band.setdefault(loc[0], []).append(loc[1])
        for s, slots in by_band.items():
            self.shards[s].delete(slots)
            for slot in slots:
                g = int(self._gids[s][slot])
                self._gids[s][slot] = -1
                self._slot_of.pop(g, None)

    def kill_hubs(self, band: int, k: int) -> np.ndarray:
        """Fault injection on one band: tombstone its k highest in-degree
        live nodes (at most all but one); returns their GLOBAL ids."""
        local = self.shards[band].kill_hubs(k)
        gids = self._gids[band][local].copy()
        for slot in local:
            g = int(self._gids[band][slot])
            self._gids[band][slot] = -1
            self._slot_of.pop(g, None)
        return gids

    # -- repair / health ---------------------------------------------------

    def _graphs(self, band: int) -> List[GraphIndex]:
        m = self.shards[band]
        return [m.index.ip_graph, m.index.ang_graph] if self.plus else [m.index.graph]

    def _orphan_slots(self, band: int) -> np.ndarray:
        """Live slots of one band that no live node points to and that are no
        graph's entry (for ip-NSW+: in both graphs).  Out-edge repair cannot
        make such a node findable again; it needs a re-seat.  Reads the
        band's adjacency back to the host."""
        m = self.shards[band]
        live = m._live_host
        orphan = live.copy()
        for g in self._graphs(band):
            adj = g.adj.cpu().numpy()[: m.size]
            edge = (adj >= 0) & live[: m.size, None]
            indeg = np.zeros(len(live), np.int64)
            np.add.at(indeg, adj[edge], 1)
            reachable = indeg > 0
            reachable[int(g.entry)] = True
            orphan &= ~reachable
        return np.flatnonzero(orphan).astype(np.int32)

    def _reseat(self, band: int, slot: int) -> None:
        """Re-insert an orphaned slot's item under its global id (a fresh
        insertion's reverse-link commit restores in-edges); a node that comes
        back still orphaned gets one forced in-edge, so repair converges."""
        m = self.shards[band]
        gid = int(self._gids[band][slot])
        item = m.graph.items[slot].cpu().numpy().copy()
        m.delete([slot])
        self._gids[band][slot] = -1
        new_slot = int(m.upsert(item[None, :])[0])
        self._gids[band][new_slot] = gid
        self._slot_of[gid] = (band, new_slot)
        if new_slot in self._orphan_slots(band):
            self._force_in_edge(band, new_slot)

    def _force_in_edge(self, band: int, slot: int) -> None:
        """Point one live node's edge at ``slot``, written into the band's
        adjacency in place.  Donors are tried best inner product first; the
        evicted edge is the most redundant one (a -1 hole, else a dead
        target, else a live target of in-degree >= 2), so no third node is
        orphaned.  Keeps I1-I6."""
        m = self.shards[band]
        g = self._graphs(band)[0]
        adj = g.adj.cpu().numpy().copy()
        live = m._live_host
        size = m.size
        items = g.items.cpu().numpy()
        donors = np.flatnonzero(live[:size])
        donors = donors[donors != slot]
        if donors.size == 0:
            return
        donors = donors[np.argsort(-(items[donors] @ items[slot]))]
        indeg = np.zeros(len(live), np.int64)
        used = adj[:size]
        src_live = (used >= 0) & live[:size, None]
        np.add.at(indeg, used[src_live], 1)
        for u in donors:
            row = adj[u]
            holes = np.flatnonzero(row < 0)
            if holes.size:
                j = int(holes[0])
            else:
                dead = np.flatnonzero(~live[row])
                if dead.size:
                    j = int(dead[0])
                else:
                    red = np.flatnonzero(indeg[row] >= 2)
                    if red.size == 0:
                        continue
                    j = int(red[np.argmin(items[row[red]] @ items[u])])
            g.adj[int(u), j] = slot
            return

    def relink(self, budget: int) -> int:
        """Per-band repair under one budget: rewrite rotted out-edge lists
        (``MutableIndex.relink``), then re-seat orphaned live nodes.  Both
        count toward ``relink_debt()``."""
        done = 0
        for s, m in enumerate(self.shards):
            done += m.relink(budget)
            for slot in self._orphan_slots(s)[: max(int(budget), 0)]:
                self._reseat(s, int(slot))
                done += 1
        return done

    def relink_debt(self) -> int:
        return sum(m.relink_debt() for m in self.shards) + sum(
            len(self._orphan_slots(s)) for s in range(self.n_shards))

    def check_invariants(self, max_dead_edge_frac: float = 1.0) -> List[str]:
        errs: List[str] = []
        for s, m in enumerate(self.shards):
            errs += [f"band{s}: {e}" for e in m.check_invariants(max_dead_edge_frac)]
        return errs

    def live_gids(self) -> np.ndarray:
        return np.asarray(sorted(self._slot_of), np.int64)

    def live_items(self) -> Tuple[np.ndarray, np.ndarray]:
        """(gids, items) of the live catalog, gid-sorted: the input a fresh
        banded rebuild would index."""
        gids = self.live_gids()
        band_items = [m.graph.items.cpu().numpy() for m in self.shards]
        rows = np.empty((len(gids), band_items[0].shape[1]), np.float32)
        for i, g in enumerate(gids):
            s, slot = self._slot_of[int(g)]
            rows[i] = band_items[s][slot]
        return gids, rows

    # -- snapshot ----------------------------------------------------------

    def snapshot(self, storage: str = "f32") -> ShardedIndex:
        """Freeze the current state into a ``ShardedIndex`` (copies): stacked
        padded graphs, the bands' live masks, the gid map, count = each
        band's slot high-water mark, the (possibly widened) max_norm
        bounds, and the flat adjacency."""
        dev = self.shards[0].device
        ip = _stack_graphs([m.index.ip_graph if self.plus else m.index.graph
                            for m in self.shards])
        ang = _stack_graphs([m.index.ang_graph for m in self.shards]) if self.plus else None
        index = with_flat_adjacency(ShardedIndex(
            ip=ip, ang=ang,
            offset=torch.arange(self.n_shards, dtype=torch.int32, device=dev) * self.capacity,
            count=torch.tensor([m.size for m in self.shards], dtype=torch.int32, device=dev),
            live=torch.stack([m.live for m in self.shards]),
            gid=torch.as_tensor(np.stack(self._gids), device=dev),
            max_norm=torch.as_tensor(self.max_norm.copy(), device=dev),
        ))
        return _attach_stores(index, storage)
