"""ip-NSW+ (the paper's contribution, §4, Algorithm 3).

Two proximity graphs over the same items:
  A_s -- angular NSW over the unit-normalized items (paper: M = l = 10)
  G_s -- inner-product NSW (the parameters of plain ip-NSW)

Search: walk A_s for the top-k' angular neighbors of q, seed the pool with
their G_s out-neighbors (Theorem 2: the MIPS neighbor of an angular
neighbor is likely a MIPS neighbor), then walk G_s.

Build (§4.2): each batch is inserted into A_s first; its G_s neighbors are
then found by the ip-NSW+ search itself, seeded from the angular neighbors
just found.  ``build_backend="scan"`` runs both inserts of a batch as one
fixed-shape step (``scan_build_plus_arrays``; on the card one CUDA graph,
replayed over the schedule, ``build.replay_schedule``).

With ``storage="int8"`` both walks of a search stream quantized stores, one
per graph (the angular one holds the normalized copy), and each ends with
its exact fp32 rerank.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from repro_torch.core.build import (
    _bootstrap_neighbors,
    batch_schedule,
    commit_batch,
    find_neighbors,
    replay_schedule,
    validate_build_backend,
    write_carry,
)
from repro_torch.core.graph import GraphIndex, empty_graph
from repro_torch.core.ipnsw import _as_mask
from repro_torch.core.search import beam_search
from repro_torch.core.similarity import NEG_INF, normalize
from repro_torch.core.storage import ItemStore, make_store, validate_storage


class PlusResult(NamedTuple):
    ids: torch.Tensor          # [B, k] final MIPS ids
    scores: torch.Tensor       # [B, k] inner products
    evals: torch.Tensor        # [B] total evaluations (angular + ip)
    ang_evals: torch.Tensor    # [B]
    ip_evals: torch.Tensor     # [B]
    visited_ang: torch.Tensor  # [B, Va] ids scored on A_s
    visited_ip: torch.Tensor   # [B, Vi] ids scored on G_s
    trace: Optional[object] = None  # obs.WalkTrace of the G_s refine walk;
    #   None untraced


def _seed_from_angular(ip_adj: torch.Tensor, ang_ids: torch.Tensor) -> torch.Tensor:
    """Algorithm 3 lines 3-5: the G_s out-neighbors of the angular results.
    [B, k'] ids (-1 padded) -> [B, k' * M] seeds (-1 padded)."""
    rows = ip_adj[ang_ids.clamp_min(0).long()]               # [B, k', M]
    rows = torch.where(ang_ids[..., None] >= 0, rows, -1)
    return rows.reshape(ang_ids.shape[0], -1)


def _find_ip_neighbors_seeded(
    ip_graph: GraphIndex,
    batch_items: torch.Tensor,
    ang_nbr_ids: torch.Tensor,
    *,
    max_degree: int,
    ef: int,
    max_steps: int,
    live: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    capturable: bool = False,
):
    """§4.2 insertion: an item's G_s neighbors by the angular-seeded walk.
    The entry vertex joins the seeds so that the first, sparse batches still
    have a valid start.  ``live``, ``valid`` and ``capturable`` are
    ``build.find_neighbors``'s: no new edge points at a dead slot, pad rows
    are born done, nothing is read back."""
    seeds = _seed_from_angular(ip_graph.adj, ang_nbr_ids)
    entry = ip_graph.entry.expand(batch_items.shape[0], 1).to(seeds.dtype)
    res = beam_search(ip_graph, batch_items, torch.cat([seeds, entry], dim=-1),
                      pool_size=ef, max_steps=max_steps, k=max_degree, live=live,
                      valid=valid, capturable=capturable)
    return torch.where(res.scores > NEG_INF, res.ids, -1), res.scores


def _search_plus(
    ang_graph: GraphIndex,
    ip_graph: GraphIndex,
    queries: torch.Tensor,
    *,
    k: int,
    ef: int,
    ang_ef: int,
    k_angular: int,
    max_steps: int,
    ang_max_steps: int,
    storage: str = "f32",
    ang_store: Optional[ItemStore] = None,
    ip_store: Optional[ItemStore] = None,
    live: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    capturable: bool = False,
    trace=None,
) -> PlusResult:
    b = queries.shape[0]
    # Angular ranking is monotone in q . x_hat, so the raw query walks the
    # normalized items.  Both graphs index the same slots, so one tombstone
    # mask serves both walks; the angular walk cuts dead ids from its own
    # results, so no G_s seed row comes from a deleted item.  The padding
    # mask also masks both: a pad row's angular walk returns -1 ids, which
    # seed nothing.
    ang = beam_search(ang_graph, queries, ang_graph.entry.expand(b, 1),
                      pool_size=max(ang_ef, k_angular), max_steps=ang_max_steps,
                      k=k_angular, storage=storage, store=ang_store, live=live, valid=valid,
                      capturable=capturable)
    seeds = _seed_from_angular(ip_graph.adj, ang.ids)
    # The trace covers the G_s refine walk only: the walk whose norm bias
    # the paper measures (the angular walk runs on the normalized copy,
    # where every norm is 1).
    ip = beam_search(ip_graph, queries, seeds, pool_size=max(ef, k),
                     max_steps=max_steps, k=k, storage=storage, store=ip_store, live=live,
                     valid=valid, capturable=capturable, trace=trace)
    return PlusResult(
        ids=ip.ids,
        scores=ip.scores,
        evals=ang.evals + ip.evals,
        ang_evals=ang.evals,
        ip_evals=ip.evals,
        visited_ang=ang.visited,
        visited_ip=ip.visited,
        trace=ip.trace,
    )


@dataclass
class IpNSWPlus:
    """Dual-graph MIPS index (Algorithm 3 + the §4.2 joint construction).
    The angular graph uses the paper's M = l = 10; the inner-product graph
    the parameters of plain ip-NSW.  ``storage`` is the item representation
    search streams, as ``IpNSW``'s.  The index lives on ``device``; the
    default is the card."""

    max_degree: int = 16          # M of G_s
    ef_construction: int = 64     # l of G_s insertion
    ang_degree: int = 10          # M of A_s
    ang_ef: int = 10              # l of A_s
    k_angular: int = 10           # k': angular results whose G_s edges seed C
    insert_batch: int = 128
    reverse_links: bool = True
    build_backend: str = "host"   # insertion driver (build.BUILD_BACKENDS)
    storage: str = "f32"
    device: str = "cuda"
    ang_graph: Optional[GraphIndex] = None
    ip_graph: Optional[GraphIndex] = None
    ang_store: Optional[ItemStore] = None
    ip_store: Optional[ItemStore] = None

    def build(self, items, progress: bool = False) -> "IpNSWPlus":
        validate_storage(self.storage)
        validate_build_backend(self.build_backend)
        items = torch.as_tensor(items, dtype=torch.float32, device=self.device).contiguous()
        n = items.shape[0]
        ang_items = normalize(items).contiguous()
        norms = torch.linalg.vector_norm(items, dim=-1)
        ang_norms = torch.ones(n, dtype=torch.float32, device=items.device)
        _, batch_ids, batch_valid = batch_schedule(n, self.insert_batch)
        knobs = dict(max_degree=self.max_degree, ef_construction=self.ef_construction,
                     ang_degree=self.ang_degree, ang_ef=self.ang_ef,
                     k_angular=self.k_angular, reverse_links=self.reverse_links)
        if self.build_backend == "scan":
            a_adj, a_size, a_entry, a_enorm, i_adj, i_size, i_entry, i_enorm = (
                scan_build_plus_arrays(
                    items, ang_items, norms, ang_norms,
                    torch.as_tensor(batch_ids, device=items.device),
                    torch.as_tensor(batch_valid, device=items.device),
                    insert_batch=self.insert_batch, **knobs))
            self.ang_graph = GraphIndex(a_adj, ang_items, a_size, a_entry, a_enorm)
            self.ip_graph = GraphIndex(i_adj, items, i_size, i_entry, i_enorm)
        else:
            ang, ip = _bootstrap_plus(items, ang_items, norms, ang_norms,
                                      max_degree=self.max_degree, ang_degree=self.ang_degree,
                                      insert_batch=self.insert_batch,
                                      reverse_links=self.reverse_links)
            step = _insert_plus_step(ang, ip, norms, ang_norms, capturable=False, **knobs)
            for row, valid in zip(batch_ids, batch_valid):
                step(torch.as_tensor(row[valid], device=items.device), None)
                if progress and (int(row[0]) // self.insert_batch) % 20 == 0:
                    print(f"  inserted {int(row[valid][-1]) + 1}/{n}")
            self.ang_graph, self.ip_graph = ang, ip
        self._make_stores(self.storage)
        return self

    def _make_stores(self, storage: str) -> None:
        """Derive both graphs' stores (None for "f32")."""
        self.ang_store = make_store(self.ang_graph.items, storage)
        self.ip_store = make_store(self.ip_graph.items, storage)

    def search(self, queries, k: int = 10, ef: int = 64,
               ang_ef: Optional[int] = None, k_angular: Optional[int] = None,
               max_steps: Optional[int] = None,
               storage: Optional[str] = None,
               live: Optional[torch.Tensor] = None,
               valid: Optional[torch.Tensor] = None,
               capturable: bool = False, trace=None) -> PlusResult:
        """``storage`` overrides the index's own for this call; ``live`` is
        the tombstone mask of a mutable index and ``valid`` the [B]
        bucket-padding mask (``search.beam_search``), each applied to both
        walks: pad rows skip the angular stage, seed nothing and come back
        as ids -1.  ``capturable`` reads nothing back in either walk.
        ``trace`` is an optional ``obs.TraceContext`` over the raw item
        norms: it traces the G_s refine walk (``PlusResult.trace``) at
        unchanged outputs."""
        if self.ip_graph is None:
            raise RuntimeError("call build() first")
        st = storage if storage is not None else self.storage
        validate_storage(st)
        if st == "int8" and self.ip_store is None:
            self._make_stores(st)  # an f32-built index searched with int8
        ang_ef = ang_ef if ang_ef is not None else self.ang_ef
        k_ang = k_angular if k_angular is not None else self.k_angular
        return _search_plus(
            self.ang_graph, self.ip_graph,
            torch.as_tensor(queries, dtype=torch.float32, device=self.device),
            k=k, ef=ef, ang_ef=ang_ef, k_angular=k_ang,
            max_steps=max_steps if max_steps is not None else 2 * ef,
            ang_max_steps=2 * max(ang_ef, k_ang),
            storage=st,
            ang_store=self.ang_store if st == "int8" else None,
            ip_store=self.ip_store if st == "int8" else None,
            live=live,
            valid=_as_mask(valid, self.device),
            capturable=capturable,
            trace=trace,
        )


def _bootstrap_plus(items, ang_items, norms, ang_norms, *, max_degree: int, ang_degree: int,
                    insert_batch: int, reverse_links: bool):
    """Both graphs with the sequential-prefix first batch committed."""
    first = min(insert_batch, items.shape[0])
    ids0 = torch.arange(first, device=items.device)
    a_nbr0, a_sc0 = _bootstrap_neighbors(ang_items[:first], ang_degree)
    ang = commit_batch(empty_graph(ang_items, ang_degree), ids0, a_nbr0, a_sc0, ang_norms,
                       reverse_links=reverse_links)
    g_nbr0, g_sc0 = _bootstrap_neighbors(items[:first], max_degree)
    ip = commit_batch(empty_graph(items, max_degree), ids0, g_nbr0, g_sc0, norms,
                      reverse_links=reverse_links)
    return ang, ip


def _insert_plus_step(ang: GraphIndex, ip: GraphIndex, norms, ang_norms, *, max_degree: int,
                      ef_construction: int, ang_degree: int, ang_ef: int, k_angular: int,
                      reverse_links: bool, capturable: bool):
    """One §4.2 batch of both drivers, ``step(bids, valid)``: the angular
    insert and its commit, then the angular-seeded ip insert against the ip
    graph as it stood before its commit, then that commit.  Both graphs are
    written in place (``build.write_carry``).  The host driver passes a
    ragged batch and ``valid=None``; the scan driver a fixed-shape one with
    its mask, ``capturable``."""
    ang_ef = max(ang_ef, ang_degree)

    def step(bids: torch.Tensor, valid: Optional[torch.Tensor]) -> None:
        # 1. insert into the angular graph (plain Algorithm 2)
        a_nbr, a_sc = find_neighbors(ang, ang.items[bids], max_degree=ang_degree, ef=ang_ef,
                                     max_steps=2 * ang_ef, valid=valid, capturable=capturable)
        write_carry(ang, commit_batch(ang, bids, a_nbr, a_sc, ang_norms, valid=valid,
                                      reverse_links=reverse_links))
        # 2. insert into the ip graph with the ip-NSW+ search itself
        g_nbr, g_sc = _find_ip_neighbors_seeded(
            ip, ip.items[bids], a_nbr[:, :k_angular], max_degree=max_degree,
            ef=ef_construction, max_steps=2 * ef_construction, valid=valid,
            capturable=capturable)
        write_carry(ip, commit_batch(ip, bids, g_nbr, g_sc, norms, valid=valid,
                                     reverse_links=reverse_links))

    return step


def scan_build_plus_arrays(
    items: torch.Tensor,
    ang_items: torch.Tensor,
    norms: torch.Tensor,
    ang_norms: torch.Tensor,
    batch_ids: torch.Tensor,    # [T, B] int64 (tail clamped)
    batch_valid: torch.Tensor,  # [T, B] bool
    *,
    max_degree: int,
    ef_construction: int,
    ang_degree: int,
    ang_ef: int,
    k_angular: int,
    insert_batch: int,
    reverse_links: bool,
):
    """The ip-NSW+ scan build: both graphs bootstrapped, then one
    fixed-shape step holding both inserts of a batch, replayed over the
    schedule (``build.replay_schedule``), each graph with its own in-place
    carry.  Returns ``(ang_adj, ang_size, ang_entry, ang_entry_norm, ip_adj,
    ip_size, ip_entry, ip_entry_norm)``."""
    ang, ip = _bootstrap_plus(items, ang_items, norms, ang_norms, max_degree=max_degree,
                              ang_degree=ang_degree, insert_batch=insert_batch,
                              reverse_links=reverse_links)
    replay_schedule(
        _insert_plus_step(ang, ip, norms, ang_norms, max_degree=max_degree,
                          ef_construction=ef_construction, ang_degree=ang_degree,
                          ang_ef=ang_ef, k_angular=k_angular, reverse_links=reverse_links,
                          capturable=True),
        batch_ids, batch_valid)
    return (ang.adj, ang.size, ang.entry, ang.entry_norm,
            ip.adj, ip.size, ip.entry, ip.entry_norm)
