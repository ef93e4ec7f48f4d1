"""Streaming index mutation: live upsert, tombstone delete, hub kill and
relink repair (the JAX package's DESIGN.md §9).

The paper's graphs are built once; production catalogs churn.  The norm
bias the paper studies makes churn costly: walks funnel through a few
large-norm, high-in-degree hubs, so deleting them can sever navigability far
out of proportion to the items removed.

  tombstones  -- a delete clears one entry of the ``[capacity]`` bool live
                 mask.  Dead nodes keep their vectors and adjacency rows and
                 still route walks; every search cuts them from its results
                 (``search.beam_search(live=)``).
  free slots  -- a fixed-capacity slot pool.  Upserts reuse tombstoned slots
                 FIFO by deletion time, then never-used headroom in ascending
                 order, so steady churn keeps the high-water mark flat.
  relink      -- the repair pass: a live node whose out-edges point mostly
                 at tombstones re-runs the live-masked neighbor search and
                 commit, a budget at a time, worst first.

``MutableIndex`` wraps a built ``IpNSW`` or ``IpNSWPlus`` (both graphs of the
latter mutate together and share one live mask).  It pads the graphs once to
``capacity`` rows and then updates them in place, on the index's device: the
JAX package's jitted bodies with donated carries become plain functions that
write the padded tensors, in the same order of operations.  A chunk of a
mutation is sliced to its rows where the JAX package pads it to
``mutation_batch`` rows; walks are row-independent, so the result is the
same.  The host keeps what the JAX package keeps there: a mirror of the live
mask (for validation and for seeded sampling) and the free-slot deque.
``ChurnTrace`` generates seeded churn and fault-injection event streams, and
``core/invariants.py`` checks the graphs.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.build import commit_batch, find_neighbors
from repro_torch.core.graph import GraphIndex, pad_graph
from repro_torch.core.invariants import check_graph_invariants, dead_edge_fraction
from repro_torch.core.ipnsw import IpNSW
from repro_torch.core.ipnsw_plus import IpNSWPlus, _find_ip_neighbors_seeded
from repro_torch.core.similarity import NEG_INF, normalize
from repro_torch.core.storage import ItemStore, quantize_items, update_store_rows


class MutableIndex:
    """A built ``IpNSW`` / ``IpNSWPlus`` opened for streaming mutation.

    Construction pads the graphs to ``capacity`` rows (never-used tail: adj
    -1, items 0, live False); every mutation then writes those tensors in
    place, ``mutation_batch`` rows at a time.

    Slot policy (deterministic): tombstoned slots are reused FIFO by
    deletion time, then never-used headroom in ascending order.  When both
    are exhausted, ``upsert`` raises RuntimeError before any state changes.

    The wrapped index stays the one source of truth for search: every
    mutation writes the updated graphs (and int8 store rows) back into it,
    and ``search()`` delegates with ``live=`` attached.  A search between two
    mutation batches sees the committed prefix, nothing half-written.
    """

    def __init__(
        self,
        index: Union[IpNSW, IpNSWPlus],
        *,
        capacity: Optional[int] = None,
        mutation_batch: int = 32,
        relink_threshold: float = 0.3,
    ):
        if not isinstance(index, (IpNSW, IpNSWPlus)):
            raise TypeError(f"MutableIndex wraps IpNSW or IpNSWPlus, got {type(index)}")
        self.index = index
        self.plus = isinstance(index, IpNSWPlus)
        g = index.ip_graph if self.plus else index.graph
        if g is None:
            raise ValueError("index must be built before mutation")
        n0 = g.capacity
        self.capacity = n0 if capacity is None else int(capacity)
        if self.capacity < n0:
            raise ValueError(f"capacity {self.capacity} below built size {n0}")
        if mutation_batch <= 0:
            raise ValueError(f"mutation_batch must be positive, got {mutation_batch}")
        self.mutation_batch = int(mutation_batch)
        self.relink_threshold = float(relink_threshold)

        if self.plus:
            index.ip_graph = pad_graph(index.ip_graph, self.capacity)
            index.ang_graph = pad_graph(index.ang_graph, self.capacity)
        else:
            index.graph = pad_graph(index.graph, self.capacity)
        self._pad_stores()

        g = self.graph
        self.device = g.adj.device
        size0 = int(g.size)
        self.norms = torch.linalg.vector_norm(g.items, dim=-1)
        self.live = torch.arange(self.capacity, device=self.device) < size0
        self._ang_norms = torch.ones_like(self.norms)  # every angular item is unit
        self._live_host = np.arange(self.capacity) < size0
        self._next_fresh = size0
        self._free: deque = deque()   # tombstones, FIFO by deletion time
        self.mutation_count = 0

    # -- introspection -----------------------------------------------------

    @property
    def graph(self) -> GraphIndex:
        """The (ip) graph currently served."""
        return self.index.ip_graph if self.plus else self.index.graph

    @property
    def size(self) -> int:
        """High-water mark of used slots (tombstones included)."""
        return int(self.graph.size)

    def free_slots(self) -> int:
        return len(self._free) + (self.capacity - self._next_fresh)

    def live_ids(self) -> np.ndarray:
        return np.flatnonzero(self._live_host)

    # -- stores ------------------------------------------------------------

    def _pad_stores(self) -> None:
        """Requantize a cached int8 store from the padded items: pad rows are
        zero vectors, which quantize to zero codes (score 0.0)."""
        idx = self.index

        def pad(store: Optional[ItemStore], items) -> Optional[ItemStore]:
            if store is None or store.scales.shape[0] == self.capacity:
                return store
            return quantize_items(items)

        if self.plus:
            idx.ip_store = pad(idx.ip_store, idx.ip_graph.items)
            idx.ang_store = pad(idx.ang_store, idx.ang_graph.items)
        else:
            idx.store = pad(idx.store, idx.graph.items)

    def _sync_store_rows(self, slots, new_items, new_ang) -> None:
        """Mirror an upsert's item rows into the cached int8 stores."""
        idx = self.index
        if self.plus:
            if idx.ip_store is not None:
                idx.ip_store = update_store_rows(idx.ip_store, slots, new_items)
            if idx.ang_store is not None:
                idx.ang_store = update_store_rows(idx.ang_store, slots, new_ang)
        elif idx.store is not None:
            idx.store = update_store_rows(idx.store, slots, new_items)

    # -- allocation --------------------------------------------------------

    def _allocate(self, b: int) -> np.ndarray:
        if b > self.free_slots():
            raise RuntimeError(
                f"free-slot pool exhausted: need {b} slots, have "
                f"{self.free_slots()} (capacity {self.capacity}, "
                f"high-water {self._next_fresh}, tombstones "
                f"{len(self._free)}) — grow capacity= or delete first"
            )
        out: List[int] = []
        while len(out) < b and self._free:
            out.append(self._free.popleft())
        while len(out) < b:
            out.append(self._next_fresh)
            self._next_fresh += 1
        return np.asarray(out, np.int32)

    def _chunks(self, ids: np.ndarray):
        """(start, slots) per chunk of ``mutation_batch`` ids, slots a long
        tensor on the index's device."""
        mb = self.mutation_batch
        for i in range(0, len(ids), mb):
            yield i, torch.as_tensor(ids[i:i + mb], dtype=torch.long, device=self.device)

    def _walk_knobs(self) -> Tuple[dict, dict]:
        """Knobs of the ip-graph find and of the angular find."""
        idx = self.index
        ip = dict(max_degree=idx.max_degree, ef=idx.ef_construction,
                  max_steps=2 * idx.ef_construction, live=self.live)
        if not self.plus:
            return ip, {}
        ang_ef = max(idx.ang_ef, idx.ang_degree)
        return ip, dict(max_degree=idx.ang_degree, ef=ang_ef, max_steps=2 * ang_ef,
                        live=self.live)

    # -- mutations ---------------------------------------------------------

    def upsert(self, new_items) -> np.ndarray:
        """Insert (or replace, via slot reuse) a batch of items; returns the
        slot ids assigned, in payload order."""
        d = self.graph.items.shape[1]
        if not isinstance(new_items, torch.Tensor):
            new_items = np.asarray(new_items, np.float32)
        new_items = torch.as_tensor(new_items, dtype=torch.float32,
                                    device=self.device).contiguous()
        if new_items.ndim != 2 or new_items.shape[1] != d:
            raise ValueError(
                f"upsert payload must be [b, {d}], got {tuple(new_items.shape)}"
            )
        slots = self._allocate(new_items.shape[0])
        idx = self.index
        ip_knobs, ang_knobs = self._walk_knobs()
        for i, rows in self._chunks(slots):
            pay = new_items[i:i + rows.shape[0]]
            # Item rows and norms first, then the batch slots dead for the
            # find: fresh slots were never live, reused ones are tombstones
            # whose stale adjacency rows may still route the walk, and no
            # new item can link to a half-written batch row.
            if self.plus:
                ag, ig = idx.ang_graph, idx.ip_graph
                new_ang = normalize(pay)
                ig.items[rows] = pay
                ag.items[rows] = new_ang
                self.norms[rows] = torch.linalg.vector_norm(pay, dim=-1)
                self.live[rows] = False
                # §4.2 order: the angular insert, then the angular-seeded ip one
                a_nbr, a_sc = find_neighbors(ag, new_ang, **ang_knobs)
                idx.ang_graph = commit_batch(ag, rows, a_nbr, a_sc, self._ang_norms,
                                             reverse_links=idx.reverse_links)
                g_nbr, g_sc = _find_ip_neighbors_seeded(
                    ig, pay, a_nbr[:, :idx.k_angular], **ip_knobs)
                idx.ip_graph = commit_batch(ig, rows, g_nbr, g_sc, self.norms,
                                            reverse_links=idx.reverse_links)
                self._sync_store_rows(rows, pay, new_ang)
            else:
                g = idx.graph
                g.items[rows] = pay
                self.norms[rows] = torch.linalg.vector_norm(pay, dim=-1)
                self.live[rows] = False
                nbr, sc = find_neighbors(g, pay, **ip_knobs)
                idx.graph = commit_batch(g, rows, nbr, sc, self.norms,
                                         reverse_links=idx.reverse_links)
                self._sync_store_rows(rows, pay, None)
            self.live[rows] = True
        self._live_host[slots] = True
        self.mutation_count += 1
        return slots

    def delete(self, ids) -> None:
        """Tombstone a batch of live slots.  The rows stay in the graph as
        routing vertices; searches stop returning them at once."""
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids = np.unique(np.asarray(ids, np.int32).ravel())
        if ids.size == 0:
            return
        if ids.min() < 0 or ids.max() >= self._next_fresh:
            raise ValueError(
                f"delete ids must be used slots in [0, {self._next_fresh}), "
                f"got range [{ids.min()}, {ids.max()}]"
            )
        dead = ids[~self._live_host[ids]]
        if dead.size:
            raise ValueError(f"slots already tombstoned: {dead.tolist()}")
        if int(self._live_host.sum()) - ids.size < 1:
            raise RuntimeError("delete would tombstone the entire catalog")
        for _, rows in self._chunks(ids):
            self.live[rows] = False
            # The entry re-seats to the max-norm live node (the criterion the
            # build keeps), by one masked argmax taking the first maximum.
            masked = torch.where(self.live, self.norms, NEG_INF)
            new_entry = torch.argmax(masked)
            ip = self.graph
            moved = ~self.live[ip.entry]
            ip = dataclasses.replace(
                ip, entry=torch.where(moved, new_entry, ip.entry),
                entry_norm=torch.where(moved, masked[new_entry], ip.entry_norm))
            if self.plus:
                self.index.ip_graph = ip
                # The angular entry only needs to be a live vertex: it takes
                # the ip re-seat (every angular norm is 1.0) when that moved.
                ag = self.index.ang_graph
                self.index.ang_graph = dataclasses.replace(
                    ag, entry=torch.where(moved, new_entry, ag.entry),
                    entry_norm=torch.where(moved, 1.0, ag.entry_norm))
            else:
                self.index.graph = ip
        self._live_host[ids] = False
        self._free.extend(ids.tolist())
        self.mutation_count += 1

    def kill_hubs(self, k: int) -> np.ndarray:
        """Adversarial fault injection: tombstone the k live nodes with the
        highest in-degree, ties to the smaller id.  Never kills the last
        live node; returns the ids killed."""
        g = self.graph
        flat = g.adj[: int(g.size)].reshape(-1)
        indeg = torch.bincount(flat[flat >= 0].long(), minlength=self.capacity)
        indeg = torch.where(self.live, indeg, -1)
        k = min(int(k), max(int(self._live_host.sum()) - 1, 0))
        if k <= 0:
            return np.asarray([], np.int32)
        order = torch.sort(-indeg, stable=True).indices[:k]
        ids = order.cpu().numpy().astype(np.int32)
        self.delete(ids)
        return ids

    # -- repair ------------------------------------------------------------

    def _relink_candidates(self) -> torch.Tensor:
        """Live used rows ordered worst-first by dead-out-edge fraction
        (float64, ties by id), cut at ``relink_threshold``."""
        adj = self.graph.adj[: self.size]
        live = self.live
        edge = (adj >= 0) & live[: adj.shape[0], None]
        n_edges = edge.sum(dim=1)
        dead = (edge & ~live[adj.clamp_min(0).long()]).sum(dim=1)
        frac = torch.where(n_edges > 0,
                           dead.double() / n_edges.clamp_min(1).double(), 0.0)
        cand = torch.nonzero(frac >= self.relink_threshold).flatten()
        return cand[torch.sort(-frac[cand], stable=True).indices]

    def relink_debt(self) -> int:
        """Nodes currently above the repair threshold."""
        return int(self._relink_candidates().numel())

    def relink(self, budget: int) -> int:
        """Repair up to ``budget`` of the worst rotted live nodes; returns
        how many were relinked.  Call repeatedly (or with a large budget)
        until ``relink_debt() == 0`` for a full repair."""
        todo = self._relink_candidates()[: max(int(budget), 0)]
        if todo.numel() == 0:
            return 0
        idx = self.index
        ip_knobs, ang_knobs = self._walk_knobs()
        mb = self.mutation_batch
        for i in range(0, todo.numel(), mb):
            rows = todo[i:i + mb]
            # The node stays live during its own find, so it can come back
            # as its own neighbor: masked to -1 before the commit (I3).
            if self.plus:
                ag, ig = idx.ang_graph, idx.ip_graph
                a_nbr, a_sc = find_neighbors(ag, ag.items[rows], **ang_knobs)
                a_self = a_nbr == rows[:, None]
                idx.ang_graph = commit_batch(
                    ag, rows, torch.where(a_self, -1, a_nbr),
                    torch.where(a_self, NEG_INF, a_sc), self._ang_norms,
                    reverse_links=idx.reverse_links)
                g = ig
                g_nbr, g_sc = _find_ip_neighbors_seeded(
                    g, g.items[rows], a_nbr[:, :idx.k_angular], **ip_knobs)
            else:
                g = idx.graph
                g_nbr, g_sc = find_neighbors(g, g.items[rows], **ip_knobs)
            g_self = g_nbr == rows[:, None]
            g = commit_batch(g, rows, torch.where(g_self, -1, g_nbr),
                             torch.where(g_self, NEG_INF, g_sc), self.norms,
                             reverse_links=idx.reverse_links)
            if self.plus:
                idx.ip_graph = g
            else:
                idx.graph = g
        self.mutation_count += 1
        return int(todo.numel())

    # -- observability -----------------------------------------------------

    def health(self) -> Dict[str, float]:
        """Churn-health counters."""
        size = max(self.size, 1)
        live_n = int(self._live_host.sum())
        fracs = [dead_edge_fraction(self.graph.adj, self.live, self.size)]
        if self.plus:
            fracs.append(dead_edge_fraction(self.index.ang_graph.adj, self.live, self.size))
        return {
            "live_fraction": live_n / size,
            "tombstone_ratio": 1.0 - live_n / size,
            "dead_edge_frac": float(max(fracs)),
            "relink_debt": float(self.relink_debt()),
            # free tombstone slots + never-used headroom over capacity: 0.0
            # means the next upsert without a matching delete raises
            "pool_headroom": self.free_slots() / max(self.capacity, 1),
        }

    def check_invariants(self, max_dead_edge_frac: float = 1.0) -> List[str]:
        """I1-I6 over every graph (``core/invariants.py``); the violations."""
        errs = check_graph_invariants(
            self.graph, self._live_host, max_dead_edge_frac=max_dead_edge_frac,
            name="ip" if self.plus else "graph",
        )
        if self.plus:
            errs += check_graph_invariants(
                self.index.ang_graph, self._live_host,
                max_dead_edge_frac=max_dead_edge_frac, name="ang",
            )
        return errs

    # -- search ------------------------------------------------------------

    def search(self, queries, **kwargs):
        """Delegate to the wrapped index with the tombstone mask attached."""
        return self.index.search(queries, live=self.live, **kwargs)


# ---------------------------------------------------------------------------
# Churn / fault-injection traces
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ChurnEvent:
    """One timed mutation.  ``kind``:
      "upsert"   -- insert ``items`` ([b, d] payload baked into the trace)
      "delete"   -- tombstone ``count`` uniformly chosen live slots (the
                    selection rng is seeded with ``seed`` when applied, so a
                    replay against the same states is deterministic)
      "hub_kill" -- tombstone the ``count`` highest-in-degree live nodes
      "relink"   -- run a repair pass with budget ``count``
    """

    t: float
    kind: str
    items: Optional[np.ndarray] = None
    count: int = 0
    seed: int = 0


@dataclass(frozen=True)
class ChurnTrace:
    """A seeded, fully materialized churn schedule (a pure function of its
    generation arguments)."""

    events: Tuple[ChurnEvent, ...]

    @property
    def n_events(self) -> int:
        return len(self.events)

    @staticmethod
    def generate(
        *,
        n_items: int,
        dim: int,
        duration_s: float,
        turnover: float = 0.2,
        batch: int = 32,
        seed: int = 0,
        profile: str = "gaussian",
        hub_kill_at: Optional[float] = None,
        hub_kill_k: int = 0,
        relink_every: Optional[float] = None,
        relink_budget: int = 0,
        start_t: float = 0.0,
    ) -> "ChurnTrace":
        """``turnover`` is the catalog fraction both upserted and deleted
        over ``duration_s``, as alternating delete / upsert batches of
        ``batch`` evenly spaced over the window.  ``hub_kill_at`` injects one
        hub kill of ``hub_kill_k`` nodes at that offset; ``relink_every``
        schedules repair passes of ``relink_budget`` nodes."""
        from repro_torch.data import mips_dataset

        rng = np.random.default_rng(seed)
        n_mut = max(int(round(turnover * n_items / max(batch, 1))), 1)
        events: List[ChurnEvent] = []
        span = duration_s / max(2 * n_mut, 1)
        t = start_t
        for _ in range(n_mut):
            # delete before upsert: the live count stays flat and the upsert
            # reuses the slots the delete just freed
            t += span
            events.append(ChurnEvent(t=t, kind="delete", count=batch,
                                     seed=int(rng.integers(0, 2**31 - 1))))
            t += span
            payload = mips_dataset(batch, dim, profile, seed=int(rng.integers(0, 2**31 - 1)))
            events.append(ChurnEvent(t=t, kind="upsert", items=payload))
        if hub_kill_at is not None and hub_kill_k > 0:
            events.append(ChurnEvent(t=start_t + hub_kill_at, kind="hub_kill",
                                     count=hub_kill_k))
        if relink_every is not None and relink_budget > 0:
            t = start_t + relink_every
            while t < start_t + duration_s + 1e-9:
                events.append(ChurnEvent(t=t, kind="relink", count=relink_budget))
                t += relink_every
        events.sort(key=lambda e: (e.t, e.kind))
        return ChurnTrace(events=tuple(events))


def apply_churn_event(m: MutableIndex, ev: ChurnEvent) -> Dict[str, float]:
    """Apply one event; returns a small summary dict."""
    if ev.kind == "upsert":
        slots = m.upsert(ev.items)
        return {"kind": ev.kind, "n": int(len(slots))}
    if ev.kind == "delete":
        rng = np.random.default_rng(ev.seed)
        pool = m.live_ids()
        n = min(int(ev.count), len(pool) - 1)
        if n <= 0:
            return {"kind": ev.kind, "n": 0}
        m.delete(rng.choice(pool, size=n, replace=False))
        return {"kind": ev.kind, "n": n}
    if ev.kind == "hub_kill":
        return {"kind": ev.kind, "n": int(len(m.kill_hubs(ev.count)))}
    if ev.kind == "relink":
        return {"kind": ev.kind, "n": m.relink(ev.count)}
    raise ValueError(f"unknown churn event kind {ev.kind!r}")
