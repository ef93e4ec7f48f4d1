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
``capacity`` rows; from then on every tensor of the graphs and the int8
stores, the live mask and the norms keeps its address.  Each mutation runs
in fixed-shape chunks of ``mutation_batch`` rows (``_chunks``) that write
those tensors in place (``build.write_carry``, ``storage.write_store_rows``):
the JAX package's jitted bodies with donated carries, in the same order of
operations.  On the card the upsert chunk (``upsert_step``) is captured
once as a CUDA graph and replayed for every later chunk
(``capture.capture``); delete and relink run eagerly.  On the CPU every
chunk runs eagerly.  The host keeps what the JAX package keeps there: a
mirror of the live mask (for validation and for seeded sampling), the
free-slot deque and the relink candidates.  ``ChurnTrace`` generates seeded
churn and fault-injection event streams, and ``core/invariants.py`` checks
the graphs.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.build import commit_batch, find_neighbors, write_carry
from repro_torch.core.capture import capture, data_ptrs, no_sync, to_device
from repro_torch.core.graph import GraphIndex, pad_graph
from repro_torch.core.invariants import check_graph_invariants, dead_edge_fraction
from repro_torch.core.ipnsw import IpNSW
from repro_torch.core.ipnsw_plus import IpNSWPlus, _find_ip_neighbors_seeded
from repro_torch.core.similarity import NEG_INF, normalize
from repro_torch.core.storage import ItemStore, quantize_items, write_store_rows


def _walk_knobs(index: Union[IpNSW, IpNSWPlus], live: torch.Tensor) -> Tuple[dict, dict]:
    """Knobs of the ip-graph find and of the angular find: live-masked,
    fixed-shape (pad rows born done) and with nothing read back."""
    fixed = dict(live=live, capturable=True)
    ip = dict(max_degree=index.max_degree, ef=index.ef_construction,
              max_steps=2 * index.ef_construction, **fixed)
    if not isinstance(index, IpNSWPlus):
        return ip, {}
    ang_ef = max(index.ang_ef, index.ang_degree)
    return ip, dict(max_degree=index.ang_degree, ef=ang_ef, max_steps=2 * ang_ef, **fixed)


def upsert_step(index: Union[IpNSW, IpNSWPlus], norms: torch.Tensor,
                live: torch.Tensor) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], None]:
    """The fixed-shape upsert batch (the body of the JAX package's
    ``_upsert_arrays`` / ``_upsert_plus_arrays``): ``step(slots [mb] int64,
    payload [mb, d] fp32, valid [mb] bool)`` writes the batch's item rows,
    norms and live bits, the graphs and the int8 store rows in place.  Pad
    rows repeat a valid row's slot and payload (``MutableIndex._chunks``),
    so what they write changes nothing; their walks are born done and the
    commits drop them.  Nothing is read back, so on the card the step is
    captured as a CUDA graph."""
    ip_knobs, ang_knobs = _walk_knobs(index, live)
    ang_norms = torch.ones_like(norms)  # every angular item is unit
    commit = dict(reverse_links=index.reverse_links)

    def step(slots: torch.Tensor, pay: torch.Tensor, valid: torch.Tensor) -> None:
        # Item rows and norms first, then the batch slots dead for the find:
        # fresh slots were never live, reused ones are tombstones whose stale
        # adjacency rows may still route the walk, and no new item can link
        # to a half-written batch row.
        if isinstance(index, IpNSWPlus):
            ag, ig = index.ang_graph, index.ip_graph
            new_ang = normalize(pay)
            ig.items[slots] = pay
            ag.items[slots] = new_ang
            norms[slots] = torch.linalg.vector_norm(pay, dim=-1)
            live.index_fill_(0, slots, False)
            # §4.2 order: the angular insert, then the angular-seeded ip one
            a_nbr, a_sc = find_neighbors(ag, new_ang, valid=valid, **ang_knobs)
            write_carry(ag, commit_batch(ag, slots, a_nbr, a_sc, ang_norms, valid=valid,
                                         **commit))
            g_nbr, g_sc = _find_ip_neighbors_seeded(ig, pay, a_nbr[:, :index.k_angular],
                                                    valid=valid, **ip_knobs)
            write_carry(ig, commit_batch(ig, slots, g_nbr, g_sc, norms, valid=valid, **commit))
            stores = ((index.ip_store, pay), (index.ang_store, new_ang))
        else:
            g = index.graph
            g.items[slots] = pay
            norms[slots] = torch.linalg.vector_norm(pay, dim=-1)
            live.index_fill_(0, slots, False)
            nbr, sc = find_neighbors(g, pay, valid=valid, **ip_knobs)
            write_carry(g, commit_batch(g, slots, nbr, sc, norms, valid=valid, **commit))
            stores = ((index.store, pay),)
        for store, rows in stores:
            if store is not None:
                write_store_rows(store, slots, rows)
        live.index_fill_(0, slots, True)

    return step


def _drop_self(nbr: torch.Tensor, sc: torch.Tensor, slots: torch.Tensor,
               valid: torch.Tensor):
    """A relinked node stays live during its own find, so it can come back
    as its own neighbor: masked to -1 before the commit (I3), with the pad
    rows, as the JAX package's ``_relink_arrays`` masks them."""
    cut = (nbr == slots[:, None]) | ~valid[:, None]
    return torch.where(cut, -1, nbr), torch.where(cut, NEG_INF, sc)


class MutableIndex:
    """A built ``IpNSW`` / ``IpNSWPlus`` opened for streaming mutation.

    Construction pads the graphs to ``capacity`` rows (never-used tail: adj
    -1, items 0, live False); every mutation then writes those tensors in
    place, in fixed-shape chunks of ``mutation_batch`` rows.  On the card
    the first upsert chunk runs eagerly and is captured as a CUDA graph,
    which every later chunk replays (captured anew if an operand was
    replaced since, as ``search(storage="int8")`` does for an index built
    without its int8 store).

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
        self._live_host = np.arange(self.capacity) < size0
        self._next_fresh = size0
        self._free: deque = deque()   # tombstones, FIFO by deletion time
        self.mutation_count = 0
        # the captured upsert chunk: (capture.Captured, its static buffers,
        # the addresses of the operands it was captured over)
        self._upsert_graph: Optional[tuple] = None
        self.upsert_capture_ms: Optional[float] = None  # the latest capture's host ms

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

    def operands(self) -> tuple:
        """The addresses of every tensor a mutation writes: the graphs, the
        int8 stores, the live mask and the norms (0 for a store not made)."""
        idx = self.index
        if self.plus:
            parts = (idx.ang_graph, idx.ip_graph, idx.ang_store, idx.ip_store)
        else:
            parts = (idx.graph, idx.store)
        return data_ptrs(*parts, self.live, self.norms)

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

    def _chunks(self, ids: np.ndarray, payload=None):
        """``(slots [mb] int64, payload [mb, d] | None, valid [mb] bool)`` per
        chunk of ``mutation_batch`` ids, on the index's device, padded to
        ``mb`` rows as the JAX package pads them, except that a pad row
        repeats the last valid row, its slot and payload: PyTorch has no
        scatter that drops a row (JAX's ``mode="drop"``), and a repeated row
        with equal values writes nothing new.  All chunks go to the device
        at once, by asynchronous copies (``capture.to_device``)."""
        mb, n = self.mutation_batch, len(ids)
        flat = np.arange(-(-n // mb) * mb)
        take = np.minimum(flat, n - 1).reshape(-1, mb)  # payload row of each chunk row
        slots = to_device(np.asarray(ids, np.int64)[take], self.device)
        valid = to_device((flat < n).reshape(-1, mb), self.device)
        if payload is None:
            pay = [None] * len(take)
        elif isinstance(payload, torch.Tensor):
            pay = payload.to(self.device)[to_device(take, self.device)]
        else:
            pay = to_device(payload[take], self.device)
        for c in range(len(take)):
            yield slots[c], pay[c], valid[c]

    def _upsert_chunk(self, slots: torch.Tensor, pay: torch.Tensor,
                      valid: torch.Tensor) -> None:
        """One upsert chunk: eager on the CPU; on the card a replay of the
        captured step, captured at the first chunk (whose eager warm-up
        upserts it) or when an operand moved.  The replay and its copies
        run under ``capture.no_sync()``."""
        if self.device.type != "cuda":
            upsert_step(self.index, self.norms, self.live)(slots, pay, valid)
            return
        key = self.operands()
        if self._upsert_graph is None or self._upsert_graph[2] != key:
            bufs = (slots.clone(), pay.clone(), valid.clone())
            cap = capture(upsert_step(self.index, self.norms, self.live), *bufs)
            self._upsert_graph = (cap, bufs, key)
            self.upsert_capture_ms = cap.capture_ms
            return
        cap, bufs, _ = self._upsert_graph
        with no_sync():
            for buf, x in zip(bufs, (slots, pay, valid)):
                buf.copy_(x)
            cap.graph.replay()

    # -- mutations ---------------------------------------------------------

    def upsert(self, new_items) -> np.ndarray:
        """Insert (or replace, via slot reuse) a batch of items; returns the
        slot ids assigned, in payload order."""
        d = self.graph.items.shape[1]
        if isinstance(new_items, torch.Tensor):
            new_items = new_items.float()
        else:
            new_items = np.asarray(new_items, np.float32)
        if new_items.ndim != 2 or new_items.shape[1] != d:
            raise ValueError(
                f"upsert payload must be [b, {d}], got {tuple(new_items.shape)}"
            )
        slots = self._allocate(new_items.shape[0])
        for chunk in self._chunks(slots, new_items):
            self._upsert_chunk(*chunk)
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
        for slots, _, _ in self._chunks(ids):
            self.live.index_fill_(0, slots, False)
            # The entry re-seats to the max-norm live node (the criterion the
            # build keeps), by one masked argmax taking the first maximum (a
            # 1-element index: a 0-dim one would be read back).
            masked = torch.where(self.live, self.norms, NEG_INF)
            best = torch.argmax(masked, dim=0, keepdim=True)
            moved = ~self.live[self.graph.entry.view(1)]
            reseat = [(self.graph, masked.gather(0, best))]
            if self.plus:
                # The angular entry only needs to be a live vertex: it takes
                # the ip re-seat (every angular norm is 1.0) when that moved.
                reseat.append((self.index.ang_graph, 1.0))
            for g, norm in reseat:
                g.entry.copy_(torch.where(moved, best, g.entry).squeeze(0))
                g.entry_norm.copy_(torch.where(moved, norm, g.entry_norm).squeeze(0))
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

    def _relink_candidates(self) -> np.ndarray:
        """Live used rows ordered worst-first by dead-out-edge fraction
        (float64, ties by id), cut at ``relink_threshold``; read back to the
        host, as the JAX package's list is a numpy array."""
        adj = self.graph.adj[: self.size]
        live = self.live
        edge = (adj >= 0) & live[: adj.shape[0], None]
        n_edges = edge.sum(dim=1)
        dead = (edge & ~live[adj.clamp_min(0).long()]).sum(dim=1)
        frac = torch.where(n_edges > 0,
                           dead.double() / n_edges.clamp_min(1).double(), 0.0)
        cand = torch.nonzero(frac >= self.relink_threshold).flatten()
        return cand[torch.sort(-frac[cand], stable=True).indices].cpu().numpy()

    def relink_debt(self) -> int:
        """Nodes currently above the repair threshold."""
        return len(self._relink_candidates())

    def relink(self, budget: int) -> int:
        """Repair up to ``budget`` of the worst rotted live nodes; returns
        how many were relinked.  Call repeatedly (or with a large budget)
        until ``relink_debt() == 0`` for a full repair."""
        todo = self._relink_candidates()[: max(int(budget), 0)]
        if todo.size == 0:
            return 0
        idx = self.index
        ip_knobs, ang_knobs = _walk_knobs(idx, self.live)
        commit = dict(reverse_links=idx.reverse_links)
        for slots, _, valid in self._chunks(todo):
            if self.plus:
                ag, g = idx.ang_graph, idx.ip_graph
                a_nbr, a_sc = find_neighbors(ag, ag.items[slots], valid=valid, **ang_knobs)
                write_carry(ag, commit_batch(ag, slots, *_drop_self(a_nbr, a_sc, slots, valid),
                                             torch.ones_like(self.norms), valid=valid,
                                             **commit))
                g_nbr, g_sc = _find_ip_neighbors_seeded(
                    g, g.items[slots], a_nbr[:, :idx.k_angular], valid=valid, **ip_knobs)
            else:
                g = idx.graph
                g_nbr, g_sc = find_neighbors(g, g.items[slots], valid=valid, **ip_knobs)
            write_carry(g, commit_batch(g, slots, *_drop_self(g_nbr, g_sc, slots, valid),
                                        self.norms, valid=valid, **commit))
        self.mutation_count += 1
        return int(todo.size)

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
