"""The mutation slice, port vs JAX: the tombstone count of the walk step,
the live-masked walk, the I1-I6 checker, ``MutableIndex`` (slot discipline,
upsert / delete / hub kill / relink) and ``ChurnTrace``.

Sizes follow ``tests/test_mutation.py``: N = 300, d = 16, M = 8,
``mutation_batch = 16``.  The JAX side runs ``backend="reference"`` and
``commit_backend="reference"``; the port runs on ``device="cpu"``, where
every wrapper runs its plain version.

"Integer" items are ``s * v`` with ``v`` in {-1, +1}^16 and ``s`` in
{1, 2, 4}: every inner product is an integer and every norm (4, 8 or 16) a
power of two, so the normalized angular copies and their products are exact
too.  On them every walk, commit and entry choice is exact in both packages,
and the mutable state must be bit-identical after every event, ties
included.  On float data the packages are held to recall.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import ChurnEvent as JaxChurnEvent
from repro.core import ChurnTrace as JaxChurnTrace
from repro.core import IpNSW as JaxIpNSW
from repro.core import IpNSWPlus as JaxIpNSWPlus
from repro.core import MutableIndex as JaxMutableIndex
from repro.core import apply_churn_event as jax_apply_churn_event
from repro.core.graph import GraphIndex as JaxGraphIndex
from repro.core.invariants import check_graph_invariants as jax_check_graph_invariants
from repro.core.invariants import dead_edge_fraction as jax_dead_edge_fraction
from repro.core.search import beam_search as jax_beam_search
from repro.data import mips_dataset, mips_queries
from repro.kernels.beam_step.ref import beam_step_ref as jax_beam_step_ref

from repro_torch.convert import (
    graph_from_arrays,
    ipnsw_from_arrays,
    ipnsw_plus_from_arrays,
    mutable_from_arrays,
)
from repro_torch.core import (
    ChurnEvent,
    ChurnTrace,
    IpNSW,
    IpNSWPlus,
    MutableIndex,
    apply_churn_event,
    check_graph_invariants,
    dead_edge_fraction,
)
from repro_torch.core.search import beam_search
from repro_torch.kernels.beam_step import beam_step, beam_step_ref, beam_walk
from repro_torch.testing import RECALL_MARGIN, near_tie_rows
from test_torch_build import one_torch_thread  # noqa: F401 -- an autouse fixture

N, D, K = 300, 16, 10
PARAMS = dict(max_degree=8, ef_construction=32, insert_batch=100)
KINDS = {"ipnsw": (JaxIpNSW, IpNSW), "ipnsw_plus": (JaxIpNSWPlus, IpNSWPlus)}
JAX_BACKENDS = dict(backend="reference", commit_backend="reference")


def _integer_items(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.choice([-1.0, 1.0], size=(n, D))
    s = rng.choice([1.0, 2.0, 4.0], size=(n, 1))
    return (v * s).astype(np.float32)


def _float_items(n, seed, profile="gaussian"):
    return mips_dataset(n, D, profile, seed=seed).astype(np.float32)


def _graph_arrays(g):
    return dict(adj=np.asarray(g.adj), items=np.asarray(g.items), size=int(g.size),
                entry=int(g.entry), entry_norm=float(g.entry_norm))


def _store(s):
    return None if s is None else (np.asarray(s.codes), np.asarray(s.scales))


def _jax_mutable(kind, items, *, capacity=N + 128, storage="f32", **kw):
    idx = KINDS[kind][0](storage=storage, **PARAMS, **JAX_BACKENDS).build(jnp.asarray(items))
    return JaxMutableIndex(idx, capacity=capacity, mutation_batch=16, **kw)


def _carry(jm):
    """The port's MutableIndex with a JAX MutableIndex's whole state."""
    idx = jm.index
    if jm.plus:
        t_idx = ipnsw_plus_from_arrays(
            _graph_arrays(idx.ang_graph), _graph_arrays(idx.ip_graph),
            ang_store=_store(idx.ang_store), ip_store=_store(idx.ip_store),
            device="cpu", storage=idx.storage, **PARAMS)
    else:
        t_idx = ipnsw_from_arrays(**_graph_arrays(idx.graph), store=_store(idx.store),
                                  device="cpu", storage=idx.storage, **PARAMS)
    return mutable_from_arrays(
        t_idx, norms=np.asarray(jm.norms), live=np.asarray(jm.live), free=list(jm._free),
        next_fresh=jm._next_fresh, mutation_count=jm.mutation_count,
        mutation_batch=jm.mutation_batch, relink_threshold=jm.relink_threshold)


def _assert_same_state(jm, tm, where=""):
    """Bit-identical mutable state: both graphs, live, norms, the slot pool,
    and the int8 stores."""
    j_idx, t_idx = jm.index, tm.index
    pairs = ([("ang", j_idx.ang_graph, t_idx.ang_graph), ("ip", j_idx.ip_graph, t_idx.ip_graph)]
             if jm.plus else [("graph", j_idx.graph, t_idx.graph)])
    for name, jg, tg in pairs:
        tag = f"{where} {name}"
        assert np.array_equal(tg.adj.numpy(), np.asarray(jg.adj)), f"{tag}: adj"
        assert np.array_equal(tg.items.numpy(), np.asarray(jg.items)), f"{tag}: items"
        assert int(tg.size) == int(jg.size), f"{tag}: size"
        assert int(tg.entry) == int(jg.entry), f"{tag}: entry"
        assert float(tg.entry_norm) == float(jg.entry_norm), f"{tag}: entry_norm"
    assert np.array_equal(tm.live.numpy(), np.asarray(jm.live)), f"{where}: live"
    assert np.array_equal(tm._live_host, jm._live_host), f"{where}: live mirror"
    assert np.array_equal(tm.norms.numpy(), np.asarray(jm.norms)), f"{where}: norms"
    assert list(tm._free) == list(jm._free), f"{where}: free deque"
    assert tm._next_fresh == jm._next_fresh and tm.mutation_count == jm.mutation_count
    stores = (["ang_store", "ip_store"] if jm.plus else ["store"])
    for name in stores:
        js, ts = getattr(j_idx, name), getattr(t_idx, name)
        assert (js is None) == (ts is None), f"{where} {name}"
        if js is not None:
            assert np.array_equal(ts.codes.numpy(), np.asarray(js.codes)), f"{where} {name}"
            assert np.array_equal(ts.scales.numpy(), np.asarray(js.scales)), f"{where} {name}"


def _exact_live_topk(queries, items, live, k=K):
    s = np.asarray(queries) @ np.asarray(items).T
    s = np.where(np.asarray(live, bool)[None, : items.shape[0]], s, -np.inf)
    return np.argsort(-s, axis=1, kind="stable")[:, :k]


def _recall(ids, gt):
    ids = np.asarray(ids)
    return sum(len(set(ids[i][ids[i] >= 0]) & set(gt[i])) for i in range(len(gt))) / gt.size


# ------------------------------------------------------------------ the step


def test_beam_step_ref_n_dead_matches_jax_and_is_none_without_live():
    rng = np.random.default_rng(0)
    b, l, m, n, v = 12, 10, 8, 200, 40
    items = _float_items(n, 1)
    queries = _float_items(b, 2)
    adj = rng.integers(-1, n, (n, m)).astype(np.int32)
    ids = rng.integers(0, n, (b, l)).astype(np.int32)
    scores = np.einsum("bd,bld->bl", queries, items[ids]).astype(np.float32)
    order = np.argsort(-scores, axis=1, kind="stable")
    ids, scores = np.take_along_axis(ids, order, 1), np.take_along_axis(scores, order, 1)
    checked = rng.random((b, l)) < 0.3
    visited = np.concatenate([ids, np.full((b, v - l), -1, np.int32)], axis=1)
    done = np.zeros(b, bool)
    live = rng.random(n) < 0.5
    state = (ids, scores, checked, visited, done, queries, adj, items)
    j = jax_beam_step_ref(*map(jnp.asarray, state), live=jnp.asarray(live))
    t = beam_step_ref(*map(torch.from_numpy, state), live=torch.from_numpy(live))
    assert np.array_equal(t.n_dead.numpy(), np.asarray(j.n_dead))
    assert 0 < int(t.n_dead.sum()) < int(t.n_scored.sum())
    assert beam_step_ref(*map(torch.from_numpy, state)).n_dead is None
    assert jax_beam_step_ref(*map(jnp.asarray, state)).n_dead is None


# ------------------------------------------------------------------ the walk


@functools.lru_cache(maxsize=None)
def _jax_graph(integer):
    items = _integer_items(N, 3) if integer else _float_items(N, 3)
    return JaxIpNSW(**PARAMS, **JAX_BACKENDS).build(jnp.asarray(items)).graph


@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
def test_beam_search_live_on_carried_graph_matches_jax(integer, storage):
    jg = _jax_graph(integer)
    tg = graph_from_arrays(**_graph_arrays(jg), device="cpu")
    rng = np.random.default_rng(4)
    live = rng.random(N) >= 0.3
    queries = _integer_items(24, 5) if integer else _float_items(24, 5)
    init = np.full((24, 1), int(jg.entry), np.int32)
    kw = dict(pool_size=32, max_steps=64, k=K, storage=storage)
    j = jax_beam_search(jg, jnp.asarray(queries), jnp.asarray(init), live=jnp.asarray(live),
                        backend="reference", **kw)
    t = beam_search(tg, torch.from_numpy(queries), torch.from_numpy(init),
                    live=torch.from_numpy(live), **kw)
    j_ids, t_ids = np.asarray(j.ids), t.ids.numpy()
    rows = near_tie_rows(t_ids, j_ids, t.scores.numpy(), np.asarray(j.scores))
    if integer:
        assert rows.size == 0
        assert np.array_equal(t.scores.numpy(), np.asarray(j.scores))
    other = np.setdiff1d(np.arange(24), rows)
    assert np.array_equal(t.dead_evals.numpy()[other], np.asarray(j.dead_evals)[other])
    assert np.array_equal(t.evals.numpy()[other], np.asarray(j.evals)[other])
    assert int(t.dead_evals.sum()) > 0
    dead = np.flatnonzero(~live)
    assert not np.isin(t_ids, dead).any()
    off = beam_search(tg, torch.from_numpy(queries), torch.from_numpy(init), **kw)
    assert off.dead_evals is None
    assert np.isin(off.ids.numpy(), dead).any(), "the mask must have had work to do"


# ------------------------------------------------------------ invariants I1-I6


def _violate(case, adj, size, entry, live):
    if case == "I1":
        adj[3, 0] = adj.shape[0] + 5
    elif case == "I2":
        adj[3, 0] = size + 1
    elif case == "I3":
        adj[3, 0] = 3
    elif case == "I4":
        entry = size + 2
    elif case == "I4_live":
        live[entry] = False
    elif case == "I5":
        live[size + 2] = True
    elif case == "size":
        size = adj.shape[0] + 1
    return adj, size, entry, live


@pytest.mark.parametrize("case", ["healthy", "I1", "I2", "I3", "I4", "I4_live", "I5", "I6",
                                  "size"])
def test_invariants_report_each_violation_as_jax(case):
    jg = _jax_graph(False)
    cap = N + 20
    adj = np.concatenate([np.asarray(jg.adj), np.full((20, PARAMS["max_degree"]), -1, np.int32)])
    items = np.concatenate([np.asarray(jg.items), np.zeros((20, D), np.float32)])
    live = np.arange(cap) < N
    live[np.random.default_rng(6).choice(N, 40, replace=False)] = False
    live[int(jg.entry)] = True
    adj, size, entry, live = _violate(case, adj, N, int(jg.entry), live)
    frac = 0.0 if case == "I6" else 1.0
    j_graph = JaxGraphIndex(adj=jnp.asarray(adj), items=jnp.asarray(items),
                            size=jnp.asarray(size, jnp.int32),
                            entry=jnp.asarray(entry, jnp.int32),
                            entry_norm=jnp.asarray(1.0, jnp.float32))
    t_graph = graph_from_arrays(adj, items, size, entry, 1.0, device="cpu")
    if case == "I1":
        live = None  # an id past the capacity cannot index the mask (in JAX either)
    want = jax_check_graph_invariants(j_graph, live, max_dead_edge_frac=frac, name="g")
    got = check_graph_invariants(t_graph, None if live is None else torch.from_numpy(live),
                                 max_dead_edge_frac=frac, name="g")
    assert got == want
    assert (got == []) == (case == "healthy")
    assert check_graph_invariants(t_graph, live, max_dead_edge_frac=frac, name="g") == want
    if live is None:
        return
    s = min(size, cap)
    assert dead_edge_fraction(t_graph.adj, torch.from_numpy(live), s) == \
        jax_dead_edge_fraction(adj, live, s)


# ------------------------------------------------------------- slot discipline


def _pair(kind, integer=False, storage="f32", capacity=N + 128, **kw):
    """Fresh JAX and port MutableIndexes over one JAX build."""
    items = _integer_items(N, 7) if integer else _float_items(N, 7)
    jm = _jax_mutable(kind, items, storage=storage, capacity=capacity, **kw)
    return jm, _carry(jm)


@pytest.mark.parametrize("kind", list(KINDS))
def test_fifo_reuse_then_headroom(kind):
    jm, tm = _pair(kind)
    for m in (jm, tm):
        m.delete([5, 9])
        m.delete([200])
    payload = _float_items(4, 8)
    slots = tm.upsert(payload)
    assert list(slots) == [5, 9, 200, N] == list(jm.upsert(payload))
    assert tm._live_host[[5, 9, 200, N]].all() and bool(tm.live[[5, 9, 200, N]].all())
    assert tm.check_invariants() == []


@pytest.mark.parametrize("kind", list(KINDS))
def test_exhaustion_refuses_before_any_state_changes(kind):
    jm, tm = _pair(kind, capacity=N + 16)
    adj0 = tm.graph.adj.clone()
    live0, free0, fresh0 = tm.live.clone(), list(tm._free), tm._next_fresh
    for m in (jm, tm):
        with pytest.raises(RuntimeError, match="free-slot pool exhausted"):
            m.upsert(_float_items(17, 9))
    assert torch.equal(tm.graph.adj, adj0) and torch.equal(tm.live, live0)
    assert list(tm._free) == free0 and tm._next_fresh == fresh0
    assert len(tm.upsert(_float_items(16, 9))) == 16
    with pytest.raises(RuntimeError):
        tm.upsert(_float_items(1, 10))
    assert tm.check_invariants() == []


@pytest.mark.parametrize("kind", list(KINDS))
def test_delete_validation(kind):
    jm, tm = _pair(kind)
    for m in (jm, tm):
        with pytest.raises(ValueError, match="used slots"):
            m.delete([N + 5])
        m.delete([3])
        with pytest.raises(ValueError, match="already tombstoned"):
            m.delete([3])
        with pytest.raises(RuntimeError, match="entire catalog"):
            m.delete(m.live_ids())
    _assert_same_state(jm, tm, "after the refusals")


@pytest.mark.parametrize("kind", list(KINDS))
def test_entry_reseat_when_the_entry_dies(kind):
    jm, tm = _pair(kind)
    entry = int(tm.graph.entry)
    for m in (jm, tm):
        m.delete([entry])
    new = int(tm.graph.entry)
    assert new != entry and tm._live_host[new]
    assert new == int(jm.graph.entry)
    if kind == "ipnsw_plus":
        assert int(tm.index.ang_graph.entry) == new
        assert float(tm.index.ang_graph.entry_norm) == 1.0
    _assert_same_state(jm, tm, "after the re-seat")
    assert tm.check_invariants() == []
    r = tm.search(torch.from_numpy(mips_queries(8, D, seed=4)), k=K, ef=64)
    assert (r.ids.numpy() != entry).all()


# ------------------------------------------ event by event, bit for bit


@pytest.mark.parametrize("kind", list(KINDS))
def test_mutation_sequence_bit_identical_to_jax_on_integer_items(kind):
    """Every kind of event, the state compared after each one.  Payloads of
    20 and 37 rows are not multiples of ``mutation_batch``: both packages
    pad the last chunk, the JAX package with slot 0 and a zero payload, the
    port with its last valid row."""
    jm, tm = _pair(kind, integer=True, storage="int8", relink_threshold=0.1)
    rng = np.random.default_rng(11)
    _assert_same_state(jm, tm, "carried")
    steps = [
        ("delete", rng.choice(N, 40, replace=False)),
        ("upsert", _integer_items(20, 12)),
        ("kill_hubs", 6),
        ("delete", rng.choice(np.setdiff1d(np.arange(N), np.arange(0, N, 7)), 30,
                              replace=False)),
        ("upsert", _integer_items(37, 13)),
        ("relink", 20),
        ("relink", 10_000),
        ("upsert", _integer_items(16, 14)),
    ]
    for i, (op, arg) in enumerate(steps):
        if op == "delete":
            arg = np.intersect1d(arg, tm.live_ids())
        if op == "relink":
            assert tm.relink_debt() == jm.relink_debt() > (20 if arg == 20 else 0)
        j_out, t_out = getattr(jm, op)(arg), getattr(tm, op)(arg)
        assert np.array_equal(np.asarray(t_out), np.asarray(j_out)), op
        _assert_same_state(jm, tm, f"step {i} ({op})")
        assert tm.check_invariants() == jm.check_invariants() == []
    assert tm.relink_debt() == jm.relink_debt()
    assert tm.health() == pytest.approx(jm.health())
    queries = _integer_items(16, 15)
    for storage in ("f32", "int8"):
        t = tm.search(torch.from_numpy(queries), k=K, ef=32, storage=storage)
        j = jm.search(jnp.asarray(queries), k=K, ef=32, storage=storage)
        assert np.array_equal(t.ids.numpy(), np.asarray(j.ids)), storage
        assert not np.isin(t.ids.numpy(), np.flatnonzero(~tm._live_host)).any()


# --------------------------------------------------------------- churn traces


def test_churn_trace_generate_matches_jax():
    kw = dict(n_items=N, dim=D, duration_s=1.0, turnover=0.25, batch=16, seed=5,
              profile="lognormal", hub_kill_at=0.5, hub_kill_k=4, relink_every=1 / 3,
              relink_budget=32)
    t, j = ChurnTrace.generate(**kw), JaxChurnTrace.generate(**kw)
    assert t.n_events == j.n_events > 2 * int(0.25 * N / 16)
    kinds = [e.kind for e in t.events]
    assert kinds.count("hub_kill") == 1 and kinds.count("relink") == 3
    for a, b in zip(t.events, j.events):
        assert (a.t, a.kind, a.count, a.seed) == (b.t, b.kind, b.count, b.seed)
        assert (a.items is None) == (b.items is None)
        if a.items is not None:
            assert a.items.dtype == b.items.dtype and a.items.tobytes() == b.items.tobytes()
    with pytest.raises(ValueError, match="unknown churn event"):
        apply_churn_event(None, ChurnEvent(t=0.0, kind="compact"))


def _trace(profile, seed):
    return dict(n_items=N, dim=D, duration_s=1.0, turnover=0.2, batch=16, seed=seed,
                profile=profile, hub_kill_at=0.5, hub_kill_k=4, relink_every=1 / 3,
                relink_budget=32)


@pytest.mark.parametrize("profile", ["gaussian", "lognormal"])
def test_churn_end_to_end_recall_against_fresh_rebuild_and_jax(profile):
    """Turnover 0.2, one hub kill, three relink passes on float data: the
    port builds its own index.  I1-I6 hold, no tombstone surfaces, and after
    a full relink recall is at least a fresh rebuild's - 0.02 and within
    0.02 of the JAX package's on the same trace."""
    items = _float_items(N, 0, profile)
    queries = mips_queries(128, D, seed=20)
    tm = MutableIndex(IpNSW(device="cpu", **PARAMS).build(items), capacity=N + 128,
                      mutation_batch=16)
    jm = _jax_mutable("ipnsw", items)
    trace = ChurnTrace.generate(**_trace(profile, 1))
    for ev in trace.events:
        apply_churn_event(tm, ev)
        jax_apply_churn_event(jm, ev)
    assert tm.check_invariants() == []
    dead = np.flatnonzero(~tm._live_host[: tm.size])
    assert dead.size >= 4
    for storage in ("f32", "int8"):
        r = tm.search(torch.from_numpy(queries), k=K, ef=64, storage=storage)
        assert not np.isin(r.ids.numpy(), dead).any(), storage
        assert r.dead_evals is not None
    recalls = {}
    for name, m, put in (("port", tm, torch.from_numpy), ("jax", jm, jnp.asarray)):
        while m.relink_debt():
            m.relink(64)
        assert not m.check_invariants(max_dead_edge_frac=0.35)
        items_now = np.asarray(m.graph.items)
        gt = _exact_live_topk(queries, items_now, m._live_host)
        recalls[name] = _recall(np.asarray(m.search(put(queries), k=K, ef=64).ids), gt)
    compact = tm.graph.items.numpy()[tm.live_ids()]
    fresh = IpNSW(device="cpu", **PARAMS).build(compact)
    gt_f = np.argsort(-(queries @ compact.T), axis=1, kind="stable")[:, :K]
    rec_fresh = _recall(fresh.search(torch.from_numpy(queries), k=K, ef=64).ids.numpy(), gt_f)
    assert recalls["port"] >= rec_fresh - 0.02, (recalls, rec_fresh)
    assert abs(recalls["port"] - recalls["jax"]) <= RECALL_MARGIN, recalls


def test_mid_churn_jax_index_carried_across_continues_identically():
    """A JAX ip-NSW+ index halfway through a trace (integer payloads) is
    carried into the port; both packages apply the rest of the trace and
    stay bit-identical after every event."""
    trace = ChurnTrace.generate(**_trace("gaussian", 2))
    events = [e if e.items is None else
              ChurnEvent(t=e.t, kind=e.kind, items=_integer_items(len(e.items), i))
              for i, e in enumerate(trace.events)]
    jm = _jax_mutable("ipnsw_plus", _integer_items(N, 16), storage="int8")
    half = [e.kind for e in events].index("hub_kill") - 1   # carry a few events before it
    assert {e.kind for e in events[:half]} == {"delete", "upsert", "relink"}
    for ev in events[:half]:
        jax_apply_churn_event(jm, JaxChurnEvent(t=ev.t, kind=ev.kind, items=ev.items,
                                                count=ev.count, seed=ev.seed))
    tm = _carry(jm)
    _assert_same_state(jm, tm, "carried mid-churn")
    kinds = set()
    for i, ev in enumerate(events[half:]):
        out_t = apply_churn_event(tm, ev)
        out_j = jax_apply_churn_event(jm, JaxChurnEvent(t=ev.t, kind=ev.kind, items=ev.items,
                                                        count=ev.count, seed=ev.seed))
        assert out_t == out_j
        _assert_same_state(jm, tm, f"event {half + i} ({ev.kind})")
        kinds.add(ev.kind)
    assert kinds == {"delete", "upsert", "hub_kill", "relink"}
    assert tm.check_invariants() == jm.check_invariants() == []


def test_cpu_walks_never_launch_the_live_kernels():
    beam_step.launches_live = beam_step.launches_int8_live = 0
    beam_walk.launches_live = beam_walk.launches_int8_live = 0
    tm = MutableIndex(IpNSW(device="cpu", storage="int8", **PARAMS).build(_float_items(N, 7)),
                      capacity=N + 16, mutation_batch=16)
    tm.delete([1, 2, 3])
    tm.upsert(_float_items(3, 17))
    tm.search(torch.from_numpy(mips_queries(4, D, seed=1)), k=K, ef=16, storage="int8")
    assert beam_step.launches_live == beam_step.launches_int8_live == 0
    assert beam_walk.launches_live == beam_walk.launches_int8_live == 0
