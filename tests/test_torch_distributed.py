"""The sharding slice, port vs JAX (``core/distributed.py`` of each).

Sizes follow ``tests/test_shard_routing.py``: N = 510, D = 16, P = 4 (a
ragged tail: Nloc = 128, count[3] = 126), M = 8, ef 32.  The JAX side runs
``backend="reference"`` and ``commit_backend="reference"``; the port runs on
``device="cpu"``, where every wrapper runs its plain version.

  * ``norm_band_partition``: bands and ``band_max`` bits equal to JAX's;
  * a JAX ``build_sharded`` carried across (``convert.sharded_from_arrays``):
    the port's oracle and fan-out (route none / upper_bound; f32 / int8 /
    tiered; ip-NSW and ip-NSW+) give JAX's oracle's ids except at near-ties,
    its evals and its ``RouteStats`` on the other rows.  Visits may differ
    only on a row where a shard's bound ``max_norm_s * ||q||`` lies within
    1e-6 of a score the row's k-th could take (``||q||`` is summed in
    another order: an ulp there flips a visit, recall-safe either way);
  * JAX's two-phase shard_map driver, run once in one subprocess with 4
    forced host devices, against the port's routed fan-out;
  * the fan-out's rows equal each shard's own walk bit for bit;
  * the port's host and scan shard builds bit-identical, IpNSW's shards
    equal to JAX's on integer items, I1-I6 and recall otherwise;
  * pad ids never surface, the skip rule, its refusals, ``ShardedMutable``
    bit for bit through JAX's churn scenario on integer items, and
    ``serve --shards``.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as jax_core
from repro.core import distributed as jd
from repro.data import mips_dataset, mips_queries

import repro_torch.core as torch_core
from repro_torch.convert import sharded_from_arrays
from repro_torch.core import distributed as td
from repro_torch.core.invariants import check_graph_invariants
from repro_torch.core.ipnsw_plus import _seed_from_angular
from repro_torch.core.search import beam_search
from repro_torch.launch import serve
from repro_torch.testing import RECALL_MARGIN, near_tie_rows
from test_torch_build import one_torch_thread  # noqa: F401 -- an autouse fixture

N, D, P, K, EF = 510, 16, 4, 10, 32
PARAMS = dict(max_degree=8, ef_construction=16, insert_batch=64)
JAX_BACKENDS = dict(backend="reference", commit_backend="reference")
KINDS = {"ipnsw": False, "ipnsw_plus": True}
STORAGES = ("f32", "int8", "tiered")
ROOT = os.path.join(os.path.dirname(__file__), "..")


@functools.lru_cache(maxsize=None)
def _items():
    return mips_dataset(N, D, "lognormal", seed=5)


@functools.lru_cache(maxsize=None)
def _queries():
    return mips_queries(24, D, seed=6)


@functools.lru_cache(maxsize=None)
def _jax_index(kind):
    return jd.build_sharded(jnp.asarray(_items()), P, plus=KINDS[kind], partition="norm_bands",
                            storage="int8", **PARAMS, **JAX_BACKENDS)


def _graph(g):
    return None if g is None else {f: np.asarray(getattr(g, f))
                                   for f in ("adj", "items", "size", "entry", "entry_norm")}


def _store(s):
    return None if s is None else (np.asarray(s.codes), np.asarray(s.scales))


def _carry(j):
    opt = lambda x: None if x is None else np.asarray(x)  # noqa: E731
    return sharded_from_arrays(
        _graph(j.ip), _graph(j.ang), offset=np.asarray(j.offset), count=opt(j.count),
        store=_store(j.store), ang_store=_store(j.ang_store), live=opt(j.live),
        gid=opt(j.gid), max_norm=opt(j.max_norm), device="cpu")


@functools.lru_cache(maxsize=None)
def _carried(kind):
    return _carry(_jax_index(kind))


def _np(out):
    ids, scores, evals, stats = out
    return (np.asarray(ids), np.asarray(scores), np.asarray(evals),
            np.asarray(stats.shards_visited), np.asarray(stats.bound_skips))


@functools.lru_cache(maxsize=None)
def _jax_oracle(kind, storage, route):
    return _np(jd.sharded_search_reference(
        _jax_index(kind), jnp.asarray(_queries()), k=K, ef=EF, plus=KINDS[kind],
        storage=storage, route=route, return_stats=True))


def _boundary_rows(index, kind, queries):
    """Rows where some shard's bound is within 1e-6 of a score the row's
    k-th could be (any shard's result, f32 or int8 walk)."""
    q = torch.as_tensor(queries)
    walk = dict(plus=KINDS[kind], k=K, ef=EF, max_steps=2 * EF, ang_ef=10, k_angular=10)
    every = torch.arange(P)
    vals = torch.cat([td.fanout(index, q, every, storage=st, **walk).scores
                      for st in ("f32", "int8")], dim=-1).permute(1, 0, 2).reshape(len(q), -1)
    bound = (index.max_norm[:, None] * td.query_norms(q)[None, :]).T   # [B, P]
    gap = (bound[:, :, None] - vals[:, None, :]).abs()
    near = torch.isfinite(vals)[:, None, :] & (gap <= 1e-6 * vals.abs()[:, None, :])
    return set(np.flatnonzero(near.flatten(1).any(dim=1).numpy()))


def _assert_matches(got, want, boundary, tag):
    """ids up to near-ties; evals on the other rows; RouteStats except on
    ulp-boundary rows."""
    ids, scores, evals, visited, skips = got
    tied = set(near_tie_rows(ids, want[0], scores, want[1]))
    rows = np.setdiff1d(np.arange(len(ids)), sorted(tied | boundary))
    assert len(rows) >= len(ids) - 2, (tag, tied, boundary)
    assert np.array_equal(evals[rows], want[2][rows]), tag
    for a, b in ((visited, want[3]), (skips, want[4])):
        off = set(np.flatnonzero(a != b))
        assert off <= boundary, (tag, off)


# ----------------------------------------------------------------- partition


@pytest.mark.parametrize("case", ["random", "tied", "round_up", "ragged", "empty_band"])
def test_norm_band_partition_matches_jax(case):
    rng = np.random.default_rng(11)
    n, p = 203, 4
    if case == "random":
        norms = rng.lognormal(size=n).astype(np.float32)
    elif case == "tied":
        norms = rng.choice([1.0, 2.0, 4.0], size=n).astype(np.float32)
    elif case == "round_up":  # float64 norms between two fp32 values
        norms = 1.0 + rng.random(n) * 1e-6 + 1e-9
    elif case == "ragged":
        norms, p = rng.random(10), 3
    else:
        norms, p = rng.random(3), 5
    tb, tm = td.norm_band_partition(norms, p)
    jb, jm = jd.norm_band_partition(norms, p)
    assert len(tb) == len(jb) and all(np.array_equal(a, b) for a, b in zip(tb, jb))
    assert tm.dtype == jm.dtype == np.float32
    assert np.array_equal(tm.view(np.int32), jm.view(np.int32))
    norms64 = np.asarray(norms, np.float64)
    assert all(len(b) == 0 or tm[s] >= norms64[b].max() for s, b in enumerate(tb))
    with pytest.raises(ValueError, match="positive"):
        td.norm_band_partition(norms, 0)


# -------------------------------------------------- carried JAX index, oracle


@pytest.mark.parametrize("route", ["none", "upper_bound"])
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_drivers_on_carried_index_match_jax_oracle(kind, storage, route):
    index, q = _carried(kind), _queries()
    want = _jax_oracle(kind, storage, route)
    boundary = _boundary_rows(index, kind, q)
    common = dict(k=K, ef=EF, plus=KINDS[kind], storage=storage, route=route,
                  return_stats=True)
    oracle = _np(td.sharded_search_reference(index, torch.as_tensor(q), **common))
    _assert_matches(oracle, want, boundary, (kind, storage, route, "oracle"))
    if storage == "tiered" and route == "none":
        return  # the fan-out refuses it (test_refusals)
    fan = _np(td.sharded_search(index, torch.as_tensor(q), **common))
    if route == "none":  # the fan-out's merge is the oracle's, bit for bit
        for a, b in zip(fan, oracle):
            assert np.array_equal(a.view(np.int32) if a.dtype == np.float32 else a,
                                  b.view(np.int32) if b.dtype == np.float32 else b)
    else:  # routed: the exhaustive answer up to near-ties, visits >= the oracle's
        exhaustive = _jax_oracle(kind, "f32" if storage == "tiered" else storage, "none")
        if storage != "tiered":
            near_tie_rows(fan[0], exhaustive[0], fan[1], exhaustive[1])
        near_tie_rows(fan[0], oracle[0], fan[1], oracle[1])
        assert (oracle[3] <= fan[3]).all()
    assert fan[0].max() < N and oracle[0].max() < N


@pytest.fixture(scope="module")
def jax_shard_map(tmp_path_factory):
    """JAX's two-phase shard_map driver on 4 forced host devices, routed,
    every storage and both kinds, in one subprocess: its outputs by key."""
    out = tmp_path_factory.mktemp("shard_map") / "out.npz"
    code = f"""
import functools
import numpy as np, jax, jax.numpy as jnp
from repro.core.distributed import build_sharded, sharded_search
from repro.data import mips_dataset, mips_queries
from repro.launch.mesh import make_mesh_compat
mesh = make_mesh_compat(({P},), ("model",))
items = jnp.asarray(mips_dataset({N}, {D}, "lognormal", seed=5))
q = jnp.asarray(mips_queries(24, {D}, seed=6))
out = {{}}
for kind, plus in (("ipnsw", False), ("ipnsw_plus", True)):
    idx = build_sharded(items, {P}, plus=plus, partition="norm_bands", storage="int8",
                        **{PARAMS!r}, **{JAX_BACKENDS!r})
    for storage in {STORAGES!r}:
        search = jax.jit(functools.partial(
            sharded_search, mesh=mesh, k={K}, ef={EF}, plus=plus, storage=storage,
            route="upper_bound", return_stats=True))
        ids, sc, ev, st = search(idx, q)
        for name, x in zip(("ids", "scores", "evals", "visited", "skips"),
                           (ids, sc, ev, st.shards_visited, st.bound_skips)):
            out[f"{{kind}}/{{storage}}/{{name}}"] = np.asarray(x)
np.savez({str(out)!r}, **out)
"""
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={P}",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return dict(np.load(out))


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_routed_fanout_matches_jax_shard_map(jax_shard_map, kind, storage):
    index, q = _carried(kind), _queries()
    want = tuple(jax_shard_map[f"{kind}/{storage}/{name}"]
                 for name in ("ids", "scores", "evals", "visited", "skips"))
    got = _np(td.sharded_search(index, torch.as_tensor(q), k=K, ef=EF, plus=KINDS[kind],
                                storage=storage, route="upper_bound", return_stats=True))
    _assert_matches(got, want, _boundary_rows(index, kind, q), (kind, storage))


# ---------------------------------------------------------------- the fan-out


@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_fanout_rows_equal_each_shards_own_walk(kind, storage, live):
    """One walk of P * B rows over the flat graph, against P walks of B rows
    on each shard's own graphs: ids, score bits, evals, dead evals; pad rows
    (``valid``) born done."""
    index = _carried(kind)
    if live:
        mask = np.random.default_rng(2).random((P, index.ip.adj.shape[1])) > 0.3
        index = dataclasses.replace(index, live=torch.as_tensor(mask))
    q = torch.as_tensor(_queries())
    b, plus = len(q), KINDS[kind]
    valid = torch.as_tensor(np.random.default_rng(3).random(P * b) > 0.2)
    f = td.fanout(index, q, torch.arange(P), valid=valid, storage=storage, plus=plus, k=K,
                  ef=EF, max_steps=2 * EF, ang_ef=10, k_angular=10)
    int8 = storage == "int8"
    for s in range(P):
        def shard(g):
            return type(g)(*(getattr(g, fld.name)[s] for fld in dataclasses.fields(g)))

        def store(st):
            return type(st)(st.codes[s], st.scales[s]) if int8 else None

        lv = None if index.live is None else index.live[s]
        v = valid[s * b:(s + 1) * b]
        kw = dict(storage=storage, live=lv, valid=v)
        if plus:
            a = beam_search(shard(index.ang), q, index.ang.entry[s].expand(b, 1), pool_size=10,
                            max_steps=20, k=10, store=store(index.ang_store), **kw)
            r = beam_search(shard(index.ip), q, _seed_from_angular(index.ip.adj[s], a.ids),
                            pool_size=EF, max_steps=2 * EF, k=K, store=store(index.store), **kw)
            want = (r.ids, r.scores, a.evals + r.evals,
                    None if lv is None else a.dead_evals + r.dead_evals)
        else:
            r = beam_search(shard(index.ip), q, index.ip.entry[s].expand(b, 1), pool_size=EF,
                            max_steps=2 * EF, k=K, store=store(index.store), **kw)
            want = (r.ids, r.scores, r.evals, r.dead_evals)
        assert torch.equal(f.ids[s], want[0])
        assert torch.equal(f.scores[s].view(torch.int32), want[1].view(torch.int32))
        assert torch.equal(f.evals[s], want[2])
        assert (f.dead_evals is None) == (want[3] is None)
        if live:
            assert torch.equal(f.dead_evals[s], want[3])
        assert (f.evals[s][~v] == 0).all() and (f.ids[s][~v] == -1).all()


def test_flat_adjacency_offsets_every_shard():
    adj = torch.tensor([[[1, -1], [0, 1]], [[-1, 0], [1, 1]]], dtype=torch.int32)
    assert td.flat_adjacency(adj).tolist() == [[1, -1], [0, 1], [-1, 2], [3, 3]]
    index = _carried("ipnsw_plus")
    assert torch.equal(index.flat_adj, td.flat_adjacency(index.ip.adj))
    assert torch.equal(index.flat_ang_adj, td.flat_adjacency(index.ang.adj))


# --------------------------------------------------------------------- builds


@pytest.mark.parametrize("partition", ["roundrobin", "norm_bands"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_scan_shard_build_bit_identical_to_host(kind, partition):
    builds = [td.build_sharded(_items(), P, plus=KINDS[kind], partition=partition,
                               build_backend=driver, device="cpu", **PARAMS)
              for driver in ("host", "scan")]
    for name in ("ip", "ang"):
        a, b = getattr(builds[0], name), getattr(builds[1], name)
        if a is None:
            continue
        for fld in ("adj", "items", "size", "entry", "entry_norm"):
            assert torch.equal(getattr(a, fld), getattr(b, fld)), (name, fld)
    for fld in ("offset", "count", "gid", "max_norm", "flat_adj"):
        x, y = getattr(builds[0], fld), getattr(builds[1], fld)
        assert (x is None and y is None) or torch.equal(x, y), fld
    assert builds[0].count.tolist() == [128, 128, 128, 126]


def _integer_items(n, seed, d=D):
    rng = np.random.default_rng(seed)
    v = rng.choice([-1.0, 1.0], size=(n, d))
    s = rng.choice([1.0, 2.0, 4.0], size=(n, 1))
    return (v * s).astype(np.float32)


@pytest.mark.parametrize("partition", ["roundrobin", "norm_bands"])
def test_ipnsw_shards_on_integer_items_equal_jax(partition):
    items = _integer_items(N, 4)
    j = jd.build_sharded(jnp.asarray(items), P, plus=False, partition=partition,
                         **PARAMS, **JAX_BACKENDS)
    t = td.build_sharded(items, P, plus=False, partition=partition, device="cpu", **PARAMS)
    assert np.array_equal(t.ip.adj.numpy(), np.asarray(j.ip.adj))
    assert np.array_equal(t.ip.entry.numpy(), np.asarray(j.ip.entry))
    assert np.array_equal(t.ip.size.numpy(), np.asarray(j.ip.size))
    assert np.array_equal(t.max_norm.numpy().view(np.int32),
                          np.asarray(j.max_norm).view(np.int32))
    for fld in ("offset", "count", "gid"):
        x, y = getattr(t, fld), getattr(j, fld)
        assert (x is None and y is None) or np.array_equal(x.numpy(), np.asarray(y)), fld


@pytest.mark.parametrize("kind", list(KINDS))
def test_float_shard_builds_hold_invariants_and_jax_recall(kind):
    t = td.build_sharded(_items(), P, plus=KINDS[kind], partition="norm_bands",
                         device="cpu", **PARAMS)
    for name in ("ip", "ang"):
        g = getattr(t, name)
        if g is None:
            continue
        for s in range(P):
            shard = type(g)(*(getattr(g, fld.name)[s] for fld in dataclasses.fields(g)))
            live = np.ones(shard.capacity, bool)  # with the mask: I5-I6 as well
            assert check_graph_invariants(shard, name=f"{name}{s}") == []
            assert check_graph_invariants(shard, live, name=f"{name}{s}") == []
    q = _queries()
    gt = np.argsort(-(q @ _items().T), axis=1, kind="stable")[:, :K]
    recall = lambda ids: np.mean([len(set(a) & set(b)) / K  # noqa: E731
                                  for a, b in zip(np.asarray(ids).tolist(), gt.tolist())])
    mine = recall(td.sharded_search_reference(t, torch.as_tensor(q), k=K, ef=EF,
                                              plus=KINDS[kind])[0])
    assert mine >= recall(_jax_oracle(kind, "f32", "none")[0]) - RECALL_MARGIN


def test_build_sharded_validates_before_any_work():
    for kw, match in ((dict(storage="fp16"), "storage"), (dict(partition="hash"), "partition"),
                      (dict(build_backend="jit"), "build_backend")):
        with pytest.raises(ValueError, match=match):
            td.build_sharded(_items(), P, device="meta", **kw)


# ------------------------------------------------------------- the skip rule


def test_shard_visit_mask_skips_iff_bound_below_kth():
    mn, qn = torch.tensor(2.0), torch.tensor(3.0)
    bound = float(mn * qn)
    assert bool(td.shard_visit_mask(mn, qn, torch.tensor(bound - 1e-3)))
    assert bool(td.shard_visit_mask(mn, qn, torch.tensor(bound)))       # a tie visits
    assert not bool(td.shard_visit_mask(mn, qn, torch.tensor(bound + 1e-3)))
    kth = torch.tensor([0.0, bound, bound + 1.0, -float("inf")])
    assert td.shard_visit_mask(mn, torch.full((4,), 3.0), kth).tolist() == [True, True, False,
                                                                          True]


@pytest.mark.parametrize("driver", ["oracle", "fanout"])
def test_routing_skips_a_provably_unable_shard_only(driver):
    """JAX's crafted two-band catalog: a query aligned with the hot band
    skips the cold band, one orthogonal to it visits; both give the
    exhaustive answer."""
    d = 4
    hot = np.zeros((8, d), np.float32)
    hot[:, 0] = 10.0 + np.arange(8)
    cold = np.zeros((8, d), np.float32)
    cold[:, 1] = 1.0
    idx = td.build_sharded(np.concatenate([hot, cold]), 2, plus=False, partition="norm_bands",
                           device="cpu", max_degree=4, ef_construction=8, insert_batch=8)
    assert idx.max_norm.tolist() == [17.0, 1.0]
    q = torch.zeros((2, d))
    q[0, 0] = 1.0
    q[1, 1] = 1.0
    fn = td.sharded_search_reference if driver == "oracle" else td.sharded_search
    common = dict(k=2, ef=8, plus=False)
    ids_u, sc_u, _ = fn(idx, q, **common)
    ids_r, sc_r, _, st = fn(idx, q, route="upper_bound", return_stats=True, **common)
    assert isinstance(st, td.RouteStats)
    assert st.shards_visited.tolist() == [1, 2] and st.bound_skips.tolist() == [1, 0]
    assert torch.equal(ids_r, ids_u) and torch.equal(sc_r, sc_u)
    assert set(ids_r[1].tolist()) <= set(range(8, 16))


@pytest.mark.parametrize("route", ["none", "upper_bound"])
@pytest.mark.parametrize("driver", ["oracle", "fanout"])
def test_pad_ids_never_surface(driver, route):
    """Every real score negative and N = 101 not divisible by P: the tail
    shard's zero pad rows score 0.0 and would win a merge without the
    count mask."""
    rng = np.random.default_rng(9)
    n = 101
    items = -np.abs(rng.normal(size=(n, 8))).astype(np.float32)
    queries = torch.as_tensor(np.abs(rng.normal(size=(6, 8))).astype(np.float32))
    idx = td.build_sharded(items, P, plus=False, partition="norm_bands", device="cpu",
                           max_degree=8, ef_construction=16, insert_batch=32)
    assert idx.count.tolist() == [26, 26, 26, 23]
    fn = td.sharded_search_reference if driver == "oracle" else td.sharded_search
    ids, scores, _ = fn(idx, queries, k=5, ef=16, plus=False, route=route)
    assert int(ids.max()) < n and bool((ids >= 0).all()) and float(scores.max()) < 0.0


def test_shard_mask_drops_a_dead_shard_at_the_merge():
    index, q = _carried("ipnsw"), torch.as_tensor(_queries())
    mask = torch.tensor([True, False, True, True])
    common = dict(k=K, ef=EF, plus=False, shard_mask=mask, return_stats=True)
    dead = set(index.gid[1].tolist()) - {-1}
    for route in ("none", "upper_bound"):
        outs = [fn(index, q, route=route, **common)
                for fn in (td.sharded_search, td.sharded_search_reference)]
        for ids, _, _, st in outs:
            assert not set(ids.flatten().tolist()) & dead
            assert int(st.shards_visited.max()) <= 3
        want = jd.sharded_search_reference(_jax_index("ipnsw"), jnp.asarray(_queries()), k=K,
                                           ef=EF, plus=False, route=route,
                                           shard_mask=jnp.asarray(mask.numpy()))
        near_tie_rows(outs[1][0].numpy(), np.asarray(want[0]), outs[1][1].numpy(),
                      np.asarray(want[1]))


def test_refusals():
    index, q = _carried("ipnsw"), torch.as_tensor(_queries())
    legacy = dataclasses.replace(index, max_norm=None)
    for fn in (td.sharded_search, td.sharded_search_reference):
        for kw in (dict(route="upper_bound"), dict(route="upper_bound", storage="tiered")):
            with pytest.raises(ValueError, match="max_norm"):
                fn(legacy, q, plus=False, **kw)
        with pytest.raises(ValueError, match="route"):
            fn(index, q, plus=False, route="closest")
        with pytest.raises(ValueError, match="storage"):
            fn(index, q, plus=False, storage="bf16")
    with pytest.raises(ValueError, match="requires route='upper_bound'"):
        td.sharded_search(index, q, plus=False, storage="tiered")
    # an index without int8 stores derives them for the call; the caller's
    # index is not written
    bare = dataclasses.replace(index, store=None, ang_store=None)
    a = td.sharded_search(bare, q, plus=False, storage="int8")
    b = td.sharded_search(index, q, plus=False, storage="int8")
    assert bare.store is None and all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------------------ ShardedMutable


def _churn(mod, items, fresh, queries, **kw):
    """JAX's banded-churn scenario (tests/test_mutation.py): returns the new
    gids, the killed gids and the snapshot's arrays after each stage."""
    sm = mod.ShardedMutable(items, P, plus=False, headroom=64, **PARAMS, **kw)
    stages = []

    def snap():
        s = sm.snapshot(storage="int8")
        # copies: JAX's snapshot may share its host max_norm buffer with the
        # upserts that follow (ROADMAP Queue 3), so a view could change later
        stages.append({name: np.array(x.cpu() if isinstance(x, torch.Tensor) else x, copy=True)
                       for name, x in (("adj", s.ip.adj), ("items", s.ip.items),
                                       ("live", s.live), ("gid", s.gid), ("count", s.count),
                                       ("max_norm", s.max_norm), ("entry", s.ip.entry),
                                       ("codes", s.store.codes))})
        return s

    snap()
    rng = np.random.default_rng(3)
    sm.delete(rng.choice(sm.live_gids(), size=80, replace=False))
    new = sm.upsert(fresh)
    snap()
    killed = sm.kill_hubs(0, k=sm.capacity)
    passes = 0
    while sm.relink_debt():
        sm.relink(64)
        passes += 1
    assert sm.check_invariants() == []
    return sm, np.asarray(new), np.asarray(killed), stages, snap(), passes


def test_sharded_mutable_churn_bit_identical_to_jax():
    items = _integer_items(256, 7)
    fresh = _integer_items(96, 8)
    fresh[:4] *= 10.0  # norm outliers routed to band 0, widening its bound
    queries = _integer_items(16, 9)
    jsm, jnew, jkilled, jstages, jsnap, jpasses = _churn(jd, items, fresh, queries,
                                                         **JAX_BACKENDS)
    tsm, tnew, tkilled, tstages, tsnap, tpasses = _churn(td, items, fresh, queries,
                                                         device="cpu")
    assert np.array_equal(tnew, jnew) and len(set(tnew.tolist())) == 96
    assert np.array_equal(tkilled, jkilled) and len(tkilled) > 0 and tpasses == jpasses
    for i, (t, j) in enumerate(zip(tstages, jstages)):
        for name in t:
            a, b = t[name], j[name]
            if a.dtype == np.float32:
                a, b = a.view(np.int32), b.view(np.int32)
            assert np.array_equal(a, b), (i, name)
    assert tsm.band_lo.tobytes() == jsm.band_lo.tobytes()
    assert np.array_equal(tsm.live_gids(), jsm.live_gids())
    assert np.array_equal(tsm.live_items()[1], jsm.live_items()[1])
    # routed search of the churned snapshot: no tombstoned gid, JAX's answer
    q = torch.as_tensor(queries)
    common = dict(k=K, ef=64, plus=False, route="upper_bound")
    want = jd.sharded_search_reference(jsnap, jnp.asarray(queries), **common)
    live = set(tsm.live_gids().tolist())
    for fn in (td.sharded_search, td.sharded_search_reference):
        ids, scores, _ = fn(tsnap, q, **common)
        assert set(ids.flatten().tolist()) - {-1} <= live
        # exact scores and bounds: the fan-out's answer is the oracle's
        assert np.array_equal(ids.numpy(), np.asarray(want[0]))
        assert np.array_equal(scores.numpy(), np.asarray(want[1]))
    assert np.array_equal(td.sharded_search_reference(tsnap, q, **common)[2].numpy(),
                          np.asarray(want[2]))


def test_sharded_mutable_force_in_edge_writes_in_place():
    sm = td.ShardedMutable(_integer_items(64, 1), 2, plus=False, headroom=8, device="cpu",
                           **PARAMS)
    adj = sm.shards[0].graph.adj
    ptr, before = adj.data_ptr(), adj.clone()
    sm._force_in_edge(0, 5)
    assert sm.shards[0].graph.adj.data_ptr() == ptr
    changed = (adj != before).nonzero().tolist()
    assert len(changed) == 1 and int(adj[changed[0][0], changed[0][1]]) == 5


# ---------------------------------------------------------------------- serve


@pytest.mark.parametrize("flags, match", [
    (["--route", "upper_bound"], "add --shards N"),
    (["--partition", "norm_bands"], "add --shards N"),
    (["--storage", "tiered"], "add --shards N"),
    (["--shards", "4", "--storage", "tiered"], "add --route upper_bound"),
    (["--shards", "4", "--loop"], "on one device"),
    (["--shards", "4", "--trace"], "on one device"),
])
def test_serve_shards_validation(flags, match):
    with pytest.raises(SystemExit, match=match):
        serve.main(["--n-items", "64", "--dim", "8", "--batch", "4", "--device", "cpu", *flags])


def test_serve_shards_print_line(capsys):
    res = serve.main(["--index", "ipnsw", "--n-items", "600", "--dim", "16", "--batch", "16",
                      "--shards", "4", "--partition", "norm_bands", "--route", "upper_bound",
                      "--storage", "tiered", "--device", "cpu"])
    line = capsys.readouterr().out
    assert ("[serve] index=ipnsw shards=4 storage=tiered partition=norm_bands "
            "route=upper_bound shards_visited_mean=") in line and " skipped_mean=" in line
    assert res["recall"] > 0.8 and 1.0 <= res["shards_visited_mean"] <= 4.0
    assert res["shards_visited_mean"] + res["skipped_mean"] == pytest.approx(4.0)


# -------------------------------------------------------------------- exports


def test_core_exports_cover_the_jax_package():
    missing = set(jax_core.__all__) - set(torch_core.__all__)
    assert not missing, missing
    for name in torch_core.__all__:
        assert getattr(torch_core, name) is not None
    sharded = {"ShardedIndex", "RouteStats", "ShardedMutable", "build_sharded",
               "norm_band_partition", "shard_visit_mask", "sharded_search",
               "sharded_search_reference"}
    assert sharded <= set(torch_core.__all__)
    assert all(hasattr(jd, name) for name in sharded)
