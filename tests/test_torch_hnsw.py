"""HierarchicalIpNSW, port vs JAX (``core/hnsw.py`` of each).

Sizes: N = 600, D = 16, M = 8, ef_construction 16, insert_batch 64, level
seed 3, whose levels hold 600, 77, 10 and 2 items: the top level is smaller
than M and than an insert batch, built from its bootstrap alone, and the
upper levels' M 4 / ef 8 walks run the descent.  The JAX side runs
``backend="reference"`` and ``commit_backend="reference"``; the port runs on
``device="cpu"``, where every wrapper runs its plain version.

  * ``assign_levels`` bit-identical, the ``max_levels`` cap included;
  * on integer items (every dot product exact) every level's adjacency,
    size, entry and entry_norm, and ``ids`` / ``inv``, equal to JAX's with
    both build drivers; searches (f32, int8) equal to JAX's in ids, score
    bits, evals and steps;
  * on lognormal items I1-I6 on every level and recall within
    ``RECALL_MARGIN`` of JAX's; a JAX hierarchy carried across
    (``convert.hnsw_from_arrays``) searched by the port: ids equal up to
    near-ties, evals equal on the other rows;
  * the edges: a single level (no descent), and the descent's walk (a pool
    of one, ``beam_walk_ref`` at L = 1) equal to JAX's
    ``beam_search(pool_size=1)``.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import HierarchicalIpNSW as JaxHNSW
from repro.core import exact_topk as jax_exact_topk
from repro.core import recall_at_k
from repro.core.hnsw import assign_levels as jax_assign_levels
from repro.core.search import beam_search as jax_beam_search
from repro.core.storage import ItemStore as JaxItemStore
from repro.data import mips_dataset, mips_queries

from repro_torch.convert import graph_from_arrays, hnsw_from_arrays
from repro_torch.core import HierarchicalIpNSW
from repro_torch.core.hnsw import assign_levels
from repro_torch.core.invariants import check_graph_invariants
from repro_torch.core.search import beam_search
from repro_torch.core.storage import ItemStore
from repro_torch.testing import RECALL_MARGIN, near_tie_rows
from test_torch_build import one_torch_thread  # noqa: F401 -- an autouse fixture

N, D, K, EF = 600, 16, 10, 16
PARAMS = dict(max_degree=8, ef_construction=16, insert_batch=64, seed=3)
JAX_BACKENDS = dict(backend="reference", commit_backend="reference")
LEVEL_SIZES = [600, 77, 10, 2]


def _integer_items(n, seed, d=D):
    rng = np.random.default_rng(seed)
    v = rng.choice([-1.0, 1.0], size=(n, d))
    s = rng.choice([1.0, 2.0, 4.0], size=(n, 1))
    return (v * s).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _items(profile):
    if profile == "integer":
        return _integer_items(N, 4)
    return mips_dataset(N, D, "lognormal", seed=5)


@functools.lru_cache(maxsize=None)
def _queries(profile):
    if profile == "integer":
        return np.random.default_rng(9).integers(-3, 4, (24, D)).astype(np.float32)
    return mips_queries(24, D, seed=6)


@functools.lru_cache(maxsize=None)
def _jax_index(profile):
    return JaxHNSW(storage="int8", **PARAMS, **JAX_BACKENDS).build(jnp.asarray(_items(profile)))


@functools.lru_cache(maxsize=None)
def _port_index(profile, driver="host"):
    return HierarchicalIpNSW(build_backend=driver, device="cpu", **PARAMS).build(_items(profile))


@functools.lru_cache(maxsize=None)
def _jax_search(profile, storage):
    r = _jax_index(profile).search(jnp.asarray(_queries(profile)), k=K, ef=EF, storage=storage)
    return {f: np.asarray(getattr(r, f)) for f in ("ids", "scores", "evals", "steps")}


def _arrays(g):
    return dict(adj=np.asarray(g.adj), items=np.asarray(g.items), size=int(g.size),
                entry=int(g.entry), entry_norm=float(g.entry_norm))


@pytest.mark.parametrize("n,m,seed,max_levels", [(600, 8, 3, 6), (136_736, 16, 0, 6),
                                                 (200_000, 2, 0, 6), (5_000, 2, 1, 3)])
def test_assign_levels_bit_identical_to_jax(n, m, seed, max_levels):
    lv = assign_levels(n, m, seed, max_levels=max_levels)
    assert lv.dtype == np.int32
    assert np.array_equal(lv, jax_assign_levels(n, m, seed, max_levels=max_levels))
    if m == 2:
        assert lv.max() == max_levels - 1  # the cap holds every level above it


@pytest.mark.parametrize("driver", ["host", "scan"])
def test_integer_hierarchy_equals_jax(driver):
    j, t = _jax_index("integer"), _port_index("integer", driver)
    assert [int(g.size) for g in t.levels] == LEVEL_SIZES
    assert len(t.levels) == len(j.levels)
    for level, (jg, tg) in enumerate(zip(j.levels, t.levels)):
        assert np.array_equal(tg.adj.numpy(), np.asarray(jg.adj)), level
        assert np.array_equal(tg.items.numpy(), np.asarray(jg.items)), level
        assert (int(tg.size), int(tg.entry)) == (int(jg.size), int(jg.entry)), level
        assert float(tg.entry_norm) == float(jg.entry_norm), level
        assert tg.adj.shape[1] == (8 if level == 0 else 4)
        assert t.ids[level].dtype == t.inv[level].dtype == torch.int32
        assert np.array_equal(t.ids[level].numpy(), j.ids[level])
        assert np.array_equal(t.inv[level].numpy(), j.inv[level])
    if driver == "scan":
        h = _port_index("integer", "host")
        for hg, sg in zip(h.levels, t.levels):
            for fld in ("adj", "size", "entry", "entry_norm"):
                assert torch.equal(getattr(hg, fld), getattr(sg, fld)), fld


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_integer_search_equals_jax(storage):
    t = _port_index("integer").search(_queries("integer"), k=K, ef=EF, storage=storage)
    j = _jax_search("integer", storage)
    assert np.array_equal(t.ids.numpy(), j["ids"])
    assert np.array_equal(t.scores.numpy().view(np.int32), j["scores"].view(np.int32))
    assert np.array_equal(t.evals.numpy(), j["evals"])
    assert t.steps == int(j["steps"]) > 0


def test_lognormal_levels_hold_invariants_and_jax_recall():
    t, j = _port_index("lognormal"), _jax_index("lognormal")
    for level, g in enumerate(t.levels):
        live = torch.ones(g.capacity, dtype=torch.bool)
        assert check_graph_invariants(g, live, max_dead_edge_frac=0.0) == [], level
    q = _queries("lognormal")
    _, gt = jax_exact_topk(jnp.asarray(q), jnp.asarray(_items("lognormal")), k=K)
    gt = np.asarray(gt)
    rec_t = recall_at_k(t.search(q, k=K, ef=EF).ids.numpy(), gt)
    rec_j = recall_at_k(_jax_search("lognormal", "f32")["ids"], gt)
    assert rec_t > 0.6 and abs(rec_t - rec_j) <= RECALL_MARGIN, (rec_t, rec_j)


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_carried_jax_hierarchy_searched_by_port(storage):
    j = _jax_index("lognormal")
    t = hnsw_from_arrays([_arrays(g) for g in j.levels], j.ids, j.inv,
                         stores=[(np.asarray(s.codes), np.asarray(s.scales)) for s in j.stores],
                         device="cpu", **PARAMS)
    assert [int(g.size) for g in t.levels] == [int(g.size) for g in j.levels]
    for level, s in enumerate(j.stores):
        assert np.array_equal(t.stores[level].codes.numpy(), np.asarray(s.codes))
    r = t.search(_queries("lognormal"), k=K, ef=EF, storage=storage)
    jr = _jax_search("lognormal", storage)
    tied = near_tie_rows(r.ids.numpy(), jr["ids"], r.scores.numpy(), jr["scores"])
    rest = np.setdiff1d(np.arange(r.ids.shape[0]), tied)
    assert np.array_equal(r.evals.numpy()[rest], jr["evals"][rest])
    assert len(rest) > 0


def test_single_level_has_no_descent():
    """20 items at M 16 (level seed 1): one item above level 0, so the
    hierarchy is level 0 alone and the search is its walk from the entry."""
    x, q = _integer_items(20, 8), _queries("integer")
    kw = dict(max_degree=16, ef_construction=16, insert_batch=64, seed=1)
    j = JaxHNSW(**kw, **JAX_BACKENDS).build(jnp.asarray(x))
    t = HierarchicalIpNSW(device="cpu", **kw).build(x)
    assert len(t.levels) == len(j.levels) == 1 and int(t.levels[0].size) == 20
    assert np.array_equal(t.levels[0].adj.numpy(), np.asarray(j.levels[0].adj))
    r, jr = t.search(q, k=5, ef=8), j.search(jnp.asarray(q), k=5, ef=8)
    assert np.array_equal(r.ids.numpy(), np.asarray(jr.ids))
    assert np.array_equal(r.evals.numpy(), np.asarray(jr.evals))
    g = t.levels[0]
    alone = beam_search(g, torch.from_numpy(q), g.entry.expand(q.shape[0], 1).to(torch.int32),
                        pool_size=8, max_steps=16, k=5)
    assert torch.equal(r.evals, alone.evals) and r.steps == alone.steps


@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("level", [1, 3])
def test_descent_walk_matches_jax_pool_of_one(level, storage):
    """One descent walk (pool 1, k 1, 4 M steps) on an upper level of the
    integer hierarchy, from its entry: ``beam_walk_ref`` at L = 1 against
    JAX's ``beam_search(pool_size=1)``.  Level 3 holds 2 items."""
    jg = _jax_index("integer").levels[level]
    st = _jax_index("integer").stores[level]
    q = _queries("integer")
    b = q.shape[0]
    kw = dict(pool_size=1, max_steps=4 * PARAMS["max_degree"], k=1, storage=storage)
    init = np.full((b, 1), int(jg.entry), np.int32)
    j = jax_beam_search(jg, jnp.asarray(q), jnp.asarray(init), backend="reference",
                        store=JaxItemStore(st.codes, st.scales) if storage == "int8" else None,
                        **kw)
    g = graph_from_arrays(**_arrays(jg), device="cpu")
    t = beam_search(g, torch.from_numpy(q), torch.from_numpy(init),
                    store=ItemStore(torch.tensor(np.asarray(st.codes)),
                                    torch.tensor(np.asarray(st.scales)))
                    if storage == "int8" else None, **kw)
    for field in ("ids", "scores", "evals", "visited"):
        assert np.array_equal(getattr(t, field).numpy(), np.asarray(getattr(j, field))), field
    assert t.steps == int(j.steps) > 0
    assert t.visited.shape[1] == 1 + kw["max_steps"] * jg.adj.shape[1]
