"""NormFilteredIndex and the norm-bias analysis, port vs JAX
(``core/norm_filter.py`` and ``core/norms.py`` of each).

Sizes: N = 600, D = 16, keep_frac 0.25 (150 items kept), M 8,
ef_construction 16, insert_batch 64.  The JAX side runs
``backend="reference"`` and ``commit_backend="reference"``; the port runs on
``device="cpu"``.

  * ``global_ids`` bit-identical to JAX's (the same host computation);
  * on integer items the inner graphs equal JAX's (ip-NSW and ip-NSW+), and
    the mapped ids of a search (f32, and int8 forwarded) too;
  * on lognormal items every id in the kept slice, recall > 0.6 x the
    slice's ground-truth bound (``tests/test_core.py``) and within
    ``RECALL_MARGIN`` of JAX's; a JAX filter carried across
    (``convert.norm_filtered_from_arrays``) searched by the port;
  * the norms functions against JAX's: bit for bit, but
    ``theorem1_probability`` and ``cardinality_win_probability`` within
    ``THEOREM_TOL`` (JAX's ``erf`` is float32, the port's float64).
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import NormFilteredIndex as JaxNormFiltered
from repro.core import exact_topk as jax_exact_topk
from repro.core import norms as jax_norms
from repro.core import recall_at_k
from repro.data import mips_dataset, mips_queries

from repro_torch.convert import norm_filtered_from_arrays
from repro_torch.core import IpNSW, IpNSWPlus, NormFilteredIndex
from repro_torch.core import norms
from repro_torch.core.norm_filter import kept_slice
from repro_torch.testing import RECALL_MARGIN, near_tie_rows
from test_torch_build import one_torch_thread  # noqa: F401 -- an autouse fixture

N, D, K, EF, KEEP = 600, 16, 10, 32, 0.25
PARAMS = dict(keep_frac=KEEP, max_degree=8, ef_construction=16, insert_batch=64)
JAX_BACKENDS = dict(backend="reference", commit_backend="reference")
THEOREM_TOL = 1e-6  # absolute: float32 erf in JAX against float64 here


def _integer_items(n, seed, d=D):
    rng = np.random.default_rng(seed)
    v = rng.choice([-1.0, 1.0], size=(n, d))
    s = rng.choice([1.0, 2.0, 4.0], size=(n, 1))
    return (v * s).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _items(profile):
    if profile == "integer":
        return _integer_items(N, 4)
    return mips_dataset(N, D, "lognormal", seed=5).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _queries(profile):
    if profile == "integer":
        return np.random.default_rng(9).integers(-3, 4, (24, D)).astype(np.float32)
    return mips_queries(24, D, seed=6).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_index(profile, plus):
    return JaxNormFiltered(plus=plus, storage="int8", **PARAMS, **JAX_BACKENDS).build(
        jnp.asarray(_items(profile)))


@functools.lru_cache(maxsize=None)
def _port_index(profile, plus):
    return NormFilteredIndex(plus=plus, device="cpu", **PARAMS).build(_items(profile))


@functools.lru_cache(maxsize=None)
def _jax_search(profile, plus, storage):
    r = _jax_index(profile, plus).search(jnp.asarray(_queries(profile)), k=K, ef=EF,
                                         storage=storage)
    return np.asarray(r.ids), np.asarray(r.scores), np.asarray(r.evals)


@functools.lru_cache(maxsize=None)
def _gt():
    _, gt = jax_exact_topk(jnp.asarray(_queries("lognormal")), jnp.asarray(_items("lognormal")),
                           k=K)
    return np.asarray(gt)


def _arrays(g):
    return dict(adj=np.asarray(g.adj), items=np.asarray(g.items), size=int(g.size),
                entry=int(g.entry), entry_norm=float(g.entry_norm))


def _store(s):
    return None if s is None else (np.asarray(s.codes), np.asarray(s.scales))


@pytest.mark.parametrize("profile", ["integer", "lognormal"])
def test_global_ids_bit_identical_to_jax(profile):
    j, t = _jax_index(profile, True), _port_index(profile, True)
    assert t.global_ids.dtype == torch.int32 and j.global_ids.dtype == np.int32
    assert np.array_equal(t.global_ids.numpy(), j.global_ids)
    assert len(t.global_ids) == int(N * KEEP)
    assert np.array_equal(kept_slice(_items(profile), KEEP), j.global_ids)


def test_keep_frac_floor_of_16():
    assert len(kept_slice(_items("lognormal")[:64], 0.01)) == 16


@pytest.mark.parametrize("plus", [True, False], ids=["plus", "ipnsw"])
def test_integer_inner_graphs_and_search_equal_jax(plus):
    j, t = _jax_index("integer", plus), _port_index("integer", plus)
    assert isinstance(t.inner, IpNSWPlus if plus else IpNSW)
    pairs = ([(j.inner.ang_graph, t.inner.ang_graph), (j.inner.ip_graph, t.inner.ip_graph)]
             if plus else [(j.inner.graph, t.inner.graph)])
    for jg, tg in pairs:
        assert np.array_equal(tg.adj.numpy(), np.asarray(jg.adj))
        assert (int(tg.size), int(tg.entry)) == (int(jg.size), int(jg.entry))
    for storage in ("f32", "int8"):
        r = t.search(_queries("integer"), k=K, ef=EF, storage=storage)
        ids, scores, evals = _jax_search("integer", plus, storage)
        assert np.array_equal(r.ids.numpy(), ids), storage
        assert np.array_equal(r.scores.numpy().view(np.int32), scores.view(np.int32)), storage
        assert np.array_equal(r.evals.numpy(), evals), storage


@pytest.mark.parametrize("plus", [True, False], ids=["plus", "ipnsw"])
def test_lognormal_ids_in_slice_and_recall_to_its_bound(plus):
    t = _port_index("lognormal", plus)
    r = t.search(_queries("lognormal"), k=K, ef=EF)
    ids = r.ids.numpy()
    assert set(ids[ids >= 0].tolist()) <= set(t.global_ids.tolist())
    gt = _gt()
    rec = recall_at_k(ids, gt)
    bound = norms.top_group_share(gt, np.linalg.norm(_items("lognormal"), axis=1), 100 * KEEP)
    assert rec > 0.6 * bound, (rec, bound)
    rec_j = recall_at_k(_jax_search("lognormal", plus, "f32")[0], gt)
    assert abs(rec - rec_j) <= RECALL_MARGIN, (rec, rec_j)
    # a returned score is the inner product of the mapped global row
    b, c = 0, int(np.argmax(ids[0] >= 0))
    np.testing.assert_allclose(r.scores.numpy()[b, c],
                               _queries("lognormal")[b] @ _items("lognormal")[ids[b, c]],
                               rtol=1e-5)


def test_int8_storage_and_drivers_forwarded():
    t = NormFilteredIndex(plus=False, storage="int8", build_backend="scan", device="cpu",
                          **PARAMS).build(_items("lognormal"))
    assert t.inner.storage == "int8" and t.inner.build_backend == "scan"
    assert t.inner.store is not None and t.inner.store.codes.dtype == torch.int8
    assert torch.equal(t.inner.graph.adj, _port_index("lognormal", False).inner.graph.adj)
    ids = t.search(_queries("lognormal"), k=K, ef=EF).ids.numpy()
    assert set(ids[ids >= 0].tolist()) <= set(t.global_ids.tolist())
    rec32 = recall_at_k(_port_index("lognormal", False).search(_queries("lognormal"), k=K,
                                                               ef=EF).ids.numpy(), _gt())
    assert recall_at_k(ids, _gt()) >= rec32 - 0.01


@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("plus", [True, False], ids=["plus", "ipnsw"])
def test_carried_jax_filter_searched_by_port(plus, storage):
    j = _jax_index("lognormal", plus)
    inner = j.inner
    if plus:
        t = norm_filtered_from_arrays(j.global_ids, _arrays(inner.ip_graph),
                                      _arrays(inner.ang_graph), ip_store=_store(inner.ip_store),
                                      ang_store=_store(inner.ang_store), device="cpu", **PARAMS)
    else:
        t = norm_filtered_from_arrays(j.global_ids, _arrays(inner.graph),
                                      ip_store=_store(inner.store), device="cpu", **PARAMS)
    assert t.plus == plus and isinstance(t.inner, IpNSWPlus if plus else IpNSW)
    assert np.array_equal(t.global_ids.numpy(), j.global_ids)
    r = t.search(_queries("lognormal"), k=K, ef=EF, storage=storage)
    ids, scores, evals = _jax_search("lognormal", plus, storage)
    tied = near_tie_rows(r.ids.numpy(), ids, r.scores.numpy(), scores)
    rest = np.setdiff1d(np.arange(ids.shape[0]), tied)
    assert len(rest) > 0 and np.array_equal(r.evals.numpy()[rest], evals[rest])


# ---------------------------------------------------------------- norms


@pytest.mark.parametrize("n_groups", [4, 20])
def test_norm_groups_and_occupancy_bit_identical(n_groups):
    nrm = np.linalg.norm(_items("lognormal"), axis=1)
    groups = norms.norm_group_of(nrm, n_groups)
    assert groups.dtype == np.int32
    assert np.array_equal(groups, jax_norms.norm_group_of(nrm, n_groups))
    gt = _gt().copy()
    gt[0, :3] = -1  # padding is ignored
    assert np.array_equal(norms.group_occupancy(gt, groups, n_groups),
                          jax_norms.group_occupancy(gt, groups, n_groups))
    pct = 100.0 / n_groups
    assert norms.top_group_share(gt, nrm, pct) == jax_norms.top_group_share(gt, nrm, pct)
    in_deg = np.random.default_rng(0).integers(0, 40, N)
    assert np.array_equal(norms.in_degree_by_group(in_deg, groups, n_groups),
                          jax_norms.in_degree_by_group(in_deg, groups, n_groups))
    assert norms.tailing_factor(nrm) == jax_norms.tailing_factor(nrm)


@pytest.mark.parametrize("alpha", [0.25, 1.0, 2.0, 4.0, 16.0, 100.0])
def test_theorems_match_jax(alpha):
    p = norms.theorem1_probability(alpha)
    assert abs(p - jax_norms.theorem1_probability(alpha)) <= THEOREM_TOL
    if alpha == 1.0:
        assert abs(p - 0.5) <= THEOREM_TOL
    for m in (1, 10, 100):
        assert abs(norms.cardinality_win_probability(alpha, m)
                   - jax_norms.cardinality_win_probability(alpha, m)) <= THEOREM_TOL
    for beta, gamma in ((0.5, 1.0), (1.2, -0.3)):
        assert (norms.theorem2_conditional(beta, gamma, alpha, 2.0)
                == jax_norms.theorem2_conditional(beta, gamma, alpha, 2.0))
