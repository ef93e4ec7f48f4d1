"""The slice as a whole, port vs JAX, on ``tests/test_recall.py``'s sets
(N = 1500, D = 24, gaussian and lognormal norms):

  * carried across: a graph the JAX package built, converted with
    ``repro_torch.convert``, searched by the port -- ids identical on every
    row except where a near-tie shows, evals identical on the other rows,
    the same number of walk steps;
  * end to end: the port builds its own IpNSW / IpNSWPlus (whole builds are
    compared by invariants and recall, not adjacency) -- recall@10 above
    ``test_recall.FLOORS`` and within 0.02 of the JAX index on the same
    seed, I1-I4 holding by both packages' checkers.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import IpNSW as JaxIpNSW
from repro.core import IpNSWPlus as JaxIpNSWPlus
from repro.core import check_graph_invariants as jax_check_graph_invariants
from repro.core import exact_topk as jax_exact_topk
from repro.core import in_degrees as jax_in_degrees
from repro.core import out_degrees as jax_out_degrees
from repro.core import recall_curve as jax_recall_curve
from repro.core.graph import GraphIndex as JaxGraphIndex
from repro.data import mips_dataset, mips_queries

from repro_torch.convert import ipnsw_from_arrays, ipnsw_plus_from_arrays
from repro_torch.core.graph import in_degrees, out_degrees
from repro_torch.core.invariants import check_graph_invariants
from repro_torch.core.ipnsw import IpNSW
from repro_torch.core.ipnsw_plus import IpNSWPlus
from repro_torch.obs.recall import recall_at_k, recall_curve
from repro_torch.testing import RECALL_MARGIN, near_tie_rows

N, D, K, EF = 1500, 24, 10, 48
FLOORS = {"gaussian": 0.80, "lognormal": 0.85}  # tests/test_recall.py::FLOORS
PARAMS = dict(max_degree=12, ef_construction=32, insert_batch=256)
KINDS = {"ipnsw": (JaxIpNSW, IpNSW), "ipnsw_plus": (JaxIpNSWPlus, IpNSWPlus)}


@functools.lru_cache(maxsize=None)
def _items(profile):
    return mips_dataset(N, D, profile=profile, seed=7)


@functools.lru_cache(maxsize=None)
def _queries():
    return mips_queries(128, D, seed=123)


@functools.lru_cache(maxsize=None)
def _gt(profile):
    _, ids = jax_exact_topk(jnp.asarray(_queries()), jnp.asarray(_items(profile)), k=K)
    return np.asarray(ids)


@functools.lru_cache(maxsize=None)
def _jax_index(kind, profile):
    return KINDS[kind][0](**PARAMS).build(jnp.asarray(_items(profile)))


def _arrays(g):
    return dict(adj=np.asarray(g.adj), items=np.asarray(g.items), size=int(g.size),
                entry=int(g.entry), entry_norm=float(g.entry_norm))


def _carried(kind, profile):
    jidx = _jax_index(kind, profile)
    if kind == "ipnsw":
        return ipnsw_from_arrays(**_arrays(jidx.graph), device="cpu", **PARAMS)
    return ipnsw_plus_from_arrays(_arrays(jidx.ang_graph), _arrays(jidx.ip_graph),
                                  device="cpu", **PARAMS)


@pytest.mark.parametrize("profile", ["gaussian", "lognormal"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_search_on_carried_graph_matches_jax(kind, profile):
    q = _queries()
    j = _jax_index(kind, profile).search(jnp.asarray(q), k=K, ef=EF)
    t = _carried(kind, profile).search(torch.from_numpy(q), k=K, ef=EF)
    tied = near_tie_rows(t.ids.numpy(), np.asarray(j.ids), t.scores.numpy(), np.asarray(j.scores))
    rows = np.setdiff1d(np.arange(q.shape[0]), tied)
    assert len(rows) >= q.shape[0] - 2
    assert np.array_equal(t.evals.numpy()[rows], np.asarray(j.evals)[rows])
    if kind == "ipnsw":
        assert t.steps == int(j.steps)
        assert np.array_equal(t.visited.numpy()[rows], np.asarray(j.visited)[rows])
    else:
        assert np.array_equal(t.ang_evals.numpy(), np.asarray(j.ang_evals))
        assert np.array_equal(t.visited_ang.numpy(), np.asarray(j.visited_ang))
        assert np.array_equal(t.visited_ip.numpy()[rows], np.asarray(j.visited_ip)[rows])


@pytest.mark.parametrize("profile", ["gaussian", "lognormal"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_end_to_end_build_recall_matches_jax(kind, profile):
    index = KINDS[kind][1](device="cpu", **PARAMS).build(_items(profile))
    q = _queries()
    rec = recall_at_k(index.search(torch.from_numpy(q), k=K, ef=EF).ids.numpy(), _gt(profile))
    jrec = recall_at_k(np.asarray(_jax_index(kind, profile).search(jnp.asarray(q), k=K, ef=EF).ids),
                       _gt(profile))
    assert rec >= FLOORS[profile]
    assert abs(rec - jrec) <= RECALL_MARGIN, (rec, jrec)
    graphs = [index.graph] if kind == "ipnsw" else [index.ang_graph, index.ip_graph]
    for g in graphs:
        assert check_graph_invariants(g) == []
        jg = JaxGraphIndex(adj=g.adj.numpy(), items=g.items.numpy(),
                           size=np.int32(int(g.size)), entry=np.int32(int(g.entry)))
        assert jax_check_graph_invariants(jg) == []
        assert int(g.size) == N


def test_degrees_and_recall_curve_match_jax():
    jidx = _jax_index("ipnsw", "lognormal")
    tidx = _carried("ipnsw", "lognormal")
    assert np.array_equal(in_degrees(tidx.graph), jax_in_degrees(jidx.graph))
    assert np.array_equal(out_degrees(tidx.graph), jax_out_degrees(jidx.graph))
    q, efs = _queries(), (16, EF)
    got = recall_curve([tidx.search(torch.from_numpy(q), k=K, ef=ef) for ef in efs],
                       _gt("lognormal"))
    want = jax_recall_curve([jidx.search(jnp.asarray(q), k=K, ef=ef) for ef in efs],
                            _gt("lognormal"))
    np.testing.assert_allclose(got, want, rtol=0, atol=0.01)
    assert got[1][0] > got[0][0] and got[1][1] >= got[0][1]
