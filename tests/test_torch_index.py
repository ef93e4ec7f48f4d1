"""The slice as a whole, port vs JAX, on ``tests/test_recall.py``'s sets
(N = 1500, D = 24, gaussian and lognormal norms):

  * carried across: a graph the JAX package built, converted with
    ``repro_torch.convert``, searched by the port -- ids identical on every
    row except where a near-tie shows, evals identical on the other rows,
    the same number of walk steps, also where ``max_steps`` cuts the walk or
    ``valid=`` pads rows (born done: no step, no evaluation);
  * end to end: the port builds its own IpNSW / IpNSWPlus (whole builds are
    compared by invariants and recall, not adjacency) -- recall@10 above
    ``test_recall.FLOORS`` and within 0.02 of the JAX index on the same
    seed, I1-I4 holding by both packages' checkers;
  * the scan build driver (``build_backend="scan"``): bit-identical to the
    port's host build (adjacency, size, entry, entry_norm; both graphs of
    IpNSWPlus; with and without reverse links), and held to JAX's scan build
    as the host builds are held to JAX's: on integer items (exact dot
    products) IpNSW's adjacency bit for bit, otherwise I1-I6 and recall
    within ``RECALL_MARGIN``.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import IpNSW as JaxIpNSW
from repro.core import build_graph as jax_build_graph
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
from repro_torch.core.similarity import Similarity
from repro_torch.core.build import build_graph, find_neighbors
from repro_torch.core.ipnsw import IpNSW
from repro_torch.core.ipnsw_plus import IpNSWPlus
from repro_torch.core.search import beam_search
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


@pytest.mark.parametrize("case", ["max_steps_cut", "pad_rows", "all_pad"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_walk_cuts_and_pad_rows_on_carried_graph_match_jax(kind, case):
    q = _queries()
    b = q.shape[0]
    kw = dict(k=K, ef=EF, max_steps=6 if case == "max_steps_cut" else None)
    valid = {"max_steps_cut": None, "pad_rows": np.arange(b) % 4 != 0,
             "all_pad": np.zeros(b, bool)}[case]
    j = _jax_index(kind, "lognormal").search(
        jnp.asarray(q), valid=None if valid is None else jnp.asarray(valid), **kw)
    t = _carried(kind, "lognormal").search(
        torch.from_numpy(q), valid=None if valid is None else torch.from_numpy(valid), **kw)
    tied = near_tie_rows(t.ids.numpy(), np.asarray(j.ids), t.scores.numpy(), np.asarray(j.scores))
    rows = np.setdiff1d(np.arange(b), tied)
    assert len(rows) >= b - 2
    assert np.array_equal(t.evals.numpy()[rows], np.asarray(j.evals)[rows])
    visited = ["visited"] if kind == "ipnsw" else ["visited_ang", "visited_ip"]
    for field in visited:
        assert np.array_equal(getattr(t, field).numpy()[rows], np.asarray(getattr(j, field))[rows])
    if kind == "ipnsw":
        assert t.steps == int(j.steps)
        assert t.steps == {"max_steps_cut": 6, "all_pad": 0}.get(case, t.steps) and (
            case == "all_pad" or t.steps > 0)
    if valid is not None:
        assert (t.evals.numpy()[~valid] == 0).all() and (t.ids.numpy()[~valid] == -1).all()
        assert all((getattr(t, f).numpy()[~valid] == -1).all() for f in visited)


def _graphs(index):
    return [index.graph] if isinstance(index, IpNSW) else [index.ang_graph, index.ip_graph]


def _assert_bit_identical(host, scan):
    for field in ("adj", "size", "entry", "entry_norm"):
        assert torch.equal(getattr(host, field), getattr(scan, field)), field


@pytest.mark.parametrize("case", ["gaussian", "lognormal", "gaussian_directed"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_scan_build_bit_identical_to_host(kind, case):
    """N 1,500 in batches of 256: a ragged tail of 220 rows, padded to 256
    and masked by the scan driver.  ``_directed``: ``reverse_links=False``,
    Algorithm 2 as printed (forward rows only)."""
    profile = case.split("_")[0]
    params = dict(PARAMS, reverse_links=case != "gaussian_directed", device="cpu")
    host = KINDS[kind][1](**params).build(_items(profile))
    scan = KINDS[kind][1](build_backend="scan", **params).build(_items(profile))
    for h, s in zip(_graphs(host), _graphs(scan)):
        _assert_bit_identical(h, s)
        assert int(s.size) == N


def test_build_graph_scan_bit_identical_to_host():
    """``build_graph`` itself, angular, with a ``max_steps`` cut and a
    schedule whose tail has one valid row; the host driver also with the
    standard finder passed as ``neighbor_fn``."""
    x = torch.from_numpy(_items("lognormal")[:1 + 128 * 5])
    kw = dict(similarity=Similarity.ANGULAR, max_degree=8, ef_construction=16,
              insert_batch=128, max_steps=6)
    host = build_graph(x, **kw)
    _assert_bit_identical(host, build_graph(x, build_backend="scan", **kw))
    finder = functools.partial(find_neighbors, max_degree=8, ef=16, max_steps=6)
    _assert_bit_identical(host, build_graph(x, neighbor_fn=finder, **kw))


@pytest.mark.parametrize("profile", ["gaussian", "lognormal"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_scan_build_matches_jax_scan(kind, profile):
    """The port's and JAX's scan builds of the same items: recall@10 within
    ``RECALL_MARGIN`` of each other and above the floor, I1-I6 by both
    packages' checkers (every slot live: no dead edge allowed)."""
    scan = KINDS[kind][1](build_backend="scan", device="cpu", **PARAMS).build(_items(profile))
    jscan = KINDS[kind][0](build_backend="scan", **PARAMS).build(jnp.asarray(_items(profile)))
    q = _queries()
    rec = recall_at_k(scan.search(torch.from_numpy(q), k=K, ef=EF).ids.numpy(), _gt(profile))
    jrec = recall_at_k(np.asarray(jscan.search(jnp.asarray(q), k=K, ef=EF).ids), _gt(profile))
    assert rec >= FLOORS[profile]
    assert abs(rec - jrec) <= RECALL_MARGIN, (rec, jrec)
    live = np.ones(N, bool)
    for g in _graphs(scan):
        assert check_graph_invariants(g, live, max_dead_edge_frac=0.0) == []
        jg = JaxGraphIndex(adj=g.adj.numpy(), items=g.items.numpy(),
                           size=np.int32(int(g.size)), entry=np.int32(int(g.entry)))
        assert jax_check_graph_invariants(jg, live, max_dead_edge_frac=0.0) == []


def test_scan_build_on_integer_items_is_jax_scan_bit_for_bit():
    """On integer items every dot product is exact, so the IpNSW scan build
    is JAX's bit for bit (adjacency, size, entry, entry_norm)."""
    x = np.random.default_rng(3).integers(-3, 4, (N, D)).astype(np.float32)
    kw = dict(max_degree=12, ef_construction=32, insert_batch=256, build_backend="scan")
    jg = jax_build_graph(jnp.asarray(x), **kw)
    tg = build_graph(torch.from_numpy(x), **kw)
    assert np.array_equal(np.asarray(jg.adj), tg.adj.numpy())
    assert (int(jg.size), int(jg.entry)) == (int(tg.size), int(tg.entry)) == (N, int(tg.entry))
    assert float(jg.entry_norm) == float(tg.entry_norm)


@pytest.mark.parametrize("case", ["plain", "pad_rows", "max_steps_cut"])
def test_capturable_search_equals_the_plain_search(case):
    """``beam_search(capturable=True)``, the walk the scan driver captures,
    returns what the default search returns, with its step count as a 0-dim
    tensor instead of an int."""
    g = _carried("ipnsw", "lognormal").graph
    q = torch.from_numpy(_queries())
    valid = torch.arange(q.shape[0]) % 4 != 0 if case == "pad_rows" else None
    kw = dict(pool_size=EF, max_steps=6 if case == "max_steps_cut" else 2 * EF, k=K, valid=valid)
    init = g.entry.expand(q.shape[0], 1)
    plain = beam_search(g, q, init, **kw)
    captured = beam_search(g, q, init, capturable=True, **kw)
    assert isinstance(plain.steps, int) and captured.steps.shape == ()
    assert int(captured.steps) == plain.steps > 0
    for field in ("ids", "scores", "evals", "visited"):
        assert torch.equal(getattr(plain, field), getattr(captured, field)), field
