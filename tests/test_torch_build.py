"""Port vs JAX parity of the build's pieces: ``_bootstrap_neighbors`` and
``commit_batch`` (forward rows, reverse-link merge, size and entry; with
``valid=`` pad rows too) on the same seeded inputs, the JAX side through
``commit_backend="reference"``.  The port runs on ``device="cpu"``, its
plain versions.  The scan driver's batch and ``commit_batch(valid=)`` also
run on meta tensors, with every kernel launch a no-op: what a CUDA graph
captures has no shape that depends on data and reads nothing back."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.build import BUILD_BACKENDS as JAX_BUILD_BACKENDS
from repro.core.build import _bootstrap_neighbors as jax_bootstrap
from repro.core.build import bootstrap_graph as jax_bootstrap_graph
from repro.core.build import commit_batch as jax_commit_batch
from repro.core.build import find_neighbors as jax_find_neighbors
from repro.core.similarity import Similarity as JaxSimilarity
from repro.core.similarity import gather_scores as jax_gather_scores
from repro.core.similarity import pair_scores as jax_pair_scores
from repro.core.similarity import prepare_items as jax_prepare_items
from repro.data import mips_dataset as jax_mips_dataset

import repro_torch.core
from repro_torch.convert import graph_from_arrays
from repro_torch.core.build import _bootstrap_neighbors, bootstrap_graph, commit_batch
from repro_torch.core.build import batch_schedule, build_graph, find_neighbors, insert_batch_step
from repro_torch.core.graph import GraphIndex
from repro_torch.core.ipnsw import IpNSW
from repro_torch.core.ipnsw_plus import IpNSWPlus, _insert_plus_step
from repro_torch.kernels import _lib
from repro_torch.kernels.beam_step import beam_walk
from repro_torch.kernels.commit_merge import commit_merge
from repro_torch.kernels.gather_score import gather_score
from repro_torch.core.similarity import Similarity, gather_scores, pair_scores, prepare_items
from repro_torch.data import mips_dataset, mips_queries
from repro_torch.testing import assert_topk_match

N, D, M, BATCH = 600, 24, 8, 128


def _items(profile, integer=False):
    if integer:
        return np.random.default_rng(3).integers(-3, 4, (N, D)).astype(np.float32)
    return mips_dataset(N, D, profile=profile, seed=5)


def _graph_arrays(g):
    return dict(adj=np.asarray(g.adj), items=np.asarray(g.items), size=int(g.size),
                entry=int(g.entry), entry_norm=float(g.entry_norm))


def _assert_same_graph(jg, tg):
    assert np.array_equal(np.asarray(jg.adj), tg.adj.numpy())
    assert int(jg.size) == int(tg.size)
    assert int(jg.entry) == int(tg.entry)
    assert float(jg.entry_norm) == float(tg.entry_norm)


def test_synthetic_data_is_the_jax_generator_bit_for_bit():
    for profile in ("gaussian", "lognormal", "uniform_norm"):
        assert np.array_equal(mips_dataset(50, 7, profile, seed=2, shift=0.5),
                              jax_mips_dataset(50, 7, profile, seed=2, shift=0.5))


@pytest.mark.parametrize("sim", ["INNER_PRODUCT", "ANGULAR"])
def test_similarity_primitives_match_jax(sim):
    rng = np.random.default_rng(1)
    x = _items("lognormal")
    q = rng.normal(size=(9, D)).astype(np.float32)
    ids = rng.integers(-1, N, (9, 5)).astype(np.int32)
    jp = np.asarray(jax_prepare_items(jnp.asarray(x), getattr(JaxSimilarity, sim)))
    tp = prepare_items(torch.from_numpy(x), getattr(Similarity, sim)).numpy()
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pair_scores(torch.from_numpy(q), torch.from_numpy(tp)).numpy(),
                               np.asarray(jax_pair_scores(jnp.asarray(q), jnp.asarray(jp))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        gather_scores(torch.from_numpy(q), torch.from_numpy(tp), torch.from_numpy(ids)).numpy(),
        np.asarray(jax_gather_scores(jnp.asarray(q), jnp.asarray(jp), jnp.asarray(ids))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
def test_bootstrap_neighbors_match_jax(integer):
    x = _items("lognormal", integer)[:BATCH]
    j_ids, j_vals = jax_bootstrap(jnp.asarray(x), M)
    t_ids, t_vals = _bootstrap_neighbors(torch.from_numpy(x), M)
    if integer:
        assert np.array_equal(np.asarray(j_ids), t_ids.numpy())
        assert np.array_equal(np.asarray(j_vals), t_vals.numpy())
    else:
        assert_topk_match(t_ids.numpy(), t_vals.numpy(), np.asarray(j_ids), np.asarray(j_vals))


@pytest.mark.parametrize("reverse_links", [True, False], ids=["reverse", "directed"])
@pytest.mark.parametrize("profile", ["gaussian", "lognormal", "integer"])
def test_commit_batch_matches_jax(profile, reverse_links):
    """Bootstrap both graphs from the same items, then commit the same
    second batch (its neighbors found by the JAX walk) on both sides.
    ``reverse_links=False`` is Algorithm 2 as printed (forward rows only)."""
    x = _items(profile, integer=profile == "integer")
    norms = np.linalg.norm(x, axis=1).astype(np.float32)
    jg = jax_bootstrap_graph(jnp.asarray(x), jnp.asarray(norms), max_degree=M,
                             insert_batch=BATCH, reverse_links=reverse_links)
    tg = bootstrap_graph(torch.from_numpy(x), torch.from_numpy(norms), max_degree=M,
                         insert_batch=BATCH, reverse_links=reverse_links)
    _assert_same_graph(jg, tg)

    bids = np.arange(BATCH, 2 * BATCH, dtype=np.int32)
    nbr, sc = jax_find_neighbors(jg, jnp.asarray(x[bids]), max_degree=M, ef=16, max_steps=32)
    jg2 = jax_commit_batch(jg, jnp.asarray(bids), nbr, sc, jnp.asarray(norms),
                           reverse_links=reverse_links, commit_backend="reference")
    tg2 = commit_batch(graph_from_arrays(**_graph_arrays(jg), device="cpu"),
                       torch.from_numpy(bids), torch.from_numpy(np.array(nbr)),
                       torch.from_numpy(np.array(sc)), torch.from_numpy(norms),
                       reverse_links=reverse_links)
    _assert_same_graph(jg2, tg2)
    assert int(tg2.size) == 2 * BATCH


def test_find_neighbors_matches_jax_on_a_carried_graph():
    x = _items("lognormal")
    norms = np.linalg.norm(x, axis=1).astype(np.float32)
    jg = jax_bootstrap_graph(jnp.asarray(x), jnp.asarray(norms), max_degree=M,
                             insert_batch=BATCH, reverse_links=True)
    batch = x[BATCH: 2 * BATCH]
    j_ids, j_sc = jax_find_neighbors(jg, jnp.asarray(batch), max_degree=M, ef=16, max_steps=32)
    t_ids, t_sc = find_neighbors(graph_from_arrays(**_graph_arrays(jg), device="cpu"),
                                 torch.from_numpy(batch), max_degree=M, ef=16, max_steps=32)
    assert_topk_match(t_ids.numpy(), t_sc.numpy(), np.asarray(j_ids), np.asarray(j_sc))


def test_batch_schedule_and_queries():
    first, ids, valid = batch_schedule(1000, 256)
    assert first == 256 and ids.shape == (3, 256)
    assert np.array_equal(ids[valid], np.arange(256, 1000))
    q = mips_queries(4, 9, seed=3)
    assert q.dtype == np.float32 and q.shape == (4, 9)


@pytest.mark.parametrize("reverse_links", [True, False], ids=["reverse", "directed"])
@pytest.mark.parametrize("pads", ["clamped_tail", "interleaved"])
def test_commit_batch_valid_matches_jax(pads, reverse_links):
    """A padded batch of 128 rows, 100 valid, on integer items: the port's
    ``commit_batch(valid=)`` equals JAX's bit for bit, and the port's
    ragged commit of the valid rows alone.  Every pad id repeats a valid
    id: the tail clamped to its last valid id, as ``batch_schedule`` pads
    it, or pad rows spread among the valid ones.  JAX gets the pad rows'
    neighbors masked to -1, as its contract asks; the port gets them
    unmasked (random ids) and must drop them itself."""
    x = _items("integer", integer=True)
    norms = np.linalg.norm(x, axis=1).astype(np.float32)
    jg = jax_bootstrap_graph(jnp.asarray(x), jnp.asarray(norms), max_degree=M,
                             insert_batch=BATCH, reverse_links=reverse_links)
    n_valid = 100
    valid_ids = np.arange(BATCH, BATCH + n_valid)
    j_nbr, j_sc = jax_find_neighbors(jg, jnp.asarray(x[valid_ids]), max_degree=M, ef=16,
                                     max_steps=32)
    rng = np.random.default_rng(5)
    pad = BATCH - n_valid
    if pads == "clamped_tail":
        pad_ids, order = np.full(pad, valid_ids[-1]), np.arange(BATCH)
    else:
        pad_ids, order = rng.choice(valid_ids, pad), rng.permutation(BATCH)
    ids = np.concatenate([valid_ids, pad_ids])[order]
    valid = (np.arange(BATCH) < n_valid)[order]
    nbr = np.concatenate([np.asarray(j_nbr), rng.integers(0, BATCH, (pad, M))])[order]
    sc = np.concatenate([np.asarray(j_sc), rng.normal(size=(pad, M))]).astype(np.float32)[order]
    nbr = nbr.astype(np.int32)
    jg2 = jax_commit_batch(jg, jnp.asarray(ids.astype(np.int32)),
                           jnp.asarray(np.where(valid[:, None], nbr, -1)),
                           jnp.asarray(np.where(valid[:, None], sc, -np.inf)),
                           jnp.asarray(norms), valid=jnp.asarray(valid),
                           reverse_links=reverse_links, commit_backend="reference")
    t = {k: torch.from_numpy(v) for k, v in
         dict(ids=ids, nbr=nbr, sc=sc, norms=norms, valid=valid).items()}
    tg2 = commit_batch(graph_from_arrays(**_graph_arrays(jg), device="cpu"), t["ids"], t["nbr"],
                       t["sc"], t["norms"], valid=t["valid"], reverse_links=reverse_links)
    _assert_same_graph(jg2, tg2)
    assert int(tg2.size) == BATCH + n_valid
    ragged = commit_batch(graph_from_arrays(**_graph_arrays(jg), device="cpu"),
                          t["ids"][valid], t["nbr"][valid], t["sc"][valid], t["norms"],
                          reverse_links=reverse_links)
    for field in ("adj", "size", "entry", "entry_norm"):
        assert torch.equal(getattr(ragged, field), getattr(tg2, field)), field


@pytest.fixture
def kernels_on_meta(monkeypatch):
    """The kernel wrappers take meta tensors as they take CUDA tensors, and
    every launch succeeds and does nothing: the code around each launch
    (checks, outputs, counters) runs as it does on the card, on tensors
    with no data, where a read-back or a shape that depends on data
    raises.  The launch counters start from 0 and are restored after."""

    class NoLaunch:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(_lib, "on_cuda", lambda t: t.device.type in ("cuda", "meta"))
    monkeypatch.setattr(_lib, "lib", NoLaunch)
    monkeypatch.setattr(_lib, "stream", lambda device: 0)
    for fn in (beam_walk, commit_merge, gather_score):
        monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(beam_walk, "steps", 0)
    monkeypatch.setattr(gather_score, "launches_by_width", {})


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


def _meta_graph(n: int, m: int, d: int) -> GraphIndex:
    return GraphIndex(adj=_meta(n, m, dtype=torch.int32), items=_meta(n, d),
                      size=_meta(dtype=torch.int64), entry=_meta(dtype=torch.int64),
                      entry_norm=_meta())


def test_commit_batch_valid_has_static_shapes_on_meta(kernels_on_meta):
    """``commit_batch(valid=)`` at the full-size build's shapes (N 136,736,
    M 16, d 300, a batch of 512) runs on meta tensors: no shape depends on
    the data and nothing is read back, so a CUDA graph can capture it.  Its
    one kernel launch is the reverse-link merge's."""
    n, m, d, b = 136_736, 16, 300, 512
    graph = _meta_graph(n, m, d)
    new = commit_batch(graph, _meta(b, dtype=torch.int64), _meta(b, m, dtype=torch.int32),
                       _meta(b, m), _meta(n), valid=_meta(b, dtype=torch.bool))
    assert new.adj is graph.adj and new.items is graph.items
    for x, dtype in ((new.size, torch.int64), (new.entry, torch.int64),
                     (new.entry_norm, torch.float32)):
        assert x.device.type == "meta" and x.shape == () and x.dtype == dtype
    assert commit_merge.launches == 1
    with pytest.raises((NotImplementedError, RuntimeError)):
        int(new.size)


@pytest.mark.parametrize("kind", ["ipnsw", "ipnsw_plus"])
def test_scan_step_has_static_shapes_on_meta(kind, kernels_on_meta):
    """The batch that the scan driver captures as a CUDA graph (the walk
    with pad rows, ``gather_score`` seeds, ``beam_walk`` with
    ``capturable=True``, ``commit_batch(valid=)`` and the in-place carry)
    runs on meta tensors at the full-size build's shapes: nothing is read
    back and no shape depends on the data.  It launches each of its kernels
    once a graph (IpNSW+: two graphs)."""
    n, d, b = 136_736, 300, 512
    ip = _meta_graph(n, 16, d)
    if kind == "ipnsw":
        step = insert_batch_step(ip, _meta(n), max_degree=16, ef=32, max_steps=64,
                                 reverse_links=True)
    else:
        ang = _meta_graph(n, 10, d)
        step = _insert_plus_step(ang, ip, _meta(n), _meta(n), max_degree=16, ef_construction=32,
                                 ang_degree=10, ang_ef=10, k_angular=10, reverse_links=True,
                                 capturable=True)
    step(_meta(b, dtype=torch.int64), _meta(b, dtype=torch.bool))
    graphs = 1 if kind == "ipnsw" else 2
    assert (beam_walk.launches, gather_score.launches, commit_merge.launches) == (graphs,) * 3
    assert beam_walk.steps == 0  # the step count stayed on the device
    assert gather_score.launches_by_width == ({1: 1} if kind == "ipnsw" else {1: 1, 161: 1})
    assert ip.size.shape == () and ip.adj.shape == (n, 16)


@pytest.mark.parametrize("case", ["build_graph", "ipnsw", "ipnsw_plus", "scan_neighbor_fn"])
def test_build_backend_rejected_before_any_work(case):
    """An unknown driver, and a custom neighbor finder under "scan", raise
    ``ValueError`` before the items are looked at (they are None here), as
    the JAX package's ``build_graph`` does."""
    if case == "scan_neighbor_fn":
        with pytest.raises(ValueError, match="neighbor_fn"):
            build_graph(None, build_backend="scan", neighbor_fn=lambda g, b: None)
        return
    with pytest.raises(ValueError, match="build_backend"):
        if case == "build_graph":
            build_graph(None, build_backend="nope")
        else:
            (IpNSW if case == "ipnsw" else IpNSWPlus)(build_backend="nope").build(None)


def test_build_backends_exported():
    assert repro_torch.core.BUILD_BACKENDS == JAX_BUILD_BACKENDS == ("host", "scan")
    assert "BUILD_BACKENDS" in repro_torch.core.__all__
