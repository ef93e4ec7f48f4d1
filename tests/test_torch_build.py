"""Port vs JAX parity of the build's pieces: ``_bootstrap_neighbors`` and
``commit_batch`` (forward rows, reverse-link merge, size and entry) on the
same seeded inputs, the JAX side through ``commit_backend="reference"``.
The port runs on ``device="cpu"``, its plain versions."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.build import _bootstrap_neighbors as jax_bootstrap
from repro.core.build import bootstrap_graph as jax_bootstrap_graph
from repro.core.build import commit_batch as jax_commit_batch
from repro.core.build import find_neighbors as jax_find_neighbors
from repro.core.similarity import Similarity as JaxSimilarity
from repro.core.similarity import gather_scores as jax_gather_scores
from repro.core.similarity import pair_scores as jax_pair_scores
from repro.core.similarity import prepare_items as jax_prepare_items
from repro.data import mips_dataset as jax_mips_dataset

from repro_torch.convert import graph_from_arrays
from repro_torch.core.build import _bootstrap_neighbors, bootstrap_graph, commit_batch
from repro_torch.core.build import batch_schedule, find_neighbors
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
