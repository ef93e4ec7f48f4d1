"""Port vs JAX parity for each module that holds a kernel: beam_step,
commit_merge and mips_topk / exact_topk.

The same seeded numpy inputs go through the JAX package's plain references
(``beam_step_ref``, ``commit_merge_ref``, ``exact_topk(backend="jnp")``, and
``mips_topk`` in interpret mode) and through the port on ``device="cpu"``,
where every wrapper runs its plain PyTorch version.  The tolerance contract
is ``repro_torch.testing``'s: scores within rtol=1e-5 / atol=1e-6, ids
identical up to near-ties, and bit-identical on integer-valued items.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.brute_force import exact_topk as jax_exact_topk
from repro.kernels.beam_step.ref import beam_step_ref as jax_beam_step_ref
from repro.kernels.commit_merge.ref import commit_merge_ref as jax_commit_merge_ref
from repro.kernels.mips_topk.ops import mips_topk as jax_mips_topk
from repro.kernels.quant_score.ref import quant_score_ref as jax_quant_score_ref

from repro_torch.core.brute_force import exact_topk
from repro_torch.core.similarity import top_l
from repro_torch.kernels.beam_step import beam_step
from repro_torch.kernels.commit_merge import (
    commit_merge,
    commit_merge_ref,
    commit_rows_ref,
    csr_proposals,
)
from repro_torch.kernels.mips_topk import mips_topk
from repro_torch.testing import assert_topk_match, scores_close


def _vectors(rng, shape, integer):
    if integer:
        return rng.integers(-3, 4, shape).astype(np.float32)
    return (rng.normal(size=shape) / np.sqrt(shape[-1])).astype(np.float32)


# ------------------------------------------------------------------ beam_step


def _beam_state(seed, *, integer=False, all_done=False, n=300, d=37, b=24, l=12, m=8, v=60):
    """A valid walk state: pools sorted in lax.top_k order, empty tail slots,
    random checked slots, rows done on input, rows with nothing unchecked,
    and visited buffers that hit the adjacency rows of the pool."""
    rng = np.random.default_rng(seed)
    items = _vectors(rng, (n, d), integer)
    queries = _vectors(rng, (b, d), integer)
    adj = rng.integers(0, n, (n, m)).astype(np.int32)
    adj[rng.random((n, m)) < 0.15] = -1
    ids = rng.integers(0, n, (b, l)).astype(np.int32)
    ids[np.arange(l)[None, :] >= l - rng.integers(0, l // 2 + 1, (b, 1))] = -1
    scores = np.where(ids >= 0, np.einsum("bd,bld->bl", queries, items[np.maximum(ids, 0)]),
                      -np.inf).astype(np.float32)
    order = np.argsort(-scores, axis=1, kind="stable")
    ids, scores = np.take_along_axis(ids, order, 1), np.take_along_axis(scores, order, 1)
    checked = (rng.random((b, l)) < 0.5) | (ids < 0)
    checked[:2] = True
    done = rng.random(b) < 0.2
    if all_done:
        done[:] = True
    # every pool id was scored, so it is in the visited buffer, as in a walk
    visited = rng.integers(0, n, (b, v)).astype(np.int32)
    visited[rng.random((b, v)) < 0.3] = -1
    hits = adj[np.maximum(ids, 0)][:, :, : m // 2].reshape(b, -1)
    visited[:, :l] = ids
    visited[:, l: v // 2] = hits[:, : v // 2 - l]
    return ids, scores, checked, visited, done, queries, adj, items


def _run_both_steps(state):
    j = jax_beam_step_ref(*map(jnp.asarray, state))
    t = beam_step(*map(torch.from_numpy, state))
    return j, t


@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_step_matches_jax(seed, integer):
    state = _beam_state(seed, integer=integer)
    j, t = _run_both_steps(state)
    for field in ("nbr_ids", "done", "n_scored"):
        assert np.array_equal(np.asarray(getattr(j, field)), getattr(t, field).numpy()), field
    j_ids, j_s = np.asarray(j.pool_ids), np.asarray(j.pool_scores)
    t_ids, t_s = t.pool_ids.numpy(), t.pool_scores.numpy()
    if integer:
        assert np.array_equal(j_ids, t_ids)
        assert np.array_equal(j_s, t_s)
        assert np.array_equal(np.asarray(j.pool_checked), t.pool_checked.numpy())
    else:
        tied = assert_topk_match(t_ids, t_s, j_ids, j_s)
        rows = np.setdiff1d(np.arange(j_ids.shape[0]), tied)
        assert np.array_equal(np.asarray(j.pool_checked)[rows], t.pool_checked.numpy()[rows])
    # the state really exercised done rows, empty ids and visited hits
    ids, _, checked, visited, done, _, adj, _ = state
    assert done.any() and (ids < 0).any()
    unchecked = ~checked & (ids >= 0)
    stepping = ~done & unchecked.any(1)
    cur = ids[np.arange(len(ids)), unchecked.argmax(1)]
    hit = [np.isin(adj[c][adj[c] >= 0], visited[r]).any() for r, c in enumerate(cur)]
    assert (stepping & np.array(hit)).any()


def test_beam_step_all_done_is_a_no_op():
    state = _beam_state(3, all_done=True)
    j, t = _run_both_steps(state)
    assert np.array_equal(t.pool_ids.numpy(), state[0])
    assert np.array_equal(t.pool_scores.numpy(), state[1])
    assert np.array_equal(t.pool_checked.numpy(), state[2])
    assert (t.nbr_ids.numpy() == -1).all() and (t.n_scored.numpy() == 0).all()
    assert t.done.numpy().all()
    assert np.array_equal(np.asarray(j.pool_ids), t.pool_ids.numpy())


@pytest.mark.parametrize("dead_share", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("variant", ["f32", "int8"])
@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
def test_beam_step_live_matches_jax(integer, variant, dead_share):
    """The tombstone count: ``n_dead`` equals JAX's, and the mask changes no
    other output (dead nodes are scored and merged like live ones)."""
    state = _beam_state(4 + int(integer), integer=integer)
    rng = np.random.default_rng(9)
    n = state[7].shape[0]
    live = rng.random(n) >= dead_share
    scales = None
    j_kw = {}
    if variant == "int8":
        codes = rng.integers(-3, 4, state[7].shape).astype(np.int8)
        scales = np.exp2(rng.integers(-3, 4, n)).astype(np.float32)
        state = (*state[:7], codes)
        j_kw["score_fn"] = lambda q, c, ids: jax_quant_score_ref(q, c, jnp.asarray(scales), ids)
    j = jax_beam_step_ref(*map(jnp.asarray, state), live=jnp.asarray(live), **j_kw)
    t_args = [torch.from_numpy(a) for a in state]
    t_scales = None if scales is None else torch.from_numpy(scales)
    t = beam_step(*t_args, t_scales, live=torch.from_numpy(live))
    off = beam_step(*t_args, t_scales)
    assert off.n_dead is None and t.n_dead.dtype == torch.int32
    assert np.array_equal(t.n_dead.numpy(), np.asarray(j.n_dead))
    for field in ("pool_ids", "pool_scores", "pool_checked", "nbr_ids", "done", "n_scored"):
        assert torch.equal(getattr(t, field), getattr(off, field)), field
    for field in ("nbr_ids", "done", "n_scored"):
        assert np.array_equal(np.asarray(getattr(j, field)), getattr(t, field).numpy()), field
    if integer:
        assert np.array_equal(t.pool_ids.numpy(), np.asarray(j.pool_ids))
    n_dead = t.n_dead.numpy()
    assert (n_dead <= t.n_scored.numpy()).all()
    if dead_share == 0.0:
        assert (n_dead == 0).all()
    elif dead_share == 1.0:
        assert np.array_equal(n_dead, t.n_scored.numpy()) and n_dead.sum() > 0
    else:
        assert 0 < n_dead.sum() < t.n_scored.numpy().sum()


# ------------------------------------------------------- signed-zero ordering


def test_top_l_ranks_positive_zero_above_negative_zero_as_lax_top_k():
    x = np.array([[-0.0, 0.0, -0.0, 0.0]], np.float32)
    vals, idx = top_l(torch.from_numpy(x), 4)
    j_vals, j_idx = jax.lax.top_k(jnp.asarray(x), 4)
    assert np.asarray(j_idx).tolist() == [[1, 3, 0, 2]]
    assert idx.tolist() == [[1, 3, 0, 2]]
    assert np.array_equal(np.signbit(vals.numpy()), np.signbit(np.asarray(j_vals)))


@pytest.mark.parametrize("seed", [0, 1])
def test_top_l_matches_lax_top_k_with_signed_zeros_and_ties(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, (16, 48)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = -0.0
    x[rng.random(x.shape) < 0.1] = -np.inf
    vals, idx = top_l(torch.from_numpy(x), 20)
    j_vals, j_idx = jax.lax.top_k(jnp.asarray(x), 20)
    assert np.array_equal(idx.numpy(), np.asarray(j_idx))
    assert np.array_equal(np.signbit(vals.numpy()), np.signbit(np.asarray(j_vals)))


def test_beam_step_ranks_signed_zero_neighbours_as_jax():
    """d = 1 and a negative query: the row +0.0 scores -0.0 and the row -0.0
    scores +0.0 (in both packages).  The neighbours come in that order, and
    the pool already holds a -0.0 score, so a merge that keeps +-0 equal puts
    the +0.0 neighbour last."""
    items = np.array([[0.0], [-0.0], [1.0], [0.0]], np.float32)
    queries = np.array([[-1.0]], np.float32)
    adj = np.array([[2, -1, -1], [2, -1, -1], [3, -1, -1], [0, 1, -1]], np.int32)
    state = (
        np.array([[2, 3, -1, -1]], np.int32),                      # pool ids
        np.array([[-1.0, -0.0, -np.inf, -np.inf]], np.float32),    # scores
        np.array([[True, False, True, True]]),                     # checked
        np.array([[2, 3, -1, -1, -1]], np.int32),                  # visited
        np.array([False]),
        queries,
        adj,
        items,
    )
    j, t = _run_both_steps(state)
    assert np.asarray(j.pool_ids).tolist() == [[1, 3, 0, 2]]
    assert np.array_equal(t.pool_ids.numpy(), np.asarray(j.pool_ids))
    assert np.array_equal(np.signbit(t.pool_scores.numpy()), np.signbit(np.asarray(j.pool_scores)))
    assert np.array_equal(t.pool_checked.numpy(), np.asarray(j.pool_checked))


# --------------------------------------------------------------- commit_merge


def _commit_case(case, seed=0, n=200, d=24, m=8, e=96):
    rng = np.random.default_rng(seed)
    integer = case == "integer_ties"
    items = _vectors(rng, (n, d), integer)
    adj = rng.integers(0, n, (n, m)).astype(np.int32)
    adj[rng.random((n, m)) < 0.2] = -1
    targets = rng.integers(0, n, e).astype(np.int32)
    cands = rng.integers(0, n, e).astype(np.int32)
    targets[rng.random(e) < 0.2] = -1
    cands[rng.random(e) < 0.1] = -1
    if case == "duplicates":
        targets[e // 2:] = targets[: e // 2]
        cands[e // 2:] = cands[: e // 2]      # same pairs, other scores below
    elif case == "replace":
        slot = rng.integers(0, m, e)
        cands = adj[np.maximum(targets, 0), slot]  # proposals repeating existing edges
    elif case == "hub":
        targets[: e // 2] = 7                      # one target gets ~e/2 > M proposals
    elif case == "all_invalid":
        targets[:] = -1
    elif case == "cands_invalid":
        cands[:] = -1                              # rows are still rewritten
    if integer:
        scores = np.einsum("ed,ed->e", items[np.maximum(targets, 0)],
                           items[np.maximum(cands, 0)]).astype(np.float32)
    else:
        scores = rng.normal(size=e).astype(np.float32)
    return adj, items, targets, cands, scores


COMMIT_CASES = ["random", "duplicates", "replace", "hub", "all_invalid", "cands_invalid",
                "integer_ties"]


@pytest.mark.parametrize("case", COMMIT_CASES)
def test_commit_merge_matches_jax(case):
    adj, items, targets, cands, scores = _commit_case(case)
    want = np.asarray(jax_commit_merge_ref(*map(jnp.asarray, (adj, items, targets, cands, scores))))
    got = commit_merge(torch.from_numpy(adj.copy()),
                       *map(torch.from_numpy, (items, targets, cands, scores)))
    assert np.array_equal(got.numpy(), want)
    if case == "all_invalid":
        assert np.array_equal(got.numpy(), adj)


@pytest.mark.parametrize("case", COMMIT_CASES)
def test_commit_merge_two_sort_ref_equals_csr_path(case):
    args = [torch.from_numpy(a) for a in _commit_case(case, seed=5)]
    adj = args[0]
    csr = csr_proposals(adj.shape[0], *args[2:])
    assert bool((csr.offsets[1:] >= csr.offsets[:-1]).all())
    rows = commit_rows_ref(adj, args[1], *csr[:4])
    merged = adj.clone()
    merged[csr.utgt.long()] = rows
    assert torch.equal(merged, commit_merge_ref(*args))


# ------------------------------------------------------------------ mips_topk


@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
def test_exact_topk_matches_jax(integer):
    rng = np.random.default_rng(11)
    q = _vectors(rng, (19, 37), integer)      # odd d, N not a multiple of any tile
    x = _vectors(rng, (1037, 37), integer)
    s, i = exact_topk(torch.from_numpy(q), torch.from_numpy(x), k=10)
    for js, ji in (jax_exact_topk(jnp.asarray(q), jnp.asarray(x), k=10, backend="jnp"),
                   jax_mips_topk(jnp.asarray(q), jnp.asarray(x), k=10, interpret=True)):
        js, ji = np.asarray(js), np.asarray(ji)
        if integer:
            assert np.array_equal(i.numpy(), ji) and np.array_equal(s.numpy(), js)
        else:
            assert_topk_match(i.numpy(), s.numpy(), ji, js)
    # small query tiles give the same answer as one tile
    s2, i2 = exact_topk(torch.from_numpy(q), torch.from_numpy(x), k=10, query_tile=4)
    assert torch.equal(i, i2) and bool(scores_close(s.numpy(), s2.numpy()).all())


def test_cpu_wrappers_never_launch():
    beam_step.launches = commit_merge.launches = mips_topk.launches = 0
    beam_step.launches_live = beam_step.launches_int8_live = 0
    test_beam_step_matches_jax(0, False)
    test_beam_step_live_matches_jax(False, "f32", 0.5)
    test_beam_step_live_matches_jax(False, "int8", 0.5)
    test_commit_merge_matches_jax("random")
    test_exact_topk_matches_jax(False)
    assert beam_step.launches == commit_merge.launches == mips_topk.launches == 0
    assert beam_step.launches_live == beam_step.launches_int8_live == 0
