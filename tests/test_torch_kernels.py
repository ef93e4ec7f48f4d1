"""Port vs JAX parity for each module that holds a kernel: beam_step and
beam_walk, commit_merge, mips_topk / exact_topk, topk_merge and flash_attn.

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
from repro.core.graph import GraphIndex as JaxGraphIndex
from repro.core.search import beam_search as jax_beam_search
from repro.core.storage import ItemStore as JaxItemStore
from repro.kernels.beam_step.ref import beam_step_ref as jax_beam_step_ref
from repro.kernels.commit_merge.ref import commit_merge_ref as jax_commit_merge_ref
from repro.kernels.flash_attn import flash_attention as jax_flash_attention
from repro.kernels.flash_attn import flash_attention_head as jax_flash_attention_head
from repro.kernels.flash_attn import flash_attention_head_ref as jax_flash_attention_head_ref
from repro.kernels.mips_topk.ops import mips_topk as jax_mips_topk
from repro.kernels.quant_score.ref import quant_score_ref as jax_quant_score_ref
from repro.kernels.topk_merge import topk_merge as jax_topk_merge
from repro.kernels.topk_merge import topk_merge_ref as jax_topk_merge_ref

from repro_torch.convert import graph_from_arrays
from repro_torch.core.brute_force import exact_topk
from repro_torch.core.search import beam_search
from repro_torch.core.similarity import top_l
from repro_torch.core.storage import ItemStore
from repro_torch.kernels.beam_step import beam_step, beam_walk, beam_walk_ref
from repro_torch.kernels.beam_step.ops import check_walk_inputs
from repro_torch.kernels.commit_merge import (
    commit_merge,
    commit_merge_ref,
    commit_rows_ref,
    sort_proposals,
)
from repro_torch.kernels.flash_attn import (
    flash_attention,
    flash_attention_head,
    flash_attention_head_ref,
)
from repro_torch.kernels.flash_attn.ops import check_kernel_inputs
from repro_torch.kernels.mips_topk import (
    mips_topk,
    mips_topk_ref,
    mips_topk_select,
    select_candidates_ref,
    select_top_k_ref,
)
from repro_torch.kernels.mips_topk.ops import (
    ITEM_TILE,
    MAX_CANDIDATES,
    MAX_K,
    SCRATCH_FLOATS,
    SELECT_SLICE,
    chunking,
    select_plan,
    select_rows,
)
from repro_torch.kernels.mips_topk.ref import BIN_BITS, SORT_MAX
from repro_torch.kernels.mips_topk.ops import check_kernel_inputs as check_mips_inputs
from repro_torch.kernels.topk_merge import topk_merge
from repro_torch.testing import assert_topk_match, scores_close
from test_torch_build import one_torch_thread  # noqa: F401 -- an autouse fixture


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


# ------------------------------------------------------------------ beam_walk
#
# A walk is the host loop of beam_step (beam_walk_ref on the CPU; one kernel
# launch on the card).  Through beam_search it is held to the JAX package's
# lax.while_loop walk (backend="reference") on integer inputs, where every
# score is exact: ids, scores, evals, dead_evals, steps and visited
# bit-identical.

WALK_CASES = {  # name -> (storage, live, valid, max_steps)
    "f32": ("f32", False, "all", 64),
    "int8": ("int8", False, "all", 64),
    "live": ("f32", True, "all", 64),
    "int8_live": ("int8", True, "all", 64),
    "valid": ("f32", False, "some", 64),
    "max_steps_cut": ("f32", True, "some", 3),
    "all_born_done": ("int8", True, "none", 64),
}


def _walk_case(seed, *, n=300, d=12, m=8, b=24, s=4):
    """A random graph (15% empty slots, repeats allowed) over integer items
    and codes with power-of-two scales, integer queries, and seeds with
    repeats and -1."""
    rng = np.random.default_rng(seed)
    items = _vectors(rng, (n, d), True)
    adj = rng.integers(0, n, (n, m)).astype(np.int32)
    adj[rng.random((n, m)) < 0.15] = -1
    codes = rng.integers(-3, 4, (n, d)).astype(np.int8)
    scales = np.exp2(rng.integers(-3, 4, n)).astype(np.float32)
    queries = _vectors(rng, (b, d), True)
    init = rng.integers(0, n, (b, s)).astype(np.int32)
    init[:, 2] = init[:, 0]
    init[rng.random((b, s)) < 0.2] = -1
    live = rng.random(n) >= 0.3
    return items, adj, codes, scales, queries, init, live


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_beam_walk_ref_matches_jax_beam_search(case):
    storage, use_live, rows, max_steps = WALK_CASES[case]
    items, adj, codes, scales, queries, init, live = _walk_case(31)
    b, n = queries.shape[0], items.shape[0]
    valid = {"all": None, "some": np.arange(b) % 3 != 1, "none": np.zeros(b, bool)}[rows]
    kw = dict(pool_size=10, max_steps=max_steps, k=6, storage=storage)
    jg = JaxGraphIndex(adj=jnp.asarray(adj), items=jnp.asarray(items), size=jnp.int32(n),
                       entry=jnp.int32(0))
    j = jax_beam_search(
        jg, jnp.asarray(queries), jnp.asarray(init), backend="reference",
        store=JaxItemStore(jnp.asarray(codes), jnp.asarray(scales)) if storage == "int8" else None,
        live=jnp.asarray(live) if use_live else None,
        valid=None if valid is None else jnp.asarray(valid), **kw)
    t = beam_search(
        graph_from_arrays(adj, items, n, 0, 1.0, device="cpu"), torch.from_numpy(queries),
        torch.from_numpy(init),
        store=ItemStore(torch.from_numpy(codes), torch.from_numpy(scales)) if storage == "int8"
        else None,
        live=torch.from_numpy(live) if use_live else None,
        valid=None if valid is None else torch.from_numpy(valid), **kw)
    for field in ("ids", "scores", "evals", "visited"):
        assert np.array_equal(getattr(t, field).numpy(), np.asarray(getattr(j, field))), field
    assert t.steps == int(j.steps)
    if use_live:
        assert np.array_equal(t.dead_evals.numpy(), np.asarray(j.dead_evals))
        assert rows == "none" or int(t.dead_evals.sum()) > 0
    else:
        assert t.dead_evals is None
    if valid is not None:
        pad = ~valid
        assert (t.evals.numpy()[pad] == 0).all() and (t.visited.numpy()[pad] == -1).all()
        assert (t.ids.numpy()[pad] == -1).all()
    if case == "all_born_done":
        assert t.steps == 0
    elif case == "max_steps_cut":
        assert t.steps == max_steps
    else:
        assert 0 < t.steps < max_steps  # the walks ended on their own


def _walk_state(seed, *, integer=True, n=300, d=12, m=8, b=24, l=10, s=4, max_steps=40):
    """Seeded pools as beam_search makes them, with some rows born done."""
    items, adj, codes, scales, queries, init, live = _walk_case(seed, n=n, d=d, m=m, b=b, s=s)
    if not integer:
        rng = np.random.default_rng(seed + 1)
        items, queries = _vectors(rng, items.shape, False), _vectors(rng, queries.shape, False)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    seeds = torch.sort(t(init), dim=1).values
    seeds[:, 1:][seeds[:, 1:] == seeds[:, :-1]] = -1
    scores = torch.where(seeds >= 0, (t(queries)[:, None] * t(items)[seeds.clamp_min(0).long()]
                                      ).sum(-1), float("-inf"))
    top, idx = top_l(scores, s)
    pool_ids = torch.full((b, l), -1, dtype=torch.int32)
    pool_scores = torch.full((b, l), float("-inf"))
    pool_ids[:, :s], pool_scores[:, :s] = seeds.gather(1, idx), top
    visited = torch.full((b, s + max_steps * m), -1, dtype=torch.int32)
    visited[:, :s] = seeds
    done = t(np.arange(b) % 5 == 4)
    evals = (seeds >= 0).sum(1, dtype=torch.int32)
    return (pool_ids, pool_scores, pool_ids < 0, visited, done, evals, t(queries), t(adj),
            t(items))


@pytest.mark.parametrize("max_steps", [2, 40])
@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
def test_beam_walk_ref_steps_rule_and_row_independence(integer, max_steps):
    """Each row's count is the steps it ran, the step that found no unchecked
    slot included, capped at max_steps, 0 for a row done on entry; the walk's
    steps is the largest count.  Rows are independent: each equals a walk of
    that row alone, whose steps is its count -- what the kernel relies on."""
    state = _walk_state(5, integer=integer, max_steps=max_steps)
    whole = beam_walk_ref(*[x.clone() for x in state], max_steps=max_steps)
    counts = whole.row_steps.numpy()
    assert whole.steps == counts.max() <= max_steps
    assert (counts[state[4].numpy()] == 0).all() and (counts[~state[4].numpy()] > 0).all()
    if max_steps == 2:
        assert counts.max() == 2
    else:
        assert counts.max() < max_steps and len(set(counts.tolist())) > 2
    for r in range(state[0].shape[0]):
        one = beam_walk_ref(*[x[r: r + 1].clone() for x in state[:7]], *state[7:],
                            max_steps=max_steps)
        assert one.steps == counts[r]
        for field in ("pool_ids", "pool_scores", "pool_checked", "visited", "evals"):
            assert torch.equal(getattr(one, field)[0], getattr(whole, field)[r]), (r, field)
    # the columns past a row's last step stay -1
    m = state[7].shape[1]
    s = state[3].shape[1] - max_steps * m
    for r, c in enumerate(counts):
        assert (whole.visited[r, s + c * m:] == -1).all()


def test_beam_walk_on_cpu_is_beam_walk_ref():
    state = _walk_state(6)
    a = beam_walk(*[x.clone() for x in state], max_steps=40)
    b = beam_walk_ref(*[x.clone() for x in state], max_steps=40)
    for x, y in zip(a, b):
        assert x == y if isinstance(x, int) or x is None else torch.equal(x, y)


@pytest.mark.parametrize("case", ["ok", "max_steps", "visited_dtype", "evals_shape",
                                  "live_without_dead_evals", "codes_dtype"])
def test_beam_walk_kernel_inputs_rejected_on_meta(case):
    """What the walk kernel does not take raises before any launch; the seed
    columns S = V - max_steps * M come back."""
    def t(*shape, dtype):
        return torch.zeros(*shape, dtype=dtype, device="meta")
    b, l, n, m, d, s, steps = 4, 10, 50, 8, 12, 3, 5
    args = [t(b, l, dtype=torch.int32), t(b, l, dtype=torch.float32), t(b, l, dtype=torch.bool),
            t(b, s + steps * m, dtype=torch.int32), t(b, dtype=torch.bool),
            t(b, dtype=torch.int32), t(b, d, dtype=torch.float32), t(n, m, dtype=torch.int32),
            t(n, d, dtype=torch.float32)]
    kw = {}
    if case == "ok":
        assert check_walk_inputs(*args, max_steps=steps) == s
        assert check_walk_inputs(*args[:8], t(n, d, dtype=torch.int8),
                                 t(n, dtype=torch.float32), t(n, dtype=torch.bool),
                                 t(b, dtype=torch.int32), max_steps=steps) == s
        return
    if case == "max_steps":
        kw["max_steps"] = steps + 1
    elif case == "visited_dtype":
        args[3] = t(b, s + steps * m, dtype=torch.int64)
    elif case == "evals_shape":
        args[5] = t(b + 1, dtype=torch.int32)
    elif case == "live_without_dead_evals":
        args += [None, t(n, dtype=torch.bool)]
    elif case == "codes_dtype":
        args += [t(n, dtype=torch.float32)]
    with pytest.raises((TypeError, ValueError)):
        check_walk_inputs(*args, **{"max_steps": steps, **kw})


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


# (n, d, m, e) of the cases that need more than the default sizes
COMMIT_SIZES = {"long_run": (40_000, 8, 8, 30_000)}


def _commit_case(case, seed=0, n=200, d=24, m=8, e=96):
    n, d, m, e = COMMIT_SIZES.get(case, (n, d, m, e))
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
    elif case == "rounds":
        targets[:80] = 7                           # 80 proposals, over two rounds of 32
        cands[:80] = rng.permutation(n)[:80]
    elif case == "long_run":
        targets[:] = 7                             # 30,000 proposals of one target: past
        cands[:] = rng.permutation(n)[:e]          # what a segment in shared memory held
        cands[rng.random(e) < 0.05] = -1
    elif case == "all_repeat":
        adj = np.stack([rng.permutation(n)[:m] for _ in range(n)]).astype(np.int32)
        targets = rng.integers(0, n, e).astype(np.int32)
        cands = adj[targets, rng.integers(0, m, e)]  # every proposal repeats an existing edge
    if integer:
        scores = np.einsum("ed,ed->e", items[np.maximum(targets, 0)],
                           items[np.maximum(cands, 0)]).astype(np.float32)
    else:
        scores = rng.normal(size=e).astype(np.float32)
    return adj, items, targets, cands, scores


COMMIT_CASES = ["random", "duplicates", "replace", "hub", "all_invalid", "cands_invalid",
                "integer_ties", "rounds", "long_run", "all_repeat"]


@pytest.mark.parametrize("case", COMMIT_CASES)
def test_commit_merge_matches_jax(case):
    adj, items, targets, cands, scores = _commit_case(case)
    want = np.asarray(jax_commit_merge_ref(*map(jnp.asarray, (adj, items, targets, cands, scores))))
    got = commit_merge(torch.from_numpy(adj.copy()),
                       *map(torch.from_numpy, (items, targets, cands, scores)))
    assert np.array_equal(got.numpy(), want)
    if case == "all_invalid":
        assert np.array_equal(got.numpy(), adj)
    touched = np.unique(targets[targets >= 0])
    if case == "cands_invalid":  # every touched row rewritten: its -1 holes moved last
        rows = got.numpy()[touched]
        assert (rows != adj[touched]).any()
        assert ((rows >= 0) | (np.cumsum(rows < 0, axis=1) > 0)).all()
    if case == "all_repeat":     # the proposals replaced the edges they repeat
        for t in touched[:20]:
            assert set(got.numpy()[t]) <= set(adj[t]) | set(cands[targets == t])


@pytest.mark.parametrize("case", COMMIT_CASES)
def test_commit_merge_two_sort_ref_equals_csr_path(case):
    """The kernel's plain version on the pre-pass's sorted proposals (one
    run per target) equals the two-sort oracle."""
    args = [torch.from_numpy(a) for a in _commit_case(case, seed=5)]
    adj = args[0]
    props = sort_proposals(adj.shape[0], *args[2:])
    t = props.targets.long()
    valid = t >= 0
    assert bool((t[valid][1:] >= t[valid][:-1]).all()) and not bool(valid[int(valid.sum()):].any())
    tgt, rows = commit_rows_ref(adj, args[1], *props)
    assert torch.equal(tgt, torch.unique(args[2][args[2] >= 0].long()))
    merged = adj.clone()
    merged[tgt] = rows
    assert torch.equal(merged, commit_merge_ref(*args))


def test_commit_merge_prepass_has_static_shapes_on_meta():
    """The pre-pass runs on meta tensors (no data, no device), so it has no
    data-dependent shape and reads nothing back: on the card a commit never
    waits for the host.  A boolean-mask compaction or ``.item()`` raises
    there."""
    e, n = 8192, 136_736
    targets = torch.zeros(e, dtype=torch.int32, device="meta")
    cands = torch.zeros(e, dtype=torch.int32, device="meta")
    scores = torch.zeros(e, device="meta")
    props = sort_proposals(n, targets, cands, scores)
    for x, dtype in zip(props, (torch.int32, torch.int32, torch.float32)):
        assert x.device.type == "meta" and x.shape == (e,) and x.dtype == dtype
    with pytest.raises((NotImplementedError, RuntimeError)):
        targets[targets >= 0]
    with pytest.raises((NotImplementedError, RuntimeError)):
        int(targets.max())


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


@pytest.mark.parametrize("k", [33, 100, "N"])
@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
def test_exact_topk_past_32_matches_jax(k, integer):
    """k > 32 (the card's select route) answers as JAX's exact_topk, up to
    k = N: the whole catalog in lax.top_k's order."""
    rng = np.random.default_rng(12)
    q = _vectors(rng, (9, 37), integer)
    x = _vectors(rng, (300, 37), integer)
    k = x.shape[0] if k == "N" else k
    s, i = exact_topk(torch.from_numpy(q), torch.from_numpy(x), k=k)
    js, ji = (np.asarray(a) for a in jax_exact_topk(jnp.asarray(q), jnp.asarray(x), k=k,
                                                   backend="jnp"))
    assert s.shape == i.shape == (9, k)
    if integer:
        assert np.array_equal(i.numpy(), ji) and np.array_equal(s.numpy(), js)
    else:
        assert_topk_match(i.numpy(), s.numpy(), ji, js)


def test_cpu_wrappers_never_launch():
    beam_step.launches = commit_merge.launches = mips_topk.launches = 0
    beam_step.launches_live = beam_step.launches_int8_live = 0
    walk_counters = ("launches", "launches_int8", "launches_live", "launches_int8_live",
                     "steps")
    for attr in walk_counters:
        setattr(beam_walk, attr, 0)
    mips_topk.launches_select = mips_topk.launches_select_int8 = 0
    test_beam_step_matches_jax(0, False)
    test_beam_step_live_matches_jax(False, "f32", 0.5)
    test_beam_step_live_matches_jax(False, "int8", 0.5)
    for case in WALK_CASES:
        test_beam_walk_ref_matches_jax_beam_search(case)
    test_beam_walk_on_cpu_is_beam_walk_ref()
    test_commit_merge_matches_jax("random")
    test_exact_topk_matches_jax(False)
    test_exact_topk_past_32_matches_jax(33, False)
    assert beam_step.launches == commit_merge.launches == mips_topk.launches == 0
    assert beam_step.launches_live == beam_step.launches_int8_live == 0
    assert all(getattr(beam_walk, attr) == 0 for attr in walk_counters)
    assert mips_topk.launches_select == mips_topk.launches_select_int8 == 0


@pytest.mark.parametrize("b,n,k", [(256, 136736, 10), (4096, 136736, 10), (100, 20000, 32),
                                   (1, 5, 5)])
def test_mips_topk_chunking_covers_every_item_once(b, n, k):
    """Pass 1's chunks, as the kernel cuts them ([c * per, min(n, (c + 1) *
    per))), hold every item exactly once, in whole item tiles, with at most
    MAX_CANDIDATES merge candidates a query."""
    chunks, per = chunking(b, n, k, sms=132)
    assert per % ITEM_TILE == 0 and chunks * k <= MAX_CANDIDATES
    hits = np.zeros(n, np.int64)
    for c in range(chunks):
        lo, hi = c * per, min(n, (c + 1) * per)
        assert lo < hi, f"chunk {c} is empty"
        hits[lo:hi] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("b,n,k", [(256, 136736, 33), (4096, 136736, 1000), (100, 5000, 5000),
                                   (3, 1 << 27, 40), (1, 40, 40)])
def test_mips_topk_select_chunking_covers_every_query_and_item_once(b, n, k):
    """The select route (k > 32) scores ``select_rows`` queries at a time
    into a scratch of at most SCRATCH_FLOATS (one row where a row is
    larger), every query once; pass 1 cuts each row's items as the k <= 32
    route does, every item once."""
    assert k > MAX_K
    rows = select_rows(b, n)
    assert 1 <= rows <= b and (rows * n <= SCRATCH_FLOATS or rows == 1)
    seen = np.zeros(b, np.int64)
    for r0 in range(0, b, rows):
        seen[r0: min(b, r0 + rows)] += 1
    assert (seen == 1).all()
    chunks, per = chunking(rows, n, 1, sms=132)
    assert per % ITEM_TILE == 0 and (chunks - 1) * per < n <= chunks * per


def _select_scores(case, rng):
    """[R, N] score rows for the select's model: random, integer ties, +-0
    pairs, -inf rows, and a narrow band whose top bins hold most of a row."""
    if case == "ties":
        return rng.integers(-4, 5, (6, 3000)).astype(np.float32)
    if case == "signed_zeros":
        s = rng.integers(-1, 2, (6, 3000)).astype(np.float32)
        s[s == 0] = np.where(rng.random(int((s == 0).sum())) < 0.5, -0.0, 0.0)
        return s
    if case == "neg_inf":
        s = rng.normal(size=(6, 3000)).astype(np.float32)
        s[0] = -np.inf
        s[1, rng.random(3000) < 0.9] = -np.inf
        return s
    if case == "narrow":
        return (10.0 + rng.random((6, 3000)) * 1e-3).astype(np.float32)
    return rng.normal(size=(6, 6000) if case == "two_rounds" else (6, 3000)).astype(np.float32)


@pytest.mark.parametrize("case,k", [("random", 33), ("random", 1000), ("ties", 33),
                                    ("ties", 500), ("signed_zeros", 100), ("neg_inf", 33),
                                    ("neg_inf", 3000), ("narrow", 40), ("random", "N"),
                                    ("two_rounds", 5000)])
def test_select_candidates_hold_the_exact_top_k(case, k):
    """The select route's threshold and candidate step (the model of its
    histogram, find and compaction kernels): the threshold bin is the
    highest bin whose count from the top reaches k, the candidates at or
    above it always hold the exact top k, and sorting them in rounds of
    SORT_MAX keys (``select_top_k_ref``; k = 5,000 takes two) gives top_l's
    ids and score bits -- ties to the lower id, +0.0 above -0.0, -inf rows,
    k = N."""
    scores = torch.from_numpy(_select_scores(case, np.random.default_rng(13)))
    k = scores.shape[1] if k == "N" else k
    thresh, counts, take = select_candidates_ref(None, None, k=k, scores=scores)
    want_s, want_i = top_l(scores, k)
    bins = (torch.where(scores.view(torch.int32) < 0, scores.view(torch.int32) ^ 0x7FFFFFFF,
                        scores.view(torch.int32)).long() & 0xFFFFFFFF) ^ 0x80000000
    bins = bins >> (32 - BIN_BITS)
    for r in range(scores.shape[0]):
        assert int((bins[r] > thresh[r]).sum()) < k <= int((bins[r] >= thresh[r]).sum())
        assert int(counts[r]) == int(take[r].sum()) >= k
        assert bool(take[r, want_i[r]].all()), "a key of the top k is not a candidate"
        s, i = select_top_k_ref(scores[r], take[r], k)
        assert torch.equal(i.long(), want_i[r])
        assert torch.equal(s.view(torch.int32), want_s[r].view(torch.int32))
    if case == "two_rounds":
        assert k > SORT_MAX


@pytest.mark.parametrize("k", [33, 300])
def test_mips_topk_select_on_cpu_is_the_plain_version_and_the_model(k):
    """On CPU tensors the select entry point answers with the plain version
    and counts each row's candidates as the model does."""
    rng = np.random.default_rng(14)
    q, x = (torch.from_numpy(_vectors(rng, shape, True)) for shape in ((7, 16), (900, 16)))
    s, i, counts = mips_topk_select(q, x, k=k)
    ws, wi = mips_topk_ref(q, x, k=k)
    assert torch.equal(i, wi) and torch.equal(s, ws)
    assert torch.equal(counts, select_candidates_ref(q, x, k=k)[1])
    assert bool((counts >= k).all())


@pytest.mark.parametrize("n,k", [(136_736, 33), (136_736, 1000), (136_736, 136_736),
                                 (5000, 5000), (20_000, 33), (40, 40), (8193, 100)])
def test_select_plan_covers_every_item_once(n, k):
    """The select's streaming passes cut a row into ceil(n / per) slices,
    each item in exactly one, none empty; a row's candidate buffer holds at
    least k keys and at most the row, so with the scratch's rows it stays
    within twice the scratch's bytes."""
    per, cap = select_plan(n, k)
    assert 1 <= per <= SELECT_SLICE
    hits = np.zeros(n, np.int64)
    for sl in range(-(-n // per)):
        lo, hi = sl * per, min(n, (sl + 1) * per)
        assert lo < hi
        hits[lo:hi] += 1
    assert (hits == 1).all()
    assert k <= cap <= n
    rows = select_rows(4096, n)
    assert rows * cap * 2 <= max(2 * SCRATCH_FLOATS, 2 * n)


@pytest.mark.parametrize("case", ["ok", "k_zero", "k_past_n", "items_dtype", "codes_scales",
                                  "queries_width"])
def test_mips_topk_kernel_inputs_rejected_on_meta(case):
    """Any 1 <= k <= N goes to a kernel (k = 33 and k = N included); what no
    kernel takes raises before any launch."""
    def t(*shape, dtype=torch.float32):
        return torch.zeros(*shape, dtype=dtype, device="meta")
    q, x = t(5, 16), t(70, 16)
    if case == "ok":
        for k in (1, MAX_K, MAX_K + 1, 70):
            check_mips_inputs(q, x, None, k)
        check_mips_inputs(q, t(70, 16, dtype=torch.int8), t(70), 70)
        return
    bad = {"k_zero": (q, x, None, 0), "k_past_n": (q, x, None, 71),
           "items_dtype": (q, t(70, 16, dtype=torch.float64), None, 10),
           "codes_scales": (q, t(70, 16, dtype=torch.int8), t(69), 10),
           "queries_width": (t(5, 15), x, None, 10)}[case]
    with pytest.raises((TypeError, ValueError)):
        check_mips_inputs(*bad)


# ----------------------------------------------------------------- topk_merge
#
# The port follows topk_merge_ref (lax.top_k's order).  Scores, ids and flags
# of the plain version must equal JAX's bit for bit: both select by the same
# total order and gather the same slots.


def _merge_inputs(rng, b, l, m, *, padded, integer=False):
    def scores(shape):
        if integer:
            return rng.integers(-4, 5, shape).astype(np.float32)
        return rng.normal(size=shape).astype(np.float32)

    pool_s, new_s = scores((b, l)), scores((b, m))
    pool_i = rng.integers(-1 if padded else 0, 100, (b, l)).astype(np.int32)
    new_i = rng.integers(-1 if padded else 0, 100, (b, m)).astype(np.int32)
    if padded:  # -1 slots carry -inf, like a real pool
        pool_s[pool_i < 0] = -np.inf
        new_s[new_i < 0] = -np.inf
    return (pool_s, pool_i, rng.integers(0, 2, (b, l)).astype(np.int32),
            new_s, new_i, rng.integers(0, 2, (b, m)).astype(np.int32))


def _assert_merge_equal(got, want):
    for g, w, name in zip(got, want, ("scores", "ids", "checked")):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, name
        assert np.array_equal(g.view(np.int32), w.view(np.int32)), name  # bits, +-0 included


@pytest.mark.parametrize("b,l,m,padded", [(5, 16, 8, False), (130, 64, 16, False),
                                          (17, 33, 9, True), (3, 7, 5, True)])
def test_topk_merge_matches_jax_ref_and_pallas(b, l, m, padded):
    """The JAX package's own shapes (tests/test_kernels.py): the port's
    wrapper (its plain version on the CPU) equals ``topk_merge_ref`` bit for
    bit, and the Pallas kernel in interpret mode on inputs without signed
    zeros."""
    args = _merge_inputs(np.random.default_rng(b * l + m), b, l, m, padded=padded)
    got = topk_merge(*map(torch.from_numpy, args))
    _assert_merge_equal([t.numpy() for t in got], jax_topk_merge_ref(*map(jnp.asarray, args)))
    _assert_merge_equal([t.numpy() for t in got], jax_topk_merge(*map(jnp.asarray, args)))


@pytest.mark.parametrize("seed,b,l,m", [
    pytest.param(0, 64, 40, 16, id="0"), pytest.param(1, 64, 40, 16, id="1"),
    # C = 64 exactly, the most the kernel's warp route sorts; C = 416, the
    # ef-400 pool, its rank route
    pytest.param(2, 64, 48, 16, id="c64"), pytest.param(3, 16, 400, 16, id="c416")])
def test_topk_merge_integer_ties_and_signed_zeros_match_jax_ref(seed, b, l, m):
    """Integer scores with exact ties, -inf / -1 slots and +-0 pairs: the
    port equals ``topk_merge_ref`` bit for bit."""
    rng = np.random.default_rng(seed)
    args = list(_merge_inputs(rng, b, l, m, padded=True, integer=True))
    for s in (args[0], args[3]):
        zero = s == 0
        s[zero] = np.where(rng.random(int(zero.sum())) < 0.5, -0.0, 0.0)
    assert np.signbit(args[0][args[0] == 0]).any() and (~np.signbit(args[3][args[3] == 0])).any()
    got = topk_merge(*map(torch.from_numpy, args))
    _assert_merge_equal([t.numpy() for t in got], jax_topk_merge_ref(*map(jnp.asarray, args)))


def test_topk_merge_signed_zero_pins_the_ref_not_the_pallas_kernel():
    """Pool [(-0.0, 7, checked), (-1, 8)] merged with [(+0.0, 9), (-2, 10)]:
    ``topk_merge_ref`` (lax.top_k) ranks +0.0 above -0.0 and keeps each
    slot's score; the Pallas kernel keeps them equal, takes the first, and
    emits the row maximum (+0.0 for id 7).  The port follows the ref."""
    args = (np.array([[-0.0, -1.0]], np.float32), np.array([[7, 8]], np.int32),
            np.array([[1, 0]], np.int32), np.array([[0.0, -2.0]], np.float32),
            np.array([[9, 10]], np.int32), np.array([[0, 0]], np.int32))
    s, i, c = (t.numpy() for t in topk_merge(*map(torch.from_numpy, args)))
    assert i.tolist() == [[9, 7]] and c.tolist() == [[0, 1]]
    assert s.tolist() == [[0.0, 0.0]] and np.signbit(s).tolist() == [[False, True]]
    _assert_merge_equal((s, i, c), jax_topk_merge_ref(*map(jnp.asarray, args)))
    ps, pi, pc = map(np.asarray, jax_topk_merge(*map(jnp.asarray, args)))
    assert pi.tolist() == [[7, 9]] and pc.tolist() == [[1, 0]]
    assert not np.signbit(ps).any()


# ----------------------------------------------------------------- flash_attn
#
# fp32: the JAX tests' own tolerance, rtol = atol = 2e-5.  bf16: the port's
# plain version against JAX's reference, both in bf16, within one bf16 ulp of
# the output's scale (rtol = atol = 2**-7): the two CPU matmuls may round a
# bf16 score or output differently in the last bit.

FLASH_TOL = dict(rtol=2e-5, atol=2e-5)
FLASH_BF16_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -7)


def _qkv(rng, *shapes):
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("s,t,hd,off,win", [(128, 128, 64, 0, None), (128, 256, 64, 128, None),
                                            (128, 128, 64, 0, 32), (256, 256, 128, 0, None)])
def test_flash_attention_head_matches_jax_ref_and_pallas(s, t, hd, off, win):
    """The JAX package's shapes (tests/test_kernels.py): the port's head
    entry (its plain version on the CPU) against ``flash_attention_head_ref``
    and the Pallas kernel in interpret mode."""
    q, k, v = _qkv(np.random.default_rng(s + t + hd + off), (s, hd), (t, hd), (t, hd))
    got = flash_attention_head(*map(torch.from_numpy, (q, k, v)), q_offset=off, window=win)
    ref = jax_flash_attention_head_ref(*map(jnp.asarray, (q, k, v)), q_offset=off, window=win)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FLASH_TOL)
    plain = flash_attention_head_ref(*map(torch.from_numpy, (q, k, v)), q_offset=off, window=win)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **FLASH_TOL)
    pallas = jax_flash_attention_head(*map(jnp.asarray, (q, k, v)), q_offset=off, window=win,
                                      bq=64, bk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **FLASH_TOL)


def test_flash_attention_fully_masked_rows_are_zero_as_the_ref():
    """q_offset = 100 with a window of 8 over 64 keys: no row has a key in
    range.  The port gives 0, as ``flash_attention_head_ref``; the Pallas
    kernel's finite mask gives the mean of v instead (the reference's
    divergence, kept out of the port)."""
    q, k, v = _qkv(np.random.default_rng(3), (64, 64), (64, 64), (64, 64))
    got = flash_attention_head(*map(torch.from_numpy, (q, k, v)), q_offset=100, window=8)
    ref = jax_flash_attention_head_ref(*map(jnp.asarray, (q, k, v)), q_offset=100, window=8)
    plain = flash_attention_head_ref(*map(torch.from_numpy, (q, k, v)), q_offset=100, window=8)
    assert not got.numpy().any() and not np.asarray(ref).any() and not plain.numpy().any()
    pallas = np.asarray(jax_flash_attention_head(*map(jnp.asarray, (q, k, v)), q_offset=100,
                                                 window=8, bq=64, bk=64))
    np.testing.assert_allclose(pallas, np.broadcast_to(v.mean(0), pallas.shape), rtol=1e-5,
                               atol=1e-5)
    # a window that leaves the keys: rows 0-10 see some, rows 11-63 none
    got = flash_attention_head(*map(torch.from_numpy, (q, k, v)), q_offset=60, window=8)
    ref = jax_flash_attention_head_ref(*map(jnp.asarray, (q, k, v)), q_offset=60, window=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FLASH_TOL)
    assert got.numpy()[:11].all(axis=1).all() and not got.numpy()[11:].any()


@pytest.mark.parametrize("q_offset,window", [(0, None), (64, 48)])
def test_flash_attention_gqa_matches_jax(q_offset, window):
    """The grouped-query wrapper: head h reads kv head h // (H / KV), as the
    JAX wrapper's reshape groups them; against the Pallas wrapper in
    interpret mode and against the per-head reference."""
    B, S, T, H, KV, hd = 2, 128, 192, 8, 2, 64
    q, k, v = _qkv(np.random.default_rng(5), (B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), q_offset=q_offset, window=window)
    assert got.shape == (B, S, H, hd)
    pallas = jax_flash_attention(*map(jnp.asarray, (q, k, v)), q_offset=q_offset, window=window,
                                 bq=64, bk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **FLASH_TOL)
    for b in range(B):
        for h in range(H):
            ref = jax_flash_attention_head_ref(*map(jnp.asarray, (q[b, :, h], k[b, :, h // 4],
                                                                  v[b, :, h // 4])),
                                               q_offset=q_offset, window=window)
            np.testing.assert_allclose(got.numpy()[b, :, h], np.asarray(ref), **FLASH_TOL)


@pytest.mark.parametrize("b,s,t,h,kv,hd,off,win", [
    (1, 100, 227, 4, 2, 128, 127, 50), (2, 130, 130, 2, 1, 128, 0, None),
    (1, 77, 150, 2, 1, 256, 73, 40), (1, 70, 200, 2, 2, 256, 130, None)])
def test_flash_attention_wide_heads_ragged_match_jax_ref(b, s, t, h, kv, hd, off, win):
    """fp32 at hd 128 and 256 (the fp32 kernel's smaller tiles), with S and T
    that are no multiple of a tile, q_offset and a window: the port against
    ``flash_attention_head_ref`` head by head (the Pallas kernel takes only
    whole tiles)."""
    q, k, v = _qkv(np.random.default_rng(s * t + hd), (b, s, h, hd), (b, t, kv, hd),
                   (b, t, kv, hd))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), q_offset=off, window=win).numpy()
    assert got.shape == q.shape
    for bi in range(b):
        for hi in range(h):
            g = hi // (h // kv)
            ref = jax_flash_attention_head_ref(*map(jnp.asarray, (q[bi, :, hi], k[bi, :, g],
                                                                  v[bi, :, g])),
                                               q_offset=off, window=win)
            np.testing.assert_allclose(got[bi, :, hi], np.asarray(ref), **FLASH_TOL)


def test_flash_attention_bf16_matches_jax_ref():
    """bf16 inputs (the models' dtype): the port's plain version and JAX's
    reference both score, round p and multiply in bf16."""
    q, k, v = _qkv(np.random.default_rng(7), (1, 256, 4, 64), (1, 256, 2, 64), (1, 256, 2, 64))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = flash_attention(tq, tk, tv, window=96)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v))
    for h in range(4):
        ref = jax_flash_attention_head_ref(jq[0, :, h], jk[0, :, h // 2], jv[0, :, h // 2],
                                           window=96)
        np.testing.assert_allclose(got[0, :, h].float().numpy(), np.asarray(ref, np.float32),
                                   **FLASH_BF16_TOL)


def test_flash_attention_rejects_what_the_kernel_cannot_take():
    q = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 4, 2, 64, device="meta"), q, q)


@pytest.mark.parametrize("case", ["float16", "head_dim", "grouping", "k_dtype", "k_shape",
                                  "v_strided"])
def test_flash_attention_kernel_inputs_rejected_on_meta(case):
    """What neither kernel takes raises before any launch (meta tensors: no
    data, no device)."""
    def t(*shape, dtype=torch.bfloat16):
        return torch.zeros(*shape, dtype=dtype, device="meta")
    q, k, v = t(1, 64, 4, 64), t(1, 64, 2, 64), t(1, 64, 2, 64)
    check_kernel_inputs(q, k, v)
    check_kernel_inputs(q.float(), k.float(), v.float())
    bad = {"float16": (q.half(), k.half(), v.half()),
           "head_dim": (t(1, 64, 4, 96), t(1, 64, 2, 96), t(1, 64, 2, 96)),
           "grouping": (t(1, 64, 6, 64), t(1, 64, 4, 64), t(1, 64, 4, 64)),
           "k_dtype": (q, k.float(), v),
           "k_shape": (q, t(1, 64, 2, 32), v),
           "v_strided": (q, k, t(1, 2, 64, 64).transpose(1, 2))}[case]
    with pytest.raises((TypeError, ValueError)):
        check_kernel_inputs(*bad)


def test_cpu_topk_merge_and_flash_attn_never_launch():
    topk_merge.launches = flash_attention.launches = flash_attention.launches_bf16 = 0
    test_topk_merge_integer_ties_and_signed_zeros_match_jax_ref(0, 64, 40, 16)
    test_flash_attention_gqa_matches_jax(0, None)
    test_flash_attention_bf16_matches_jax_ref()
    assert topk_merge.launches == flash_attention.launches == flash_attention.launches_bf16 == 0
