"""The int8 storage slice, port vs JAX: the quantizer, the two gathered
scorers (quant_score, gather_score), the int8 step and walk, the exact fp32
rerank, the index classes' ``storage=`` knob, the quantized scan and the CLI.

The same seeded numpy inputs go through the JAX package's plain references
(``storage="int8"`` with ``backend="reference"``, ``quant_score_ref``,
``gather_score_ref``, ``beam_step_ref(score_fn=...)``, and ``mips_topk`` in
interpret mode) and through the port on ``device="cpu"``, where every
wrapper runs its plain version.  The tolerance contract is
``repro_torch.testing``'s.  "Integer" inputs are integer-valued queries,
items and codes with power-of-two scales: every fp32 dot product and every
scale multiply is then exact, so results must be bit-identical, ties
included.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import IpNSW as JaxIpNSW
from repro.core import IpNSWPlus as JaxIpNSWPlus
from repro.core import exact_topk as jax_exact_topk
from repro.core.search import beam_search as jax_beam_search
from repro.core.storage import ItemStore as JaxItemStore
from repro.core.storage import quantize_items as jax_quantize_items
from repro.core.storage import store_scores as jax_store_scores
from repro.core.storage import update_store_rows as jax_update_store_rows
from repro.data import mips_dataset, mips_queries
from repro.kernels.beam_step.ref import beam_step_ref as jax_beam_step_ref
from repro.kernels.gather_score.ref import gather_score_ref as jax_gather_score_ref
from repro.kernels.mips_topk.ops import mips_topk as jax_mips_topk
from repro.kernels.quant_score.ref import quant_score_ref as jax_quant_score_ref

from repro_torch.convert import graph_from_arrays, ipnsw_from_arrays, ipnsw_plus_from_arrays
from repro_torch.core import search as port_search
from repro_torch.core.ipnsw import IpNSW
from repro_torch.core.ipnsw_plus import IpNSWPlus
from repro_torch.core.search import beam_search
from repro_torch.core.similarity import gather_scores
from repro_torch.core.storage import (
    STORAGE_BACKENDS,
    ItemStore,
    dequantize,
    make_store,
    quantize_items,
    store_scores,
    update_store_rows,
)
from repro_torch.kernels.beam_step import beam_step, beam_walk
from repro_torch.kernels.gather_score import gather_score, gather_score_ref
from repro_torch.kernels.mips_topk import mips_topk, mips_topk_ref
from repro_torch.kernels.quant_score import quant_score, quant_score_ref
from repro_torch.obs.recall import recall_at_k
from repro_torch.testing import RECALL_MARGIN, assert_topk_match, near_tie_rows, scores_close

PROFILES = ("gaussian", "lognormal")
N, D, K, EF = 1500, 24, 10, 48                   # tests/test_recall.py's sets
PARAMS = dict(max_degree=12, ef_construction=32, insert_batch=256)
KINDS = {"ipnsw": (JaxIpNSW, IpNSW), "ipnsw_plus": (JaxIpNSWPlus, IpNSWPlus)}
MAX_RECALL_DELTA = 0.01                          # tests/test_storage.py


def _vectors(rng, shape, integer):
    if integer:
        return rng.integers(-3, 4, shape).astype(np.float32)
    return (rng.normal(size=shape) / np.sqrt(shape[-1])).astype(np.float32)


def _store_arrays(rng, items, integer):
    """(codes, scales) as numpy: integer codes with power-of-two scales, or
    the JAX package's eager quantizer of ``items``."""
    if integer:
        n, d = items.shape
        codes = rng.integers(-3, 4, (n, d)).astype(np.int8)
        return codes, np.exp2(rng.integers(-3, 4, n)).astype(np.float32)
    store = jax_quantize_items(jnp.asarray(items))
    return np.array(store.codes), np.array(store.scales)


def _ids(rng, b, w, n):
    ids = rng.integers(0, n, (b, w)).astype(np.int32)
    ids[:, : w // 4] = rng.integers(0, 8, (b, w // 4))   # repeats
    ids[rng.random((b, w)) < 0.15] = -1
    return ids


# ------------------------------------------------------------------ quantizer


@pytest.mark.parametrize("profile", PROFILES)
def test_quantize_items_bit_identical_to_jax_eager(profile):
    items = mips_dataset(5000, 300, profile=profile, seed=3).astype(np.float32)
    items[[0, 17, 4999]] = 0.0
    got = quantize_items(torch.from_numpy(items))
    want = jax_quantize_items(jnp.asarray(items))
    assert got.codes.dtype == torch.int8 and got.scales.dtype == torch.float32
    assert np.array_equal(got.codes.numpy(), np.asarray(want.codes))
    assert np.array_equal(got.scales.numpy(), np.asarray(want.scales))
    # zero rows: zero codes, the clamped scale, a score of exactly 0.0
    zero = np.array([0, 17, 4999])
    assert (got.codes.numpy()[zero] == 0).all()
    assert np.array_equal(got.scales.numpy()[zero], np.full(3, np.float32(1e-12) / np.float32(127)))
    q = torch.from_numpy(mips_queries(4, 300, seed=1).astype(np.float32))
    s = store_scores(q, got, torch.from_numpy(np.tile(zero.astype(np.int32), (4, 1))))
    assert (s.numpy() == 0.0).all()


def test_quantize_items_casts_float64_to_float32_first():
    items = mips_dataset(500, 64, profile="lognormal", seed=4)   # float64
    got = quantize_items(torch.as_tensor(items))
    want = jax_quantize_items(jnp.asarray(items))                 # float32 in JAX
    assert np.array_equal(got.codes.numpy(), np.asarray(want.codes))
    assert np.array_equal(got.scales.numpy(), np.asarray(want.scales))


@pytest.mark.parametrize("profile", PROFILES)
def test_dequantize_error_within_half_a_scale(profile):
    items = mips_dataset(2000, 48, profile=profile, seed=5).astype(np.float32)
    store = quantize_items(torch.from_numpy(items))
    err = np.abs(dequantize(store).numpy() - items)
    bound = store.scales.numpy()[:, None] / 2
    assert np.all(err <= bound * (1 + 1e-5))
    assert np.abs(store.codes.numpy()).max() == 127


def test_update_store_rows_requantizes_like_a_whole_requantization():
    rng = np.random.default_rng(6)
    items = mips_dataset(300, 40, profile="lognormal", seed=6).astype(np.float32)
    new = (rng.normal(size=(5, 40)) * 3).astype(np.float32)
    rows = np.array([3, 300, 71, 299, 300], np.int32)             # 300 == N drops
    store = update_store_rows(quantize_items(torch.from_numpy(items)), torch.from_numpy(rows),
                              torch.from_numpy(new))
    whole = items.copy()
    whole[[3, 71, 299]] = new[[0, 2, 3]]
    want = quantize_items(torch.from_numpy(whole))
    assert torch.equal(store.codes, want.codes) and torch.equal(store.scales, want.scales)
    j = jax_update_store_rows(jax_quantize_items(jnp.asarray(items)), jnp.asarray(rows),
                              jnp.asarray(new))
    assert np.array_equal(store.codes.numpy(), np.asarray(j.codes))
    assert np.array_equal(store.scales.numpy(), np.asarray(j.scales))


def test_make_store_resolves_the_knob():
    items = torch.from_numpy(mips_dataset(50, 8, seed=2).astype(np.float32))
    assert STORAGE_BACKENDS == ("f32", "int8")
    assert make_store(items, "f32") is None
    store = make_store(items, "int8")
    assert isinstance(store, ItemStore) and store.codes.shape == (50, 8)
    with pytest.raises(ValueError, match="storage"):
        make_store(items, "fp16")


# ------------------------------------------------------------------- scorers


@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
@pytest.mark.parametrize("d", [37, 300])
def test_quant_score_matches_jax(d, integer):
    rng = np.random.default_rng(d)
    items = _vectors(rng, (400, d), integer)
    codes, scales = _store_arrays(rng, items, integer)
    q = _vectors(rng, (9, d), integer)
    ids = _ids(rng, 9, 33, 400)
    want = np.asarray(jax_quant_score_ref(*map(jnp.asarray, (q, codes, scales, ids))))
    t = [torch.from_numpy(a) for a in (q, codes, scales, ids)]
    for got in (quant_score(*t), quant_score_ref(*t),
                store_scores(t[0], ItemStore(t[1], t[2]), t[3])):
        got = got.numpy()
        assert np.array_equal(np.isneginf(got), ids < 0) and np.isneginf(want[ids < 0]).all()
        if integer:
            assert np.array_equal(got, want)
        else:
            assert scores_close(got, want).all()
    js = np.asarray(jax_store_scores(jnp.asarray(q), JaxItemStore(jnp.asarray(codes),
                                                                  jnp.asarray(scales)),
                                     jnp.asarray(ids)))
    assert np.array_equal(js, want)


@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
def test_gather_score_matches_jax(integer):
    rng = np.random.default_rng(8)
    items = _vectors(rng, (300, 29), integer)
    q = _vectors(rng, (7, 29), integer)
    ids = _ids(rng, 7, 21, 300)
    want = np.asarray(jax_gather_score_ref(jnp.asarray(q), jnp.asarray(items),
                                           jnp.asarray(np.maximum(ids, 0))))
    t = [torch.from_numpy(a) for a in (q, items, ids)]
    for got in (gather_score(*t), gather_score_ref(*t)):
        if integer:
            assert np.array_equal(got.numpy(), want)
        else:
            assert scores_close(got.numpy(), want).all()
    assert gather_score_ref is gather_scores


# ---------------------------------------------------------------------- step


def _int8_beam_state(seed, *, integer, n=300, d=36, b=24, l=12, m=8, v=60):
    """A valid walk state over an int8 store: pools sorted by the quantized
    scores in lax.top_k order, empty tail slots, checked slots, done rows,
    and visited buffers that hit the adjacency rows of the pool."""
    rng = np.random.default_rng(seed)
    items = _vectors(rng, (n, d), integer)
    codes, scales = _store_arrays(rng, items, integer)
    queries = _vectors(rng, (b, d), integer)
    adj = rng.integers(0, n, (n, m)).astype(np.int32)
    adj[rng.random((n, m)) < 0.15] = -1
    ids = rng.integers(0, n, (b, l)).astype(np.int32)
    ids[np.arange(l)[None, :] >= l - rng.integers(0, l // 2 + 1, (b, 1))] = -1
    scores = np.asarray(jax_quant_score_ref(*map(jnp.asarray, (queries, codes, scales, ids))))
    order = np.argsort(-scores, axis=1, kind="stable")
    ids, scores = np.take_along_axis(ids, order, 1), np.take_along_axis(scores, order, 1)
    checked = (rng.random((b, l)) < 0.5) | (ids < 0)
    checked[:2] = True
    done = rng.random(b) < 0.2
    visited = rng.integers(0, n, (b, v)).astype(np.int32)
    visited[rng.random((b, v)) < 0.3] = -1
    hits = adj[np.maximum(ids, 0)][:, :, : m // 2].reshape(b, -1)
    visited[:, :l] = ids
    visited[:, l: v // 2] = hits[:, : v // 2 - l]
    return (ids, scores, checked, visited, done, queries, adj, codes), scales


@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
@pytest.mark.parametrize("seed", [0, 1])
def test_beam_step_int8_matches_jax(seed, integer):
    state, scales = _int8_beam_state(seed, integer=integer)
    j_store = JaxItemStore(jnp.asarray(state[7]), jnp.asarray(scales))
    j = jax_beam_step_ref(*map(jnp.asarray, state),
                          score_fn=lambda q, _x, ids: jax_store_scores(q, j_store, ids))
    t = beam_step(*map(torch.from_numpy, state), torch.from_numpy(scales))
    for field in ("nbr_ids", "done", "n_scored"):
        assert np.array_equal(np.asarray(getattr(j, field)), getattr(t, field).numpy()), field
    j_ids, j_s = np.asarray(j.pool_ids), np.asarray(j.pool_scores)
    if integer:
        assert np.array_equal(t.pool_ids.numpy(), j_ids)
        assert np.array_equal(t.pool_scores.numpy(), j_s)
        assert np.array_equal(t.pool_checked.numpy(), np.asarray(j.pool_checked))
    else:
        assert_topk_match(t.pool_ids.numpy(), t.pool_scores.numpy(), j_ids, j_s)
    assert state[4].any() and (state[0] < 0).any() and int(t.n_scored.sum()) > 0


# ---------------------------------------------------------------- whole walk


def _graph_arrays(g):
    return dict(adj=np.asarray(g.adj), items=np.asarray(g.items), size=int(g.size),
                entry=int(g.entry), entry_norm=float(g.entry_norm))


@functools.lru_cache(maxsize=None)
def _integer_case():
    """A JAX-built graph over integer-valued items, integer queries, and an
    int8 store of integer codes with power-of-two scales."""
    rng = np.random.default_rng(21)
    items = _vectors(rng, (400, 16), True)
    graph = JaxIpNSW(max_degree=8, ef_construction=16, insert_batch=128).build(
        jnp.asarray(items)).graph
    codes, scales = _store_arrays(rng, items, True)
    queries = _vectors(rng, (24, 16), True)
    init = rng.integers(0, 400, (24, 6)).astype(np.int32)
    init[:, 3] = init[:, 0]                                    # repeats
    init[rng.random((24, 6)) < 0.2] = -1
    init[0] = -1                                               # a row with no seed
    return graph, codes, scales, queries, init


def test_beam_search_int8_bit_identical_to_jax_on_integer_inputs():
    graph, codes, scales, queries, init = _integer_case()
    kw = dict(pool_size=12, max_steps=24, k=5)
    j = jax_beam_search(graph, jnp.asarray(queries), jnp.asarray(init), storage="int8",
                        store=JaxItemStore(jnp.asarray(codes), jnp.asarray(scales)), **kw)
    t = beam_search(graph_from_arrays(**_graph_arrays(graph), device="cpu"),
                    torch.from_numpy(queries), torch.from_numpy(init), storage="int8",
                    store=ItemStore(torch.from_numpy(codes), torch.from_numpy(scales)), **kw)
    assert np.array_equal(t.ids.numpy(), np.asarray(j.ids))
    assert np.array_equal(t.scores.numpy(), np.asarray(j.scores))
    assert np.array_equal(t.evals.numpy(), np.asarray(j.evals))
    assert np.array_equal(t.visited.numpy(), np.asarray(j.visited))
    assert t.steps == int(j.steps)
    assert (t.ids.numpy()[0] == -1).all() and np.isneginf(t.scores.numpy()[0]).all()


def test_beam_search_int8_scores_are_the_exact_fp32_scores_of_the_ids():
    graph, codes, scales, _, _ = _integer_case()
    rng = np.random.default_rng(22)
    q = _vectors(rng, (16, 16), False)
    g = graph_from_arrays(**_graph_arrays(graph), device="cpu")
    init = g.entry.expand(16, 1)
    r = beam_search(g, torch.from_numpy(q), init, pool_size=16, max_steps=32, k=6,
                    storage="int8")
    ids, scores = r.ids.numpy(), r.scores.numpy()
    assert (ids >= 0).all()
    exact = np.einsum("bd,bkd->bk", q, np.asarray(graph.items)[ids])
    assert scores_close(scores, exact).all()
    quantized = quant_score_ref(torch.from_numpy(q), *quantize_items(g.items), r.ids).numpy()
    assert not np.array_equal(scores, quantized)     # the rerank replaced them
    assert (np.diff(scores, axis=1) <= 0).all()


@functools.lru_cache(maxsize=None)
def _items(profile):
    return mips_dataset(N, D, profile=profile, seed=7).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _queries():
    return mips_queries(128, D, seed=123).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _gt(profile):
    _, ids = jax_exact_topk(jnp.asarray(_queries()), jnp.asarray(_items(profile)), k=K)
    return np.asarray(ids)


@functools.lru_cache(maxsize=None)
def _jax_index(kind, profile):
    return KINDS[kind][0](storage="int8", **PARAMS).build(jnp.asarray(_items(profile)))


@functools.lru_cache(maxsize=None)
def _port_index(kind, profile):
    return KINDS[kind][1](device="cpu", **PARAMS).build(_items(profile))


def _store_pair(store):
    return np.asarray(store.codes), np.asarray(store.scales)


def _carried(kind, profile):
    jidx = _jax_index(kind, profile)
    if kind == "ipnsw":
        return ipnsw_from_arrays(**_graph_arrays(jidx.graph), store=_store_pair(jidx.store),
                                 storage="int8", device="cpu", **PARAMS)
    return ipnsw_plus_from_arrays(_graph_arrays(jidx.ang_graph), _graph_arrays(jidx.ip_graph),
                                  ang_store=_store_pair(jidx.ang_store),
                                  ip_store=_store_pair(jidx.ip_store),
                                  storage="int8", device="cpu", **PARAMS)


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_int8_search_on_carried_graph_and_store_matches_jax(kind, profile):
    q = _queries()
    j = _jax_index(kind, profile).search(jnp.asarray(q), k=K, ef=EF)
    t = _carried(kind, profile).search(torch.from_numpy(q), k=K, ef=EF)
    tied = near_tie_rows(t.ids.numpy(), np.asarray(j.ids), t.scores.numpy(),
                         np.asarray(j.scores))
    rows = np.setdiff1d(np.arange(q.shape[0]), tied)
    assert len(rows) >= q.shape[0] - 2
    assert scores_close(t.scores.numpy(), np.asarray(j.scores)).all()
    assert np.array_equal(t.evals.numpy()[rows], np.asarray(j.evals)[rows])
    if kind == "ipnsw_plus":
        assert np.array_equal(t.ang_evals.numpy()[rows], np.asarray(j.ang_evals)[rows])


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_int8_recall_tracks_f32_and_jax(kind, profile):
    q = torch.from_numpy(_queries())
    index = _port_index(kind, profile)
    r32 = recall_at_k(index.search(q, k=K, ef=EF).ids.numpy(), _gt(profile))
    r8 = recall_at_k(index.search(q, k=K, ef=EF, storage="int8").ids.numpy(), _gt(profile))
    j8 = recall_at_k(np.asarray(_jax_index(kind, profile).search(
        jnp.asarray(_queries()), k=K, ef=EF).ids), _gt(profile))
    assert r8 >= r32 - MAX_RECALL_DELTA, (r32, r8)
    assert abs(r8 - j8) <= RECALL_MARGIN, (r8, j8)


# ---------------------------------------------------------------------- knobs


@pytest.mark.parametrize("kind", list(KINDS))
def test_storage_field_equals_per_call_override(kind):
    items = mips_dataset(400, 16, profile="lognormal", seed=9)
    q = torch.from_numpy(mips_queries(16, 16, seed=10).astype(np.float32))
    params = dict(max_degree=8, ef_construction=16, insert_batch=128, device="cpu")
    built = KINDS[kind][1](storage="int8", **params).build(items)
    plain = KINDS[kind][1](**params).build(items)
    stores = [built.store] if kind == "ipnsw" else [built.ang_store, built.ip_store]
    assert all(s is not None for s in stores)
    a = built.search(q, k=5, ef=16)
    b = plain.search(q, k=5, ef=16, storage="int8")
    assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)
    assert torch.equal(a.evals, b.evals)
    f32 = built.search(q, k=5, ef=16, storage="f32")
    assert torch.equal(f32.ids, plain.search(q, k=5, ef=16).ids)


@pytest.mark.parametrize("kind", list(KINDS))
def test_unknown_storage_raises_before_any_work(kind, monkeypatch):
    items = mips_dataset(200, 8, seed=11)
    index = KINDS[kind][1](max_degree=6, ef_construction=8, insert_batch=64,
                           device="cpu").build(items)

    def no_work(*a, **k):
        raise AssertionError("work started before the storage knob was checked")

    monkeypatch.setattr(port_search, "gather_score", no_work)
    monkeypatch.setattr(port_search, "store_scores", no_work)
    monkeypatch.setattr(port_search, "beam_walk", no_work)
    with pytest.raises(ValueError, match="storage"):
        KINDS[kind][1](storage="fp16", device="cpu").build(items)
    with pytest.raises(ValueError, match="storage"):
        index.search(torch.zeros(2, 8), storage="fp16")
    g = index.graph if kind == "ipnsw" else index.ip_graph
    with pytest.raises(ValueError, match="storage"):
        beam_search(g, torch.zeros(2, 8), torch.zeros(2, 1, dtype=torch.int32),
                    pool_size=4, max_steps=2, k=2, storage="fp16")


# ------------------------------------------------------------ quantized scan


@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
def test_quantized_mips_topk_matches_jax(integer):
    rng = np.random.default_rng(12)
    q = _vectors(rng, (19, 37), integer)
    items = _vectors(rng, (1037, 37), integer)
    codes, scales = _store_arrays(rng, items, integer)
    s, i = mips_topk(torch.from_numpy(q), torch.from_numpy(codes), torch.from_numpy(scales),
                     k=10)
    s_ref, i_ref = mips_topk_ref(torch.from_numpy(q), torch.from_numpy(codes), k=10,
                                 scales=torch.from_numpy(scales))
    assert torch.equal(s, s_ref) and torch.equal(i, i_ref)
    js, ji = jax_mips_topk(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scales), k=10,
                           interpret=True)
    js, ji = np.asarray(js), np.asarray(ji)
    if integer:
        assert np.array_equal(i.numpy(), ji) and np.array_equal(s.numpy(), js)
    else:
        assert_topk_match(i.numpy(), s.numpy(), ji, js)


# ------------------------------------------------------------------------ CLI


def test_serve_int8_on_cpu(capsys):
    from repro_torch.launch import serve

    res = serve.main(["--index", "ipnsw_plus", "--n-items", "800", "--dim", "16",
                      "--batch", "16", "--storage", "int8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] index=ipnsw_plus shards=1 storage=int8" in out
    assert res["recall"] > 0.8
    with pytest.raises(SystemExit):
        serve.main(["--storage", "fp16", "--device", "cpu"])


def test_cpu_int8_wrappers_never_launch():
    counters = [(beam_step, "launches_int8"), (beam_walk, "launches_int8"),
                (mips_topk, "launches_int8"), (mips_topk, "launches_select_int8"),
                (quant_score, "launches"), (gather_score, "launches")]
    for fn, attr in counters:
        setattr(fn, attr, 0)
    test_beam_step_int8_matches_jax(0, False)
    test_quant_score_matches_jax(37, False)
    test_gather_score_matches_jax(False)
    test_quantized_mips_topk_matches_jax(False)
    test_beam_search_int8_bit_identical_to_jax_on_integer_inputs()
    assert all(getattr(fn, attr) == 0 for fn, attr in counters)
