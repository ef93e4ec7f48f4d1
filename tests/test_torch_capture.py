"""The compiled programs of the serving loop and the mutation path: fixed-
shape, in-place mutation chunks, and the bucket and upsert programs that
the card captures as CUDA graphs (``core/capture.py``).

On the CPU every program runs eagerly, so these tests hold what a capture
needs and what it must keep:
  * the padded, in-place mutations equal the JAX package's ``MutableIndex``
    bit for bit on integer items (the sizes and items of
    ``tests/test_torch_mutation.py``, but ``mutation_batch`` 32 and
    payloads of 45 rows: a ragged tail of 13), with slot 0 live while
    JAX's pad rows point at it, and slots reused;
  * no tensor a captured graph reads or writes moves across a churn trace;
  * the bucket program and the upsert step run on meta tensors with every
    kernel launch a no-op (``kernels_on_meta``), where a read-back, a shape
    that depends on the data or a Python scalar written through indexing
    (a host-to-device copy on the card) raises;
  * a bucket whose operands were replaced raises instead of serving them.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import IpNSW as JaxIpNSW
from repro.core import IpNSWPlus as JaxIpNSWPlus
from repro.core import MutableIndex as JaxMutableIndex

from repro_torch.core import (
    ChurnTrace,
    IpNSW,
    IpNSWPlus,
    ItemStore,
    MutableIndex,
    apply_churn_event,
)
from repro_torch.core.mutation import upsert_step
from repro_torch.kernels.beam_step import beam_walk
from repro_torch.kernels.commit_merge import commit_merge
from repro_torch.kernels.gather_score import gather_score
from repro_torch.kernels.quant_score import quant_score
from repro_torch.launch.serve_loop import Bucket, BucketExecutor, BucketLadder

from test_torch_build import _meta, _meta_graph, kernels_on_meta  # noqa: F401 -- a fixture
from test_torch_mutation import D, JAX_BACKENDS, N, PARAMS, _assert_same_state, _carry
from test_torch_mutation import _integer_items

KINDS = {"ipnsw": (JaxIpNSW, IpNSW), "ipnsw_plus": (JaxIpNSWPlus, IpNSWPlus)}
MB = 32  # mutation_batch: a payload of 45 rows leaves a tail of 13


def _pair(kind, storage):
    """A JAX MutableIndex over integer items and the port's with its state."""
    jidx = KINDS[kind][0](storage=storage, **PARAMS, **JAX_BACKENDS).build(
        jnp.asarray(_integer_items(N, 7)))
    jm = JaxMutableIndex(jidx, capacity=N + 128, mutation_batch=MB, relink_threshold=0.1)
    return jm, _carry(jm)


@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_padded_in_place_mutations_bit_identical_to_jax(kind, storage):
    """Upserts of 45 rows (a ragged tail; the JAX package pads it with slot
    0, which is live), a delete of 40 that takes slot 0, an upsert that
    reuses those 40 slots, 0 first, a hub kill and relinks of 45 and of the
    whole debt: the state equals JAX's after every step, and no tensor of
    the port moved."""
    jm, tm = _pair(kind, storage)
    addresses = tm.operands()
    rng = np.random.default_rng(21)
    steps = [
        ("upsert", _integer_items(45, 22)),
        ("delete", np.concatenate([[0], rng.choice(np.arange(1, N), 39, replace=False)])),
        ("upsert", _integer_items(45, 23)),
        ("kill_hubs", 6),
        ("relink", 45),
        ("relink", 10_000),
        ("upsert", _integer_items(20, 24)),
    ]
    for i, (op, arg) in enumerate(steps):
        if op == "upsert" and i == 0:
            assert tm._live_host[0] and len(arg) % MB == 13
        if op == "relink":
            assert tm.relink_debt() == jm.relink_debt() > (45 if arg == 45 else 0)
        j_out, t_out = getattr(jm, op)(arg), getattr(tm, op)(arg)
        assert np.array_equal(np.asarray(t_out), np.asarray(j_out)), op
        if op == "upsert" and i == 2:  # the 40 tombstones, FIFO: slot 0 first
            assert t_out[:40].tolist() == sorted(steps[1][1].tolist())
        _assert_same_state(jm, tm, f"step {i} ({op})")
        errs = tm.check_invariants()
        assert errs == jm.check_invariants()
        # the JAX package re-seats the angular entry only when the ip entry
        # moves: deleting slot 0, the angular graph's entry, leaves it dead
        assert set(errs) <= {"ang: entry 0 is tombstoned"}
        assert tm.operands() == addresses, f"step {i} ({op}) moved a tensor"
    assert tm.health() == pytest.approx(jm.health())


@pytest.mark.parametrize("kind", list(KINDS))
def test_addresses_unchanged_across_a_churn_trace(kind):
    """Every tensor of the graphs and int8 stores, the live mask and the
    norms keeps the address it had when the index was opened, through
    deletes, upserts, a hub kill and relinks: a captured graph keeps
    reading and writing the index itself."""
    idx = KINDS[kind][1](device="cpu", storage="int8", **PARAMS).build(_integer_items(N, 8))
    m = MutableIndex(idx, capacity=N + 128, mutation_batch=16)
    addresses = m.operands()
    tensors = [m.live, m.norms, *(
        [idx.ang_graph.adj, idx.ip_graph.adj, idx.ang_store.codes, idx.ip_store.scales]
        if kind == "ipnsw_plus" else [idx.graph.adj, idx.graph.entry, idx.store.codes])]
    before = [t.clone() for t in tensors]
    trace = ChurnTrace.generate(n_items=N, dim=D, duration_s=1.0, turnover=0.2, batch=16,
                                seed=1, hub_kill_at=0.5, hub_kill_k=4, relink_every=1 / 3,
                                relink_budget=32)
    assert {e.kind for e in trace.events} == {"delete", "upsert", "hub_kill", "relink"}
    for ev in trace.events:
        apply_churn_event(m, ev)
        assert m.operands() == addresses, ev.kind
    assert m.check_invariants() == []
    assert sum(not torch.equal(a, b) for a, b in zip(tensors, before)) >= 3


def test_chunks_pad_by_repeating_the_last_valid_row():
    """37 ids at mutation_batch 16: three chunks of 16, the last with 5
    valid rows and 11 pad rows that repeat the 37th id and its payload;
    the payload may be a numpy array or a tensor, or absent."""
    m = MutableIndex(IpNSW(device="cpu", **PARAMS).build(_integer_items(N, 9)),
                     capacity=N + 64, mutation_batch=16)
    ids = np.arange(100, 137, dtype=np.int32)[::-1].copy()
    pay = np.arange(37 * D, dtype=np.float32).reshape(37, D)
    rows = np.minimum(np.arange(48), 36)
    for payload in (pay, torch.from_numpy(pay), None):
        chunks = list(m._chunks(ids, payload))
        assert len(chunks) == 3
        slots = torch.stack([c[0] for c in chunks])
        valid = torch.stack([c[2] for c in chunks])
        assert slots.dtype == torch.int64 and slots.shape == (3, 16)
        assert np.array_equal(slots.numpy().ravel(), ids[rows])
        assert np.array_equal(valid.numpy().ravel(), np.arange(48) < 37)
        if payload is None:
            assert all(c[1] is None for c in chunks)
        else:
            got = torch.stack([c[1] for c in chunks]).numpy()
            assert got.dtype == np.float32 and np.array_equal(got, pay[rows].reshape(3, 16, D))
    assert list(m._chunks(np.zeros(0, np.int32))) == []


@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_capturable_index_search_equals_the_plain_search(kind, storage):
    """``search(capturable=True)`` on either index, the walks a bucket
    captures, returns what the default search returns, with a live mask
    and pad rows; IpNSW's step count stays a 0-dim tensor."""
    idx = KINDS[kind][1](device="cpu", storage=storage, **PARAMS).build(_integer_items(N, 13))
    q = torch.from_numpy(_integer_items(12, 14))
    live = torch.arange(N) % 5 != 0
    valid = torch.arange(12) % 4 != 0
    kw = dict(k=10, ef=24, live=live, valid=valid)
    plain, captured = idx.search(q, **kw), idx.search(q, capturable=True, **kw)
    for field, x in zip(plain._fields, plain):
        if field == "steps":
            assert isinstance(x, int) and captured.steps.shape == () and int(captured.steps) == x
        else:
            assert torch.equal(x, getattr(captured, field)), field
    assert (plain.ids[~valid] == -1).all() and not torch.isin(plain.ids, torch.nonzero(~live)).any()


# ------------------------------------------------------------ meta tensors

WALK_COUNTERS = ("launches", "launches_int8", "launches_live", "launches_int8_live")


class NoHostScalars(TorchDispatchMode):
    """Raises at a scalar written through indexing (``x[i] = 0``): on the
    card PyTorch makes a Python scalar a host tensor and copies it to the
    device, which a CUDA graph capture refuses.  (A scalar operand of an
    elementwise op, ``torch.where(m, x, -1)``, is a kernel argument.)"""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.index_put_.default and args[2].dim() == 0:
            raise AssertionError("a scalar written through indexing")
        return func(*args, **(kwargs or {}))


@pytest.fixture
def counters(kernels_on_meta, monkeypatch):
    """Every launch counter of the walk and the scorers from 0, and no
    Python scalar written through indexing."""
    for name in WALK_COUNTERS:
        monkeypatch.setattr(beam_walk, name, 0)
    monkeypatch.setattr(quant_score, "launches", 0)
    monkeypatch.setattr(quant_score, "launches_by_width", {})
    with NoHostScalars():
        yield


def _meta_index(kind, storage, n, d):
    """An index of ``kind`` whose graphs and stores are meta tensors."""
    def store():
        return None if storage == "f32" else ItemStore(_meta(n, d, dtype=torch.int8), _meta(n))

    if kind == "ipnsw":
        idx = IpNSW(max_degree=16, ef_construction=32, storage=storage, device="meta")
        idx.graph, idx.store = _meta_graph(n, 16, d), store()
    else:
        idx = IpNSWPlus(max_degree=16, ef_construction=32, storage=storage, device="meta")
        idx.ang_graph, idx.ip_graph = _meta_graph(n, 10, d), _meta_graph(n, 16, d)
        idx.ang_store, idx.ip_store = store(), store()
    return idx


def _walk_launches() -> dict:
    return {name: getattr(beam_walk, name) for name in WALK_COUNTERS if getattr(beam_walk, name)}


@pytest.mark.parametrize("live", [False, True], ids=["frozen", "live"])
@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_bucket_program_has_static_shapes_on_meta(kind, storage, live, counters):
    """The program a bucket captures (seeds, walks, int8 rerank, live cut
    and the packed output) at the full-size loop's widest bucket, 256 x 40
    over 136,736 x 300 items: nothing is read back, no shape depends on the
    data, and each walk launches its kernel once."""
    n, d, b, k = 136_736, 300, 256, 10
    idx = _meta_index(kind, storage, n, d)
    mask = _meta(n, dtype=torch.bool) if live else None
    ex = BucketExecutor(idx, BucketLadder(batches=(64, b), efs=(10, 20, 40)), k=k)
    consts = ((idx.graph, idx.store, mask) if kind == "ipnsw" else
              (idx.ang_graph, idx.ip_graph, idx.ang_store, idx.ip_store, mask))
    out = ex._body(Bucket(b, 40), consts)(_meta(b, d), _meta(b, dtype=torch.bool))
    assert out.device.type == "meta" and out.shape == (b, 2 * k + 1) and out.dtype == torch.int32
    walks = 1 if kind == "ipnsw" else 2
    counter = "launches" + ("_int8" if storage == "int8" else "") + ("_live" if live else "")
    assert _walk_launches() == {counter: walks}
    assert beam_walk.steps == 0  # the step counts stayed on the device
    # seeds by the walk's scorer; the int8 walks rerank with gather_score
    assert (gather_score.launches, quant_score.launches) == (
        (walks, 0) if storage == "f32" else (walks, walks))
    assert commit_merge.launches == 0


@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_upsert_step_has_static_shapes_on_meta(kind, storage, counters):
    """The upsert chunk the card captures (item rows, norms, live bits, the
    live-masked walks with pad rows, the commits with the in-place carry,
    the int8 store rows) at the full-size churn phase's shapes: a chunk of
    32 over a capacity of 170,920 x 300.  Nothing is read back; each graph
    launches its walk, seed scorer and commit once."""
    n, d, b = 170_920, 300, 32
    idx = _meta_index(kind, storage, n, d)
    step = upsert_step(idx, _meta(n), _meta(n, dtype=torch.bool))
    step(_meta(b, dtype=torch.int64), _meta(b, d), _meta(b, dtype=torch.bool))
    graphs = 1 if kind == "ipnsw" else 2
    assert _walk_launches() == {"launches_live": graphs}
    assert (gather_score.launches, commit_merge.launches, quant_score.launches) == (
        graphs, graphs, 0)
    assert beam_walk.steps == 0


# ---------------------------------------------------------- moved operands


@pytest.mark.parametrize("moved", ["adj", "store", "live"])
def test_bucket_with_a_replaced_operand_raises(moved):
    """Churn writes in place and is served; a graph, store or live mask
    replaced by another tensor after the bucket was built makes its next
    dispatch raise rather than serve the old one."""
    idx = IpNSW(device="cpu", storage="int8", **PARAMS).build(_integer_items(N, 10))
    m = MutableIndex(idx, capacity=N + 32, mutation_batch=16)
    ex = BucketExecutor(m, BucketLadder(batches=(4,), efs=(16,)), k=5)
    ex.warmup()
    bucket, q = Bucket(4, 16), _integer_items(4, 11)
    ids0, _, _ = ex.run(bucket, q, np.ones(4, bool))
    m.delete(ids0[:, 0])
    m.upsert(_integer_items(6, 12))
    ids1, _, _ = ex.run(bucket, q, np.ones(4, bool))
    want = m.search(torch.from_numpy(q), k=5, ef=16)
    assert np.array_equal(ids1, want.ids.numpy()) and not np.isin(ids1, ids0[:, 0]).any()
    if moved == "adj":
        idx.graph = dataclasses.replace(idx.graph, adj=idx.graph.adj.clone())
    elif moved == "store":
        idx.store = ItemStore(idx.store.codes.clone(), idx.store.scales.clone())
    else:
        m.live = m.live.clone()
    with pytest.raises(RuntimeError, match="replaced"):
        ex.run(bucket, q, np.ones(4, bool))
