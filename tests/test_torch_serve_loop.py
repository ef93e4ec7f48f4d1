"""The serving-loop slice, port vs JAX: ``valid=`` on every search entry
point, the continuous-batching loop (``launch/serve_loop.py``) and
``serve --loop``.

Sizes follow ``tests/test_serve_loop.py``: N = 400, d = 16, M = 8, a
(2, 4) x (8, 16, 32) ladder and a service model of 1 ms + 1 ms per ef unit.
The JAX side runs its reference backends; the port runs on ``device="cpu"``,
where every wrapper runs its plain version, over the JAX package's own graphs
and int8 stores carried across by ``repro_torch.convert``.

Tolerances: under the virtual clock the schedule (dispatch and finish
times, buckets, members, served ef) is a pure function of the trace and
must be equal, float for float; response ids are identical except at
near-ties and scores within ``repro_torch.testing``'s rtol = 1e-5 /
atol = 1e-6; on integer-valued items (churn) everything is bit-identical.
Padding is held bit for bit: a valid row of a padded batch equals the same
query searched without padding, in the same package.
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import ChurnEvent as JaxChurnEvent
from repro.core import IpNSW as JaxIpNSW
from repro.core import IpNSWPlus as JaxIpNSWPlus
from repro.core import MutableIndex as JaxMutableIndex
from repro.data import mips_dataset, mips_queries
from repro.launch import serve_loop as jsl

from repro_torch.convert import ipnsw_from_arrays, ipnsw_plus_from_arrays, mutable_from_arrays
from repro_torch.core import ChurnTrace, IpNSW, IpNSWPlus, MutableIndex
from repro_torch.core.search import beam_search
from repro_torch.kernels.beam_step import beam_step, beam_walk
from repro_torch.launch import serve_loop as sl
from repro_torch.launch.serve_loop import (
    Bucket,
    BucketExecutor,
    BucketLadder,
    LinearServiceModel,
    Request,
    ServeLoop,
    VirtualClock,
    WallClock,
    poisson_trace,
    schedule_digest,
)
from repro_torch.testing import assert_topk_match

N, D, K = 400, 16, 5
PARAMS = dict(max_degree=8, ef_construction=16, insert_batch=100)
JAX_BACKENDS = dict(backend="reference", commit_backend="reference")
LADDER = BucketLadder(batches=(2, 4), efs=(8, 16, 32))
# service = 1 ms + 1 ms * ef: ef 8 / 16 / 32 -> 9 / 17 / 33 ms, batch-size free
MODEL = LinearServiceModel(base_s=0.001, per_row_s=0.0, per_ef_s=0.001, per_ef_row_s=0.0)
KINDS = ("ipnsw", "ipnsw_plus")


def _graph_arrays(g):
    return dict(adj=np.asarray(g.adj), items=np.asarray(g.items), size=int(g.size),
                entry=int(g.entry), entry_norm=float(g.entry_norm))


def _store(s):
    return None if s is None else (np.asarray(s.codes), np.asarray(s.scales))


@functools.lru_cache(maxsize=None)
def _jax_index(kind, storage="f32"):
    """The JAX tests' indexes: ip-NSW over 400 lognormal items, ip-NSW+ over
    250 gaussian ones; the int8 one is the f32 build with its store."""
    if storage == "int8":
        idx = dataclasses.replace(_jax_index(kind), storage="int8")
        if kind == "ipnsw":
            idx.store = None
            idx._resolve_store("int8")
        else:
            idx._make_stores("int8")
        return idx
    if kind == "ipnsw":
        items = jnp.asarray(mips_dataset(N, D, "lognormal", seed=3))
        return JaxIpNSW(**PARAMS, **JAX_BACKENDS).build(items)
    items = jnp.asarray(mips_dataset(250, D, "gaussian", seed=4))
    return JaxIpNSWPlus(**PARAMS, **JAX_BACKENDS).build(items)


def _carry(jidx):
    """The port's index over a JAX index's graphs and stores."""
    if isinstance(jidx, JaxIpNSWPlus):
        return ipnsw_plus_from_arrays(
            _graph_arrays(jidx.ang_graph), _graph_arrays(jidx.ip_graph),
            ang_store=_store(jidx.ang_store), ip_store=_store(jidx.ip_store), device="cpu",
            storage=jidx.storage, **PARAMS)
    return ipnsw_from_arrays(**_graph_arrays(jidx.graph), store=_store(jidx.store),
                             device="cpu", storage=jidx.storage, **PARAMS)


def _index(kind="ipnsw", storage="f32"):
    return _carry(_jax_index(kind, storage))


def _trace(seed=5, n=24, ef=16, mod=sl):
    q = mips_queries(n, D, seed=11)
    return mod.poisson_trace(q, rate_qps=400.0, seed=seed, ef=ef,
                             classes=("interactive", "standard", "relaxed"))


def _loop(index=None, ladder=LADDER, model=MODEL, k=K):
    return ServeLoop(index if index is not None else _index(), ladder=ladder,
                     clock=VirtualClock(), k=k, service_model=model)


def _request(rid, q, arrival, budget, ef, klass="standard"):
    return Request(rid=rid, query=np.asarray(q, np.float32), arrival_t=arrival,
                   deadline_t=arrival + budget, ef=ef, klass=klass)


def _schedule(stats):
    return [(b.seq, b.dispatch_t, b.finish_t, b.bucket.batch, b.bucket.ef, b.rids, b.ef_served)
            for b in stats.batches]


# ------------------------------------------------------------ valid= (padding)


def _padded(queries, valid):
    """queries [n, d] spread over the True rows of ``valid``; pad rows hold
    finite junk."""
    out = np.full((len(valid), queries.shape[1]), 7.0, np.float32)
    out[np.asarray(valid)] = queries
    return out


VALID = np.array([True, False, True, True, False, False])


def _check_padding(padded, solo, valid, *, live):
    rows = np.flatnonzero(valid)
    pad = np.flatnonzero(~valid)
    for field in ("ids", "scores", "evals"):
        got, want = getattr(padded, field).numpy(), getattr(solo, field).numpy()
        assert np.array_equal(got[rows].view(np.int32), want.view(np.int32)), field
    assert (padded.ids.numpy()[pad] == -1).all()
    assert np.isneginf(padded.scores.numpy()[pad]).all()
    assert (padded.evals.numpy()[pad] == 0).all()
    if live:
        assert np.array_equal(padded.dead_evals.numpy()[rows], solo.dead_evals.numpy())
        assert (padded.dead_evals.numpy()[pad] == 0).all()


@pytest.mark.parametrize("live", [False, True], ids=["frozen", "live"])
@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_beam_search_valid_pads_rows_and_keeps_live_rows_bit_identical(storage, live):
    idx = _index("ipnsw", storage)
    g = idx.graph
    queries = mips_queries(3, D, seed=21)
    mask = None
    if live:
        mask = torch.ones(g.adj.shape[0], dtype=torch.bool)
        mask[np.random.default_rng(1).choice(N, 60, replace=False)] = False
    kw = dict(pool_size=16, max_steps=32, k=K, storage=storage, store=idx.store, live=mask)
    padded = beam_search(g, torch.from_numpy(_padded(queries, VALID)),
                         g.entry.expand(len(VALID), 1), valid=torch.from_numpy(VALID), **kw)
    solo = beam_search(g, torch.from_numpy(queries), g.entry.expand(3, 1), **kw)
    _check_padding(padded, solo, VALID, live=live)
    assert (padded.visited.numpy()[~VALID] == -1).all()


@pytest.mark.parametrize("live", [False, True], ids=["frozen", "live"])
@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("kind", KINDS)
def test_index_search_valid_matches_unpadded_search(kind, storage, live):
    """``IpNSW.search``, ``IpNSWPlus.search`` (both walks masked) and, with
    tombstones, ``MutableIndex.search`` pass ``valid`` through."""
    idx = _index(kind, storage)
    if live:
        idx = MutableIndex(idx, capacity=N + 16)
        idx.delete(np.random.default_rng(2).choice(idx.live_ids(), 40, replace=False))
    queries = mips_queries(3, D, seed=22)
    padded = idx.search(torch.from_numpy(_padded(queries, VALID)), k=K, ef=16,
                        valid=torch.from_numpy(VALID))
    solo = idx.search(torch.from_numpy(queries), k=K, ef=16)
    _check_padding(padded, solo, VALID, live=live and kind == "ipnsw")
    if kind == "ipnsw_plus":
        for name in ("ang_evals", "ip_evals"):
            assert (getattr(padded, name).numpy()[~VALID] == 0).all()
        assert (padded.visited_ang.numpy()[~VALID] == -1).all()


@pytest.mark.parametrize("kind", KINDS)
def test_valid_padding_matches_jax(kind):
    """The same padded batch through both packages, over the same graph."""
    jidx, tidx = _jax_index(kind), _index(kind)
    q = _padded(mips_queries(3, D, seed=23), VALID)
    j = jidx.search(jnp.asarray(q), k=K, ef=16, valid=jnp.asarray(VALID))
    t = tidx.search(torch.from_numpy(q), k=K, ef=16, valid=torch.from_numpy(VALID))
    assert np.array_equal(t.evals.numpy(), np.asarray(j.evals))
    assert_topk_match(t.ids.numpy(), t.scores.numpy(), np.asarray(j.ids), np.asarray(j.scores))


# ------------------------------------------------------- the loop against JAX


@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("kind", KINDS)
def test_loop_schedule_and_responses_match_jax(kind, storage):
    """The same trace, ladder and service model through both loops over the
    same graph: identical batch records and digests, identical ids up to
    near-ties, scores within tolerance, zero steady builds in both."""
    jstats = jsl.ServeLoop(_jax_index(kind, storage), ladder=jsl.BucketLadder(
        batches=LADDER.batches, efs=LADDER.efs), clock=jsl.VirtualClock(), k=K,
        service_model=jsl.LinearServiceModel(base_s=0.001, per_row_s=0.0, per_ef_s=0.001,
                                              per_ef_row_s=0.0)).run(_trace(mod=jsl))
    tstats = _loop(_index(kind, storage)).run(_trace())
    assert _schedule(tstats) == _schedule(jstats)
    assert schedule_digest(tstats.batches) == schedule_digest(jstats.batches)
    assert _reference_tool().schedule_digest(jstats.batches) == schedule_digest(tstats.batches)
    assert tstats.summary() == jstats.summary()
    j = sorted(jstats.responses, key=lambda r: r.rid)
    t = sorted(tstats.responses, key=lambda r: r.rid)
    assert [(r.rid, r.ef_served, r.finish_t, r.deadline_met, r.degraded) for r in t] == \
           [(r.rid, r.ef_served, r.finish_t, r.deadline_met, r.degraded) for r in j]
    assert_topk_match(np.stack([r.ids for r in t]), np.stack([r.scores for r in t]),
                      np.stack([r.ids for r in j]), np.stack([r.scores for r in j]))


def _reference_tool():
    """tools/serve_loop_reference.py, whose copy of the digest gives the
    JAX schedule digest that chip_smoke.py holds the port to."""
    path = Path(__file__).resolve().parents[1] / "tools" / "serve_loop_reference.py"
    spec = importlib.util.spec_from_file_location("serve_loop_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _integer_items(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.choice([-1.0, 1.0], size=(n, D))
    s = rng.choice([1.0, 2.0, 4.0], size=(n, 1))
    return (v * s).astype(np.float32)


def test_churn_through_both_loops_is_bit_identical():
    """A churn trace (deletes, integer upserts, a hub kill, relink passes)
    replayed through both loops between the dispatches of integer queries:
    the same events apply before the same dispatches, and the mutation
    counts, health, final index state and every response are equal."""
    n = 300
    jidx = JaxIpNSW(storage="int8", **PARAMS, **JAX_BACKENDS).build(
        jnp.asarray(_integer_items(n, 16)))
    jm = JaxMutableIndex(jidx, capacity=n + 64, mutation_batch=16)
    tm = mutable_from_arrays(_carry(jidx), norms=np.asarray(jm.norms), live=np.asarray(jm.live),
                             free=list(jm._free), next_fresh=jm._next_fresh,
                             mutation_batch=16, relink_threshold=jm.relink_threshold)
    reqs = poisson_trace(_integer_items(24, 17), rate_qps=400.0, seed=5, ef=16,
                         classes=("interactive", "standard", "relaxed"))
    dur = max(r.arrival_t for r in reqs)
    trace = ChurnTrace.generate(n_items=n, dim=D, duration_s=dur, turnover=0.2, batch=16, seed=2,
                                hub_kill_at=dur / 2, hub_kill_k=4, relink_every=dur / 3,
                                relink_budget=32)
    events = [e if e.items is None else dataclasses.replace(e, items=_integer_items(16, i))
              for i, e in enumerate(trace.events)]
    jevents = [JaxChurnEvent(t=e.t, kind=e.kind, items=e.items, count=e.count, seed=e.seed)
               for e in events]
    jreqs = [jsl.Request(rid=r.rid, query=r.query, arrival_t=r.arrival_t,
                         deadline_t=r.deadline_t, ef=r.ef, klass=r.klass) for r in reqs]
    jstats = jsl.ServeLoop(jm, ladder=jsl.BucketLadder(batches=LADDER.batches, efs=LADDER.efs),
                           clock=jsl.VirtualClock(), k=K, service_model=jsl.LinearServiceModel(
                               base_s=0.001, per_row_s=0.0, per_ef_s=0.001, per_ef_row_s=0.0),
                           assert_invariants=True).run(jreqs, churn=jevents)
    tstats = ServeLoop(tm, ladder=LADDER, clock=VirtualClock(), k=K, service_model=MODEL,
                       assert_invariants=True).run(reqs, churn=events)
    assert {e.kind for e in events} == {"delete", "upsert", "hub_kill", "relink"}
    assert tstats.mutation_events == jstats.mutation_events == len(events)
    assert tstats.summary() == jstats.summary()  # health included
    assert _schedule(tstats) == _schedule(jstats)
    for a, b in zip(sorted(tstats.responses, key=lambda r: r.rid),
                    sorted(jstats.responses, key=lambda r: r.rid)):
        assert np.array_equal(a.ids, b.ids) and np.array_equal(a.scores, b.scores), a.rid
    tg, jg = tm.graph, jm.graph
    assert np.array_equal(tg.adj.numpy(), np.asarray(jg.adj))
    assert np.array_equal(tg.items.numpy(), np.asarray(jg.items))
    assert int(tg.entry) == int(jg.entry)
    assert np.array_equal(tm.live.numpy(), np.asarray(jm.live))
    assert list(tm._free) == list(jm._free)
    assert np.array_equal(tm.index.store.codes.numpy(), np.asarray(jm.index.store.codes))
    assert np.array_equal(tm.index.store.scales.numpy(), np.asarray(jm.index.store.scales))


# ------------------------------------------------- the JAX package's own pins


def test_replay_bit_identical():
    """Same arrival trace => bit-identical schedule and results."""
    s1 = _loop().run(_trace())
    s2 = _loop().run(_trace())
    assert _schedule(s1) == _schedule(s2)
    r1 = {r.rid: r for r in s1.responses}
    r2 = {r.rid: r for r in s2.responses}
    assert set(r1) == set(r2) == set(range(24))
    for rid in r1:
        assert np.array_equal(r1[rid].ids, r2[rid].ids)
        assert np.array_equal(r1[rid].scores, r2[rid].scores)
        assert r1[rid].finish_t == r2[rid].finish_t
        assert r1[rid].ef_served == r2[rid].ef_served


@pytest.mark.parametrize("kind", KINDS)
def test_padding_equivalence_vs_direct_and_solo_search(kind):
    """A query answered inside a padded bucket returns exactly the ids and
    scores of an unpadded ``search`` at the same ef, and of a search of it
    alone (B = 1)."""
    idx = _index(kind)
    q = mips_queries(3, D, seed=21)
    stats = _loop(idx).run([_request(i, q[i], 0.0, 10.0, 16, "relaxed") for i in range(3)])
    assert len(stats.responses) == 3
    assert stats.batches[0].bucket == Bucket(4, 16)
    direct = idx.search(torch.from_numpy(q), k=K, ef=16)
    for r in stats.responses:
        assert r.ef_served == 16
        assert np.array_equal(r.ids, direct.ids.numpy()[r.rid])
        assert np.array_equal(r.scores, direct.scores.numpy()[r.rid])
        solo = idx.search(torch.from_numpy(q[r.rid: r.rid + 1]), k=K, ef=16)
        assert np.array_equal(r.ids, solo.ids.numpy()[0])
        assert np.array_equal(r.scores, solo.scores.numpy()[0])


def test_largest_fitting_ef_is_served():
    stats = _loop().run([_request(0, mips_queries(1, D, seed=61)[0], 0.0, 1.0, 32, "relaxed")])
    (r,) = stats.responses
    assert r.ef_served == 32 and not r.degraded and r.deadline_met


def test_degrade_to_smaller_ef_before_reject():
    """ef 32 costs 33 ms; a 20 ms budget fits ef 16 (17 ms)."""
    stats = _loop().run([_request(0, mips_queries(1, D, seed=62)[0], 0.0, 0.020, 32)])
    (r,) = stats.responses
    assert r.ef_served == 16 and r.degraded and r.deadline_met


def test_impossible_deadline_served_late_at_floor_not_rejected():
    stats = _loop().run([_request(0, mips_queries(1, D, seed=63)[0], 0.0, 0.002, 32)])
    (r,) = stats.responses
    assert r.ef_served == 8 and r.degraded and not r.deadline_met
    assert stats.rejected == 0


def test_fifo_within_deadline_class():
    q = mips_queries(5, D, seed=64)
    reqs = [_request(i, q[i], 0.001 * i, 1.0, 8) for i in range(5)]
    stats = _loop(ladder=BucketLadder(batches=(2,), efs=(8,))).run(reqs)
    assert [b.rids for b in stats.batches] == [(0, 1), (2, 3), (4,)]


def test_earlier_deadline_preempts_later_arrival_order():
    q = mips_queries(3, D, seed=65)
    reqs = [_request(0, q[0], 0.0, 1.000, 8, "relaxed"),
            _request(1, q[1], 0.0, 1.000, 8, "relaxed"),
            _request(2, q[2], 0.0, 0.020, 8, "interactive")]
    stats = _loop(ladder=BucketLadder(batches=(2,), efs=(8,))).run(reqs)
    assert [b.rids for b in stats.batches] == [(2, 0), (1,)]


def test_never_rejects_under_burst():
    n = 20
    q = mips_queries(n, D, seed=66)
    stats = _loop().run([_request(i, q[i], 0.0, 0.005, 32, "interactive") for i in range(n)])
    assert sorted(r.rid for r in stats.responses) == list(range(n))


def test_zero_steady_state_builds_across_runs():
    """One program build per ladder bucket at warmup; traffic, including a
    second trace on the same loop, builds none.  A bucket outside the ladder
    dispatched after warmup is logged as a steady build."""
    loop = _loop()
    s1 = loop.run(_trace())
    assert s1.recompiles_warmup == len(LADDER.buckets()) and s1.recompiles_steady == 0
    s2 = loop.run(_trace(seed=99))
    assert s2.recompiles_warmup == len(LADDER.buckets()) and s2.recompiles_steady == 0
    ex = loop.executor
    ex.run(Bucket(3, 8), np.zeros((3, D), np.float32), np.zeros(3, bool))
    assert ex.compile_log[-1] == (Bucket(3, 8), "steady") and ex.recompiles_steady == 1


def test_virtual_mode_never_touches_wall_clock(monkeypatch):
    class _Boom:
        def __getattr__(self, name):
            raise AssertionError(f"virtual serve path called time.{name}")

    monkeypatch.setattr(sl, "time", _Boom())
    stats = _loop().run(_trace(seed=7))
    assert len(stats.responses) == 24


def test_wall_clock_serves_every_request():
    q = mips_queries(6, D, seed=81)
    reqs = poisson_trace(q, rate_qps=2000.0, seed=4, ef=16, classes=("relaxed",))
    stats = ServeLoop(_index(), ladder=LADDER, clock=WallClock(), k=K,
                      service_model=MODEL).run(reqs)
    assert sorted(r.rid for r in stats.responses) == list(range(6))
    for r in stats.responses:
        assert r.finish_t >= r.dispatch_t >= 0.0
    assert stats.recompiles_steady == 0


def test_ladder_bucket_selection_and_validation():
    ladder = BucketLadder(batches=(2, 4, 8), efs=(8, 32))
    assert [ladder.batch_for(n) for n in (1, 3, 8)] == [2, 4, 8]
    with pytest.raises(ValueError):
        ladder.batch_for(9)
    assert [ladder.ef_pref(e) for e in (64, 32, 10, 4)] == [32, 32, 8, 8]
    assert len(ladder.buckets()) == 6
    for batches, efs in (((4, 2), (8,)), ((2,), (8, 8)), ((), (8,)), ((2,), (0, 8))):
        with pytest.raises(ValueError):
            BucketLadder(batches=batches, efs=efs)


def test_virtual_clock_monotone():
    c = VirtualClock()
    assert c.now() == 0.0
    c.sleep_until(1.5)
    c.sleep_until(1.0)
    assert c.now() == 1.5


def test_poisson_trace_equals_jax_byte_for_byte():
    q = mips_queries(40, D, seed=71)
    kw = dict(rate_qps=100.0, seed=3, ef=24, classes=("interactive", "relaxed"), start_t=0.5)
    t, j = poisson_trace(q, **kw), jsl.poisson_trace(q, **kw)
    assert [(r.rid, r.arrival_t, r.deadline_t, r.ef, r.klass) for r in t] == \
           [(r.rid, r.arrival_t, r.deadline_t, r.ef, r.klass) for r in j]
    assert all(a.query.tobytes() == b.query.tobytes() for a, b in zip(t, j))
    assert all(a.arrival_t < b.arrival_t for a, b in zip(t, t[1:]))
    assert sl.DEADLINE_CLASSES == jsl.DEADLINE_CLASSES


def test_executor_rejects_unknown_index_and_service_model_is_pure():
    with pytest.raises(TypeError):
        BucketExecutor(object(), LADDER)
    with pytest.raises(RuntimeError):
        BucketExecutor(IpNSW(device="cpu"), LADDER).dim()
    m = LinearServiceModel(base_s=1.0, per_row_s=0.1, per_ef_s=0.01, per_ef_row_s=0.001)
    b = Bucket(4, 16)
    assert m.service_s(b) == m.service_s(b) == 1.0 + 0.4 + 0.16 + 0.064
    jm = jsl.LinearServiceModel(base_s=1.0, per_row_s=0.1, per_ef_s=0.01, per_ef_row_s=0.001)
    assert m.service_s(b) == jm.service_s(jsl.Bucket(4, 16))


# ------------------------------------------------------------------ the CLI


def test_serve_loop_cli_on_cpu(capsys):
    from repro_torch.launch import serve

    beam_step.launches = beam_step.launches_live = 0
    beam_walk.launches = beam_walk.launches_live = beam_walk.steps = 0
    res = serve.main(["--loop", "--index", "ipnsw", "--n-items", "800", "--dim", "16",
                      "--requests", "48", "--batch", "16", "--ef", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve --loop] index=ipnsw storage=f32 clock=virtual N=800" in out
    assert "xla_compiles" not in out and "recompiles(warmup/steady)=6/0" in out
    s = res["summary"]
    assert s["served"] == 48 and s["recompiles_steady"] == 0 and res["recall"] > 0.8
    assert sum(len(b.rids) for b in res["batches"]) == 48
    res = serve.main(["--loop", "--n-items", "600", "--dim", "16", "--requests", "32",
                      "--batch", "16", "--ef", "32", "--device", "cpu", "--churn-trace", "0.1",
                      "--storage", "int8"])
    out = capsys.readouterr().out
    assert "[serve --loop] churn: events=" in out and "rejected=0" in out
    assert res["summary"]["mutation_events"] > 0 and res["summary"]["health_live_fraction"] > 0.9
    assert beam_step.launches == beam_step.launches_live == 0
    assert beam_walk.launches == beam_walk.launches_live == beam_walk.steps == 0
