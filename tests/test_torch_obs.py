"""The observability slice, port vs JAX: walk tracing (``obs/trace.py``
through ``beam_search``, ``IpNSW`` / ``IpNSWPlus`` / ``MutableIndex``
``search``), the metrics registry and its exports, the build's phase spans,
the serving loop's ``registry=`` / ``trace_ctx=`` and ``serve --trace /
--metrics-out``.

Two groups:
  * the JAX package's own pins (``tests/test_obs.py``) on the port, over a
    port build of its 2,000 x 24 lognormal catalog on the CPU;
  * the port against JAX on integer-valued items and queries (every dot
    product exact), over the JAX package's graphs carried across by
    ``repro_torch.convert``: trace context tables, traces (ids, step,
    band_hist, hub_evals, steps_to_converge and scores) bit for bit, and a
    virtual-clock loop's ``collect()``, ``events`` and Prometheus text
    equal, with churn and its health gauges too.
Tolerance: none -- everything compared here is equal.
"""
import dataclasses
import functools
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import IpNSW as JaxIpNSW
from repro.core import IpNSWPlus as JaxIpNSWPlus
from repro.core import MutableIndex as JaxMutableIndex
from repro.core import ChurnEvent as JaxChurnEvent
from repro.launch import serve_loop as jsl
from repro.obs import MetricsRegistry as JaxMetricsRegistry
from repro.obs import load_jsonl as jax_load_jsonl
from repro.obs import make_trace_context as jax_make_trace_context

from repro_torch.convert import ipnsw_from_arrays, ipnsw_plus_from_arrays, trace_context_from_arrays
from repro_torch.core import ChurnTrace, IpNSW, IpNSWPlus, MutableIndex
from repro_torch.data import mips_dataset, mips_queries
from repro_torch.kernels.gather_score import gather_score
from repro_torch.kernels.quant_score import quant_score
from repro_torch.launch import serve_loop as sl
from repro_torch.obs import (
    Histogram,
    MetricsRegistry,
    TraceContext,
    get_registry,
    load_jsonl,
    make_trace_context,
    set_registry,
    step_of_column,
    top_band_share,
    write_metrics,
)
from repro_torch.obs.report import report

from test_torch_build import _meta, one_torch_thread  # noqa: F401 -- an autouse fixture
from test_torch_capture import _meta_index, _walk_launches, counters, kernels_on_meta  # noqa: F401
from test_torch_mutation import D as ID, JAX_BACKENDS, N as IN, PARAMS as IPARAMS
from test_torch_mutation import _carry as _carry_mutable
from test_torch_mutation import _graph_arrays, _integer_items, _store

ROOT = Path(__file__).resolve().parents[1]

# the JAX tests' size: the norm-bias concentration shows (top decile ~0.87)
N, D, K = 2000, 24, 5
LADDER = dict(batches=(2, 4), efs=(8, 16))


# ------------------------------------------------------------------ fixtures


@functools.lru_cache(maxsize=None)
def _items():
    return mips_dataset(N, D, "lognormal", seed=3)


@functools.lru_cache(maxsize=None)
def _index():
    return IpNSW(max_degree=8, ef_construction=16, insert_batch=256, device="cpu").build(_items())


@functools.lru_cache(maxsize=None)
def _plus_index():
    return IpNSWPlus(max_degree=8, ef_construction=16, insert_batch=256,
                     device="cpu").build(_items())


@functools.lru_cache(maxsize=None)
def _ctx(trace_cap: int = 64, n_bands: int = 10):
    g = _index().graph
    return make_trace_context(np.linalg.norm(g.items.numpy(), axis=1), g.adj.numpy(),
                              trace_cap=trace_cap, n_bands=n_bands, device="cpu")


def _queries(b=8, seed=7):
    return torch.as_tensor(mips_queries(b, D, seed=seed))


# -------------------------------------- the JAX package's pins, on the port


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_trace_leaves_walk_bit_identical_ipnsw(storage):
    q = _queries()
    base = _index().search(q, k=K, ef=16, storage=storage)
    traced = _index().search(q, k=K, ef=16, storage=storage, trace=_ctx())
    assert base.trace is None and traced.trace is not None
    for field in ("ids", "scores", "evals", "visited"):
        assert torch.equal(getattr(base, field), getattr(traced, field)), field
    assert base.steps == traced.steps


def test_trace_leaves_walk_bit_identical_plus():
    q = _queries()
    base = _plus_index().search(q, k=K, ef=16)
    traced = _plus_index().search(q, k=K, ef=16, trace=_ctx())
    assert base.trace is None and traced.trace is not None
    for field in ("ids", "scores", "ip_evals", "ang_evals", "visited_ang", "visited_ip"):
        assert torch.equal(getattr(base, field), getattr(traced, field)), field
    assert torch.equal(traced.trace.band_hist.sum(1), traced.ip_evals)


def test_trace_context_size_mismatch_raises_before_any_work(monkeypatch):
    from repro_torch.core import search

    def no_work(*args, **kwargs):
        raise AssertionError("the search scored its seeds before the size check")

    index, wrong = _index(), make_trace_context(np.ones(N + 3, np.float32), device="cpu")
    monkeypatch.setattr(search, "gather_score", no_work)
    with pytest.raises(ValueError, match="trace context covers"):
        index.search(_queries(2), k=K, ef=16, trace=wrong)


def test_trace_shapes_and_step_map():
    b, cap, bands = 6, 32, 10
    r = _index().search(_queries(b), k=K, ef=16, trace=_ctx(trace_cap=cap, n_bands=bands))
    tr = r.trace
    assert tr.ids.shape == (b, cap) and tr.scores.shape == (b, cap)
    assert tr.step.shape == (cap,) and tr.step.device.type == "cpu"
    assert tr.band_hist.shape == (b, bands)
    assert tr.hub_evals.shape == (b,) and tr.steps_to_converge.shape == (b,)
    assert {t.dtype for t in (tr.ids, tr.step, tr.band_hist, tr.hub_evals,
                              tr.steps_to_converge)} == {torch.int32}
    step = tr.step.numpy()
    assert step[0] == 0 and (np.diff(step) >= 0).all()
    assert torch.equal(tr.ids, r.visited[:, :cap])
    pads = tr.ids.numpy() < 0
    assert np.isneginf(tr.scores.numpy()[pads]).all()
    assert np.isfinite(tr.scores.numpy()[~pads]).all()


def test_trace_cap_truncates_and_caps_at_buffer():
    assert _index().search(_queries(4), k=K, ef=16, trace=_ctx(trace_cap=8)).trace.ids.shape[1] == 8
    r = _index().search(_queries(4), k=K, ef=16, trace=_ctx(trace_cap=10_000))
    assert r.trace.ids.shape[1] == r.visited.shape[1] < 10_000
    assert torch.equal(r.trace.ids, r.visited)


def test_step_of_column_map():
    np.testing.assert_array_equal(step_of_column(1 + 3 * 4, seeds=1, degree=4),
                                  [0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3])


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_band_hist_sums_to_evals(storage):
    r = _index().search(_queries(), k=K, ef=16, storage=storage, trace=_ctx())
    tr = r.trace
    assert torch.equal(tr.band_hist.sum(dim=1), r.evals)
    assert (tr.hub_evals <= r.evals).all()
    assert (tr.steps_to_converge >= 1).all() and (tr.steps_to_converge <= int(r.steps)).all()
    # band_hist is a host bincount of the visited ids' bands, row by row
    bands = _ctx().band_ids.numpy()
    for row, vis in zip(tr.band_hist.numpy(), r.visited.numpy()):
        assert np.array_equal(row, np.bincount(bands[vis[vis >= 0]], minlength=10))


def test_padded_rows_trace_as_zero():
    valid = torch.tensor([True, True, False, False])
    r = _index().search(_queries(4), k=K, ef=16, valid=valid, trace=_ctx())
    band = r.trace.band_hist.numpy()
    assert band[2:].sum() == 0 and band[:2].sum() > 0
    assert (r.trace.ids.numpy()[2:] == -1).all()
    assert (r.trace.hub_evals.numpy()[2:] == 0).all()
    assert (r.trace.steps_to_converge.numpy()[2:] == 0).all()


def test_lognormal_top_decile_gets_majority_of_evals():
    """The paper's Fig-5 norm-bias claim: on a heavy-tailed catalog the top
    norm decile receives over half of all similarity evaluations."""
    r = _index().search(_queries(16, seed=11), k=K, ef=16, trace=_ctx())
    share = top_band_share(r.trace.band_hist.sum(dim=0).numpy())
    assert share > 0.5, f"top-decile share {share:.3f} <= 0.5"


def test_make_trace_context_validation_and_clipping():
    with pytest.raises(ValueError, match="size"):
        make_trace_context(np.ones(10, np.float32), size=11, device="cpu")
    with pytest.raises(ValueError, match="trace_cap"):
        make_trace_context(np.ones(10, np.float32), trace_cap=0, device="cpu")
    norms = np.concatenate([np.linspace(1, 2, 100), [0.0, 99.0]])
    ctx = make_trace_context(norms.astype(np.float32), size=100, device="cpu")
    ids = ctx.band_ids.numpy()
    assert ids[100] == 0 and ids[101] == 9
    moved = ctx.to("meta")
    assert all(t.device.type == "meta" for t in moved.tensors())
    assert (moved.trace_cap, moved.n_bands) == (ctx.trace_cap, ctx.n_bands)


def test_registry_get_or_create_and_type_drift():
    reg = MetricsRegistry()
    c = reg.counter("x_total")
    assert reg.counter("x_total") is c
    c.inc(2)
    assert reg.get("x_total").value == 2
    with pytest.raises(TypeError, match="x_total"):
        reg.gauge("x_total")
    with pytest.raises(ValueError):
        c.inc(-1)
    vec = reg.vector("by_band", 4, label="band")
    vec.add([1, 2, 3, 4])
    with pytest.raises(ValueError):
        vec.add([1, 2])
    h = reg.histogram("lat_seconds", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(5.0)
    assert h.count == 2 and h.counts == [1, 0, 1]


def _fill(mod):
    """The same records into a registry of ``mod`` (the port's or JAX's)."""
    reg = mod()
    reg.counter("req_total", "requests").inc(3)
    reg.gauge("debt").set(0.5)
    h = reg.histogram("lat_seconds", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    reg.vector("by_band", 2, label="band").add([1, 2])
    reg.event("response", 1.25, rid=0, latency_s=0.01)
    return reg


def test_registry_prometheus_text():
    text = _fill(MetricsRegistry).to_prometheus()
    assert "# TYPE req_total counter\nreq_total 3" in text
    assert "debt 0.5" in text
    assert 'lat_seconds_bucket{le="0.1"} 1' in text
    assert 'lat_seconds_bucket{le="+Inf"} 2' in text
    assert "lat_seconds_count 2" in text
    assert 'by_band{band="1"} 2' in text
    assert text == _fill(JaxMetricsRegistry).to_prometheus()


def test_registry_jsonl_roundtrip(tmp_path):
    reg = MetricsRegistry()
    reg.counter("a_total").inc(7)
    reg.histogram("h_seconds", buckets=(1.0,)).observe(0.5)
    reg.event("response", 1.25, rid=0, latency_s=0.01)
    path = str(tmp_path / "run.jsonl")
    assert write_metrics(reg, path, meta={"mode": "test"}) == "jsonl"
    snap = load_jsonl(path)
    assert snap["meta"]["mode"] == "test"
    assert snap["metrics"]["a_total"]["value"] == 7
    assert snap["metrics"]["h_seconds"]["count"] == 1
    assert snap["events"] == [{"event": "response", "t": 1.25, "rid": 0, "latency_s": 0.01}]
    prom = str(tmp_path / "run.prom")
    assert write_metrics(reg, prom) == "prometheus"
    assert "a_total 7" in open(prom).read()


def test_registry_span_and_global_swap():
    reg = MetricsRegistry()
    prev = set_registry(reg)
    try:
        with get_registry().span("phase"):
            pass
        assert reg.get("phase_seconds").count == 1
    finally:
        set_registry(prev)


@pytest.mark.parametrize("driver", ["host", "scan"])
def test_build_emits_phase_spans(driver):
    reg = MetricsRegistry()
    prev = set_registry(reg)
    try:
        IpNSW(max_degree=8, ef_construction=16, insert_batch=128, build_backend=driver,
              device="cpu").build(_items()[:300])
    finally:
        set_registry(prev)
    assert reg.get("build_bootstrap_seconds").count == 1
    assert reg.get("build_insert_seconds").count == 1


def test_observe_many_and_event_blocks_equal_one_at_a_time():
    """The batched records the loop makes equal the one-at-a-time ones:
    bucket edges, NaN, +-inf and sums whose order matters included."""
    rng = np.random.default_rng(0)
    values = np.concatenate([rng.exponential(0.01, 300), [1e-4, 2.5e-4, 10.0, 10.5, -1.0,
                                                          1e16, 1e-17, -1e16]])
    one, many = Histogram("a_seconds"), Histogram("a_seconds")
    for chunk in np.array_split(values, 7):
        for v in chunk:
            one.observe(v)
        many.observe_many(chunk)
    many.observe_many([])
    assert one.collect() == many.collect()
    odd_one, odd_many = Histogram("n"), Histogram("n")
    for v in (np.nan, np.inf, -np.inf):
        odd_one.observe(v)
    odd_many.observe_many([np.nan, np.inf, -np.inf])
    assert odd_one.counts == odd_many.counts and odd_one.count == odd_many.count == 3
    assert np.isnan(odd_one.sum) and np.isnan(odd_many.sum)
    a, b = MetricsRegistry(), MetricsRegistry()

    class Block:
        def dicts(self):
            return [{"event": "response", "t": 2.5, "rid": i} for i in range(3)]

    for i in range(3):
        a.event("response", 2.5, rid=i)
    a.event("dispatch", 2.0, n=3)
    b.event_block(Block())
    b.event("dispatch", 2.0, n=3)
    assert a.events == b.events and b.events is b.events  # built once, then kept


def _serve_once(registry, trace_ctx, n_requests=48):
    queries = mips_queries(n_requests, D, seed=5)
    trace = sl.poisson_trace(queries, rate_qps=400.0, seed=0, ef=16,
                             classes=("interactive", "standard", "relaxed"))
    loop = sl.ServeLoop(_index(), ladder=sl.BucketLadder(**LADDER), clock=sl.VirtualClock(),
                        k=K, service_model=sl.LinearServiceModel(), registry=registry,
                        trace_ctx=trace_ctx)
    return loop.run(trace)


@functools.lru_cache(maxsize=None)
def _served():
    """One traced, recorded loop run (the registry and its stats)."""
    reg = MetricsRegistry()
    return reg, _serve_once(reg, _ctx())


def test_serve_loop_traced_keeps_zero_steady_recompiles():
    reg, stats = _served()
    s = stats.summary()
    assert s["served"] == 48 and s["recompiles_steady"] == 0
    assert reg.get("serve_recompiles_steady").value == 0
    assert reg.get("serve_requests_total").value == 48
    assert reg.get("serve_batches_total").value == s["batches"]
    band = reg.get("walk_evals_by_band").values
    assert band.sum() == reg.get("walk_evals_total").value > 0
    assert reg.get("walk_hub_evals_total").value > 0
    assert reg.get("serve_latency_seconds").count == 48
    assert top_band_share(band) > 0.5
    # the untraced loop schedules the same: p50 is the service model's
    assert _serve_once(None, None).percentile_ms(50) == stats.percentile_ms(50)


def test_serve_loop_registry_is_deterministic():
    reg = MetricsRegistry()
    _serve_once(reg, _ctx())
    first, _ = _served()
    assert reg.collect() == first.collect()
    assert reg.events == first.events


def test_obs_report_renders_exported_jsonl(tmp_path):
    """A traced serve run's JSONL alone gives the norm-bias concentration
    through ``python -m repro_torch.obs.report``."""
    reg, _ = _served()
    path = str(tmp_path / "serve.jsonl")
    write_metrics(reg, path, meta={"mode": "loop", "profile": "lognormal"})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.obs.report", path, "--bins", "4"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "evals by catalog norm band" in res.stdout and "latency timeline" in res.stdout
    share = float([ln for ln in res.stdout.splitlines()
                   if ln.startswith("top_decile_share=")][0].split("=")[1])
    assert share > 0.5


def test_report_function_summary(tmp_path):
    reg, _ = _served()
    path = str(tmp_path / "serve.jsonl")
    write_metrics(reg, path)
    summary = report(path, out=io.StringIO())
    assert summary["top_decile_share"] > 0.5
    assert summary["serve_requests_total"] == 48
    assert 0.0 < summary["hub_eval_share"] < 1.0


def test_executor_trace_tables_are_operands():
    """A bucket's program reads the trace context's tables by address:
    replacing one after warmup raises, as a replaced graph does."""
    ex = sl.BucketExecutor(_index(), sl.BucketLadder(batches=(2,), efs=(8,)), k=K,
                           trace_ctx=_ctx().to("cpu"))
    ex.warmup()
    q, v = np.zeros((2, D), np.float32), np.ones(2, bool)
    ex.run(sl.Bucket(2, 8), q, v)
    assert ex.last_walk["n"] == 2 and ex.last_walk["band_hist"].shape == (10,)
    ex.trace_ctx.hub_mask = ex.trace_ctx.hub_mask.clone()
    with pytest.raises(RuntimeError, match="trace table"):
        ex.run(sl.Bucket(2, 8), q, v)


@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("kind", ["ipnsw", "ipnsw_plus"])
def test_traced_bucket_program_has_static_shapes_on_meta(kind, storage, counters):
    """The traced program a bucket captures, at the full-size loop's 256 x
    40 bucket over 136,736 x 300 items: the packed output gains n_bands + 2
    columns, nothing is read back, and the trace scores its prefix with the
    walk's own scorer (one launch more)."""
    n, d, b, k = 136_736, 300, 256, 10
    idx = _meta_index(kind, storage, n, d)
    ctx = TraceContext(_meta(n, dtype=torch.int32), _meta(n, dtype=torch.bool), _meta(11),
                       trace_cap=128, n_bands=10)
    ex = sl.BucketExecutor(idx, sl.BucketLadder(batches=(64, b), efs=(10, 20, 40)), k=k,
                           trace_ctx=ctx)
    consts = ((idx.graph, idx.store, None) if kind == "ipnsw" else
              (idx.ang_graph, idx.ip_graph, idx.ang_store, idx.ip_store, None))
    out = ex._body(sl.Bucket(b, 40), consts)(_meta(b, d), _meta(b, dtype=torch.bool))
    assert out.device.type == "meta" and out.shape == (b, 2 * k + 1 + 12)
    assert out.dtype == torch.int32
    walks = 1 if kind == "ipnsw" else 2
    assert sum(_walk_launches().values()) == walks
    assert (gather_score.launches, quant_score.launches) == (
        (walks + 1, 0) if storage == "f32" else (walks, walks + 1))


# --------------------------------------------------- the port against JAX


def _jax_pair(kind, storage="f32", seed=7):
    """A JAX index over integer items and the port's over its graphs."""
    cls = JaxIpNSW if kind == "ipnsw" else JaxIpNSWPlus
    j = cls(storage=storage, **IPARAMS, **JAX_BACKENDS).build(jnp.asarray(_integer_items(IN, seed)))
    if kind == "ipnsw":
        t = ipnsw_from_arrays(**_graph_arrays(j.graph), store=_store(j.store), device="cpu",
                              storage=storage, **IPARAMS)
    else:
        t = ipnsw_plus_from_arrays(_graph_arrays(j.ang_graph), _graph_arrays(j.ip_graph),
                                   ang_store=_store(j.ang_store), ip_store=_store(j.ip_store),
                                   device="cpu", storage=storage, **IPARAMS)
    return j, t


_jax_pair = functools.lru_cache(maxsize=None)(_jax_pair)


def _carry_ctx(jctx):
    return trace_context_from_arrays(np.asarray(jctx.band_ids), np.asarray(jctx.hub_mask),
                                     np.asarray(jctx.band_edges), trace_cap=jctx.trace_cap,
                                     n_bands=jctx.n_bands, device="cpu")


def _ctx_pair(jidx, size=None, trace_cap=40, **kw):
    g = jidx.ip_graph if isinstance(jidx, JaxIpNSWPlus) else jidx.graph
    norms = np.linalg.norm(np.asarray(g.items), axis=1)
    j = jax_make_trace_context(norms, np.asarray(g.adj), size=size, trace_cap=trace_cap, **kw)
    t = make_trace_context(norms, np.asarray(g.adj), size=size, trace_cap=trace_cap,
                           device="cpu", **kw)
    return j, t


@pytest.mark.parametrize("kw", [{}, {"size": 250, "n_bands": 7, "hub_frac": 0.05}],
                         ids=["default", "size"])
def test_make_trace_context_tables_equal_jax(kw):
    jctx, tctx = _ctx_pair(_jax_pair("ipnsw")[0], **kw)
    for name in ("band_ids", "hub_mask", "band_edges"):
        got, want = getattr(tctx, name).numpy(), np.asarray(getattr(jctx, name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert (tctx.trace_cap, tctx.n_bands) == (jctx.trace_cap, jctx.n_bands)
    assert tctx.hub_mask.sum() > 0
    carried = _carry_ctx(jctx)
    assert all(torch.equal(a, b) for a, b in zip(carried.tensors(), tctx.tensors()))


TRACE_CASES = {
    "f32": ("ipnsw", "f32", False, False),
    "int8": ("ipnsw", "int8", False, False),
    "live": ("ipnsw", "f32", True, False),
    "int8_live_valid": ("ipnsw", "int8", True, True),
    "valid": ("ipnsw", "f32", False, True),
    "plus": ("ipnsw_plus", "f32", False, False),
    "plus_int8_valid": ("ipnsw_plus", "int8", False, True),
}


@pytest.mark.parametrize("case", list(TRACE_CASES))
def test_trace_equals_jax(case):
    """The same integer queries through both packages over the same graph
    and trace tables: every trace field equal, scores included."""
    kind, storage, live, pad = TRACE_CASES[case]
    jidx, tidx = _jax_pair(kind, storage)
    jctx, _ = _ctx_pair(jidx)
    tctx = _carry_ctx(jctx)
    q = _integer_items(6, 31)
    kw = dict(k=K, ef=16)
    jkw, tkw = dict(kw), dict(kw)
    if live:
        mask = np.arange(IN) % 4 != 1
        jkw["live"], tkw["live"] = jnp.asarray(mask), torch.from_numpy(mask)
    if pad:
        valid = np.array([True, False, True, True, False, True])
        jkw["valid"], tkw["valid"] = jnp.asarray(valid), torch.from_numpy(valid)
    j = jidx.search(jnp.asarray(q), trace=jctx, **jkw)
    t = tidx.search(torch.from_numpy(q), trace=tctx, **tkw)
    base = tidx.search(torch.from_numpy(q), **tkw)
    assert np.array_equal(t.ids.numpy(), np.asarray(j.ids))
    assert torch.equal(t.ids, base.ids) and torch.equal(t.scores, base.scores)
    for field in ("ids", "scores", "step", "band_hist", "hub_evals", "steps_to_converge"):
        got, want = getattr(t.trace, field).numpy(), np.asarray(getattr(j.trace, field))
        assert got.dtype == want.dtype and np.array_equal(got, want), field
    assert t.trace.band_hist.sum() > 0 and t.trace.hub_evals.sum() > 0


def test_mutable_search_carries_a_capacity_sized_trace():
    """``MutableIndex.search`` passes ``trace`` through with its live mask,
    over a context the size of its capacity; a catalog-sized one raises."""
    _, tidx = _jax_pair("ipnsw")
    m = MutableIndex(dataclasses.replace(tidx), capacity=IN + 20)
    m.delete(np.arange(0, IN, 7))
    ctx = make_trace_context(m.norms.numpy(), m.graph.adj.numpy(), size=IN, device="cpu")
    q = torch.from_numpy(_integer_items(4, 33))
    r = m.search(q, k=K, ef=16, trace=ctx)
    assert r.trace.band_hist.shape == (4, 10)
    assert torch.equal(r.trace.band_hist.sum(1), r.evals)
    assert torch.equal(r.ids, m.search(q, k=K, ef=16).ids)
    with pytest.raises(ValueError, match="trace context covers"):
        m.search(q, k=K, ef=16, trace=_ctx_pair(_jax_pair("ipnsw")[0])[1])


J_MODEL = dict(base_s=0.001, per_row_s=0.0, per_ef_s=0.001, per_ef_row_s=0.0)


def _assert_registries_equal(treg, jreg):
    assert treg.collect() == jreg.collect()
    assert treg.events == jreg.events
    assert treg.to_prometheus() == jreg.to_prometheus()


@functools.lru_cache(maxsize=None)
def _loops_against_jax():
    """A traced, recorded virtual-clock loop of integer queries through both
    packages over the same int8 graph and trace tables."""
    jidx, tidx = _jax_pair("ipnsw", "int8")
    jctx, _ = _ctx_pair(jidx)
    reqs = sl.poisson_trace(_integer_items(24, 17), rate_qps=400.0, seed=5, ef=16,
                            classes=("interactive", "standard", "relaxed"))
    jreqs = [jsl.Request(rid=r.rid, query=r.query, arrival_t=r.arrival_t,
                         deadline_t=r.deadline_t, ef=r.ef, klass=r.klass) for r in reqs]
    jreg, treg = JaxMetricsRegistry(), MetricsRegistry()
    jstats = jsl.ServeLoop(jidx, ladder=jsl.BucketLadder(**LADDER), clock=jsl.VirtualClock(),
                           k=K, service_model=jsl.LinearServiceModel(**J_MODEL),
                           registry=jreg, trace_ctx=jctx).run(jreqs)
    tstats = sl.ServeLoop(tidx, ladder=sl.BucketLadder(**LADDER), clock=sl.VirtualClock(), k=K,
                          service_model=sl.LinearServiceModel(**J_MODEL), registry=treg,
                          trace_ctx=_carry_ctx(jctx)).run(reqs)
    return jreg, treg, jstats, tstats


def test_serve_loop_registry_equals_jax():
    jreg, treg, jstats, tstats = _loops_against_jax()
    assert tstats.summary() == jstats.summary()
    assert any(e["event"] == "dispatch" and sum(e["band_hist"]) > 0 for e in treg.events)
    assert sum(e["event"] == "response" for e in treg.events) == 24
    _assert_registries_equal(treg, jreg)


def test_churn_loop_registry_and_health_equal_jax():
    """A churn trace (deletes, integer upserts, a hub kill, relinks) between
    traced dispatches: the churn counter and events, the health gauges and
    the walk aggregates over the capacity-sized context equal JAX's."""
    jidx = JaxIpNSW(storage="int8", **IPARAMS, **JAX_BACKENDS).build(
        jnp.asarray(_integer_items(IN, 16)))
    jm = JaxMutableIndex(jidx, capacity=IN + 64, mutation_batch=16)
    tm = _carry_mutable(jm)
    jctx = jax_make_trace_context(np.asarray(jm.norms), np.asarray(jm.graph.adj), size=IN,
                                  trace_cap=40)
    reqs = sl.poisson_trace(_integer_items(24, 17), rate_qps=400.0, seed=5, ef=16,
                            classes=("interactive", "standard", "relaxed"))
    dur = max(r.arrival_t for r in reqs)
    trace = ChurnTrace.generate(n_items=IN, dim=ID, duration_s=dur, turnover=0.2, batch=16,
                                seed=2, hub_kill_at=dur / 2, hub_kill_k=4, relink_every=dur / 3,
                                relink_budget=32)
    events = [e if e.items is None else dataclasses.replace(e, items=_integer_items(16, i))
              for i, e in enumerate(trace.events)]
    jevents = [JaxChurnEvent(t=e.t, kind=e.kind, items=e.items, count=e.count, seed=e.seed)
               for e in events]
    jreqs = [jsl.Request(rid=r.rid, query=r.query, arrival_t=r.arrival_t,
                         deadline_t=r.deadline_t, ef=r.ef, klass=r.klass) for r in reqs]
    jreg, treg = JaxMetricsRegistry(), MetricsRegistry()
    jsl.ServeLoop(jm, ladder=jsl.BucketLadder(**LADDER), clock=jsl.VirtualClock(), k=K,
                  service_model=jsl.LinearServiceModel(**J_MODEL), registry=jreg,
                  trace_ctx=jctx).run(jreqs, churn=jevents)
    sl.ServeLoop(tm, ladder=sl.BucketLadder(**LADDER), clock=sl.VirtualClock(), k=K,
                 service_model=sl.LinearServiceModel(**J_MODEL), registry=treg,
                 trace_ctx=_carry_ctx(jctx)).run(reqs, churn=events)
    assert treg.get("index_churn_events_total").value == len(events)
    assert {m["name"] for m in treg.collect()} >= {"index_relink_debt", "index_live_fraction"}
    _assert_registries_equal(treg, jreg)


def _jax_report_tool():
    path = ROOT / "scripts" / "obs_report.py"
    spec = importlib.util.spec_from_file_location("obs_report", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_jsonl_reads_and_reports_as_jax(tmp_path):
    """The port's JSONL export of the loop above is the JAX package's byte
    for byte; JAX's ``load_jsonl`` reads it, and its ``obs_report.report``
    prints what the port's prints and returns the same summary."""
    jreg, treg, _, _ = _loops_against_jax()
    meta = {"mode": "loop", "band_edges": [0.5, 1.0, 2.0]}
    tpath, jpath = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    write_metrics(treg, tpath, meta=meta)
    jreg.export_jsonl(jpath, meta=meta)
    assert open(tpath).read() == open(jpath).read()
    assert jax_load_jsonl(tpath) == load_jsonl(tpath)
    tout, jout = io.StringIO(), io.StringIO()
    assert report(tpath, out=tout) == _jax_report_tool().report(tpath, out=jout)
    assert tout.getvalue() == jout.getvalue()


# ------------------------------------------------------------------ the CLI


def test_serve_cli_trace_and_metrics_out(tmp_path, capsys):
    from repro_torch.launch import serve

    path = str(tmp_path / "run.jsonl")
    res = serve.main(["--loop", "--index", "ipnsw", "--n-items", "600", "--dim", "16",
                      "--requests", "32", "--batch", "16", "--ef", "32", "--device", "cpu",
                      "--trace", "--metrics-out", path])
    out = capsys.readouterr().out
    assert "evals by catalog norm band" in out and f"-> {path}" in out
    snap = load_jsonl(path)
    assert snap["meta"]["tool"] == "repro_torch.launch.serve" and snap["meta"]["traced"]
    assert len(snap["meta"]["band_edges"]) == 11
    assert sum(e["event"] == "response" for e in snap["events"]) == 32
    assert snap["metrics"]["walk_evals_total"]["value"] > 0
    assert res["registry"].get("serve_requests_total").value == 32
    summary = report(path, out=io.StringIO())
    assert summary["serve_requests_total"] == 32 and summary["top_decile_share"] > 0
    reg = MetricsRegistry()
    prev = set_registry(reg)
    try:
        prom = str(tmp_path / "one.prom")
        serve.main(["--index", "ipnsw_plus", "--n-items", "400", "--dim", "16", "--batch", "8",
                    "--device", "cpu", "--trace", "--metrics-out", prom])
    finally:
        set_registry(prev)
    text = open(prom).read()
    assert 'walk_evals_by_band{band="9"}' in text and "walk_hub_evals_total" in text
    with pytest.raises(SystemExit, match="graph index"):
        serve.main(["--index", "bruteforce", "--trace", "--device", "cpu"])
