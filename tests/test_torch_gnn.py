"""The port's MeshGraphNet, its fanout sampler, its cells and the train
launcher's GNN branch against the JAX package's, on the CPU: the same
seeded numpy inputs, JAX's initial values carried across
(``convert.params_from_arrays``).

Tolerances: the sampler is bit for bit.  An MLP block, an aggregate and
a processor layer within 1e-6 of the largest |value| (one fp32 op order
against another).  The forward within 1e-5 of its largest |value|, the
loss within 1e-5 relative, each gradient leaf within 1e-5 of its largest
(measured 1.2e-6, 1e-7 and 7e-7 at 15 layers of d 128).  The chunked
forward within 1e-5 of the forward (only the order of a segment sum
moves); remat on and off bit for bit.  A cell's train step as the recsys
cells' (tests/test_torch_recsys.py); the launcher's losses within 1e-4
relative, as the LM launcher's."""
import dataclasses
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jax_train_launcher
from repro.configs import get_arch as jax_get_arch
from repro.launch.mesh import make_mesh_compat
from repro.models import gnn as J
from repro.models import sampler as jax_sampler
from repro.train import adamw_init as jax_adamw_init
from repro.train import adamw_update as jax_adamw_update
from repro.train import checkpoint as jax_ckpt
from repro.train.optimizer import AdamWState as JaxAdamWState
from repro_torch.configs import ARCH_IDS, PORTED_ARCH_IDS, all_cells, get_arch
from repro_torch.configs.common import GNN_SHAPES
from repro_torch.convert import adamw_from_arrays, params_from_arrays
from repro_torch.launch import train as train_launcher
from repro_torch.models import gnn as T
from repro_torch.models import sampler
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import value_and_grad
from repro_torch.train.tree import named_leaves
from test_torch_build import one_torch_thread  # noqa: F401 -- an autouse fixture

OUT_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
BLOCK_RTOL = 1e-6
LAUNCHER_RTOL = 1e-4

J_VALUE_AND_GRAD = jax.jit(jax.value_and_grad(J.mse_loss), static_argnums=(2,))
J_FORWARD = jax.jit(J.forward, static_argnums=(2,))
J_INIT = jax.jit(J._init_params, static_argnums=(1,))  # J.init's params


def _t(tree):
    return params_from_arrays(jax.tree.map(np.asarray, tree), device="cpu")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _within(got, want, rtol, what):
    """max |got - want| <= rtol * max |want|, the non-finite entries equal."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=what)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)
    if fin.any():
        err, scale = np.abs(got[fin] - want[fin]).max(), np.abs(want[fin]).max()
        assert err <= rtol * scale, f"{what}: {err / max(scale, 1e-30):.3g} of the largest"


def _jax_named(tree):
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in paths}


def _assert_grads(got, want_jax, rtol, what):
    want = _jax_named(want_jax)
    got = dict(named_leaves(got))
    assert list(got) == list(want), f"{what}: leaf names differ"
    for name in want:
        _within(got[name], want[name], rtol, f"{what} {name}")


def _cfgs(n_layers=3, d_hidden=32, d_feat=12, aggregator="sum", remat=True):
    kw = dict(n_layers=n_layers, d_hidden=d_hidden, d_feat=d_feat, d_edge=4,
              aggregator=aggregator, remat=remat)
    return J.GNNConfig(**kw), T.GNNConfig(**kw)


def _graph(rng, n, e, d_feat, src_pad=0, dst_pad=0, every_node_a_dst=False):
    """A seeded numpy graph; the last ``src_pad`` sources and ``dst_pad``
    destinations are -1 padding."""
    dst = rng.integers(0, n, e).astype(np.int32)
    if every_node_a_dst:
        dst[:n] = np.arange(n)
    g = dict(node_feat=rng.normal(size=(n, d_feat)).astype(np.float32),
             edge_feat=rng.normal(size=(e, 4)).astype(np.float32),
             src=rng.integers(0, n, e).astype(np.int32), dst=dst,
             targets=rng.normal(size=(n, 3)).astype(np.float32))
    if src_pad:
        g["src"][-src_pad:] = -1
    if dst_pad:
        g["dst"][-dst_pad:] = -1
    return g


def _tg(g):
    return {k: torch.as_tensor(v) for k, v in g.items()}


def _jg(g):
    return jax.tree.map(jnp.asarray, g)


# -------------------------------------------------------------------- sampler


@pytest.mark.parametrize("seed,n,degree", [(0, 500, 6), (3, 2_000, 20), (7, 64, 1)])
def test_random_csr_is_jax_bit_for_bit(seed, n, degree):
    got = sampler.random_csr(n, degree, np.random.default_rng(seed))
    want = jax_sampler.random_csr(n, degree, np.random.default_rng(seed))
    for field in ("indptr", "indices"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
        assert getattr(got, field).dtype == getattr(want, field).dtype
    assert got.n_nodes == want.n_nodes == n


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("seed,fanouts", [(0, (4, 3)), (5, (15, 10)), (9, (2, 2, 2))])
def test_sample_subgraph_is_jax_bit_for_bit(seed, fanouts, padded):
    """Both samplers draw from one generator each, seeded alike; after the
    call the generators stand at the same state."""
    rngs = [np.random.default_rng(seed), np.random.default_rng(seed)]
    csrs = [mod.random_csr(600, 8, r) for mod, r in zip((sampler, jax_sampler), rngs)]
    seeds = [r.integers(0, 600, 8) for r in rngs]
    pad_to = sampler.fanout_budget(8, fanouts) if padded else None
    got = sampler.sample_subgraph(csrs[0], seeds[0], fanouts, rngs[0], pad_to=pad_to)
    want = jax_sampler.sample_subgraph(csrs[1], seeds[1], fanouts, rngs[1], pad_to=pad_to)
    assert got.keys() == want.keys()
    for k in ("node_ids", "src", "dst"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    assert (got["n_nodes"], got["n_edges"]) == (want["n_nodes"], want["n_edges"])
    if padded:
        assert (len(got["node_ids"]), len(got["src"])) == pad_to
        assert (got["src"][got["n_edges"]:] == -1).all()
    assert rngs[0].integers(0, 1 << 30) == rngs[1].integers(0, 1 << 30)


@pytest.mark.parametrize("batch,fanouts", [(8, (4, 3)), (1_024, (15, 10)), (3, ())])
def test_fanout_budget_is_jax(batch, fanouts):
    assert sampler.fanout_budget(batch, fanouts) == jax_sampler.fanout_budget(batch, fanouts)
    if (batch, fanouts) == (1_024, (15, 10)):  # minibatch_lg's shape
        sh = GNN_SHAPES["minibatch_lg"]
        assert sampler.fanout_budget(batch, fanouts) == (sh["n_nodes"], sh["n_edges"])


# ------------------------------------------------------------ layers
# (the JAX functions eager on the CPU, as tests/test_arch_smoke.py runs them)


@pytest.mark.parametrize("ln", [True, False])
def test_mlp_ln_matches_jax(ln):
    p = J._mlp_ln_init(jax.random.PRNGKey(2), 24, 32, 16, 2, jnp.float32, ln=ln)
    x = np.random.default_rng(2).normal(size=(50, 24)).astype(np.float32)
    _within(T._mlp_ln(_t(p), torch.as_tensor(x)), J._mlp_ln(p, jnp.asarray(x)), BLOCK_RTOL,
            "mlp_ln")


@pytest.mark.parametrize("aggregator", ["sum", "max"])
def test_aggregate_matches_jax(aggregator):
    """-1 padding goes to the dropped dummy segment; empty segments are 0
    (sum) or -inf (max, as jax.ops.segment_max); the gradient of the
    finite entries equals jax.vjp's."""
    rng = np.random.default_rng(3)
    n = 12
    e = rng.normal(size=(40, 5)).astype(np.float32)
    dst = rng.integers(0, n - 3, 40).astype(np.int32)  # nodes 9-11 receive nothing
    dst[-6:] = -1
    ct = rng.normal(size=(n, 5)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: J._aggregate(x, jnp.asarray(dst), n, aggregator),
                        jnp.asarray(e))
    want = np.asarray(want)
    ct = np.where(np.isfinite(want), ct, 0).astype(np.float32)
    te = torch.tensor(e, requires_grad=True)
    got = T._aggregate(te, torch.as_tensor(dst), n, aggregator)
    _within(got, want, BLOCK_RTOL, f"{aggregator} aggregate")
    assert np.isfinite(want[:9]).all()
    assert (want[9:] == (0.0 if aggregator == "sum" else -np.inf)).all()
    got.backward(torch.as_tensor(ct))
    _within(te.grad, vjp(jnp.asarray(ct))[0], BLOCK_RTOL, f"{aggregator} aggregate gradient")


def test_segment_max_splits_the_gradient_among_ties():
    """Two tied maxima each take half the cotangent (jax 0.9.0's
    segment_max), the other entries none."""
    e = np.array([[1.0, 2.0], [3.0, 0.0], [3.0, 2.0], [5.0, 5.0]], np.float32)
    dst = np.array([0, 0, 0, -1], np.int32)
    ct = np.array([[1.0, 1.0], [0.0, 0.0], [0.0, 0.0]], np.float32)
    _, vjp = jax.vjp(lambda x: J._aggregate(x, jnp.asarray(dst), 3, "max"), jnp.asarray(e))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    te = torch.tensor(e, requires_grad=True)
    T._aggregate(te, torch.as_tensor(dst), 3, "max").backward(torch.as_tensor(ct))
    np.testing.assert_array_equal(te.grad.numpy(), want)
    np.testing.assert_array_equal(want, [[0.0, 0.5], [0.5, 0.0], [0.5, 0.5], [0.0, 0.0]])


@pytest.mark.parametrize("aggregator", ["sum", "max"])
def test_proc_layer_local_matches_jax(aggregator):
    """Padding by src zeroes an edge's new state, padding by dst routes it
    to the dummy segment: both as written in JAX."""
    jcfg, _ = _cfgs(n_layers=1)
    jp = J_INIT(jax.random.PRNGKey(4), jcfg)
    lp = jax.tree.map(lambda x: x[0], jp["proc"])
    rng = np.random.default_rng(4)
    hn = rng.normal(size=(20, 32)).astype(np.float32)
    e = rng.normal(size=(70, 32)).astype(np.float32)
    src = rng.integers(0, 20, 70).astype(np.int32)
    dst = rng.integers(0, 17, 70).astype(np.int32)
    src[-5:], dst[-9:-3] = -1, -1
    want = jax.jit(J._proc_layer_local, static_argnums=(5,))(
        lp, *map(jnp.asarray, (hn, e, src, dst)), aggregator)
    got = T._proc_layer_local(_t(lp), *map(torch.as_tensor, (hn, e, src, dst)), aggregator)
    for name, a, b in zip(("e_new", "agg"), got, want):
        _within(a, b, BLOCK_RTOL, f"{aggregator} {name}")
    assert (got[0][-5:] == 0).all()


# ------------------------------------------------------------ the model


@pytest.mark.parametrize("width", ["reduced", "full"])
def test_forward_loss_and_gradients_match_jax(width):
    """JAX's init carried across, the same graph with -1 padding: the
    forward, the loss and every gradient leaf (JAX with remat, the port
    with remat)."""
    if width == "reduced":
        jcfg, tcfg = _cfgs()
        g = _graph(np.random.default_rng(5), 40, 160, 12, src_pad=5, dst_pad=8)
    else:
        jcfg, tcfg = _cfgs(n_layers=15, d_hidden=128, d_feat=16)
        g = _graph(np.random.default_rng(6), 64, 256, 16, src_pad=7, dst_pad=3)
    jp = J_INIT(jax.random.PRNGKey(5), jcfg)
    jloss, jgrads = J_VALUE_AND_GRAD(jp, _jg(g), jcfg)
    tp = _t(jp)
    with torch.no_grad():
        _within(T.forward(tp, _tg(g), tcfg), J_FORWARD(jp, _jg(g), jcfg), OUT_RTOL, "forward")
    loss, grads = value_and_grad(T.mse_loss)(tp, _tg(g), tcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_grads(grads, jgrads, GRAD_RTOL, f"{width} grad")


def test_remat_on_and_off_agree_bit_for_bit():
    """remat only changes what the backward keeps: the loss and every
    gradient equal on the CPU, full width."""
    _, on = _cfgs(n_layers=15, d_hidden=128, d_feat=16, remat=True)
    off = dataclasses.replace(on, remat=False)
    params = T.init(on, torch.Generator().manual_seed(0), device="cpu")
    g = _tg(_graph(np.random.default_rng(7), 48, 200, 16, src_pad=4, dst_pad=4))
    (l1, g1), (l2, g2) = (value_and_grad(T.mse_loss)(params, g, c) for c in (on, off))
    assert torch.equal(l1, l2)
    for (name, a), (_, b) in zip(named_leaves(g1), named_leaves(g2)):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("aggregator", ["sum", "max"])
def test_forward_chunked_equals_forward(aggregator):
    """Edges and nodes in chunks of 7 rows (a ragged last chunk), the edge
    state in place: sum moves only the order of its segment sums; max is
    bit for bit.  Every node receives an edge (else max's -inf makes its
    row NaN in both)."""
    _, cfg = _cfgs(aggregator=aggregator)
    params = T.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    g = _tg(_graph(np.random.default_rng(8), 30, 100, 12, src_pad=6, dst_pad=5,
                   every_node_a_dst=True))
    with torch.no_grad():
        want = T.forward(params, g, cfg)
    got = T.forward_chunked(params, g, cfg, chunk=7)
    if aggregator == "max":
        assert torch.equal(got, want)
    else:
        _within(got, want, OUT_RTOL, "chunked forward")


def test_max_aggregator_forward_matches_jax_with_isolated_nodes():
    """With max, a node no edge reaches aggregates -inf, and its row (and
    every row it reaches later) is NaN in both packages at the same places
    (a property of the reference, kept)."""
    jcfg, tcfg = _cfgs(aggregator="max")
    jp = J_INIT(jax.random.PRNGKey(9), jcfg)
    g = _graph(np.random.default_rng(9), 40, 150, 12, src_pad=3, dst_pad=3)
    g["dst"][g["dst"] == 5] = 6  # node 5 receives nothing
    with torch.no_grad():
        got = T.forward(_t(jp), _tg(g), tcfg)
    want = J_FORWARD(jp, _jg(g), jcfg)
    assert np.isnan(np.asarray(want)[5]).all()
    _within(got, want, OUT_RTOL, "max forward")


def test_sampled_subgraph_forward_matches_jax():
    """tests/test_arch_smoke.py's minibatch_lg path: the fanout sampler
    feeds the same GNN in both packages."""
    rngs = [np.random.default_rng(0), np.random.default_rng(0)]
    budget = sampler.fanout_budget(8, (4, 3))
    subs = []
    for mod, rng in zip((sampler, jax_sampler), rngs):
        csr = mod.random_csr(500, 6, rng)
        subs.append(mod.sample_subgraph(csr, rng.integers(0, 500, 8), (4, 3), rng,
                                        pad_to=budget))
    jcfg = J.GNNConfig(n_layers=2, d_hidden=16, d_feat=8, d_edge=4)
    tcfg = T.GNNConfig(n_layers=2, d_hidden=16, d_feat=8, d_edge=4)
    jp = J_INIT(jax.random.PRNGKey(0), jcfg)
    n, rng = budget[0], rngs[0]
    g = dict(node_feat=rng.normal(size=(n, 8)).astype(np.float32),
             edge_feat=rng.normal(size=(budget[1], 4)).astype(np.float32),
             src=subs[0]["src"], dst=subs[0]["dst"],
             targets=rng.normal(size=(n, 3)).astype(np.float32))
    np.testing.assert_array_equal(subs[0]["src"], subs[1]["src"])
    with torch.no_grad():
        got = T.forward(_t(jp), _tg(g), tcfg)
    assert not torch.isnan(got).any()
    _within(got, J_FORWARD(jp, _jg(g), jcfg), OUT_RTOL, "sampled forward")


def test_init_matches_jax_tree():
    """The port's init has JAX's leaf names, shapes and dtypes (the
    processor stacked [n_layers, ...]), its weights JAX's scale."""
    jcfg, tcfg = _cfgs(n_layers=4, d_hidden=64, d_feat=40)
    want = _jax_named(J_INIT(jax.random.PRNGKey(0), jcfg))
    got = {k: v.numpy() for k, v in named_leaves(T.init(tcfg, torch.Generator().manual_seed(0),
                                                        device="cpu"))}
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    w = got["['proc']['edge']['w'][0]"]  # [4, 192, 64]: fan_in 192
    assert w.shape == (4, 192, 64) and abs(w.std() * 192**0.5 - 1) < 0.05


def test_forward_rejects_a_mesh():
    """forward and mse_loss take a DeviceMesh and raise TypeError, before any
    work, for anything else; forward_chunked refuses any mesh."""
    _, cfg = _cfgs()
    params = T.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = _tg(_graph(np.random.default_rng(0), 10, 20, 12))
    for fn in (T.forward, T.mse_loss):
        with pytest.raises(TypeError, match="DeviceMesh"):
            fn(params, {}, cfg, mesh=object())
    with pytest.raises(NotImplementedError, match="one device"):
        T.forward_chunked(params, g, cfg, mesh=object())


# ------------------------------------------------------------- cells


def test_cells_match_jax_names_and_meta():
    """The four shapes' cells: names, meta and abstract inputs as JAX's on
    one device (its counts rounded up to a multiple of one device)."""
    mesh = make_mesh_compat((1,), ("data",))
    arch, jarch = get_arch("meshgraphnet"), jax_get_arch("meshgraphnet")
    assert arch.shape_names() == jarch.shape_names() == list(GNN_SHAPES)
    for shape in arch.shape_names():
        cell, jcell = arch.build_cell(shape, device="cpu"), jarch.build_cell(shape, mesh)
        assert cell.name == jcell.name == f"meshgraphnet/{shape}"
        assert cell.meta == jcell.meta
        params, opt, graph = cell.args
        jparams, jopt, jgraph = jcell.args
        for got, want in ((params, jparams), (opt.mu, jopt.mu), (graph, jgraph)):
            w = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
                 for k, v in jax.tree_util.tree_flatten_with_path(want)[0]}
            g = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                 for k, v in named_leaves(got)}
            assert g == w, shape
            assert all(v.device.type == "meta" for _, v in named_leaves(got))
        assert dataclasses.replace(arch.config_for(shape), dtype=None) == \
            T.GNNConfig(**{**jarch.config_for(shape).__dict__, "dtype": None})


def test_cell_train_step_matches_jax():
    """One train step of a reduced molecule cell (3 layers, d 32) from a
    state at step 150 (the schedule past its warmup, zero moments): the
    loss, AdamW's moments and the params against JAX's jitted cell step;
    the params and moments written in place."""
    mesh = make_mesh_compat((1,), ("data",))
    jcfg, tcfg = _cfgs()
    jarch = dataclasses.replace(jax_get_arch("meshgraphnet"), base=jcfg)
    arch = dataclasses.replace(get_arch("meshgraphnet"), base=tcfg)
    jcell = jarch.build_cell("molecule", mesh)
    cell = arch.build_cell("molecule", device="cpu")
    sh = GNN_SHAPES["molecule"]
    g = _graph(np.random.default_rng(10), sh["n_nodes"], sh["n_edges"], 16, src_pad=9)
    jp = J_INIT(jax.random.PRNGKey(10), jarch.config_for("molecule"))
    zeros = jax.tree.map(jnp.zeros_like, jp)
    jopt = JaxAdamWState(step=jnp.asarray(150, jnp.int32), mu=zeros, nu=zeros)
    want_p, want_o, want_loss = jax.jit(jcell.step_fn)(jp, jopt, _jg(g))
    params = _t(jp)
    opt = adamw_from_arrays(150, jax.tree.map(np.zeros_like, jp),
                            jax.tree.map(np.zeros_like, jp), device="cpu")
    leaf = params["proc"]["edge"]["w"][0]
    new_p, new_o, loss = cell.step_fn(params, opt, _tg(g))
    assert new_p["proc"]["edge"]["w"][0] is leaf
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert int(new_o.step) == int(want_o.step) == 151
    for got, want, rtol, atol, what in ((new_o.mu, want_o.mu, 1e-4, 1e-7, "mu"),
                                        (new_o.nu, want_o.nu, 1e-4, 1e-12, "nu"),
                                        (new_p, want_p, 1e-5, 1e-6, "params")):
        w = _jax_named(want)
        for name, leaf in named_leaves(got):
            np.testing.assert_allclose(leaf.numpy(), w[name], rtol=rtol, atol=atol,
                                       err_msg=f"{what} {name}")
    assert float(np.abs(w["['proc']['edge']['w'][0]"] - np.asarray(jp["proc"]["edge"]["w"][0]))
                 .max()) > 0  # the step moved the weights


def test_cell_step_stays_on_its_device():
    arch = dataclasses.replace(get_arch("meshgraphnet"), base=_cfgs()[1])
    cell = arch.build_cell("molecule", device="meta")
    params = T.init(arch.config_for("molecule"), torch.Generator().manual_seed(0), device="cpu")
    from repro_torch.train import adamw_init
    with pytest.raises(ValueError, match="runs on meta"):
        cell.step_fn(params, adamw_init(params), _tg(_graph(np.random.default_rng(0), 8, 9, 16)))


# ---------------------------------------------------- launcher, checkpoints


class _Preempted(Exception):
    pass


_RUN = {jax_train_launcher: jax_train_launcher.loop.run, train_launcher: train_launcher.loop.run}


def _launch(monkeypatch, pkg, args, cut=False):
    """One run of a package's launcher (JAX's reads sys.argv, the port's
    takes argv; JAX's has no --device): its TrainResult.  ``cut``: the
    stream raises at step 2."""
    out = []

    def run(step_fn, state, stream, **kw):
        if cut:
            batch_at = stream.batch_at

            def raising(step):
                if step == 2:
                    raise _Preempted()
                return batch_at(step)

            stream.batch_at = raising
        out.append(_RUN[pkg](step_fn, state, stream, **kw))
        return out[-1]

    monkeypatch.setattr(pkg.loop, "run", run)
    if pkg is jax_train_launcher:
        monkeypatch.setattr(sys, "argv", ["train"] + args)
        pkg.main()
    else:
        pkg.main(args + ["--device", "cpu"])
    return out[0]


def test_gnn_train_launcher_matches_jax_and_resumes(monkeypatch, tmp_path, capsys):
    """``repro_torch.launch.train --arch meshgraphnet --device cpu --steps 3``
    against the JAX launcher on JAX's initial weights (its reduced config at
    PRNGKey(0), carried across): each loss within 1e-4 relative.  Then a
    run checkpointing every 2 steps is cut at step 2, and both launchers
    resume from its checkpoint (JAX's format): their step-2 losses agree,
    and differ from the uninterrupted run's (both draw the edges from one
    generator made with the stream, which a resumed run makes anew)."""
    jcfg = dataclasses.replace(jax_get_arch("meshgraphnet").base, n_layers=4, d_hidden=64,
                               d_feat=32, d_edge=4)
    jparams = J_INIT(jax.random.PRNGKey(0), jcfg)
    monkeypatch.setattr(train_launcher, "_gnn_init", lambda cfg, device: _t(jparams))
    args = ["--arch", "meshgraphnet", "--steps", "3"]
    want = [h["loss"] for h in _launch(monkeypatch, jax_train_launcher, args).history]
    got = [h["loss"] for h in _launch(monkeypatch, train_launcher, args).history]
    np.testing.assert_allclose(got, want, rtol=LAUNCHER_RTOL)
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("[train] meshgraphnet: loss ")

    ckpt_args = lambda name: args + ["--ckpt-dir", str(tmp_path / name),  # noqa: E731
                                     "--ckpt-every", "2"]
    with pytest.raises(_Preempted):
        _launch(monkeypatch, train_launcher, ckpt_args("port"), cut=True)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    resumed = [[h["loss"] for h in _launch(monkeypatch, pkg, ckpt_args(name)).history]
               for pkg, name in ((jax_train_launcher, "jax"), (train_launcher, "port"))]
    assert capsys.readouterr().out.count("resumed from step 2") == 2
    np.testing.assert_allclose(resumed[1], resumed[0], rtol=LAUNCHER_RTOL)
    assert len(resumed[1]) == 1 and abs(resumed[1][0] - got[2]) > LAUNCHER_RTOL * abs(got[2])


@pytest.fixture(scope="module")
def gnn_state():
    """A reduced GNN train state after one JAX AdamW step (non-zero
    moments): JAX's tree and the port's carried copy."""
    jcfg, _ = _cfgs()
    params = J_INIT(jax.random.PRNGKey(0), jcfg)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.01), params)
    p, o = jax.jit(lambda g, p: jax_adamw_update(g, jax_adamw_init(p), p, lr=1e-3))(grads,
                                                                                  params)
    jstate = {"params": p, "opt": o}
    tstate = {"params": _t(p), "opt": adamw_from_arrays(o.step, o.mu, o.nu, device="cpu")}
    return jstate, tstate


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_gnn_checkpoint_crosses_the_packages(direction, tmp_path, gnn_state):
    """The stacked processor leaves keep JAX's names and order; every value
    bit for bit, and the manifest's step and leaves."""
    jstate, tstate = gnn_state
    d = str(tmp_path)
    if direction == "jax_to_port":
        jax_ckpt.save(d, 5, jstate, extra={"arch": "meshgraphnet"})
        out, manifest = ckpt.restore(d, tstate)
        got = {n: leaf.numpy() for n, leaf in named_leaves(out)}
        want = _jax_named(jstate)
    else:
        ckpt.save(d, 5, tstate, extra={"arch": "meshgraphnet"})
        out, manifest = jax_ckpt.restore(d, jax.eval_shape(lambda: jstate))
        got = _jax_named(out)
        want = {n: leaf.numpy() for n, leaf in named_leaves(tstate)}
    assert list(got) == list(want)
    assert "['opt'].mu['proc']['edge']['w'][0]" in got and "['params']['dec']['b'][2]" in got
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert manifest["step"] == 5 and manifest["extra"] == {"arch": "meshgraphnet"}


def test_every_arch_id_resolves():
    """The GNN family is ported: every id of the JAX registry resolves."""
    assert PORTED_ARCH_IDS == ARCH_IDS
    assert get_arch("meshgraphnet").family == "gnn"
    assert [s for a, s in all_cells() if a == "meshgraphnet"] == list(GNN_SHAPES)
