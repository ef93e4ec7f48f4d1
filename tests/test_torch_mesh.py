"""The port's mesh tools (``repro_torch.launch.mesh``, ``train.compress``,
the sharded GNN layer, the MoE expert-parallel dispatch, the shard-local
retrieval, the row-sharded recsys lookups and the cells' mesh branches) on
the CPU.

One module-scoped run starts, together, eight gloo ranks of the port
(``tests/_torch_mesh_ranks.py``, a FileStore under tmp_path) and one JAX
subprocess on 8 forced host devices (``tests/_torch_mesh_jax.py``, every
call jitted), on the same inputs drawn here with numpy.  The port's sharded
runs are held to the JAX package's sharded runs and to the port's own local
paths (the gradients too: a gradient P times too large fails there).  The
LM cells (``tests/_torch_mesh_cfgs.py``'s two small configs) run under
JAX's layouts on the (2, 4) and (2, 2, 2) meshes: parameters as ``specs()``
shards, pure FSDP or Megatron over "model", sequence-sharded caches.  In
process: the spec trees against JAX's for every arch, ``placements`` and
``local_shard`` on fake process groups of 8 and 256 ranks, the mesh
helpers, the type checks, and the three examples at a small size.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec

from repro_torch import testing
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.common import RecsysArch
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import P
from repro_torch.models import gnn as tgnn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.recsys import dien as tdien
from repro_torch.models.recsys import dlrm as tdlrm
from repro_torch.models.recsys import embedding as temb
from repro_torch.models.recsys import mind as tmind
from repro_torch.models.recsys import sasrec as tsasrec
from repro_torch.train import optimizer as topt
from repro_torch.train.tree import named_leaves

from test_torch_build import one_torch_thread  # noqa: F401 -- an autouse fixture

import _torch_mesh_cfgs as C
import _torch_mesh_ranks as R

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
SEED = 31


def _draw(rng, shapes, prefix: str, out: dict) -> None:
    """N(0, 1) * fan_in^-0.5 for a matrix (fan_in the second-last dim), 1 +
    0.1 N(0, 1) for a vector: each leaf by its name."""
    for name, t in shapes:
        shape = tuple(t.shape)
        x = rng.normal(size=shape)
        x = x * shape[-2] ** -0.5 if len(shape) >= 2 else 1.0 + 0.1 * x
        out[prefix + name] = x.astype(np.float32)


def _graph(rng, n, e, d_feat, d_edge, out_dim, prefix, out) -> None:
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    src[-3:], dst[-3:] = -1, -1  # padding edges, as the cells pad E
    out.update({prefix + "node_feat": rng.normal(size=(n, d_feat)).astype(np.float32),
                prefix + "edge_feat": rng.normal(size=(e, d_edge)).astype(np.float32),
                prefix + "src": src, prefix + "dst": dst,
                prefix + "targets": rng.normal(size=(n, out_dim)).astype(np.float32)})


def _inputs() -> dict:
    rng = np.random.default_rng(SEED)
    out = {}
    m = R.MOE
    _draw(rng, tmoe.moe_init(None, m["d"], m["f"], m["experts"], torch.float32,
                             device="meta").items(), "moe/", out)
    out["moe/x"] = rng.normal(size=(*m["batch"], m["d"])).astype(np.float32)
    cfg = R.GNN_CFG
    _draw(rng, named_leaves(tgnn.init(cfg, device="meta")), "gnn/params", out)
    _graph(rng, R.GNN_GRAPH["nodes"], R.GNN_GRAPH["edges"], cfg.d_feat, cfg.d_edge, cfg.out_dim,
           "gnn/", out)
    cell_cfg = tgnn.GNNConfig(**{**dataclasses.asdict(cfg), "d_feat": 16})
    _draw(rng, named_leaves(tgnn.init(cell_cfg, device="meta")), "gnn_cell/params", out)
    _graph(rng, R.GNN_GRAPH["nodes"], R.GNN_GRAPH["edges"], 16, cfg.d_edge, cfg.out_dim,
           "gnn_cell/", out)
    out["compress/x"] = rng.normal(size=R.COMPRESS["shape"]).astype(np.float32)
    _draw(rng, named_leaves(ttf.init(R.LM_CFG, device="meta")), "lm/params", out)
    out["lm/tokens"] = rng.integers(0, R.LM_CFG.vocab, R.LM_TOKENS).astype(np.int32)
    r = R.RETRIEVAL
    for aid, rc in R.RETRIEVAL_CFGS.items():
        hist = rng.integers(0, r["items"], (r["batch"], rc.seq_len)).astype(np.int32)
        hist[:, : rc.seq_len // 4] = -1  # left padding
        out[f"retrieval/{aid}/hist"] = hist
    # every model rank's block the same integer rows: scores tie across shards
    out["ties/block"] = rng.integers(-3, 4, (r["items"] // 4, r["dim"])).astype(np.float32)
    out["ties/u/False"] = rng.integers(-3, 4, (r["batch"], 1, r["dim"])).astype(np.float32)
    out["ties/u/True"] = rng.integers(-3, 4, (r["batch"], 4, r["dim"])).astype(np.float32)
    for aid in R.RECSYS_CFGS:
        leaves_ = named_leaves(_recsys_arch(aid).init(device="meta"))
        _draw(rng, leaves_, f"recsys/{aid}/params", out)
        # the train step's AdamW moments, as mid-way through training: with
        # nu away from 0 the update is smooth in the gradient, not its sign
        for name, t in leaves_:
            shape = tuple(t.shape)
            out[f"recsys/{aid}/mu{name}"] = (1e-3 * rng.normal(size=shape)).astype(np.float32)
            out[f"recsys/{aid}/nu{name}"] = (
                1e-4 * (1.0 + np.abs(rng.normal(size=shape)))).astype(np.float32)
    for aid, shape in R.recsys_cells():
        for k, v in _recsys_batch(aid, shape, _recsys_arch(aid).cfg, rng).items():
            out[f"recsys/{aid}/{shape}/in/{k}"] = v
    for cname in C.LM_CFGS:
        cfg = _lm_cfg(cname)
        pre = f"lmc/{cname}/"
        leaves_ = named_leaves(ttf.init(cfg, device="meta"))
        _draw(rng, leaves_, pre + "params", out)
        for name, t in leaves_:
            shape = tuple(t.shape)
            out[f"{pre}mu{name}"] = (1e-3 * rng.normal(size=shape)).astype(np.float32)
            out[f"{pre}nu{name}"] = (1e-4 * (1.0 + np.abs(rng.normal(size=shape)))).astype(
                np.float32)
        sh = C.LM_SHAPES["train_4k"]
        out[pre + "tokens"] = rng.integers(0, cfg.vocab, (sh["batch"], sh["seq"])).astype(np.int32)
        for shape in ("decode_32k", "long_500k"):
            sh = C.LM_SHAPES[shape]
            out[f"{pre}{shape}/token"] = rng.integers(0, cfg.vocab, (sh["batch"], 1)).astype(
                np.int32)
            for name, t in named_leaves(ttf.init_cache(cfg, sh["batch"], sh["seq"],
                                                       device="meta")):
                out[f"{pre}{shape}/caches{name}"] = rng.normal(size=tuple(t.shape)).astype(
                    np.float32)
    return out


def _lm_cfg(name: str) -> ttf.TransformerConfig:
    return ttf.TransformerConfig(**C.LM_CFGS[name], dtype=torch.float32)


def _recsys_arch(aid: str) -> RecsysArch:
    return RecsysArch(aid, dataclasses.replace(get_arch(aid).cfg, **R.RECSYS_CFGS[aid]))


def _recsys_batch(aid: str, shape: str, cfg, rng) -> dict:
    """A cell's inputs at ``R.RECSYS_BATCH`` rows (-1 pads in the
    histories and candidates)."""
    b = R.RECSYS_BATCH[shape]
    rows = cfg.n_rows if aid == "dlrm-rm2" else cfg.n_items
    ids = lambda *shape_: rng.integers(0, rows, shape_).astype(np.int32)  # noqa: E731
    if aid == "dlrm-rm2":
        out = dict(dense=rng.normal(size=(b, cfg.n_dense)).astype(np.float32),
                   sparse=ids(b, cfg.n_sparse))
        if shape == "train_batch":
            out["labels"] = rng.integers(0, 2, b).astype(np.float32)
        return out
    out = dict(hist=rng.integers(-1, rows, (b, cfg.seq_len)).astype(np.int32))
    if shape != "train_batch":
        if aid == "dien":
            out["target"] = ids(b)
        else:
            out["cand"] = rng.integers(-1, rows, (b, R.RECSYS_CANDIDATES)).astype(np.int32)
    elif aid == "sasrec":
        out.update(pos=ids(b, cfg.seq_len), neg=ids(b, cfg.seq_len, 4))
    elif aid == "mind":
        out.update(pos=ids(b), neg=ids(b, 20))
    else:
        out.update(target=ids(b), labels=rng.integers(0, 2, b).astype(np.float32),
                   aux_neg=ids(b, cfg.seq_len))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the port's ranks' outputs, the JAX package's outputs)."""
    tmp = tmp_path_factory.mktemp("mesh")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    src = str(ROOT / "src")
    jax_env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
                   JAX_PLATFORMS="cpu", PYTHONPATH=src)
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_mesh_jax.py"),
                               str(tmp / "inputs.npz"), str(tmp / "jax.npz")], env=jax_env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([src, str(ROOT / "tests")]),
               OMP_NUM_THREADS="1")
    procs += [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_mesh_ranks.py"),
                                str(rank), str(WORLD), str(tmp / "store"),
                                str(tmp / "inputs.npz"), str(tmp / "port.npz")], env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for rank in range(WORLD)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"{p.args}:\n{log}"
    return inputs, dict(np.load(tmp / "port.npz")), dict(np.load(tmp / "jax.npz"))


def _within(got, want, frac, what) -> None:
    """|got - want| <= frac * max|want| elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, top = np.max(np.abs(got - want), initial=0.0), np.max(np.abs(want), initial=0.0)
    assert err <= frac * top, f"{what}: {err:.3e} > {frac} x {top:.3e}"


def _leaves(out: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


# ------------------------------------------------------------- MoE


@pytest.mark.parametrize("cf", R.MOE_CAPACITIES)
def test_moe_expert_parallel_matches_jax(runs, cf):
    _, port, ref = runs
    _within(port[f"moe/{cf}/out"], ref[f"moe/{cf}/out"], 1e-5, f"moe out cf {cf}")
    np.testing.assert_allclose(port[f"moe/{cf}/aux"], ref[f"moe/{cf}/aux"], rtol=1e-6)


def test_moe_expert_parallel_matches_local(runs):
    """No drops at cf 16: the sharded dispatch is the local one."""
    _, port, _ = runs
    np.testing.assert_allclose(port[f"moe/{R.MOE_CAPACITIES[0]}/out"], port["moe/local/out"],
                               rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------- GNN


def test_gnn_sharded_matches_local(runs):
    """Out, and every gradient leaf after the mean over the ranks (JAX's
    test holds only the first)."""
    _, port, _ = runs
    np.testing.assert_allclose(port["gnn/out"], port["gnn/local/out"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port["gnn/loss"], port["gnn/local/loss"], rtol=1e-5)
    got, want = _leaves(port, "gnn/grad/"), _leaves(port, "gnn/local/grad/")
    assert sorted(got) == sorted(want) == sorted(
        name for name, _ in named_leaves(tgnn.init(R.GNN_CFG, device="meta")))
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-3, atol=1e-5, err_msg=name)


def test_gnn_sharded_matches_jax(runs):
    _, port, ref = runs
    _within(port["gnn/out"], ref["gnn/out"], 1e-4, "gnn out")
    _within(port["gnn/loss"], ref["gnn/loss"], 1e-4, "gnn loss")
    got, want = _leaves(port, "gnn/grad/"), _leaves(ref, "gnn/grad/")
    assert sorted(got) == sorted(want)
    for name in want:
        _within(got[name], want[name], 1e-4, name)


def test_gnn_cell_step_under_the_mesh(runs):
    """One train step of the cell on the ranks' blocks against the local
    cell: the loss, and every parameter after AdamW."""
    _, port, _ = runs
    np.testing.assert_allclose(port["gnn_cell/loss"], port["gnn_cell/local/loss"], rtol=1e-5)
    got, want = _leaves(port, "gnn_cell/new/"), _leaves(port, "gnn_cell/local/new/")
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-6, err_msg=name)


# ------------------------------------------------------------- compression


def test_compressed_allreduce_equals_jax_step_for_step(runs):
    """Elementwise IEEE ops and integer sums: every step's mean and error
    equal JAX's."""
    _, port, ref = runs
    for key in ("compress/mean", "compress/error"):
        assert port[key].shape == (R.COMPRESS["steps"], *R.COMPRESS["shape"])
        np.testing.assert_allclose(port[key], ref[key], rtol=0, atol=1e-7, err_msg=key)


def test_compressed_allreduce_error_feedback_converges(runs):
    """JAX's property: the 20-step mean's error under half the first
    step's."""
    inputs, port, _ = runs
    exact = inputs["compress/x"].astype(np.float64).mean(axis=0)
    means = port["compress/mean"]
    assert np.all(means == means[:, :1])  # every rank got the same mean
    err1 = np.max(np.abs(means[0, 0] - exact))
    err20 = np.max(np.abs(means[:, 0].mean(axis=0) - exact))
    assert err20 < 0.5 * err1, (err1, err20)


# ------------------------------------------------------------- LM


def test_lm_sharded_loss_matches_jax_and_local(runs):
    _, port, ref = runs
    np.testing.assert_allclose(port["lm/loss"], ref["lm/loss"], rtol=1e-5)
    assert abs(float(port["lm/loss"]) - float(port["lm/local/loss"])) < 5e-3


def test_lm_sharded_gradient_is_the_local_gradient(runs):
    """Every leaf of the sharded step's gradient (the experts gathered over
    "model") within 1e-3 of the local leaf's largest: a sum over the ranks
    in the backward of a replicated loss would make it P times too large."""
    _, port, _ = runs
    np.testing.assert_allclose(port["lm/grad_loss"], port["lm/local/grad_loss"], rtol=1e-5)
    got, want = _leaves(port, "lm/grad/"), _leaves(port, "lm/local/grad/")
    assert sorted(got) == sorted(want) and len(got) == len(named_leaves(
        ttf.init(R.LM_CFG, device="meta")))
    for name in want:
        _within(got[name], want[name], 1e-3, name)
        assert np.abs(want[name]).max() > 0, name


def test_lm_cell_step_under_the_mesh(runs):
    _, port, _ = runs
    assert abs(float(port["lm_cell/loss"]) - float(port["lm_cell/local/loss"])) < 5e-3
    got, want = _leaves(port, "lm_cell/new/"), _leaves(port, "lm_cell/local/new/")
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-6, err_msg=name)


# ------------------------------------------------------------- LM cells

# the sharded train step's loss (a mean of the ranks' means, the vocabulary's
# log-sum-exp summed over "model") against JAX's sharded cell and the port's
# unsharded one
LM_CELL_LOSS_RTOL = 1e-5
# each parameter, AdamW moment, logit and cache after a step, relative to
# its leaf's largest: GSPMD's and the ranks' partial sums reorder fp32 sums
LM_CELL_RTOL = 1e-5
# the MoE's sharded loss against its unsharded one: the mean of the ranks'
# load-balance statistics is not the whole batch's (the limit of
# test_lm_sharded_loss_matches_jax_and_local)
LM_MOE_LOCAL_LOSS_ATOL = 5e-3


def _lm_cells(cname: str) -> list:
    return [(cname, mesh) for mesh in C.LM_MESHES]


def _hold(port: dict, ref: dict, got_at: str, want_at: str, what: str) -> list:
    """Every leaf under ``got_at`` within LM_CELL_RTOL of ``want_at``'s;
    the leaves' names."""
    got, want = _leaves(port, got_at), _leaves(ref, want_at)
    assert got and sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for name in want:
        _within(got[name], want[name], LM_CELL_RTOL, f"{what} {name}")
    return sorted(got)


@pytest.mark.parametrize("cname,mesh", _lm_cells("dense") + _lm_cells("moe"))
def test_lm_train_cell_under_jax_layouts(runs, cname, mesh):
    """train_4k from drawn moments at LM_STEP (past the warmup): the dense
    config on (2, 4) is pure FSDP (the batch over data x model, every weight
    gathered), the others Megatron over "model" (the MoE's experts over
    "model" too).  Loss, parameters, mu and nu against JAX's jitted cell
    with its in_shardings and against the port's unsharded cell; every
    parameter moved.  The MoE's load-balance loss is a statistic of the
    batch it sees (a rank's under the mesh, JAX's sharded cell too), so its
    unsharded loss is held to LM_MOE_LOCAL_LOSS_ATOL and its moments, which
    carry that gradient, to JAX's cell alone."""
    inputs, port, ref = runs
    pre = f"lmc/{cname}/"
    loss = float(port[f"{pre}{mesh}/train/loss"])
    np.testing.assert_allclose(loss, float(ref[f"{pre}{mesh}/train/loss"]), rtol=LM_CELL_LOSS_RTOL)
    local = float(port[f"{pre}local/train/loss"])
    if cname == "moe":  # the aux statistic is a rank's batch's
        assert abs(loss - local) < LM_MOE_LOCAL_LOSS_ATOL, (loss, local)
    else:
        np.testing.assert_allclose(loss, local, rtol=LM_CELL_LOSS_RTOL)
    names = [n for n, _ in named_leaves(ttf.init(_lm_cfg(cname), device="meta"))]
    for part in ("new", "mu", "nu"):
        oracles = ((ref, mesh),) if cname == "moe" and part != "new" else ((ref, mesh),
                                                                            (port, "local"))
        for want, src in oracles:
            got = _hold(port, want, f"{pre}{mesh}/train/{part}", f"{pre}{src}/train/{part}",
                        f"{cname} {mesh} {part} vs {'JAX' if want is ref else src}")
            assert got == sorted(names)
    new = _leaves(port, f"{pre}{mesh}/train/new")
    moved = [n for n in names if not np.array_equal(new[n], inputs[f"{pre}params{n}"])]
    assert moved == names, sorted(set(names) - set(moved))


@pytest.mark.parametrize("cname,mesh", _lm_cells("dense") + _lm_cells("moe"))
def test_lm_prefill_cell_under_jax_layouts(runs, cname, mesh):
    """prefill_32k: the prompts over the batch axes, Megatron, the logits'
    vocabulary over "model" and each cache's sequence over "model" (every
    rank its slice): the gathered logits and caches against JAX's and the
    unsharded cell's."""
    _, port, ref = runs
    pre = f"lmc/{cname}/"
    for want, src in ((ref, mesh), (port, "local")):
        what = f"{cname} {mesh} prefill vs {'JAX' if want is ref else src}"
        _within(port[f"{pre}{mesh}/prefill/logits"], want[f"{pre}{src}/prefill/logits"],
                LM_CELL_RTOL, what + " logits")
        _hold(port, want, f"{pre}{mesh}/prefill/caches", f"{pre}{src}/prefill/caches",
              what + " caches")


def _empty_slices(cname: str, shape: str, mesh: str, q_offset: int) -> int:
    """How many ranks' cache slices hold no valid slot at ``q_offset``, over
    the config's cache layers (sliced over "model", or every axis for
    long_500k)."""
    cfg, sh = _lm_cfg(cname), C.LM_SHAPES[shape]
    mesh_shape, axes = C.LM_MESHES[mesh]
    n = int(np.prod(mesh_shape)) if shape == "long_500k" else mesh_shape[axes.index("model")]
    empty = 0
    for window in cfg.window_pattern:
        t = ttf.cache_len(cfg, window, sh["seq"])
        empty += sum(min(q_offset, t - 1) < r * (t // n) for r in range(n))
    return empty


@pytest.mark.parametrize("q_offset", C.LM_DECODE_OFFSETS)
@pytest.mark.parametrize("cname,mesh", _lm_cells("dense") + _lm_cells("moe"))
def test_lm_decode_cell_under_jax_layouts(runs, cname, mesh, q_offset):
    """decode_32k over sequence-sharded caches (over "model"), at a position
    where some ranks' slices hold no valid slot (and, at 11, after the
    8-slot ring wrapped): the logits and every cache (the new token's k / v
    written by its slot's owner) against JAX's and the unsharded cell's."""
    _, port, ref = runs
    if q_offset == C.LM_DECODE_OFFSETS[0]:
        assert _empty_slices(cname, "decode_32k", mesh, q_offset) > 0
    at = f"lmc/{cname}/{{}}/decode_32k/{q_offset}/"
    for want, src in ((ref, mesh), (port, "local")):
        what = f"{at.format(mesh)} vs {'JAX' if want is ref else src}"
        _within(port[at.format(mesh) + "logits"], want[at.format(src) + "logits"], LM_CELL_RTOL,
                what + " logits")
        _hold(port, want, at.format(mesh) + "caches", at.format(src) + "caches", what + " caches")


@pytest.mark.parametrize("q_offset", C.LM_DECODE_OFFSETS)
@pytest.mark.parametrize("mesh", list(C.LM_MESHES))
def test_lm_long_context_decode_under_jax_layouts(runs, mesh, q_offset):
    """long_500k (one row): the caches' sequence over every axis (8 slices,
    most of them empty early), the token replicated, the logits' vocabulary
    over "model", against JAX's and the unsharded cell's."""
    _, port, ref = runs
    assert _empty_slices("dense", "long_500k", mesh, q_offset) > 0
    at = f"lmc/dense/{{}}/long_500k/{q_offset}/"
    for want, src in ((ref, mesh), (port, "local")):
        what = f"{at.format(mesh)} vs {'JAX' if want is ref else src}"
        _within(port[at.format(mesh) + "logits"], want[at.format(src) + "logits"], LM_CELL_RTOL,
                what + " logits")
        _hold(port, want, at.format(mesh) + "caches", at.format(src) + "caches", what + " caches")


@pytest.mark.parametrize("arch_id", [a for a in ARCH_IDS if get_arch(a).family == "lm"])
def test_kv_heads_map_each_rank_onto_whole_kv_heads(arch_id):
    """Each of the 16 model ranks' q heads reads a contiguous run of kv
    heads, each by as many of its heads (granite 2 of a group of 4, gemma
    1 of 2, internlm2 and grok 3 of 6, qwen3 4 of 16), the run the kernel's
    grouping of the local heads reads; a split that cuts a group unevenly
    raises."""
    from repro_torch.models.layers import kv_heads

    cfg = get_arch(arch_id).cfg
    h, kv, ranks = cfg.n_heads, cfg.n_kv, 16
    local = h // ranks
    for rank in range(ranks):
        lo, hi = kv_heads(h, kv, ranks, rank)
        heads = np.arange(rank * local, (rank + 1) * local)
        read = heads // (h // kv)  # the kv head each global q head reads
        assert (lo, hi) == (read.min(), read.max() + 1)
        group = local // (hi - lo)  # the kernel's grouping of the local heads
        np.testing.assert_array_equal(lo + np.arange(local) // group, read)
    with pytest.raises(ValueError, match="whole kv heads"):
        kv_heads(6, 3, 2, 0)  # 3 heads a rank over groups of 2
    with pytest.raises(ValueError, match="divide"):
        kv_heads(8, 2, 3, 0)


# ------------------------------------------------------------- retrieval


@pytest.mark.parametrize("arch_id", list(R.RETRIEVAL_CFGS))
def test_shard_local_retrieval_matches_unsharded(runs, arch_id):
    _, port, _ = runs
    ids, scores = port[f"retrieval/{arch_id}/ids"], port[f"retrieval/{arch_id}/scores"]
    assert ids.shape == (R.RETRIEVAL["batch"], R.RETRIEVAL["k"]) and ids.dtype == np.int32
    testing.assert_topk_match(ids, scores, port[f"retrieval/{arch_id}/local/ids"],
                              port[f"retrieval/{arch_id}/local/scores"])


@pytest.mark.parametrize("interests", [False, True])
def test_shard_local_merge_keeps_the_lower_rank_at_a_tie(runs, interests):
    """Each model rank holds the same integer rows, so every score ties
    across shards: the merge must give lax.top_k's order over the whole
    table (score descending, the lower id first), with exact scores."""
    inputs, port, _ = runs
    table = np.tile(inputs["ties/block"], (4, 1)).astype(np.float64)
    u = inputs[f"ties/u/{interests}"].astype(np.float64)
    scores = np.einsum("bkd,nd->bkn", u, table).max(axis=1)
    k = R.RETRIEVAL["k"]
    want = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(port[f"ties/{interests}/ids"], want)
    np.testing.assert_array_equal(port[f"ties/{interests}/scores"],
                                  np.take_along_axis(scores, want, axis=1))
    assert len(np.unique(want // (table.shape[0] // 4))) > 1  # the top k spans shards


# ------------------------------------------------------------- recsys cells

# the sharded step's loss against JAX's sharded cell and the port's
# unsharded one: a mean of the data ranks' means, and SASRec's and DIEN's
# ratios of sums (their counts summed over the ranks), reorder fp32 sums
RECSYS_LOSS_RTOL = 1e-5
# each parameter and each AdamW moment after one step from drawn moments at
# step RECSYS_STEP (past the warmup, so the learning rate is not 0),
# relative to its leaf's largest element; JAX's XLA fusions and the ranks' sums reorder
# the gradient's fp32 arithmetic.  The moments carry the clipped gradient
# (a tenth of it into mu, a twentieth of its square into nu), so they hold
# the gradient
# path under the mesh: the tables' sum over model, the losses' means over
# the batch ranks and the clip's norm over the specs
RECSYS_PARAM_RTOL = 1e-5
RECSYS_SERVE_RTOL = 1e-5  # serve outputs, relative to the largest


@pytest.mark.parametrize("arch_id,shape", R.recsys_cells())
def test_recsys_cell_under_the_mesh_matches_jax_and_unsharded(runs, arch_id, shape):
    """The cell's step on the (2, 4) mesh (batch over data, tables over
    model: masked gathers and a sum over model; JAX's serve replicates the
    item table) against JAX's jitted cell with its in_shardings on 8
    devices, and against the port's cell without a mesh."""
    inputs, port, ref = runs
    pre = f"recsys/{arch_id}/{shape}/"
    if shape == "train_batch":
        loss = float(port[pre + "mesh/loss"])
        np.testing.assert_allclose(loss, float(ref[pre + "loss"]), rtol=RECSYS_LOSS_RTOL)
        np.testing.assert_allclose(loss, float(port[pre + "local/loss"]), rtol=RECSYS_LOSS_RTOL)
        names = [n for n, _ in named_leaves(_recsys_arch(arch_id).init(device="meta"))]
        for part in ("new", "mu", "nu"):
            got = _leaves(port, f"{pre}mesh/{part}/")
            for want in (_leaves(ref, f"{pre}{part}/"), _leaves(port, f"{pre}local/{part}/")):
                assert sorted(got) == sorted(want) == sorted(names)
                for name in names:
                    _within(got[name], want[name], RECSYS_PARAM_RTOL, f"{part} {name}")
        # the step moved every parameter
        moved = [n for n in names if not np.array_equal(_leaves(port, pre + "mesh/new/")[n],
                                                         inputs[f"recsys/{arch_id}/params{n}"])]
        assert moved == names, sorted(set(names) - set(moved))
    elif shape == "retrieval_cand":
        ids, scores = port[pre + "mesh/ids"][None], port[pre + "mesh/scores"][None]
        assert ids.shape == (1, 100)
        testing.assert_topk_match(ids, scores, ref[pre + "ids"][None], ref[pre + "scores"][None])
        testing.assert_topk_match(ids, scores, port[pre + "local/ids"][None],
                                  port[pre + "local/scores"][None])
    else:
        got = port[pre + "mesh/out"]
        assert got.shape[0] == R.RECSYS_BATCH[shape]
        _within(got, ref[pre + "out"], RECSYS_SERVE_RTOL, pre + "jax")
        _within(got, port[pre + "local/out"], RECSYS_SERVE_RTOL, pre + "local")


# ------------------------------------------------------------- spec trees


def _jax_named(tree):
    paths = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in paths]


def _port_named(tree):
    return [(name, tuple(s)) for name, s in named_leaves(tree)]


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_spec_trees_match_jax(arch_id):
    from repro.configs import get_arch as jax_arch
    from repro.models import gnn as jgnn
    from repro.models import transformer as jtf
    from repro.models.recsys import embedding as jemb
    from repro.train.optimizer import adamw_specs

    jarch, tarch = jax_arch(arch_id), get_arch(arch_id)
    if tarch.family == "lm":
        pairs = [(jtf.specs(jarch.cfg), ttf.specs(tarch.cfg)),
                 (jtf.cache_specs(jarch.cfg), ttf.cache_specs(tarch.cfg)),
                 (jtf.cache_specs(jarch.cfg, batch=(), seq=("data", "model")),
                  ttf.cache_specs(tarch.cfg, batch=(), seq=("data", "model"))),
                 (adamw_specs(jtf.specs(jarch.cfg)), topt.adamw_specs(ttf.specs(tarch.cfg)))]
    elif tarch.family == "gnn":
        pairs = [(jgnn.specs(jarch.base), tgnn.specs(tarch.base)),
                 (jgnn.data_specs(), tgnn.data_specs()),
                 (jgnn.data_specs(("data", "model")), tgnn.data_specs(("data", "model")))]
    else:
        pairs = [(jarch.mod.specs(jarch.cfg), tarch.mod.specs(tarch.cfg)),
                 ((jemb.table_spec(), jemb.table_spec(stacked=True)),
                  (temb.table_spec(), temb.table_spec(stacked=True)))]
    for want, got in pairs:
        assert _port_named(got) == _jax_named(want)


def test_layer_specs_and_shard_resolution_match_jax():
    from repro.models import layers as jl
    from repro.models import moe as jm

    from repro_torch.models import layers as tl

    for want, got in ((jl.attention_specs(), tl.attention_specs()),
                      (jl.mlp_specs(), tl.mlp_specs()), (jm.moe_specs(), tmoe.moe_specs())):
        assert _port_named(got) == _jax_named(want)
    saved = tl.batch_axes()
    try:
        for axes in (("pod", "data"), ("data",), ("data", "model")):
            tl.set_batch_axes(axes)
            got = tl.resolve_spec("batch", "model", None)
            assert got == P(axes, None if "model" in axes else "model", None)
            assert tuple(got) == tuple(PartitionSpec(axes, got[1], None))
            x = torch.ones(2)
            assert tl.shard(x, "batch", None) is x
    finally:
        tl.set_batch_axes(saved)


# ------------------------------------------------------------- fake process groups


@pytest.fixture()
def fake_world():
    """A fake process group of ``n`` ranks (this process is rank 3 of more
    than 3)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(n):
        dist.init_process_group("fake", store=FakeStore(), rank=min(3, n - 1), world_size=n)

    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [8, 256])
def test_placements_and_local_shard_tile_as_jax(fake_world, world):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    fake_world(world)
    mesh = init_device_mesh("cpu", (world // 4, 4), mesh_dim_names=("data", "model"))
    assert tuple(mesh.get_coordinate()) == (0, 3)
    assert tmesh.placements(P(("data", "model"), None), mesh) == (Shard(0), Shard(0))
    assert tmesh.placements(P(None, "model"), mesh) == (Replicate(), Shard(1))
    assert tmesh.placements(P(), mesh) == (Replicate(), Replicate())
    t = torch.arange(world * 2 * 8).view(world * 2, 8)
    # rank 3 of the flattened (data, model) group: rows [3 N / P, 4 N / P)
    np.testing.assert_array_equal(tmesh.local_shard(t, P(("data", "model")), mesh), t[6:8])
    np.testing.assert_array_equal(tmesh.local_shard(t, P("model", None), mesh),
                                  t.view(4, -1, 8)[3])
    # data coordinate 0 of world / 4: rows [0, 8); model coordinate 3 of 4: columns [6, 8)
    np.testing.assert_array_equal(tmesh.local_shard(t, P("data", "model"), mesh), t[:8, 6:8])
    assert tmesh.local_shard(t, P(None, None), mesh) is t
    with pytest.raises(ValueError, match="order"):
        tmesh.local_shard(t, P(("model", "data")), mesh)
    with pytest.raises(ValueError, match="not in the mesh"):
        tmesh.placements(P("pod"), mesh)
    with pytest.raises(ValueError, match="divide"):
        tmesh.local_shard(t[:5], P("model"), mesh)
    group = tmesh.axis_group(mesh, ("data", "model"))
    assert dist.get_world_size(group) == world and dist.get_rank(group) == 3


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shape_and_names(fake_world, multi_pod):
    fake_world(512 if multi_pod else 256)
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    want = (((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else ((16, 16), ("data", "model")))
    assert (tuple(mesh.shape), mesh.mesh_dim_names) == want
    assert tmesh.batch_axes_of(mesh) == want[1][:-1]
    assert tmesh.data_parallelism(mesh) == (32 if multi_pod else 16)


def test_host_mesh_helpers(fake_world):
    """tests/test_launch.py::test_mesh_helpers on the port."""
    fake_world(1)
    m = tmesh.make_host_mesh(1, device="cpu")
    assert tmesh.batch_axes_of(m) == ()
    assert tmesh.data_parallelism(m) == 1
    assert m.mesh_dim_names == ("model",) and m.size() == 1


@pytest.mark.parametrize("entry", ["gnn_forward", "gnn_mse_loss", "moe_apply", "lm_forward",
                                   "lm_loss", "serve_prefill", "serve_step", "lm_cell",
                                   "sasrec_loss", "sasrec_user", "mind_loss", "dien_loss",
                                   "dlrm_loss", "dlrm_forward", "recsys_train_cell",
                                   "recsys_serve_cell", "dlrm_retrieval_cell"])
def test_a_mesh_that_is_not_a_device_mesh_raises_before_any_work(entry):
    lm = ttf.TransformerConfig(name="t", n_layers=1, d_model=8, n_heads=2, n_kv=1, head_dim=4,
                               d_ff=16, vocab=16, dtype=torch.float32)
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    calls = {
        "gnn_forward": lambda: tgnn.forward({}, {}, tgnn.GNNConfig(), mesh=object()),
        "gnn_mse_loss": lambda: tgnn.mse_loss({}, {}, tgnn.GNNConfig(), mesh=object()),
        "moe_apply": lambda: tmoe.moe_apply({}, torch.zeros(1, 2, 4), n_experts=2, top_k=1,
                                            mesh=object()),
        "lm_forward": lambda: ttf.forward({}, tokens, lm, mesh=object()),
        "lm_loss": lambda: ttf.lm_loss({}, {"tokens": tokens, "labels": tokens}, lm,
                                       mesh=object()),
        "serve_prefill": lambda: ttf.serve_prefill({}, tokens, lm, mesh=object()),
        "serve_step": lambda: ttf.serve_step({}, (), tokens[:, :1], 0, lm, mesh=object()),
        "lm_cell": lambda: get_arch("granite-3-2b").build_cell("train_4k", device="cpu",
                                                                mesh=object()),
        "sasrec_loss": lambda: tsasrec.sampled_softmax_loss({}, {"hist": tokens},
                                                            tsasrec.SASRecConfig(),
                                                            mesh=object()),
        "sasrec_user": lambda: tsasrec.user_embedding({}, tokens, tsasrec.SASRecConfig(),
                                                      mesh=object()),
        "mind_loss": lambda: tmind.sampled_softmax_loss({}, {}, tmind.MINDConfig(),
                                                        mesh=object()),
        "dien_loss": lambda: tdien.bce_loss({}, {}, tdien.DIENConfig(), mesh=object()),
        "dlrm_loss": lambda: tdlrm.bce_loss({}, {}, tdlrm.DLRMConfig(), mesh=object()),
        "dlrm_forward": lambda: tdlrm.forward({}, {}, tdlrm.DLRMConfig(), mesh=object()),
        "recsys_train_cell": lambda: get_arch("sasrec").build_cell("train_batch", device="cpu",
                                                                   mesh=object()),
        "recsys_serve_cell": lambda: get_arch("dien").build_cell("serve_p99", device="cpu",
                                                                 mesh=object()),
        "dlrm_retrieval_cell": lambda: get_arch("dlrm-rm2").build_cell(
            "retrieval_cand", device="cpu", mesh=object()),
    }
    with pytest.raises(TypeError, match="DeviceMesh"):
        calls[entry]()


# ------------------------------------------------------------- examples


def _example(name):
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def test_quickstart_example_matches_the_library():
    from repro_torch.core import IpNSW, IpNSWPlus, exact_topk, recall_at_k
    from repro_torch.data import mips_dataset, mips_queries

    rows = _example("quickstart_torch").main(["--device", "cpu", "--n-items", "1200",
                                              "--queries", "16"])
    assert [(r["algo"], r["ef"]) for r in rows] == [
        (a, ef) for ef in (10, 20, 40, 80) for a in ("ip-NSW", "ip-NSW+")]
    items, q = mips_dataset(1200, 64, profile="lognormal", seed=0), mips_queries(16, 64, seed=1)
    gt = exact_topk(torch.as_tensor(q), torch.as_tensor(items), k=10)[1].numpy()
    knobs = dict(max_degree=16, ef_construction=32, insert_batch=512, device="cpu")
    for cls, name in ((IpNSW, "ip-NSW"), (IpNSWPlus, "ip-NSW+")):
        r = cls(**knobs).build(items).search(q, k=10, ef=40)
        row = next(r_ for r_ in rows if r_["algo"] == name and r_["ef"] == 40)
        assert row["recall"] == recall_at_k(r.ids.numpy(), gt)
        assert row["evals"] == float(np.mean(r.evals.numpy()))
    assert all(r["recall"] > 0.7 for r in rows if r["ef"] >= 40)


def test_norm_bias_example_matches_the_library():
    from repro_torch.core import exact_topk
    from repro_torch.core.norms import theorem1_probability, top_group_share
    from repro_torch.data import mips_dataset, mips_queries

    table = _example("norm_bias_analysis_torch").main(["--device", "cpu", "--n-items", "2000",
                                                       "--queries", "40"])
    items, q = mips_dataset(2000, 64, profile="lognormal", seed=0), mips_queries(40, 64, seed=1)
    gt = exact_topk(torch.as_tensor(q), torch.as_tensor(items), k=10)[1].numpy()
    assert table["fig1_top5_share"] == top_group_share(gt, np.linalg.norm(items, axis=1), 5.0)
    assert table["fig3a"][2.0] == theorem1_probability(2.0)
    assert sorted(table["fig3b"]) == [40, 200, 2000]
    assert table["fig3b"][2000] == table["fig1_top5_share"]
    assert table["fig4_top5_in_degree_ratio"] > 1.0
    assert 0.0 < table["fig5_top5_eval_share"] <= 1.0


def test_distributed_serving_example_matches_the_library():
    from repro_torch.core import build_sharded, exact_topk, recall_at_k, sharded_search
    from repro_torch.data import mips_dataset, mips_queries

    rows = _example("distributed_serving_torch").main(["--device", "cpu", "--n-items", "2400",
                                                       "--queries", "16"])
    items, q = mips_dataset(2400, 48, profile="lognormal", seed=0), mips_queries(16, 48, seed=1)
    gt = exact_topk(torch.as_tensor(q), torch.as_tensor(items), k=10)[1].numpy()
    index = build_sharded(items, 8, plus=True, build_backend="scan", device="cpu",
                          max_degree=16, ef_construction=32, insert_batch=512)
    mask = np.ones(8, bool)
    mask[3] = False
    for row, shard_mask in zip(rows, (None, mask)):
        ids = sharded_search(index, q, k=10, ef=40, shard_mask=shard_mask)[0]
        assert row["recall"] == recall_at_k(ids.numpy(), gt)
    assert rows[0]["shards_up"] == 8 and rows[1]["shards_up"] == 7
    assert rows[1]["recall"] <= rows[0]["recall"]
