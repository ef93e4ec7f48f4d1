"""The port's dry-run and roofline (``repro_torch.launch.dryrun``,
``launch/roofline.py``) on the CPU, in process, as rank 0 of fake process
groups of 256 and 512 ranks: JAX's ``tests/test_dryrun.py`` assertions on
SASRec's ``serve_p99``, the per-rank scaling from one mesh to the other, a
record's argument bytes against a hand count, the sharded GNN layers'
collectives against their rule, the roofline's model flops and the cells'
metadata against the JAX package's, the LM cells' in_specs against JAX's
``build_cell`` and the bytes a rank of each holds against the shards of
JAX's ``specs()``, the kernel recorder, and the link model's premise."""
import gzip
import json
import math

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import all_cells, get_arch
from repro_torch.kernels import _lib
from repro_torch.kernels.topk_merge import topk_merge
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import local_tree, make_production_mesh
from repro_torch.train.tree import named_leaves

from test_torch_build import one_torch_thread  # noqa: F401 -- an autouse fixture


@pytest.fixture()
def fake_world():
    """``dryrun.fake_world``, torn down after the test."""
    yield dryrun.fake_world
    if dist.is_initialized():
        dist.destroy_process_group()


def test_dryrun_cell_traces_and_roofline_analyzes(tmp_path, fake_world):
    """tests/test_dryrun.py on the port: sasrec serve_p99 on the single-pod
    mesh, through the CLI."""
    dryrun.main(["--arch", "sasrec", "--shape", "serve_p99", "--mesh", "single",
                 "--out", str(tmp_path)])
    rec_path = tmp_path / "sasrec__serve_p99__single.json"
    assert rec_path.exists()
    rec = json.loads(rec_path.read_text())
    assert rec["n_devices"] == 256
    assert rec["mesh"] == "16x16"
    assert rec["cost"].get("flops", 0) > 0
    assert "peak_bytes_per_device" in rec["memory"]
    assert rec["compile_s"] == 0.0 and rec["lower_s"] >= 0
    with gzip.open(tmp_path / "sasrec__serve_p99__single.ops.json.gz", "rt") as f:
        ops = json.load(f)
    assert ops["kernel:gather_score_f32"]["count"] == 1  # the rerank, recorded

    out = roofline.analyze_record(str(rec_path))
    assert out["dominant"] in ("compute", "memory", "collective")
    assert out["compute_s"] >= 0 and out["memory_s"] > 0
    assert out["mem_gib_per_dev"] > 0


def test_two_pods_halve_a_rank_of_sasrec_serve(fake_world):
    """512 ranks: the batch of 512 over 32 batch ranks instead of 16, so a
    rank's flops are exactly half the single pod's; the replicated table is
    the same on both."""
    single = dryrun.run_cell("sasrec", "serve_p99", False, verbose=False)
    multi = dryrun.run_cell("sasrec", "serve_p99", True, verbose=False)
    assert (multi["n_devices"], multi["mesh"]) == (512, "2x16x16")
    assert multi["cost"]["flops"] * 2 == single["cost"]["flops"] > 0
    assert multi["cost"]["flops_by_dtype"] == {"fp32": multi["cost"]["flops"]}
    table = get_arch("sasrec").cfg.n_items * get_arch("sasrec").cfg.embed_dim * 4
    for rec in (single, multi):
        assert rec["memory"]["argument_size_in_bytes"] > table
        assert rec["collectives"]["ops"] == 0


def _mlp_params(widths) -> int:
    return sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))


def test_dlrm_train_arguments_are_the_rank_blocks(fake_world):
    """argument_size_in_bytes of DLRM's train_batch on 16x16: a sixteenth
    of each table's rows, the dense layers whole, AdamW's two moments of
    each and its step, and a sixteenth of the batch."""
    cfg = get_arch("dlrm-rm2").cfg
    rec = dryrun.run_cell("dlrm-rm2", "train_batch", False, verbose=False)
    dense = _mlp_params([cfg.n_dense, *cfg.bot_mlp]) + _mlp_params(
        [cfg.n_interact + cfg.embed_dim, *cfg.top_mlp])
    params = 4 * (cfg.n_sparse * (cfg.n_rows // 16) * cfg.embed_dim + dense)
    rows = 65_536 // 16
    batch = rows * (cfg.n_dense * 4 + cfg.n_sparse * 4 + 4)
    assert rec["memory"]["argument_size_in_bytes"] == 3 * params + 4 + batch
    # the AdamW state is written out of place: no output aliases an argument
    assert rec["memory"]["alias_size_in_bytes"] == 0
    assert rec["memory"]["peak_bytes_per_device"] >= (rec["memory"]["argument_size_in_bytes"]
                                                      + rec["memory"]["output_size_in_bytes"])
    kinds = rec["collectives"]["by_kind"]
    # each table lookup's sum over model, the loss's mean and the clip's norm
    assert set(kinds) == {"all-reduce"} and kinds["all-reduce"]["ops"] > 3


def test_meshgraphnet_collectives_follow_the_sharded_layer(fake_world):
    """full_graph_sm on 16x16: a sharded layer all-gathers the node state
    and reduce-scatters the aggregate; under remat the backward runs the
    layer again and then each collective's adjoint (a reduce-scatter and an
    all-gather), so 3 of each a layer; the rest are all-reduces (the loss
    and the gradient mean), and the in-place AdamW aliases its state."""
    cfg = get_arch("meshgraphnet").config_for("full_graph_sm")
    rec = dryrun.run_cell("meshgraphnet", "full_graph_sm", False, verbose=False)
    kinds = rec["collectives"]["by_kind"]
    per_layer = 3 if cfg.remat else 2
    assert kinds["all-gather"]["ops"] == kinds["reduce-scatter"]["ops"] == per_layer * cfg.n_layers
    assert set(kinds) == {"all-gather", "reduce-scatter", "all-reduce"}
    mem = rec["memory"]
    assert mem["alias_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert mem["peak_bytes_per_device"] == (mem["argument_size_in_bytes"] + mem[
        "output_size_in_bytes"] + mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"])


def _jax_meta(arch_id: str, shape: str, n_devices: int) -> dict:
    """The metadata JAX's ``build_cell`` makes, from JAX's shape tables and
    configs."""
    from repro.configs import get_arch as jax_arch
    from repro.configs.common import GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, _round_up

    arch = jax_arch(arch_id)
    if arch.family == "lm":
        sh = LM_SHAPES[shape]
        b, s = sh["batch"], sh["seq"]
        return dict(family="lm", arch=arch_id, shape=shape, kind=sh["kind"],
                    params=arch.cfg.param_count(), active_params=arch.cfg.active_param_count(),
                    tokens=b * s if sh["kind"] != "decode" else b)
    if arch.family == "gnn":
        sh, cfg = GNN_SHAPES[shape], arch.config_for(shape)
        return dict(family="gnn", arch=arch_id, shape=shape, kind="train",
                    n_nodes=_round_up(sh["n_nodes"], n_devices),
                    n_edges=_round_up(sh["n_edges"], n_devices), d_hidden=cfg.d_hidden,
                    n_layers=cfg.n_layers)
    sh = RECSYS_SHAPES[shape]
    return dict(family="recsys", arch=arch_id, shape=shape, kind=sh["kind"], batch=sh["batch"],
                n_cand=sh.get("n_cand", 0))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_model_flops_and_meta_match_jax(fake_world, multi_pod):
    """Every cell's meta equals JAX's and the port's model_flops equals
    JAX's on it (GNN cells on the mesh: their node and edge counts are
    rounded up to the rank count)."""
    from repro.launch.roofline import model_flops as jax_model_flops

    n = 512 if multi_pod else 256
    fake_world(n)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert len(all_cells()) == 36
    for arch_id, shape in all_cells():
        arch = get_arch(arch_id)
        cell = arch.build_cell(shape, device="meta", mesh=mesh if arch.family == "gnn" else None)
        assert cell.meta == _jax_meta(arch_id, shape, n), cell.name
        assert roofline.model_flops(cell.meta, n) == jax_model_flops(cell.meta, n), cell.name


LM_ARCHS = [a for a, shape in all_cells() if shape == "train_4k" and get_arch(a).family == "lm"]
MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


def _jax_lm_cell(arch_id: str, shape: str, multi_pod: bool):
    """JAX's ``build_cell`` on a stand-in of the production mesh (its axis
    names and sizes: the LM cells read nothing else), JAX's batch axes
    restored after."""
    from types import SimpleNamespace

    from repro.configs import get_arch as jax_arch
    from repro.models import layers as jl

    shape_, names = MESHES[multi_pod]
    saved = jl.batch_axes()
    try:
        return jax_arch(arch_id).build_cell(shape, SimpleNamespace(
            axis_names=names, shape=dict(zip(names, shape_))))
    finally:
        jl.set_batch_axes(saved)


def _jax_named(tree) -> list:
    import jax
    from jax.sharding import PartitionSpec

    paths = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in paths]


def _port_named(tree) -> list:
    return [(name, tuple(s)) for name, s in named_leaves(tree)]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_lm_in_specs_are_jax_in_specs(fake_world, multi_pod):
    """Every LM cell's in_specs under the production mesh equal JAX's
    ``build_cell``'s, leaf for leaf: (specs, adamw_specs, batch) for
    train, (specs, tokens) for prefill, (specs, caches, token, q_offset)
    for decode, where JAX's P() for the offset is None (a host int)."""
    from jax.sharding import PartitionSpec

    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    cells = [(a, shape) for a, shape in all_cells() if a in LM_ARCHS]
    assert len(cells) == 16
    for arch_id, shape in cells:
        got = get_arch(arch_id).build_cell(shape, device="meta", mesh=mesh).in_specs
        want = _jax_lm_cell(arch_id, shape, multi_pod).in_specs
        if len(want) == 4:  # decode
            assert got[3] is None and want[3] == PartitionSpec(), (arch_id, shape)
            got, want = got[:3], want[:3]
        assert _port_named(got) == _jax_named(want), (arch_id, shape)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_lm_rank_holds_jax_shard_bytes(fake_world, multi_pod):
    """The parameters and AdamW moments a rank's train_4k cell holds (its
    in_specs applied by ``local_tree`` to the meta tree) against the local
    shard of JAX's ``specs()`` (numpy arithmetic on the mesh shape), leaf
    for leaf, for every LM arch: the bytes equal, and no leaf that JAX cuts
    is held whole."""
    import numpy as np
    from repro.configs import get_arch as jax_arch
    from repro.models import transformer as jtf

    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    sizes = dict(zip(MESHES[multi_pod][1], MESHES[multi_pod][0]))
    for arch_id in LM_ARCHS:
        cell = get_arch(arch_id).build_cell("train_4k", device="meta", mesh=mesh)
        held = named_leaves(local_tree(cell.args[0], cell.in_specs[0], mesh))
        opt = local_tree(cell.args[1], cell.in_specs[1], mesh)
        jcfg = jax_arch(arch_id).cfg
        jspecs = dict(_jax_named(jtf.specs(jcfg)))
        jshapes = dict(_jax_named_shapes(jtf.abstract_params(jcfg)))
        assert sorted(n for n, _ in held) == sorted(jspecs) == sorted(jshapes)
        for (name, p), (_, m), (_, v) in zip(held, named_leaves(opt.mu), named_leaves(opt.nu)):
            shape, itemsize = jshapes[name]
            parts = [int(np.prod([sizes[a] for a in _axes(e)])) for e in jspecs[name]]
            parts += [1] * (len(shape) - len(parts))
            local = int(np.prod([d // c for d, c in zip(shape, parts)]))
            assert p.numel() * p.element_size() == local * itemsize, (arch_id, name)
            assert m.numel() * 4 == v.numel() * 4 == local * 4, (arch_id, name)
            if max(parts) > 1:
                assert p.numel() < int(np.prod(shape)), (arch_id, name)


def _axes(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def _jax_named_shapes(tree) -> list:
    import jax

    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(jax.tree_util.keystr(p), (tuple(a.shape), a.dtype.itemsize)) for p, a in paths]


def test_a_kernel_without_a_cost_raises_inside_the_recorder(monkeypatch):
    """topk_merge has no cost function: inside recording() its launch
    raises and its counter stays; a kernel with one records its cost."""
    from repro_torch.kernels.gather_score import gather_score
    from repro_torch.kernels.gather_score.ops import launch_cost

    monkeypatch.setattr(gather_score, "launches", 0)  # its counter moves here
    monkeypatch.setattr(gather_score, "launches_by_width", {})

    meta = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device="meta")  # noqa: E731
    args = (meta(4, 8), meta(4, 8, dtype=torch.int32), meta(4, 8, dtype=torch.int32),
            meta(4, 2), meta(4, 2, dtype=torch.int32), meta(4, 2, dtype=torch.int32))
    before = topk_merge.launches
    with _lib.recording() as rec:
        with pytest.raises(NotImplementedError, match="topk_merge_f32 has no cost"):
            topk_merge(*args)
        assert rec.launches == []
        assert _lib.stream(torch.device("meta")) == 0
        assert _lib.sm_count(torch.device("meta")) == 132
        out = gather_score(meta(3, 16), meta(100, 16), meta(3, 5, dtype=torch.int32))
    assert topk_merge.launches == before
    assert out.shape == (3, 5) and out.device.type == "meta"
    flops, nbytes = launch_cost(3, 5, 16)
    assert rec.launches == [_lib.Launch("gather_score_f32", flops, nbytes, "fp32")]
    with pytest.raises(ValueError, match="no kernel or plain version"):  # outside: as before
        topk_merge(*args)


def test_quant_score_records_its_launch_cost(monkeypatch):
    """quant_score on meta inside recording() records ``launch_cost`` with
    every id's row and slot (the data is unknown there), in fp32."""
    from repro_torch.kernels.quant_score import quant_score
    from repro_torch.kernels.quant_score.ops import launch_cost

    monkeypatch.setattr(quant_score, "launches", 0)
    monkeypatch.setattr(quant_score, "launches_by_width", {})
    meta = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device="meta")  # noqa: E731
    with _lib.recording() as rec:
        out = quant_score(meta(3, 16), meta(100, 16, dtype=torch.int8), meta(100),
                          meta(3, 5, dtype=torch.int32))
    assert out.shape == (3, 5) and quant_score.launches == 1
    flops, nbytes = launch_cost(3, 5, 16)
    assert (flops, nbytes) == (2.0 * 16 * 15, 15 * 8 + 15 * 20 + 3 * 16 * 4)
    assert rec.launches == [_lib.Launch("quant_score_i8", flops, nbytes, "fp32")]
    assert launch_cost(3, 5, 16, distinct=4, scored=9) == (2.0 * 16 * 9,
                                                           15 * 8 + 4 * 20 + 3 * 16 * 4)


def test_a_cuda_tensor_inside_the_recorder_raises():
    """The recorder launches nothing, so inside recording() a CUDA tensor
    (here a stand-in with a CUDA device: this host has no card) raises
    where it would take the card's path; outside, it takes that path, and a
    meta tensor raises as before."""
    from types import SimpleNamespace

    card = SimpleNamespace(device=torch.device("cuda", 0))
    meta = torch.empty(2, device="meta")
    assert _lib.on_cuda(card) and not _lib.on_card(meta)
    with _lib.recording():
        with pytest.raises(RuntimeError, match="CUDA tensor inside recording"):
            _lib.on_cuda(card)
        assert _lib.on_cuda(meta) and not _lib.on_cuda(torch.empty(2))
        with pytest.raises(RuntimeError, match="does not nest"):
            with _lib.recording():
                pass
    assert _lib.on_cuda(card)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        _lib.on_cuda(meta)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attn_records_what_each_launch_writes(dtype, monkeypatch):
    """A differentiable attention traced on meta records the forward with
    its lse (and bf16's fp32 residual) written, and the backward with its
    delta buffer; ``forward_cost`` / ``backward_cost`` alone, which
    chip_smoke.py's bounds read, count neither."""
    from repro_torch.kernels.flash_attn import ops as fa

    for name in ("launches", "launches_bf16", "launches_bwd", "launches_bwd_bf16"):
        monkeypatch.setattr(fa.flash_attention, name, 0)
    b, s, h, kvh, hd = 2, 64, 4, 2, 32
    q = torch.empty((b, s, h, hd), dtype=dtype, device="meta", requires_grad=True)
    k, v = (torch.empty((b, s, kvh, hd), dtype=dtype, device="meta") for _ in range(2))
    with _lib.recording() as rec:
        fa.flash_attention(q, k, v).sum().backward()
    size = torch.finfo(dtype).bits // 8
    fwd = fa.forward_cost(b, s, s, h, kvh, hd, 0, None, size)
    bwd = fa.backward_cost(b, s, s, h, kvh, hd, 0, None, size)
    lse, res = b * h * s * 4, (b * s * h * hd * 4 if dtype == torch.bfloat16 else 0)
    assert [(r.flops, r.nbytes) for r in rec.launches] == [
        (fwd[0], fwd[1] + lse + res),
        (bwd[0] * (fa.TF32_PASSES if dtype == torch.float32 else 1), bwd[1] + 3 * lse)]
    assert fa.forward_cost(b, s, s, h, kvh, hd, 0, None, size, lse=True,
                           residual=bool(res))[1] == fwd[1] + lse + res


@pytest.mark.parametrize("shape", [(16, 16), (2, 16, 16)])
def test_every_axis_group_spans_two_nodes(shape):
    """The link model's premise: no axis group of a production mesh fits
    in one 8-GPU NVLink node, so every ring crosses the network."""
    assert math.prod(shape) in (256, 512)
    for axis in range(len(shape)):
        assert roofline.axis_nodes(shape, axis) >= 2


def test_roofline_rates_are_the_cards():
    """The card model: chip_smoke.py's bounds read the same constants."""
    assert roofline.PEAK_FLOPS == {"bf16": 989e12, "fp32": 67e12, "tf32": 495e12}
    assert (roofline.HBM_BW, roofline.LINK_BW) == (3.35e12, 50e9)
    rec = {"cost": {"flops": 3e12, "bytes accessed": 6.7e12,
                    "flops_by_dtype": {"bf16": 989e12 / 1e3, "fp32": 67e12 / 1e3}},
           "collectives": {"wire_bytes": 5e9, "by_kind": {}, "ops": 0}}
    t = roofline.terms(rec)
    assert t["compute_s"] == pytest.approx(2e-3)
    assert t["memory_s"] == pytest.approx(2.0) and t["collective_s"] == pytest.approx(0.1)
