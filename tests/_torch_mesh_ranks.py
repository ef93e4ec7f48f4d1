"""One gloo rank of the port's mesh checks (tests/test_torch_mesh.py).

  python tests/_torch_mesh_ranks.py RANK WORLD STORE INPUTS OUT

Eight ranks join one process group over a FileStore and run the port's
sharded paths on the (2, 4) (data, model) mesh and on the (8,) data mesh
(the LM cells also on the (2, 2, 2) (pod, data, model) mesh), on the inputs
the test drew (INPUTS, an .npz keyed by leaf name); rank 0 also runs the
local paths and writes every result to OUT.  The shapes and configs are
shared with the test and the JAX reference script.
"""
import dataclasses
import functools
import sys

import numpy as np
import torch
import torch.distributed as dist

import _torch_mesh_cfgs as C
from _torch_mesh_cfgs import RECSYS_CFGS, RECSYS_STEP
from repro_torch.configs import get_arch
from repro_torch.configs.common import (RECSYS_SHAPES, GNNArch, LMArch, RecsysArch,
                                        mesh_value_and_grad, sharded_topk)
from repro_torch.launch.mesh import (MODEL_AXIS, P, axis_group, batch_axes_of, gather_rows,
                                     local_shard, local_tree, spec_axes)
from repro_torch.models import gnn as G
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.recsys.mind import MINDConfig
from repro_torch.models.recsys.sasrec import SASRecConfig
from repro_torch.train.compress import error_init, make_compressed_allreduce
from repro_torch.train.optimizer import AdamWState, adamw_init
from repro_torch.train.tree import named_leaves, tree_map, unflatten, value_and_grad

MESH_SHAPE, MESH_AXES = (2, 4), ("data", "model")
MOE = dict(d=16, f=32, experts=8, top_k=2, batch=(4, 8))
MOE_CAPACITIES = (16.0, 1.25)
GNN_CFG = G.GNNConfig(n_layers=2, d_hidden=16, d_feat=8, d_edge=4, remat=True)
GNN_GRAPH = dict(nodes=64, edges=128)
GNN_CELL = "molecule"  # the cell whose step the mesh runs (d_feat 16)
COMPRESS = dict(shape=(8, 512), steps=20)
LM_CFG = T.TransformerConfig(name="t", n_layers=2, d_model=32, n_heads=4, n_kv=2, head_dim=8,
                             d_ff=64, vocab=64, dtype=torch.float32, moe_experts=4, moe_top_k=2)
LM_TOKENS = (4, 16)
RETRIEVAL = dict(items=4096, dim=16, batch=8, k=100)
RETRIEVAL_CFGS = {"sasrec": SASRecConfig(embed_dim=16, n_items=4096),
                  "mind": MINDConfig(embed_dim=16, n_items=4096)}
# each recsys cell's batch (DLRM's retrieval: its candidate rows); the
# configs and the starting step are tests/_torch_mesh_cfgs.py's
RECSYS_BATCH = {"train_batch": 8, "serve_p99": 4, "serve_bulk": 8, "retrieval_cand": 512}
RECSYS_CANDIDATES = 16  # SASRec's and MIND's serve: candidates a user


def recsys_opt(inputs, aid: str, params) -> AdamWState:
    """The drawn moments at step RECSYS_STEP."""
    return AdamWState(step=torch.tensor(RECSYS_STEP, dtype=torch.int32),
                      mu=tree_from(inputs, f"recsys/{aid}/mu", params),
                      nu=tree_from(inputs, f"recsys/{aid}/nu", params))


def recsys_cells():
    """(arch id, shape) of every recsys cell the mesh runs here: all but
    the SASRec, MIND and DIEN retrievals, which ``run_retrieval`` covers."""
    return [(aid, shape) for aid in RECSYS_CFGS for shape in RECSYS_SHAPES
            if shape != "retrieval_cand" or aid == "dlrm-rm2"]


def tree_from(inputs, prefix: str, template):
    """``template``'s structure with its leaves read from ``inputs``."""
    return unflatten(template, [torch.as_tensor(inputs[prefix + name])
                                for name, _ in named_leaves(template)])


def gather_spec(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block (``local_shard``'s inverse
    for a spec cutting one dimension)."""
    for dim, entry in enumerate(spec):
        axes = spec_axes(P(entry))
        if axes:
            t = gather_rows(t.movedim(dim, 0), axis_group(mesh, axes)).movedim(0, dim)
    return t


def gather_tree(tree, specs, mesh):
    return tree_map(lambda t, s: gather_spec(t, s, mesh), tree, specs)


def put(out: dict, prefix: str, tree) -> None:
    for name, t in named_leaves(tree):
        out[prefix + name] = t.detach().numpy()


def run_moe(inputs, mesh, out, rank):
    params = {k: torch.as_tensor(inputs["moe/" + k])
              for k in ("router", "w_gate", "w_in", "w_out")}
    x = torch.as_tensor(inputs["moe/x"])
    held = local_tree(params, M.moe_specs(), mesh)
    x_blk = local_shard(x, P("data", None, None), mesh)
    kw = dict(n_experts=MOE["experts"], top_k=MOE["top_k"])
    for cf in MOE_CAPACITIES:
        o, aux = M.moe_apply(held, x_blk, capacity_factor=cf, mesh=mesh, **kw)
        out[f"moe/{cf}/out"] = gather_spec(o, P("data"), mesh).numpy()
        out[f"moe/{cf}/aux"] = aux.numpy()
    if rank == 0:
        o, aux = M.moe_apply(params, x, capacity_factor=MOE_CAPACITIES[0], **kw)
        out["moe/local/out"], out["moe/local/aux"] = o.numpy(), aux.numpy()


def run_gnn(inputs, mesh, out, rank):
    params = tree_from(inputs, "gnn/params", G.init(GNN_CFG, device="meta"))
    graph = {k: torch.as_tensor(inputs["gnn/" + k])
             for k in ("node_feat", "edge_feat", "src", "dst", "targets")}
    axes = G.mesh_axes(mesh)
    blk = local_tree(graph, G.data_specs(axes), mesh)
    with torch.no_grad():
        o = G.forward(params, blk, GNN_CFG, mesh)
    out["gnn/out"] = gather_rows(o, axis_group(mesh, axes)).numpy()
    loss, grads = mesh_value_and_grad(G.mse_loss, mesh, axes)(params, blk, GNN_CFG)
    out["gnn/loss"] = loss.numpy()
    put(out, "gnn/grad/", grads)
    if rank == 0:
        with torch.no_grad():
            out["gnn/local/out"] = G.forward(params, graph, GNN_CFG).numpy()
        loss, grads = value_and_grad(G.mse_loss)(params, graph, GNN_CFG)
        out["gnn/local/loss"] = loss.numpy()
        put(out, "gnn/local/grad/", grads)

    # the cell's train step: this rank's blocks under the mesh, the whole
    # graph without one
    arch = GNNArch("meshgraphnet", GNN_CFG)
    cell_params = tree_from(inputs, "gnn_cell/params", G.init(arch.config_for(GNN_CELL),
                                                              device="meta"))
    cell_graph = {k: torch.as_tensor(inputs["gnn_cell/" + k])
                  for k in ("node_feat", "edge_feat", "src", "dst", "targets")}
    cell = arch.build_cell(GNN_CELL, device="cpu", mesh=mesh)
    pspecs, ospecs, gspecs = cell.in_specs
    p = local_tree(cell_params, pspecs, mesh)
    new_p, _, loss = cell.step_fn(p, adamw_init(p), local_tree(cell_graph, gspecs, mesh))
    out["gnn_cell/loss"] = loss.numpy()
    put(out, "gnn_cell/new/", new_p)
    if rank == 0:
        p = tree_map(torch.clone, cell_params)
        new_p, _, loss = arch.build_cell(GNN_CELL, device="cpu").step_fn(p, adamw_init(p),
                                                                         cell_graph)
        out["gnn_cell/local/loss"] = loss.numpy()
        put(out, "gnn_cell/local/new/", new_p)


def run_compress(inputs, mesh8, out):
    f = make_compressed_allreduce(mesh8, ("data",))
    x = local_shard(torch.as_tensor(inputs["compress/x"]), P("data"), mesh8)
    e = error_init(x)
    group = axis_group(mesh8, ("data",))
    means, errors = [], []
    for _ in range(COMPRESS["steps"]):
        m, e = f(x, e)
        means.append(gather_rows(m, group))
        errors.append(gather_rows(e, group))
    out["compress/mean"] = torch.stack(means).numpy()
    out["compress/error"] = torch.stack(errors).numpy()


def run_lm(inputs, mesh, out, rank):
    arch = LMArch("t", LM_CFG)
    cell = arch.build_cell("train_4k", device="cpu", mesh=mesh)  # sets the batch axes
    pspecs, _, batch_specs = cell.in_specs
    axes = spec_axes(batch_specs["tokens"])
    params = tree_from(inputs, "lm/params", T.init(LM_CFG, device="meta"))
    tokens = torch.as_tensor(inputs["lm/tokens"])
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    held = local_tree(params, pspecs, mesh)
    blk = local_tree(batch, batch_specs, mesh)
    with torch.no_grad():
        out["lm/loss"] = T.lm_loss(held, blk, LM_CFG, mesh).numpy()
    # the gradient, without the aux statistic (a data shard's) and drops
    cfg16 = dataclasses.replace(LM_CFG, capacity_factor=16.0)
    loss_fn = functools.partial(T.lm_loss, aux_weight=0.0)
    loss, grads = mesh_value_and_grad(loss_fn, mesh, axes, pspecs)(held, blk, cfg16)
    out["lm/grad_loss"] = loss.numpy()
    put(out, "lm/grad/", gather_tree(grads, pspecs, mesh))
    # the cell's train step on this rank's blocks (written in place)
    new_p, _, loss = cell.step_fn(held, adamw_init(held), blk)
    out["lm_cell/loss"] = loss.numpy()
    put(out, "lm_cell/new/", gather_tree(new_p, pspecs, mesh))
    if rank == 0:
        with torch.no_grad():
            out["lm/local/loss"] = T.lm_loss(params, batch, LM_CFG).numpy()
        loss, grads = value_and_grad(loss_fn)(params, batch, cfg16)
        out["lm/local/grad_loss"] = loss.numpy()
        put(out, "lm/local/grad/", grads)
        p = tree_map(torch.clone, params)
        new_p, _, loss = arch.build_cell("train_4k", device="cpu").step_fn(p, adamw_init(p),
                                                                           batch)
        out["lm_cell/local/loss"] = loss.numpy()
        put(out, "lm_cell/local/new/", new_p)


def run_lm_cells(inputs, meshes, out, rank):
    """Each LM cell of C.LM_CFGS's two configs through ``build_cell(...,
    mesh=)`` on both of C.LM_MESHES, on this rank's blocks of the inputs
    (``Cell.in_specs``, JAX's), the outputs gathered whole; rank 0 also
    runs every cell without a mesh ("local")."""
    for cname, fields in C.LM_CFGS.items():
        cfg = T.TransformerConfig(**fields, dtype=torch.float32)
        arch = LMArch(cname, cfg)
        pre = f"lmc/{cname}/"
        template = T.init(cfg, device="meta")
        params = tree_from(inputs, pre + "params", template)
        moments = (tree_from(inputs, pre + "mu", template), tree_from(inputs, pre + "nu", template))
        toks = torch.as_tensor(inputs[pre + "tokens"])
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
        runs = [(name, meshes[name]) for name in C.LM_MESHES]
        for where, mesh in runs + ([("local", None)] if rank == 0 else []):
            def cut(tree, spec, mesh=mesh):
                return tree_map(torch.clone, tree) if mesh is None else local_tree(tree, spec,
                                                                                     mesh)

            def whole(tree, spec, mesh=mesh):
                return tree if mesh is None else gather_tree(tree, spec, mesh)

            at = f"{pre}{where}/"
            rows = () if mesh is None else batch_axes_of(mesh)
            for shape in arch.shape_names():
                cell = arch.build_cell(shape, device="cpu", mesh=mesh)
                specs = cell.in_specs or (None,) * 4
                if shape == "train_4k":
                    opt = AdamWState(step=torch.tensor(C.LM_STEP, dtype=torch.int32),
                                     mu=moments[0], nu=moments[1])
                    new_p, new_o, loss = cell.step_fn(cut(params, specs[0]), cut(opt, specs[1]),
                                                      cut(batch, specs[2]))
                    out[at + "train/loss"] = loss.detach().numpy()
                    put(out, at + "train/new", whole(new_p, specs[0]))
                    put(out, at + "train/mu", whole(new_o.mu, specs[0]))
                    put(out, at + "train/nu", whole(new_o.nu, specs[0]))
                elif shape == "prefill_32k":
                    logits, caches = cell.step_fn(cut(params, specs[0]), cut(toks, specs[1]))
                    out[at + "prefill/logits"] = whole(logits, P(rows, MODEL_AXIS)).numpy()
                    put(out, at + "prefill/caches",
                        whole(caches, T.cache_specs(cfg, batch=rows, seq=(MODEL_AXIS,))))
                else:
                    caches = tree_from(inputs, f"{pre}{shape}/caches", T.init_cache(
                        cfg, C.LM_SHAPES[shape]["batch"], C.LM_SHAPES[shape]["seq"],
                        device="meta"))
                    token = torch.as_tensor(inputs[f"{pre}{shape}/token"])
                    logit_rows = () if shape == "long_500k" else rows
                    for q in C.LM_DECODE_OFFSETS:
                        logits, new = cell.step_fn(cut(params, specs[0]), cut(caches, specs[1]),
                                                   cut(token, specs[2]), q)
                        out[f"{at}{shape}/{q}/logits"] = whole(
                            logits, P(logit_rows, MODEL_AXIS)).numpy()
                        put(out, f"{at}{shape}/{q}/caches", whole(new, specs[1]))


def run_retrieval(inputs, mesh, out, rank):
    for aid, cfg in RETRIEVAL_CFGS.items():
        arch = RecsysArch(aid, cfg)
        params = arch.init(torch.Generator().manual_seed(7), device="cpu")
        hist = torch.as_tensor(inputs[f"retrieval/{aid}/hist"])
        got = arch.build_cell("retrieval_cand", device="cpu", mesh=mesh).step_fn(params, hist)
        out[f"retrieval/{aid}/ids"] = got["ids"].numpy()
        out[f"retrieval/{aid}/scores"] = got["scores"].numpy()
        if rank == 0:
            want = arch.build_cell("retrieval_cand", device="cpu").step_fn(params, hist)
            out[f"retrieval/{aid}/local/ids"] = want["ids"].numpy()
            out[f"retrieval/{aid}/local/scores"] = want["scores"].numpy()
    # equal scores on every shard: each model rank holds the same block
    group = axis_group(mesh, (MODEL_AXIS,))
    block = torch.as_tensor(inputs["ties/block"])
    for interests in (False, True):
        u = torch.as_tensor(inputs[f"ties/u/{interests}"])
        v, i = sharded_topk(u, block, mesh.get_local_rank(MODEL_AXIS), group,
                            RETRIEVAL["k"], interests=interests)
        out[f"ties/{interests}/ids"], out[f"ties/{interests}/scores"] = i.numpy(), v.numpy()


def run_recsys(inputs, mesh, out, rank):
    """Each recsys cell's step on this rank's blocks (``Cell.in_specs``),
    its outputs gathered whole; rank 0 also runs the cell without a mesh."""
    rows = P(batch_axes_of(mesh))
    for aid, shape in recsys_cells():
        arch = RecsysArch(aid, dataclasses.replace(get_arch(aid).cfg, **RECSYS_CFGS[aid]))
        params = tree_from(inputs, f"recsys/{aid}/params", arch.init(device="meta"))
        pre = f"recsys/{aid}/{shape}/"
        batch = {k[len(pre + "in/"):]: torch.as_tensor(v) for k, v in inputs.items()
                 if k.startswith(pre + "in/")}
        for where, cell in (("mesh", arch.build_cell(shape, device="cpu", mesh=mesh)),
                            ("local", arch.build_cell(shape, device="cpu"))):
            if where == "local" and rank != 0:
                continue
            p, b = tree_map(torch.clone, params), batch
            o = recsys_opt(inputs, aid, params) if shape == "train_batch" else None
            if where == "mesh":
                p, b = local_tree(p, cell.in_specs[0], mesh), local_tree(b, cell.in_specs[-1], mesh)
                o = None if o is None else local_tree(o, cell.in_specs[1], mesh)
            if shape == "train_batch":
                new_p, new_o, loss = cell.step_fn(p, o, b)
                out[f"{pre}{where}/loss"] = loss.detach().numpy()
                mu, nu = new_o.mu, new_o.nu
                if where == "mesh":
                    new_p = gather_tree(new_p, cell.in_specs[0], mesh)
                    mu = gather_tree(mu, cell.in_specs[1].mu, mesh)
                    nu = gather_tree(nu, cell.in_specs[1].nu, mesh)
                put(out, f"{pre}{where}/new/", new_p)
                put(out, f"{pre}{where}/mu/", mu)
                put(out, f"{pre}{where}/nu/", nu)
            elif shape == "retrieval_cand":
                got = cell.step_fn(p, b)
                out[f"{pre}{where}/ids"] = got["ids"].numpy()
                out[f"{pre}{where}/scores"] = got["scores"].numpy()
            else:
                got = cell.step_fn(p, b)
                out[f"{pre}{where}/out"] = (gather_spec(got, rows, mesh) if where == "mesh"
                                            else got).numpy()


def main(argv) -> None:
    rank, world, store, inputs_path, out_path = (int(argv[0]), int(argv[1]), *argv[2:])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", MESH_SHAPE, mesh_dim_names=MESH_AXES)
    mesh8 = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    lm_meshes = {name: mesh if shape == MESH_SHAPE else
                 init_device_mesh("cpu", shape, mesh_dim_names=axes)
                 for name, (shape, axes) in C.LM_MESHES.items()}
    inputs = dict(np.load(inputs_path))
    out = {}
    run_moe(inputs, mesh, out, rank)
    run_gnn(inputs, mesh, out, rank)
    run_compress(inputs, mesh8, out)
    run_lm(inputs, mesh, out, rank)
    run_lm_cells(inputs, lm_meshes, out, rank)
    run_retrieval(inputs, mesh, out, rank)
    run_recsys(inputs, mesh, out, rank)
    dist.barrier()
    if rank == 0:
        np.savez(out_path, **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
