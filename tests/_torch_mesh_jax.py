"""The JAX package's sharded runs that tests/test_torch_mesh.py holds the
port to, on 8 forced host devices, each jitted:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
      python tests/_torch_mesh_jax.py INPUTS OUT

The configs are tests/_torch_mesh_ranks.py's (the recsys and LM cells'
tests/_torch_mesh_cfgs.py's); the inputs (an .npz keyed by the leaves'
keystr names) the test's.  The LM cells are ``build_cell``'s at
tests/_torch_mesh_cfgs.py's small shapes (``LM_SHAPES`` replaced in this
process), jitted with their in_shardings on both meshes.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_mesh_cfgs as C
from _torch_mesh_cfgs import RECSYS_CFGS, RECSYS_STEP
from repro.configs import get_arch
from repro.configs import common as jcommon
from repro.configs.common import RECSYS_SHAPES, LMArch, shardings
from repro.launch.mesh import make_mesh_compat
from repro.models import gnn as G
from repro.models import layers as L
from repro.models import moe as M
from repro.models import transformer as T
from repro.train.compress import make_compressed_allreduce
from repro.train.optimizer import AdamWState

GNN_CFG = G.GNNConfig(n_layers=2, d_hidden=16, d_feat=8, d_edge=4, remat=True)
LM_CFG = T.TransformerConfig(name="t", n_layers=2, d_model=32, n_heads=4, n_kv=2, head_dim=8,
                             d_ff=64, vocab=64, dtype=jnp.float32, attn_chunk=8, remat=False,
                             moe_experts=4, moe_top_k=2)
MOE_CAPACITIES = (16.0, 1.25)
COMPRESS_STEPS = 20


def tree_from(inputs, prefix, abstract):
    paths, treedef = jax.tree_util.tree_flatten_with_path(abstract)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(inputs[prefix + jax.tree_util.keystr(p)]) for p, _ in paths])


def put(out, prefix, tree):
    for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(p)] = np.asarray(leaf)


def main(inputs_path, out_path):
    inputs = dict(np.load(inputs_path))
    mesh = make_mesh_compat((2, 4), ("data", "model"))
    out = {}

    params = {k: jnp.asarray(inputs["moe/" + k]) for k in ("router", "w_gate", "w_in", "w_out")}
    x = jnp.asarray(inputs["moe/x"])
    for cf in MOE_CAPACITIES:
        o, aux = jax.jit(lambda p, x, cf=cf: M.moe_apply(
            p, x, n_experts=8, top_k=2, capacity_factor=cf, mesh=mesh))(params, x)
        out[f"moe/{cf}/out"], out[f"moe/{cf}/aux"] = np.asarray(o), np.asarray(aux)

    params = tree_from(inputs, "gnn/params",
                       jax.eval_shape(lambda k: G._init_params(k, GNN_CFG), jax.random.PRNGKey(0)))
    graph = {k: jnp.asarray(inputs["gnn/" + k])
             for k in ("node_feat", "edge_feat", "src", "dst", "targets")}
    out["gnn/out"] = np.asarray(jax.jit(lambda p, g: G.forward(p, g, GNN_CFG, mesh))(params, graph))
    loss, grads = jax.jit(jax.value_and_grad(lambda p, g: G.mse_loss(p, g, GNN_CFG, mesh)))(
        params, graph)
    out["gnn/loss"] = np.asarray(loss)
    put(out, "gnn/grad/", grads)

    mesh8 = make_mesh_compat((8,), ("data",))
    f = jax.jit(make_compressed_allreduce(mesh8, ("data",)))
    x = jnp.asarray(inputs["compress/x"])
    e = jnp.zeros_like(x)
    means, errors = [], []
    for _ in range(COMPRESS_STEPS):
        m, e = f(x, e)
        means.append(np.asarray(m))
        errors.append(np.asarray(e))
    out["compress/mean"], out["compress/error"] = np.stack(means), np.stack(errors)

    L.set_batch_axes_for_mesh(mesh)
    params = tree_from(inputs, "lm/params", T.abstract_params(LM_CFG))
    params = jax.device_put(params, jax.tree.map(lambda s: NamedSharding(mesh, s),
                                                 T.specs(LM_CFG),
                                                 is_leaf=lambda s: isinstance(s, P)))
    toks = jnp.asarray(inputs["lm/tokens"])
    batch = {"tokens": toks, "labels": jnp.roll(toks, -1, 1)}
    with mesh:
        loss = jax.jit(lambda p, b: T.lm_loss(p, b, LM_CFG, mesh))(params, batch)
    out["lm/loss"] = np.asarray(loss)

    # the recsys cells, jitted with their in_shardings on the (2, 4) mesh
    for aid, small in RECSYS_CFGS.items():
        arch = get_arch(aid)
        arch = dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg, **small))
        abstract = jax.eval_shape(lambda k: arch.mod._init_params(k, arch.cfg),
                                  jax.random.PRNGKey(0))
        params = tree_from(inputs, f"recsys/{aid}/params", abstract)
        for shape in RECSYS_SHAPES:
            if shape == "retrieval_cand" and aid != "dlrm-rm2":
                continue
            pre = f"recsys/{aid}/{shape}/"
            batch = {k[len(pre + "in/"):]: jnp.asarray(v) for k, v in inputs.items()
                     if k.startswith(pre + "in/")}
            cell = arch.build_cell(shape, mesh)
            opt = AdamWState(step=jnp.asarray(RECSYS_STEP, jnp.int32),
                             mu=tree_from(inputs, f"recsys/{aid}/mu", abstract),
                             nu=tree_from(inputs, f"recsys/{aid}/nu", abstract))
            args = (params, opt, batch) if shape == "train_batch" else (params, batch)
            with mesh:
                res = jax.jit(cell.step_fn, in_shardings=shardings(mesh, cell.in_specs))(*args)
            if shape == "train_batch":
                put(out, pre + "new/", res[0])
                put(out, pre + "mu/", res[1].mu)
                put(out, pre + "nu/", res[1].nu)
                out[pre + "loss"] = np.asarray(res[2])
            elif shape == "retrieval_cand":
                out[pre + "ids"], out[pre + "scores"] = np.asarray(res["ids"]), np.asarray(
                    res["scores"])
            else:
                out[pre + "out"] = np.asarray(res)
    run_lm_cells(inputs, out)
    np.savez(out_path, **out)


def run_lm_cells(inputs, out):
    """Each LM cell of tests/_torch_mesh_cfgs.py's two configs on both
    meshes: train from drawn moments at LM_STEP, prefill, decode at each
    LM_DECODE_OFFSETS (q_offset a traced scalar: one compile) from drawn
    caches, and the dense config's long-context decode."""
    jcommon.LM_SHAPES.update(C.LM_SHAPES)
    for cname, fields in C.LM_CFGS.items():
        cfg = T.TransformerConfig(**fields, dtype=jnp.float32)
        arch = LMArch(cname, cfg)
        pre = f"lmc/{cname}/"
        abstract = T.abstract_params(cfg)
        params = tree_from(inputs, pre + "params", abstract)
        opt = AdamWState(step=jnp.asarray(C.LM_STEP, jnp.int32),
                         mu=tree_from(inputs, pre + "mu", abstract),
                         nu=tree_from(inputs, pre + "nu", abstract))
        toks = jnp.asarray(inputs[pre + "tokens"])
        for mname, (shape, axes) in C.LM_MESHES.items():
            mesh = make_mesh_compat(shape, axes)
            at = f"{pre}{mname}/"
            for shape_name in arch.shape_names():
                cell = arch.build_cell(shape_name, mesh)
                step = jax.jit(cell.step_fn, in_shardings=shardings(mesh, cell.in_specs))
                if shape_name == "train_4k":
                    with mesh:
                        new_p, new_o, loss = step(params, opt, {"tokens": toks,
                                                                "labels": jnp.roll(toks, -1, 1)})
                    out[at + "train/loss"] = np.asarray(loss)
                    put(out, at + "train/new", new_p)
                    put(out, at + "train/mu", new_o.mu)
                    put(out, at + "train/nu", new_o.nu)
                elif shape_name == "prefill_32k":
                    with mesh:
                        logits, caches = step(params, toks)
                    out[at + "prefill/logits"] = np.asarray(logits)
                    put(out, at + "prefill/caches", caches)
                else:
                    sh = C.LM_SHAPES[shape_name]
                    caches = tree_from(inputs, f"{pre}{shape_name}/caches", jax.eval_shape(
                        lambda: T.init_cache(cfg, sh["batch"], sh["seq"])))
                    token = jnp.asarray(inputs[f"{pre}{shape_name}/token"])
                    for q in C.LM_DECODE_OFFSETS:
                        with mesh:
                            logits, new = step(params, caches, token, jnp.asarray(q, jnp.int32))
                        out[f"{at}{shape_name}/{q}/logits"] = np.asarray(logits)
                        put(out, f"{at}{shape_name}/{q}/caches", new)


if __name__ == "__main__":
    main(*sys.argv[1:])
