"""How far MeshGraphNet's fp32 output, loss and gradients at its published
widths are from a float64 run of the same weights and graph, on the CPU
(the port's plain PyTorch).

  PYTHONPATH=src python scripts/gnn_grad_conditioning.py [--shape full_graph_sm] [--seed 0]

The case is ``chip_smoke.py`` phase 12 (c)'s: the shape's whole graph
(``graph_edges``: the port's ``random_csr``, each CSR row's neighbour v of
row u the edge v -> u, cut or padded with -1 to the shape's edge count),
features, targets and weights drawn from CPU generators of ``--seed``,
15 layers at d_hidden 128.  It prints, for the output, the loss and each
gradient leaf, max |x32 - x64| over max |x64|.  Phase 12 (c) holds the card
to the CPU (both fp32; the card's ``index_add_`` sums in the order its
atomics land) within limits set from these (GNN_OUT_RTOL, GNN_LOSS_RTOL,
GNN_GRAD_RTOL): each of the two runs carries an error of this size.

``graph_edges``, ``random_graph`` and ``case`` are also what
``chip_smoke.py`` phase 12 builds its graphs with.
"""
import argparse
import math

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.common import GNN_SHAPES
from repro_torch.models import gnn
from repro_torch.models.sampler import random_csr
from repro_torch.train import value_and_grad
from repro_torch.train.tree import named_leaves, tree_map


def graph_edges(n_nodes: int, n_edges: int, seed: int):
    """(src, dst, padding) int32: the edges of ``random_csr(n_nodes,
    ceil(n_edges / n_nodes))`` (row u's neighbour v is the edge v -> u, the
    sampler's direction, so the in-degree is the power law), the first
    ``n_edges`` of them, padded with -1 where there are fewer."""
    csr = random_csr(n_nodes, math.ceil(n_edges / n_nodes), np.random.default_rng(seed))
    src = csr.indices[:n_edges].astype(np.int32)
    dst = np.repeat(np.arange(n_nodes, dtype=np.int32), np.diff(csr.indptr))[:n_edges]
    pad = n_edges - len(src)
    if pad:
        src = np.concatenate([src, np.full(pad, -1, np.int32)])
        dst = np.concatenate([dst, np.full(pad, -1, np.int32)])
    return src, dst, pad


def random_graph(n_nodes: int, src, dst, cfg: gnn.GNNConfig, generator: torch.Generator,
                 device="cuda") -> dict:
    """The graph of ``src`` / ``dst`` with node and edge features and
    targets drawn N(0, 1) from ``generator`` (on its own device), on
    ``device``."""
    draw = lambda *shape: torch.randn(shape, generator=generator,  # noqa: E731
                                      device=generator.device).to(device)
    e = len(src)
    return {"node_feat": draw(n_nodes, cfg.d_feat), "edge_feat": draw(e, cfg.d_edge),
            "src": torch.as_tensor(src).to(device), "dst": torch.as_tensor(dst).to(device),
            "targets": draw(n_nodes, cfg.out_dim)}


def case(shape: str = "full_graph_sm", seed: int = 0):
    """(cfg, params, graph, padding) on the CPU: the published config at the
    shape's d_feat, weights from a CPU generator of ``seed``, the shape's
    whole graph."""
    cfg = get_arch("meshgraphnet").config_for(shape)
    sh = GNN_SHAPES[shape]
    params = gnn.init(cfg, torch.Generator().manual_seed(seed), device="cpu")
    src, dst, pad = graph_edges(sh["n_nodes"], sh["n_edges"], seed)
    graph = random_graph(sh["n_nodes"], src, dst, cfg, torch.Generator().manual_seed(seed),
                         device="cpu")
    return cfg, params, graph, pad


def outputs(params, graph, cfg):
    """{"out": forward, "loss": mse_loss, "grad<leaf>": each gradient leaf}."""
    with torch.no_grad():
        res = {"out": gnn.forward(params, graph, cfg)}
    loss, grads = value_and_grad(gnn.mse_loss)(params, graph, cfg)
    res["loss"] = loss
    res.update({f"grad{name}": g for name, g in named_leaves(grads)})
    return res


def rel_errs(got: dict, want: dict) -> dict:
    """Each entry's max |got - want| over max |want| (float64 on the CPU)."""
    out = {}
    for k, w in want.items():
        w = w.detach().double().cpu()
        out[k] = float((got[k].detach().double().cpu() - w).abs().max()
                       / w.abs().max().clamp(min=1e-300))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="full_graph_sm", choices=list(GNN_SHAPES))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    cfg, params, graph, pad = case(args.shape, args.seed)
    f32 = outputs(params, graph, cfg)
    to64 = lambda t: t.double() if t.is_floating_point() else t  # noqa: E731
    cfg64 = gnn.GNNConfig(**{**cfg.__dict__, "dtype": torch.float64})
    f64 = outputs(tree_map(to64, params), {k: to64(v) for k, v in graph.items()}, cfg64)
    errs = rel_errs(f32, f64)
    print(f"[gnn_grad_conditioning] {args.shape} seed={args.seed} layers={cfg.n_layers} "
          f"d_hidden={cfg.d_hidden} d_feat={cfg.d_feat} edges={len(graph['src'])} "
          f"padding={pad}; fp32 against float64, max |x32 - x64| / max |x64|:")
    for k, v in errs.items():
        print(f"  {k}: {v:.3g}")
    grads = {k: v for k, v in errs.items() if k.startswith("grad")}
    worst = max(grads, key=grads.get)
    print(f"[gnn_grad_conditioning] out {errs['out']:.3g} loss {errs['loss']:.3g} "
          f"worst gradient leaf {worst} {grads[worst]:.3g}")


if __name__ == "__main__":
    main()
