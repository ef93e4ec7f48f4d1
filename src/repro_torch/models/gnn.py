"""MeshGraphNet (Pfaff et al., arXiv:2010.03409), the JAX package's
``models/gnn.py``: an encode-process-decode GNN over an edge list.

Message passing is a segment reduction over the destination node:
``index_add_`` (sum) or ``scatter_reduce_`` "amax" (max), plain PyTorch on
the card as the JAX package's ``jax.ops.segment_sum`` / ``segment_max`` is
plain XLA outside Pallas.  On the card ``index_add_`` adds in the order its
atomics land, so a sum's last bits differ from run to run and from the CPU.

Parameters are JAX's tree with JAX's leaf names: ``node_enc``, ``edge_enc``
and ``dec`` MLPs, and ``proc`` with each leaf stacked ``[n_layers, ...]``
(JAX's ``jax.vmap(proc_init)``), so ``convert.params_from_arrays`` and the
checkpoint format carry a JAX tree as it is.  JAX's ``lax.scan`` over the
layers is a Python loop over views of the stacked leaves; with ``remat`` and
a gradient enabled each layer runs under ``torch.utils.checkpoint`` (JAX's
``jax.checkpoint(scan_body)``) and keeps only its carry.

A graph is ``{node_feat [N, d_feat], edge_feat [E, d_edge], src [E],
dst [E]}`` (int32, -1 padding; ``targets [N, out_dim]`` for the loss).

Entry points (``mesh`` must be None: the mesh tools are ROADMAP Queue 1's):
  init(cfg, generator, device=)          -> params
  forward(params, graph, cfg)            -> [N, out_dim]
  mse_loss(params, graph, cfg)           -> scalar loss
  forward_chunked(params, graph, cfg)    -> [N, out_dim] without a gradient,
                                            the edges in chunks and the edge
                                            state updated in place (a graph
                                            whose edge activations do not fit)
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import _dense_init, make_generator
from repro_torch.train.tree import leaves, tree_map

# rows (edges or nodes) forward_chunked takes at once: at d_hidden 128 its
# [chunk, 3 d_hidden] message input is 3 GiB
EDGE_CHUNK = 1 << 21


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2       # hidden layers per MLP (paper: 2)
    d_feat: int = 128         # input node-feature dim
    d_edge: int = 4           # input edge-feature dim (>=1; synthetic if absent)
    out_dim: int = 3          # decoded per-node output (e.g. acceleration)
    aggregator: str = "sum"
    dtype: Any = torch.float32
    remat: bool = True


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("a mesh is the mesh tools' (ROADMAP Queue 1, item 6); "
                                  "the port runs on one device")


# ---------------------------------------------------------------------------
# MLP + LayerNorm block (MeshGraphNet uses LN after every MLP)
# ---------------------------------------------------------------------------


def _mlp_ln_init(generator, d_in, d_hidden, d_out, n_hidden, dtype, device, ln=True, lead=()):
    """JAX's ``_mlp_ln_init``; ``lead`` stacks the leaves (the processor's
    ``[n_layers]``), each layer drawn with JAX's ``fan_in = d_in``."""
    dims = [d_in] + [d_hidden] * n_hidden + [d_out]
    p = {
        "w": [_dense_init(generator, (*lead, dims[i], dims[i + 1]), dtype, device)
              for i in range(len(dims) - 1)],
        "b": [torch.zeros((*lead, dims[i + 1]), dtype=dtype, device=device)
              for i in range(len(dims) - 1)],
    }
    if ln:
        p["ln_g"] = torch.ones((*lead, d_out), dtype=dtype, device=device)
        p["ln_b"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


def _mlp_ln(p, x: torch.Tensor) -> torch.Tensor:
    """The MLP, then JAX's LayerNorm: the population variance, ``rsqrt(var +
    1e-6)``, then the gain and the bias, op for op (``F.layer_norm``'s fused
    kernel rounds otherwise, and the gradient, 1e-3 from float64 in fp32,
    follows its rounding)."""
    n = len(p["w"])
    for i in range(n):
        x = x @ p["w"][i] + p["b"][i]
        if i < n - 1:
            x = F.relu(x)
    if "ln_g" in p:
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, correction=0)
        x = (x - mu) * torch.rsqrt(var + 1e-6) * p["ln_g"] + p["ln_b"]
    return x


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init(cfg: GNNConfig, generator=None, *, device="cuda"):
    """The parameter tree, drawn from ``generator`` (the port's values, not
    JAX's; the ``meta`` device gives shapes only)."""
    g = generator if generator is not None else make_generator(device)
    h, m = cfg.d_hidden, cfg.mlp_layers
    mk = lambda d_in, d_out, **kw: _mlp_ln_init(g, d_in, h, d_out, m, cfg.dtype, device, **kw)  # noqa: E731
    return {
        "node_enc": mk(cfg.d_feat, h),
        "edge_enc": mk(cfg.d_edge, h),
        # edge MLP input: [e, h_src, h_dst]; node MLP input: [h, agg(e)]
        "proc": {"edge": mk(3 * h, h, lead=(cfg.n_layers,)),
                 "node": mk(2 * h, h, lead=(cfg.n_layers,))},
        "dec": mk(h, cfg.out_dim, ln=False),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _empty_segments(n_nodes: int, like: torch.Tensor, aggregator: str) -> torch.Tensor:
    """[n_nodes + 1, d] of the aggregator's identity; the last row takes the
    padding edges (dst < 0) and is dropped."""
    if aggregator == "sum":
        fill = 0.0
    elif aggregator == "max":
        fill = float("-inf")
    else:
        raise ValueError(aggregator)
    return torch.full((n_nodes + 1, like.shape[-1]), fill, dtype=like.dtype, device=like.device)


def _reduce_into(agg: torch.Tensor, e: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                 aggregator: str) -> torch.Tensor:
    """``agg`` with the edges ``e`` reduced into their ``dst`` rows, in place.
    Max leaves an empty segment at -inf (``jax.ops.segment_max``) and splits
    the gradient equally among tied maxima."""
    seg = torch.where(dst >= 0, dst, n_nodes).to(torch.int64)
    if aggregator == "sum":
        return agg.index_add_(0, seg, e)
    return agg.scatter_reduce_(0, seg[:, None].expand_as(e), e, "amax", include_self=True)


def _aggregate(e: torch.Tensor, dst: torch.Tensor, n_nodes: int, aggregator: str = "sum"):
    agg = _reduce_into(_empty_segments(n_nodes, e, aggregator), e, dst, n_nodes, aggregator)
    return agg[:-1]


def _edge_update(lp, hn, e, src, dst):
    """``e + edge_mlp([e, hn[src], hn[dst]])`` (indices clamped at 0)."""
    msg_in = torch.cat([e, hn.index_select(0, src.clamp(min=0)),
                        hn.index_select(0, dst.clamp(min=0))], dim=-1)
    return e + _mlp_ln(lp["edge"], msg_in)


def _proc_layer_local(lp, hn, e, src, dst, aggregator):
    """One processor layer's edge half: the new edge block (zero where src <
    0) and the node aggregate by dst."""
    e_new = _edge_update(lp, hn, e, src, dst)
    e_new = torch.where((src >= 0)[:, None], e_new, 0.0)
    return e_new, _aggregate(e_new, dst, hn.shape[0], aggregator)


def _layer(hn, e, lp, src, dst, aggregator):
    e_new, agg = _proc_layer_local(lp, hn, e, src, dst, aggregator)
    return hn + _mlp_ln(lp["node"], torch.cat([hn, agg], dim=-1)), e_new


def _layer_params(params):
    """Each processor layer's tree: views of the stacked leaves."""
    n_layers = leaves(params["proc"])[0].shape[0]
    return [tree_map(lambda t, i=i: t[i], params["proc"]) for i in range(n_layers)]


def forward(params, graph, cfg: GNNConfig, mesh=None) -> torch.Tensor:
    """graph -> node outputs [N, out_dim]."""
    _no_mesh(mesh)
    hn = _mlp_ln(params["node_enc"], graph["node_feat"].to(cfg.dtype))
    e = _mlp_ln(params["edge_enc"], graph["edge_feat"].to(cfg.dtype))
    src, dst = graph["src"], graph["dst"]
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in _layer_params(params):
        if remat:
            hn, e = checkpoint(_layer, hn, e, lp, src, dst, cfg.aggregator, use_reentrant=False)
        else:
            hn, e = _layer(hn, e, lp, src, dst, cfg.aggregator)
    return _mlp_ln(params["dec"], hn)


def mse_loss(params, graph, cfg: GNNConfig, mesh=None) -> torch.Tensor:
    out = forward(params, graph, cfg, mesh)
    return torch.mean((out - graph["targets"].to(out.dtype)) ** 2)


def _rows_into(out: torch.Tensor, fn, *xs: torch.Tensor, chunk: int) -> torch.Tensor:
    """``out[a:b] = fn(x[a:b] for x in xs)``, ``chunk`` rows at a time."""
    for a in range(0, out.shape[0], chunk):
        out[a:a + chunk] = fn(*(x[a:a + chunk] for x in xs))
    return out


@torch.no_grad()
def forward_chunked(params, graph, cfg: GNNConfig, mesh=None, chunk: int = EDGE_CHUNK):
    """``forward`` without a gradient, for a graph whose [E, d_hidden]
    temporaries do not fit: edges and nodes ``chunk`` rows at a time, the edge
    state written in place.  Exact: an edge's update reads only its own state
    and the layer's node state, so the chunks change only the order of the
    segment sums."""
    _no_mesh(mesh)
    nf, ef = graph["node_feat"], graph["edge_feat"]
    src, dst = graph["src"], graph["dst"]
    n, h = nf.shape[0], cfg.d_hidden
    new = lambda rows: torch.empty((rows, h), dtype=cfg.dtype, device=nf.device)  # noqa: E731
    hn = _rows_into(new(n), lambda x: _mlp_ln(params["node_enc"], x.to(cfg.dtype)), nf,
                    chunk=chunk)
    e = _rows_into(new(ef.shape[0]), lambda x: _mlp_ln(params["edge_enc"], x.to(cfg.dtype)), ef,
                   chunk=chunk)
    for lp in _layer_params(params):
        agg = _empty_segments(n, e, cfg.aggregator)
        for a in range(0, e.shape[0], chunk):
            ec, s, d = e[a:a + chunk], src[a:a + chunk], dst[a:a + chunk]
            ec.copy_(_edge_update(lp, hn, ec, s, d))
            ec.masked_fill_((s < 0)[:, None], 0.0)
            _reduce_into(agg, ec, d, n, cfg.aggregator)
        _rows_into(hn, lambda x, y: x + _mlp_ln(lp["node"], torch.cat([x, y], dim=-1)), hn,
                   agg[:-1], chunk=chunk)
    return _rows_into(torch.empty((n, cfg.out_dim), dtype=hn.dtype, device=hn.device),
                      lambda x: _mlp_ln(params["dec"], x), hn, chunk=chunk)
