"""Arch -> (step function, abstract inputs, metadata) cell builders, the
JAX package's ``configs/common.py`` for the LM, GNN and recsys families.

``LMArch.build_cell(shape_name, device=...)``: ``train_4k`` is one
training step, ``value_and_grad(lm_loss)`` (attention's backward on the
flash_attn backward kernel, each pattern cycle and loss chunk checkpointed)
then ``adamw_update_`` (params and moments written in place, the JAX cell's
``donate=(0, 1)``) at JAX's cosine schedule (base 3e-4, warmup 2,000, total
100,000); ``prefill_32k`` runs
``serve_prefill`` over the [B, S] prompt (caches sized S) and returns the
last token's logits and the caches; ``decode_32k`` and gemma's
``long_500k`` run one ``serve_step`` against caches of S slots (a ring of
``window`` slots for sliding layers), with ``q_offset`` a host int.  The
cells run at the published widths; the batch or layer cuts that fit one
card are the caller's (``chip_smoke.py`` records its own).

``GNNArch.build_cell(shape_name, device=...)``: each of the four
``GNN_SHAPES`` is one training step on the shape's whole graph,
``value_and_grad(mse_loss)`` (each processor layer checkpointed) then
``adamw_update_`` in place at JAX's cosine schedule (base 1e-3, warmup 100,
total 10,000).  The step takes a graph of any size; ``chip_smoke.py``
records the cut that fits one card (``ogb_products``).

``RecsysArch.build_cell(shape_name, device=...)`` returns a ``Cell``: the
step function, its inputs as ``meta`` tensors (the port's
``ShapeDtypeStruct``s) and the metadata.  A step runs on ``device`` or
raises: every tensor it is given must lie there.

  * train (``train_batch``): the loss, its gradient by autograd, the cosine
    schedule (base 1e-3, warmup 500, total 50,000) and ``adamw_update``.
  * serve (``serve_p99``, ``serve_bulk``): SASRec and MIND re-rank the
    candidates with ``gather_score`` (``q . items[max(id, 0)]``, the JAX
    step's gather and einsum without its [B, n_cand, d] tensor; MIND's K
    interests are B K query rows over the same ids, then the max over K);
    DIEN and DLRM run their forward pass.
  * retrieval (``retrieval_cand``): the top 100 of the whole table by
    ``exact_topk`` (``mips_topk``: its select route past k = 32); MIND by
    ``interest_topk``; DLRM ranks its 10^6 candidate rows with its forward
    pass and ``top_l``.

Under a mesh (``build_cell(shape_name, device, mesh=)``, a ``DeviceMesh``
with JAX's axis names) a step takes what a rank holds: ``Cell.in_specs``
are the PartitionSpec trees by which a rank cuts the global inputs
(``launch.mesh.local_tree``), and the step gives the rank's outputs.

  * LM (JAX's layouts, line for line): the parameters and AdamW moments as
    ``transformer.specs(cfg)`` shards (d_model over "data"; heads, d_ff
    and the vocabulary over "model"; experts over "model").  ``train_4k``
    of a dense arch on a mesh without ``pod`` is pure FSDP: the batch over
    ``data`` and ``model``, every weight gathered a layer at a time; every
    other ``train_4k`` (MoE, or two pods) batches over the batch axes and
    is tensor-parallel over "model" (Megatron; the experts over "model"),
    gathering only "data".  ``lm_loss(mesh=)``, the gradient by
    ``mesh_value_and_grad`` over the specs, AdamW clipped by ``global_norm``
    over the specs.  ``prefill_32k``: the prompts over the batch axes,
    Megatron, the logits ``P(batch, "model")`` and the caches' sequence
    over "model"; ``decode_32k``: the same caches and logits; ``long_500k``
    (B 1): the token replicated, the caches' sequence over every axis, the
    logits ``P(None, "model")``.
  * GNN: N and E padded to multiples of the rank count, the graph in row
    blocks over every axis (``gnn.data_specs``), the parameters whole;
    ``mse_loss(mesh=)``, the gradient mean over every axis, AdamW.
  * recsys ``train_batch``: the batch over the batch axes, the tables and
    their AdamW moments row-sharded over ``model`` (``mod.specs``), the
    dense leaves whole; a lookup is a masked gather of the rank's rows and
    a sum over ``model`` (``embedding.take``); the loss through
    ``mesh_value_and_grad`` over the batch axes, AdamW clipped by the whole
    tree's norm (``global_norm`` over the specs).
  * recsys serve: the batch over the batch axes; SASRec, MIND and DIEN hold
    ``item_emb`` whole (JAX replicates it to serve: local lookups), DLRM
    its tables row-sharded (sharded lookups).
  * recsys retrieval (SASRec, MIND, DIEN): with a ``model`` axis of P > 1
    ranks dividing ``n_items``, JAX's shard-local top k (``sharded_topk``):
    each rank its block of the item table, the per-rank top 100 gathered
    over ``model`` and merged.  The parameters are whole on every rank (the
    user tower reads the whole table).  DLRM: the 10^6 candidate rows over
    the batch axes, scored with sharded lookups; each rank's top 100 (ids
    offset by its block's start) gathered over the batch axes and merged
    by ``top_l``, the lower id winning a tie.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core.brute_force import exact_topk
from repro_torch.core.similarity import top_l
from repro_torch.kernels.gather_score import gather_score
from repro_torch.launch.mesh import (MODEL_AXIS, P, axis_group, axis_size, batch_axes_of,
                                     check_mesh, gather_rows, grad_mean, local_shard)
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import layers as layers_mod
from repro_torch.models.recsys import dien as dien_mod
from repro_torch.models.recsys import dlrm as dlrm_mod
from repro_torch.models.recsys import mind as mind_mod
from repro_torch.models import transformer as tf
from repro_torch.models.recsys import sasrec as sasrec_mod
from repro_torch.train.optimizer import (adamw_init, adamw_specs, adamw_update, adamw_update_,
                                         cosine_schedule, global_norm)
from repro_torch.train.tree import leaves, tree_map, value_and_grad


class Cell(NamedTuple):
    name: str                 # "<arch>/<shape>"
    step_fn: Callable
    args: tuple               # the inputs, as meta tensors (a decode's q_offset: an int)
    meta: dict
    in_specs: Any = None      # under a mesh: how a rank cuts ``args`` (PartitionSpec trees;
    #                           None for an argument that is not a tensor)


def mesh_value_and_grad(loss_fn: Callable, mesh, axes, specs=None) -> Callable:
    """``value_and_grad(loss_fn)`` of a loss taking ``mesh``, then the
    gradient mean over the data-parallel ``axes`` (``grad_mean``): the loss
    is the mean over those axes of each rank's term, and each rank
    backpropagates its own term (``launch.mesh.mean_out``).  ``specs`` (the
    parameters' PartitionSpecs; None: every leaf whole) say which leaves
    are cut over which of ``axes``: those were gathered in the forward,
    whose backward already summed them there, so they are not summed
    again.  Without a mesh or axes, ``value_and_grad``."""
    grad_fn = value_and_grad(loss_fn)
    axes = tuple(axes) if mesh is not None else ()

    def wrapped(params, batch, cfg):
        loss, grads = grad_fn(params, batch, cfg, mesh)
        return loss, grad_mean(grads, mesh, axes, specs) if axes else grads

    return wrapped


# ---------------------------------------------------------------------------
# LM transformers
# ---------------------------------------------------------------------------

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


@dataclasses.dataclass
class LMArch:
    arch_id: str
    cfg: tf.TransformerConfig
    family: str = "lm"

    def shape_names(self):
        names = ["train_4k", "prefill_32k", "decode_32k"]
        if any(w is not None for w in self.cfg.window_pattern):
            names.append("long_500k")  # sub-quadratic archs only
        return names

    def init(self, generator=None, *, device="cuda"):
        return tf.init(self.cfg, generator, device=device)

    def _train_axes(self, mesh) -> tuple:
        """The batch axes of ``train_4k`` (JAX's rule): a dense arch on a
        mesh without ``pod`` is pure FSDP, the batch over ``data`` and
        ``model``; an MoE arch keeps its tokens replicated over ``model``
        for the expert dispatch, and two pods keep TP."""
        names = mesh.mesh_dim_names
        if not self.cfg.is_moe and "pod" not in names:
            return tuple(a for a in ("data", MODEL_AXIS) if a in names)
        return batch_axes_of(mesh)

    def build_cell(self, shape_name: str, device="cuda", mesh=None) -> "Cell":
        check_mesh(mesh)
        if shape_name not in self.shape_names():
            raise KeyError(f"{self.arch_id} has no cell {shape_name!r}; "
                           f"it has {self.shape_names()}")
        sh = LM_SHAPES[shape_name]
        cfg = self.cfg
        dev = torch.device(device)
        torch.empty(0, device=dev)  # an absent device fails here, before any work
        b, s = sh["batch"], sh["seq"]
        meta = dict(family="lm", arch=self.arch_id, shape=shape_name, kind=sh["kind"],
                    params=cfg.param_count(), active_params=cfg.active_param_count(),
                    tokens=b * s if sh["kind"] != "decode" else b)
        name = f"{self.arch_id}/{shape_name}"
        params_abs = tf.abstract_params(cfg)
        pspecs = None if mesh is None else tf.specs(cfg)
        batch_ax = () if mesh is None else batch_axes_of(mesh)

        if sh["kind"] == "train":
            axes = () if mesh is None else self._train_axes(mesh)
            grad_fn = mesh_value_and_grad(tf.lm_loss, mesh, axes, pspecs)

            def train_step(params, opt, batch):
                _check_device(dev, (params, opt, batch))
                if mesh is not None:
                    layers_mod.set_batch_axes(axes)
                loss, grads = grad_fn(params, batch, cfg)
                lr = cosine_schedule(opt.step, base_lr=3e-4, warmup=2000, total=100_000)
                norm = None if mesh is None else global_norm(grads, pspecs, mesh)
                new_p, new_o = adamw_update_(grads, opt, params, lr=lr, grad_norm=norm)
                return new_p, new_o, loss

            if mesh is not None:
                layers_mod.set_batch_axes(axes)
            batch_abs = {"tokens": _abstract((b, s), torch.int32),
                         "labels": _abstract((b, s), torch.int32)}
            bspec = P(axes, None)
            return Cell(name, train_step, (params_abs, adamw_init(params_abs), batch_abs), meta,
                        None if mesh is None else (pspecs, adamw_specs(pspecs),
                                                   {"tokens": bspec, "labels": bspec}))

        if mesh is not None:
            layers_mod.set_batch_axes_for_mesh(mesh)

        if sh["kind"] == "prefill":
            def prefill_step(params, tokens):
                _check_device(dev, (params, tokens))
                if mesh is not None:
                    layers_mod.set_batch_axes_for_mesh(mesh)
                return tf.serve_prefill(params, tokens, cfg, mesh, max_len=tokens.shape[1])

            return Cell(name, prefill_step, (params_abs, _abstract((b, s), torch.int32)), meta,
                        None if mesh is None else (pspecs, P(batch_ax, None)))

        # decode; long_500k (B 1): the token replicated, the caches' sequence
        # over every axis
        long_ctx = b == 1
        cache_seq = () if mesh is None else (
            tuple(mesh.mesh_dim_names) if long_ctx else (MODEL_AXIS,))

        def decode_step(params, caches, token, q_offset: int):
            _check_device(dev, (params, caches, token))
            if mesh is not None:
                layers_mod.set_batch_axes_for_mesh(mesh)
            return tf.serve_step(params, caches, token, q_offset, cfg, mesh, cache_axes=cache_seq)

        caches_abs = tf.init_cache(cfg, b, s, device="meta")
        in_specs = None
        if mesh is not None:
            rows = () if long_ctx else batch_ax
            in_specs = (pspecs, tf.cache_specs(cfg, batch=rows, seq=cache_seq), P(rows, None),
                        None)
        return Cell(name, decode_step,
                    (params_abs, caches_abs, _abstract((b, 1), torch.int32), s - 1), meta,
                    in_specs)


# ---------------------------------------------------------------------------
# GNN (meshgraphnet)
# ---------------------------------------------------------------------------

GNN_SHAPES = {
    # (n_nodes, n_edges, d_feat, note)
    "full_graph_sm": dict(n_nodes=2_708, n_edges=10_556, d_feat=1_433),
    "minibatch_lg": dict(n_nodes=169_984, n_edges=168_960, d_feat=602),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100),
    "molecule": dict(n_nodes=30 * 128, n_edges=64 * 128, d_feat=16),
}


@dataclasses.dataclass
class GNNArch:
    arch_id: str
    base: gnn_mod.GNNConfig
    family: str = "gnn"

    def shape_names(self):
        return list(GNN_SHAPES)

    def config_for(self, shape_name: str) -> gnn_mod.GNNConfig:
        return dataclasses.replace(self.base, d_feat=GNN_SHAPES[shape_name]["d_feat"])

    def build_cell(self, shape_name: str, device="cuda", mesh=None) -> Cell:
        """One training step on the shape's whole graph, JAX's node and edge
        counts rounded up to a multiple of the mesh's ranks (one without a
        mesh); under a mesh the step takes this rank's row blocks."""
        check_mesh(mesh)
        sh = GNN_SHAPES[shape_name]
        cfg = self.config_for(shape_name)
        dev = torch.device(device)
        torch.empty(0, device=dev)  # an absent device fails here, before any work
        ranks = 1 if mesh is None else mesh.size()
        n, e = _round_up(sh["n_nodes"], ranks), _round_up(sh["n_edges"], ranks)
        params_abs = gnn_mod.init(cfg, device="meta")
        graph_abs = {"node_feat": _abstract((n, cfg.d_feat), torch.float32),
                     "edge_feat": _abstract((e, cfg.d_edge), torch.float32),
                     "src": _abstract((e,), torch.int32),
                     "dst": _abstract((e,), torch.int32),
                     "targets": _abstract((n, cfg.out_dim), torch.float32)}
        axes = () if mesh is None else gnn_mod.mesh_axes(mesh)
        grad_fn = mesh_value_and_grad(gnn_mod.mse_loss, mesh, axes)

        def train_step(params, opt, graph):
            _check_device(dev, (params, opt, graph))
            loss, grads = grad_fn(params, graph, cfg)
            lr = cosine_schedule(opt.step, base_lr=1e-3, warmup=100, total=10_000)
            new_p, new_o = adamw_update_(grads, opt, params, lr=lr)
            return new_p, new_o, loss

        meta = dict(family="gnn", arch=self.arch_id, shape=shape_name, kind="train",
                    n_nodes=n, n_edges=e, d_hidden=cfg.d_hidden, n_layers=cfg.n_layers)
        pspecs = gnn_mod.specs(cfg)
        return Cell(f"{self.arch_id}/{shape_name}", train_step,
                    (params_abs, adamw_init(params_abs), graph_abs), meta,
                    None if mesh is None else (pspecs, adamw_specs(pspecs),
                                               gnn_mod.data_specs(axes)))


# ---------------------------------------------------------------------------
# recsys
# ---------------------------------------------------------------------------

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512, n_cand=1_000),
    "serve_bulk": dict(kind="serve", batch=262_144, n_cand=1_000),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_cand=1_000_000),
}

RETRIEVAL_K = 100

_RECSYS_MODS = {
    "dlrm-rm2": dlrm_mod,
    "sasrec": sasrec_mod,
    "mind": mind_mod,
    "dien": dien_mod,
}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _abstract(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _check_device(device: torch.device, tree) -> None:
    """Raise unless every tensor of ``tree`` lies on ``device`` ("cuda"
    takes any card, "cuda:1" that one)."""
    for t in leaves(tree):
        if t.device.type != device.type or device.index not in (None, t.device.index):
            raise ValueError(f"the step runs on {device}; it was given a tensor on {t.device}")


def interest_topk(interests: torch.Tensor, items: torch.Tensor, k: int = RETRIEVAL_K):
    """The top k items by the max over interests: interests [B, K, d],
    items [N, d] -> (scores [B, k], ids [B, k] int32), in ``lax.top_k``'s
    order over ``max_k interests[b, k] . items[n]`` (the lowest id first
    among equal scores).

    One ``mips_topk`` over the B K interest rows; then each user's K k
    candidates, a repeated id keeping its largest score, cut to k by
    ``top_l`` in id order.  This is exact: order the items of interest i by
    (score desc, id asc).  An item y ahead of x there has
    max(y) >= s_i(y) >= s_i(x), with the lower id where equal, so it is also
    ahead of x in the max order.  If i attains max(x), x's place in i's order
    is then at most its place in the max order: an item of the true top k
    is in the top k of the interest that attains its max, with its true
    score.  An item outside the true top k gets at most its true score and
    cannot pass one inside it."""
    b, n_int, d = interests.shape
    kk = min(k, items.shape[0])
    s, i = exact_topk(interests.reshape(b * n_int, d), items, k=kk)
    s, i = s.reshape(b, n_int * kk), i.reshape(b, n_int * kk)
    # by id ascending, the largest score of an id first; then drop repeats
    by_score = torch.sort(s, dim=-1, descending=True, stable=True).indices
    i, s = i.gather(-1, by_score), s.gather(-1, by_score)
    by_id = torch.sort(i, dim=-1, stable=True).indices
    i, s = i.gather(-1, by_id), s.gather(-1, by_id)
    repeat = torch.zeros_like(i, dtype=torch.bool)
    repeat[:, 1:] = i[:, 1:] == i[:, :-1]
    s = s.masked_fill(repeat, float("-inf"))
    vals, pos = top_l(s, kk)
    return vals, i.gather(-1, pos)


def sharded_topk(u: torch.Tensor, block: torch.Tensor, rank: int, group, k: int = RETRIEVAL_K,
                 *, interests: bool = False):
    """JAX's shard-local top k over the ``model`` group: this rank's top k
    of its block of the item table (``exact_topk``, or ``interest_topk``
    over u's K interests), its ids offset by ``rank * rows``; the group's
    values and ids all-gathered into [B, P k] in rank order and the top k
    kept by ``lax.top_k``'s rule, the first occurrence winning, so the lower
    rank wins a tie.  u [B, K, d] -> (scores [B, k], ids [B, k] int32)."""
    if interests:
        vals, ids = interest_topk(u, block, k)
    else:
        vals, ids = exact_topk(u[:, 0], block, k=k)
    ids = ids + rank * block.shape[0]
    b, kk = vals.shape
    allv = gather_rows(vals, group).view(-1, b, kk).transpose(0, 1).reshape(b, -1)
    alli = gather_rows(ids, group).view(-1, b, kk).transpose(0, 1).reshape(b, -1)
    vals, sel = top_l(allv, k)
    return vals, alli.gather(-1, sel)


@dataclasses.dataclass
class RecsysArch:
    arch_id: str
    cfg: Any
    family: str = "recsys"

    @property
    def mod(self):
        return _RECSYS_MODS[self.arch_id]

    def shape_names(self):
        return list(RECSYS_SHAPES)

    @property
    def n_ids(self) -> int:
        """Rows of the item table (of each sparse table, DLRM)."""
        return self.cfg.n_rows if self.arch_id == "dlrm-rm2" else self.cfg.n_items

    def init(self, generator=None, *, device="cuda"):
        return self.mod.init(self.cfg, generator, device=device)

    # ---- batch builders per model kind -------------------------------------

    def _train_batch(self, b):
        cfg = self.cfg
        if self.arch_id == "dlrm-rm2":
            return {"dense": _abstract((b, cfg.n_dense), torch.float32),
                    "sparse": _abstract((b, cfg.n_sparse), torch.int32),
                    "labels": _abstract((b,), torch.float32)}
        s = cfg.seq_len
        if self.arch_id == "sasrec":
            return {"hist": _abstract((b, s), torch.int32),
                    "pos": _abstract((b, s), torch.int32),
                    "neg": _abstract((b, s, 4), torch.int32)}
        if self.arch_id == "mind":
            return {"hist": _abstract((b, s), torch.int32),
                    "pos": _abstract((b,), torch.int32),
                    "neg": _abstract((b, 20), torch.int32)}
        return {"hist": _abstract((b, s), torch.int32),       # dien
                "target": _abstract((b,), torch.int32),
                "labels": _abstract((b,), torch.float32),
                "aux_neg": _abstract((b, s), torch.int32)}

    def loss_fn(self):
        return {
            "dlrm-rm2": dlrm_mod.bce_loss,
            "sasrec": sasrec_mod.sampled_softmax_loss,
            "mind": mind_mod.sampled_softmax_loss,
            "dien": dien_mod.bce_loss,
        }[self.arch_id]

    def user_vectors(self, params, hist):
        """[B, K, d] user-side query vectors (K = 1 except MIND)."""
        if self.arch_id == "mind":
            return mind_mod.interest_capsules(params, hist, self.cfg)
        if self.arch_id == "sasrec":
            return sasrec_mod.user_embedding(params, hist, self.cfg)[:, None]
        return dien_mod.user_vector(params, hist, self.cfg)[:, None]

    def build_cell(self, shape_name: str, device="cuda", mesh=None) -> Cell:
        check_mesh(mesh)
        sh = RECSYS_SHAPES[shape_name]
        cfg = self.cfg
        dev = torch.device(device)
        torch.empty(0, device=dev)  # an absent device fails here, before any work
        params_abs = self.init(device="meta")
        b = sh["batch"]
        meta = dict(family="recsys", arch=self.arch_id, shape=shape_name, kind=sh["kind"],
                    batch=b, n_cand=sh.get("n_cand", 0))
        name = f"{self.arch_id}/{shape_name}"
        axes = () if mesh is None else batch_axes_of(mesh)
        pspecs = None if mesh is None else self.mod.specs(cfg)

        def rows(batch):
            """Each input's rows over the batch axes."""
            return tree_map(lambda a: P(axes, *[None] * (a.dim() - 1)), batch)

        if sh["kind"] == "train":
            grad_fn = mesh_value_and_grad(self.loss_fn(), mesh, axes)

            def train_step(params, opt, batch):
                _check_device(dev, (params, opt, batch))
                loss, grads = grad_fn(params, batch, cfg)
                lr = cosine_schedule(opt.step, base_lr=1e-3, warmup=500, total=50_000)
                norm = None if mesh is None else global_norm(grads, pspecs, mesh)
                new_p, new_o = adamw_update(grads, opt, params, lr=lr, grad_norm=norm)
                return new_p, new_o, loss

            batch_abs = self._train_batch(b)
            return Cell(name, train_step, (params_abs, adamw_init(params_abs), batch_abs), meta,
                        None if mesh is None else (pspecs, adamw_specs(pspecs), rows(batch_abs)))

        if sh["kind"] == "serve":
            nc = sh["n_cand"]
            if pspecs is not None and self.arch_id != "dlrm-rm2":
                pspecs["item_emb"] = P()  # JAX replicates the item table to serve
            if self.arch_id == "dlrm-rm2":
                batch_abs = {"dense": _abstract((b, cfg.n_dense), torch.float32),
                             "sparse": _abstract((b, cfg.n_sparse), torch.int32)}

                def serve_step(params, batch):
                    _check_device(dev, (params, batch))
                    return dlrm_mod.forward(params, batch, cfg, mesh)
            elif self.arch_id == "dien":
                batch_abs = {"hist": _abstract((b, cfg.seq_len), torch.int32),
                             "target": _abstract((b,), torch.int32)}

                def serve_step(params, batch):
                    _check_device(dev, (params, batch))
                    return dien_mod.forward(params, batch, cfg)[0]
            else:  # sasrec / mind: re-rank nc candidates a user
                batch_abs = {"hist": _abstract((b, cfg.seq_len), torch.int32),
                             "cand": _abstract((b, nc), torch.int32)}
                rerank = _make_rerank(self.mod, self.arch_id, cfg)

                def serve_step(params, batch):
                    _check_device(dev, (params, batch))
                    return rerank(params, batch)

            return Cell(name, torch.no_grad()(serve_step), (params_abs, batch_abs), meta,
                        None if mesh is None else (pspecs, rows(batch_abs)))

        nc = sh["n_cand"]
        if self.arch_id == "dlrm-rm2":
            # bulk candidate scoring through the ranker: 10^6 candidate rows,
            # under a mesh this rank's block of them
            batch_abs = {"dense": _abstract((nc, cfg.n_dense), torch.float32),
                         "sparse": _abstract((nc, cfg.n_sparse), torch.int32)}
            group = axis_group(mesh, axes) if axes else None

            def retrieval_step(params, batch):
                _check_device(dev, (params, batch))
                scores = dlrm_mod.forward(params, batch, cfg, mesh)
                vals, ids = top_l(scores, RETRIEVAL_K)
                if group is not None:  # the blocks' top k in rank order, merged
                    ids = ids + dist.get_rank(group) * scores.shape[0]
                    vals, sel = top_l(gather_rows(vals, group), RETRIEVAL_K)
                    ids = gather_rows(ids, group)[sel]
                return {"scores": vals, "ids": ids.to(torch.int32)}

            args = (params_abs, batch_abs)
            in_specs = None if mesh is None else (pspecs, rows(batch_abs))
        else:
            interests = self.arch_id == "mind"
            msize = axis_size(mesh, (MODEL_AXIS,)) if mesh is not None and \
                MODEL_AXIS in mesh.mesh_dim_names else 1
            if msize > 1 and cfg.n_items % msize == 0:
                group, rank = axis_group(mesh, (MODEL_AXIS,)), mesh.get_local_rank(MODEL_AXIS)

                def top(u, items):
                    block = local_shard(items, P(MODEL_AXIS, None), mesh)
                    return sharded_topk(u, block, rank, group, RETRIEVAL_K, interests=interests)
            else:
                def top(u, items):
                    if interests:
                        return interest_topk(u, items, RETRIEVAL_K)
                    return exact_topk(u[:, 0], items, k=RETRIEVAL_K)

            def retrieval_step(params, hist):
                _check_device(dev, (params, hist))
                vals, ids = top(self.user_vectors(params, hist), params["item_emb"])
                return {"scores": vals, "ids": ids}

            args = (params_abs, _abstract((b, cfg.seq_len), torch.int32))
            in_specs = None if mesh is None else (tree_map(lambda _: P(), params_abs), P())
        return Cell(name, torch.no_grad()(retrieval_step), args, meta, in_specs)


def _make_rerank(mod, arch_id, cfg):
    """``q . item_emb[max(cand, 0)]`` for each user's candidates, by
    ``gather_score``; MIND scores its K interests as B K query rows over the
    same ids and keeps the max over K."""
    def rerank(params, batch):
        cand = batch["cand"].to(torch.int32).contiguous()
        items = params["item_emb"].float().contiguous()
        if arch_id == "mind":
            interests = mind_mod.interest_capsules(params, batch["hist"], cfg)
            b, k, d = interests.shape
            sc = gather_score(interests.reshape(b * k, d).float().contiguous(), items,
                              cand.repeat_interleave(k, dim=0))
            return torch.amax(sc.reshape(b, k, -1), dim=1)
        u = sasrec_mod.user_embedding(params, batch["hist"], cfg)
        return gather_score(u.float().contiguous(), items, cand)

    return rerank
