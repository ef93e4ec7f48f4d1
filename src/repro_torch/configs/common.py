"""Arch -> (step function, abstract inputs, metadata) cell builders, the
LM and recsys parts of the JAX package's ``configs/common.py``.

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

The PartitionSpec trees and the sharded retrieval branch are the mesh
tools' (ROADMAP Queue 1); one card has no mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.brute_force import exact_topk
from repro_torch.core.similarity import top_l
from repro_torch.kernels.gather_score import gather_score
from repro_torch.models.recsys import dien as dien_mod
from repro_torch.models.recsys import dlrm as dlrm_mod
from repro_torch.models.recsys import mind as mind_mod
from repro_torch.models import transformer as tf
from repro_torch.models.recsys import sasrec as sasrec_mod
from repro_torch.train.optimizer import adamw_init, adamw_update, adamw_update_, cosine_schedule
from repro_torch.train.tree import leaves, value_and_grad


class Cell(NamedTuple):
    name: str                 # "<arch>/<shape>"
    step_fn: Callable
    args: tuple               # the inputs, as meta tensors (a decode's q_offset: an int)
    meta: dict


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

    def build_cell(self, shape_name: str, device="cuda") -> "Cell":
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

        if sh["kind"] == "train":
            grad_fn = value_and_grad(tf.lm_loss)

            def train_step(params, opt, batch):
                _check_device(dev, (params, opt, batch))
                loss, grads = grad_fn(params, batch, cfg)
                lr = cosine_schedule(opt.step, base_lr=3e-4, warmup=2000, total=100_000)
                new_p, new_o = adamw_update_(grads, opt, params, lr=lr)
                return new_p, new_o, loss

            batch_abs = {"tokens": _abstract((b, s), torch.int32),
                         "labels": _abstract((b, s), torch.int32)}
            return Cell(name, train_step, (params_abs, adamw_init(params_abs), batch_abs), meta)

        if sh["kind"] == "prefill":
            def prefill_step(params, tokens):
                _check_device(dev, (params, tokens))
                return tf.serve_prefill(params, tokens, cfg, max_len=tokens.shape[1])

            return Cell(name, prefill_step, (params_abs, _abstract((b, s), torch.int32)), meta)

        def decode_step(params, caches, token, q_offset: int):
            _check_device(dev, (params, caches, token))
            return tf.serve_step(params, caches, token, q_offset, cfg)

        caches_abs = tf.init_cache(cfg, b, s, device="meta")
        return Cell(name, decode_step,
                    (params_abs, caches_abs, _abstract((b, 1), torch.int32), s - 1), meta)


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

    def build_cell(self, shape_name: str, device="cuda") -> Cell:
        sh = RECSYS_SHAPES[shape_name]
        cfg = self.cfg
        dev = torch.device(device)
        torch.empty(0, device=dev)  # an absent device fails here, before any work
        params_abs = self.init(device="meta")
        b = sh["batch"]
        meta = dict(family="recsys", arch=self.arch_id, shape=shape_name, kind=sh["kind"],
                    batch=b, n_cand=sh.get("n_cand", 0))
        name = f"{self.arch_id}/{shape_name}"

        if sh["kind"] == "train":
            loss_fn = self.loss_fn()

            def train_step(params, opt, batch):
                _check_device(dev, (params, opt, batch))
                loss, grads = value_and_grad(loss_fn)(params, batch, cfg)
                lr = cosine_schedule(opt.step, base_lr=1e-3, warmup=500, total=50_000)
                new_p, new_o = adamw_update(grads, opt, params, lr=lr)
                return new_p, new_o, loss

            return Cell(name, train_step, (params_abs, adamw_init(params_abs),
                                           self._train_batch(b)), meta)

        if sh["kind"] == "serve":
            nc = sh["n_cand"]
            if self.arch_id == "dlrm-rm2":
                batch_abs = {"dense": _abstract((b, cfg.n_dense), torch.float32),
                             "sparse": _abstract((b, cfg.n_sparse), torch.int32)}

                def serve_step(params, batch):
                    _check_device(dev, (params, batch))
                    return dlrm_mod.forward(params, batch, cfg)
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

            return Cell(name, torch.no_grad()(serve_step), (params_abs, batch_abs), meta)

        nc = sh["n_cand"]
        if self.arch_id == "dlrm-rm2":
            # bulk candidate scoring through the ranker: 10^6 candidate rows
            batch_abs = {"dense": _abstract((nc, cfg.n_dense), torch.float32),
                         "sparse": _abstract((nc, cfg.n_sparse), torch.int32)}

            def retrieval_step(params, batch):
                _check_device(dev, (params, batch))
                vals, ids = top_l(dlrm_mod.forward(params, batch, cfg), RETRIEVAL_K)
                return {"scores": vals, "ids": ids.to(torch.int32)}

            args = (params_abs, batch_abs)
        else:
            def retrieval_step(params, hist):
                _check_device(dev, (params, hist))
                u = self.user_vectors(params, hist)
                if self.arch_id == "mind":
                    vals, ids = interest_topk(u, params["item_emb"], RETRIEVAL_K)
                else:
                    vals, ids = exact_topk(u[:, 0], params["item_emb"], k=RETRIEVAL_K)
                return {"scores": vals, "ids": ids}

            args = (params_abs, _abstract((b, cfg.seq_len), torch.int32))
        return Cell(name, torch.no_grad()(retrieval_step), args, meta)


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
