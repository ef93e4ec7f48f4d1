"""DLRM (Naumov et al., arXiv:1906.00091), RM2-scale.

dense [B, 13] -> bottom MLP -> [B, 64]
sparse [B, 26] -> 26 embedding tables -> [B, 26, 64]
dot interaction over the 27 vectors -> 351 pairwise dots, beside the bottom
output -> top MLP -> CTR logit.

``mesh``: a ``DeviceMesh`` under which ``tables`` is this rank's block of
rows over "model" (``table_spec(stacked=True)``) and the batch this rank's
block over the batch axes; None, every tensor whole.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.launch.mesh import P, check_mesh
from repro_torch.models.layers import dense_stack, dense_stack_init, make_generator, normal
from repro_torch.models.recsys.embedding import batch_mean, multi_table_lookup, table_spec
from repro_torch.train.tree import tree_map


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    n_rows: int = 1_000_000           # rows a sparse table
    bot_mlp: tuple = (512, 256, 64)
    top_mlp: tuple = (512, 512, 256, 1)
    dtype: Any = torch.float32

    @property
    def n_interact(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2


def init(cfg: DLRMConfig, generator=None, *, device="cuda"):
    g = generator if generator is not None else make_generator(device)
    return {
        "tables": normal((cfg.n_sparse, cfg.n_rows, cfg.embed_dim), g, device,
                         cfg.n_rows**-0.25, cfg.dtype),
        "bot": dense_stack_init(g, [cfg.n_dense, *cfg.bot_mlp], cfg.dtype, device),
        "top": dense_stack_init(g, [cfg.n_interact + cfg.embed_dim, *cfg.top_mlp], cfg.dtype,
                                device),
    }


def specs(cfg):
    """JAX's spec tree: every leaf replicated but the embedding tables, row-sharded over "model"."""
    s = tree_map(lambda _: P(), init(cfg, device="meta"))
    s["tables"] = table_spec(stacked=True)
    return s


def forward(params, batch, cfg: DLRMConfig, mesh=None) -> torch.Tensor:
    """batch = {dense [B, 13] f32, sparse [B, 26] int32} -> logits [B]."""
    check_mesh(mesh)
    bot = dense_stack(params["bot"], batch["dense"].to(cfg.dtype), final_act=True)
    emb = multi_table_lookup(params["tables"], batch["sparse"], mesh)  # [B, 26, d]
    feats = torch.cat([bot[:, None, :], emb], dim=1)              # [B, 27, d]

    # dot interaction: the strict lower triangle of feats @ feats^T, row-major
    # (torch.tril_indices(f, f, -1) is jnp.tril_indices(f, k=-1)'s order)
    z = torch.einsum("bfd,bgd->bfg", feats, feats)
    f = feats.shape[1]
    iu, ju = torch.tril_indices(f, f, -1, device=feats.device)
    inter = z[:, iu, ju]                                          # [B, 351]

    top_in = torch.cat([bot, inter], dim=-1)
    return dense_stack(params["top"], top_in)[:, 0]


def bce_loss(params, batch, cfg: DLRMConfig, mesh=None) -> torch.Tensor:
    logits = forward(params, batch, cfg, mesh)
    y = batch["labels"].to(torch.float32)
    return batch_mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))), mesh)
