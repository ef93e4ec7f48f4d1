"""Simple-LSH (Neyshabur & Srebro 2015) -- the LSH baseline of the paper's §5.

MIPS -> angular NNS reduction: items are scaled into the unit ball and
augmented with sqrt(1 - |x|^2); queries are normalized and augmented with 0.
Sign-random-projection codes then preserve the angle of the augmented pair.

The hamming-ranking variant (rank all items by code agreement, rerank the
top-T by exact inner product), as the JAX package has it.  Code agreement
of {-1,+1} codes is a plain [B, n_bits] x [N, n_bits] product, so the
ranking is the exact-MIPS kernel over the codes: ``mips_topk`` on the card,
its plain version on the CPU, in ``lax.top_k``'s order (every agreement is
an even integer in [-n_bits, n_bits], so ties are the rule and the lowest
ids win them).  The exact rerank of the T candidates is ``gather_score``.
Search effort is T (= ``n_candidates``), so #similarity-evaluations is
directly comparable with the graph methods.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from repro_torch.core.similarity import normalize, top_l
from repro_torch.kernels.gather_score import gather_score
from repro_torch.kernels.mips_topk import mips_topk


class LSHResult(NamedTuple):
    ids: torch.Tensor      # [B, k] int32
    scores: torch.Tensor   # [B, k] fp32
    evals: torch.Tensor    # [B] int32 -- exact rerank evaluations (= T)


def augment_items(items: torch.Tensor) -> torch.Tensor:
    """[N, d] -> [N, d + 1]: the items scaled by the largest norm into the
    unit ball, with sqrt(1 - |x|^2) appended."""
    scaled = items / torch.linalg.vector_norm(items, dim=-1).max()
    tail = torch.sqrt((1.0 - (scaled * scaled).sum(-1, keepdim=True)).clamp_min(0.0))
    return torch.cat([scaled, tail], dim=-1)


def augment_queries(queries: torch.Tensor) -> torch.Tensor:
    """[B, d] -> [B, d + 1]: the unit-normalized queries with 0 appended."""
    qn = normalize(queries)
    return torch.cat([qn, qn.new_zeros(qn.shape[:-1] + (1,))], dim=-1)


def sign_codes(aug: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """±1 fp32 codes of the projections ``aug @ planes`` (>= 0 gives +1).
    A plain fp32 product: under PyTorch's default TF32 is off, so a
    projection is rounded as an fp32 sum is; one within rounding of 0 may
    take the other sign on another device or in the JAX package."""
    return torch.where(aug @ planes >= 0, 1.0, -1.0).contiguous()


@dataclass
class SimpleLSH:
    """Sign-random-projection codes of ``n_bits`` over the augmented items.
    The planes are drawn from a CPU ``torch.Generator`` seeded with
    ``seed`` (the same planes on any device), so they differ from the JAX
    package's, which draws them with its own generator; carry JAX's codes
    and planes across (``convert.lsh_from_arrays``) where ids must match.
    The index lives on ``device``; the default is the card."""

    n_bits: int = 64
    seed: int = 0
    device: str = "cuda"
    codes: Optional[torch.Tensor] = None   # [N, n_bits] fp32 ±1
    planes: Optional[torch.Tensor] = None  # [d + 1, n_bits] fp32
    items: Optional[torch.Tensor] = None   # [N, d] fp32

    def build(self, items) -> "SimpleLSH":
        items = torch.as_tensor(items, dtype=torch.float32, device=self.device).contiguous()
        gen = torch.Generator().manual_seed(self.seed)
        planes = torch.randn((items.shape[1] + 1, self.n_bits), generator=gen)
        self.planes = planes.to(self.device)
        self.codes = sign_codes(augment_items(items), self.planes)
        self.items = items
        return self

    def search(self, queries, k: int = 10, n_candidates: int = 100) -> LSHResult:
        if self.codes is None:
            raise RuntimeError("call build() first")
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device).contiguous()
        q_codes = sign_codes(augment_queries(q), self.planes)
        _, cand = mips_topk(q_codes, self.codes, k=n_candidates)
        vals, sel = top_l(gather_score(q, self.items, cand), k)
        return LSHResult(
            ids=cand.gather(1, sel),
            scores=vals,
            evals=torch.full((q.shape[0],), n_candidates, dtype=torch.int32, device=q.device),
        )
