"""Norm-filtered MIPS index -- a BEYOND-PAPER optimization that
operationalizes the paper's own Figure-1 finding: items ranking top-p% in
norm hold 87.5-100% of true top-10 MIPS results, so indexing ONLY the
top-``keep_frac`` fraction by norm bounds the achievable recall by the
ground-truth occupancy of that slice while cutting index memory, build time
and walk length proportionally.

This composes with either inner index (ip-NSW or ip-NSW+), and with
``storage="int8"``: keep_frac x 4 less item memory than the full-catalog
fp32 index.  The kept slice is chosen on the host as the JAX package
chooses it (numpy norms, a descending argsort, a shuffle seeded with 0), so
``global_ids`` equal the JAX package's for the same items.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core.ipnsw import IpNSW
from repro_torch.core.ipnsw_plus import IpNSWPlus


def kept_slice(items: np.ndarray, keep_frac: float) -> np.ndarray:
    """The global ids the filter indexes, int32 in insertion order: the
    ``max(int(n * keep_frac), 16)`` largest-norm rows, shuffled by
    ``default_rng(0)`` (sorted-by-norm insertion would bias early-graph
    connectivity)."""
    n = items.shape[0]
    keep = max(int(n * keep_frac), 16)
    norms = np.linalg.norm(items, axis=1)
    order = np.argsort(-norms)[:keep].astype(np.int32)
    np.random.default_rng(0).shuffle(order)
    return order


@dataclass
class NormFilteredIndex:
    """An id-remapping shell over an ``IpNSWPlus`` (``plus``) or ``IpNSW``
    built on the kept slice; ``build_backend``, ``storage`` and ``device``
    are forwarded to it.  The index lives on ``device``; the default is
    the card."""

    keep_frac: float = 0.25
    plus: bool = True
    max_degree: int = 16
    ef_construction: int = 64
    insert_batch: int = 256
    build_backend: str = "host"
    storage: str = "f32"
    device: str = "cuda"
    inner: object = field(default=None)
    global_ids: Optional[torch.Tensor] = None  # [keep] int32: local -> global

    def build(self, items, progress: bool = False) -> "NormFilteredIndex":
        if isinstance(items, torch.Tensor):
            host = items.detach().float().cpu().numpy()
        else:
            host = np.asarray(items, dtype=np.float32)
        order = kept_slice(host, self.keep_frac)
        self.global_ids = torch.as_tensor(order, device=self.device)
        items = torch.as_tensor(items, dtype=torch.float32, device=self.device)
        cls = IpNSWPlus if self.plus else IpNSW
        self.inner = cls(
            max_degree=self.max_degree,
            ef_construction=self.ef_construction,
            insert_batch=self.insert_batch,
            build_backend=self.build_backend,
            storage=self.storage,
            device=self.device,
        ).build(items[self.global_ids.long()], progress=progress)
        return self

    def search(self, queries, k: int = 10, ef: int = 64, **kw):
        """The inner index's search (its result type) with the ids mapped
        to the full catalog's; -1 stays -1."""
        if self.inner is None:
            raise RuntimeError("call build() first")
        res = self.inner.search(queries, k=k, ef=ef, **kw)
        mapped = torch.where(res.ids >= 0, self.global_ids[res.ids.clamp_min(0).long()], -1)
        return res._replace(ids=mapped)
