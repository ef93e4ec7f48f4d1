"""ip-NSW (Morozov & Babenko 2018), the paper's baseline: NSW built and
searched with the raw inner product.  This is the algorithm whose norm bias
§3 of the paper analyses."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.build import build_graph, validate_build_backend
from repro_torch.core.graph import GraphIndex
from repro_torch.core.search import SearchResult, beam_search
from repro_torch.core.similarity import Similarity
from repro_torch.core.storage import ItemStore, make_store, validate_storage


@dataclass
class IpNSW:
    """Inner-product NSW index.  ``max_degree`` is the paper's M and
    ``ef_construction`` the pool size l of insertion.  ``storage`` ("f32" |
    "int8", ``core/storage.py``) is the item representation search streams:
    the build always runs on fp32 items, and the int8 store is derived once
    from them after it.  ``build_backend`` is the insertion driver ("host" |
    "scan", ``build.BUILD_BACKENDS``).  The index lives on ``device``; the
    default is the card."""

    max_degree: int = 16
    ef_construction: int = 64
    insert_batch: int = 128
    reverse_links: bool = True
    build_backend: str = "host"
    storage: str = "f32"
    device: str = "cuda"
    graph: Optional[GraphIndex] = None
    store: Optional[ItemStore] = None

    def build(self, items, progress: bool = False) -> "IpNSW":
        validate_storage(self.storage)
        validate_build_backend(self.build_backend)
        self.graph = build_graph(
            torch.as_tensor(items, dtype=torch.float32, device=self.device),
            similarity=Similarity.INNER_PRODUCT,
            max_degree=self.max_degree,
            ef_construction=self.ef_construction,
            insert_batch=self.insert_batch,
            reverse_links=self.reverse_links,
            build_backend=self.build_backend,
            progress=progress,
        )
        self.store = make_store(self.graph.items, self.storage)
        return self

    def _resolve_store(self, storage: str) -> Optional[ItemStore]:
        """The store a search with ``storage`` streams: None for "f32", else
        the cached int8 store, derived at the first int8 search of an index
        built with "f32"."""
        validate_storage(storage)
        if storage == "f32":
            return None
        if self.store is None:
            self.store = make_store(self.graph.items, storage)
        return self.store

    def search(self, queries, k: int = 10, ef: int = 64,
               max_steps: Optional[int] = None,
               storage: Optional[str] = None,
               live: Optional[torch.Tensor] = None,
               valid: Optional[torch.Tensor] = None,
               capturable: bool = False, trace=None) -> SearchResult:
        """``storage`` overrides the index's own for this call.  ``live`` is
        the [N] tombstone mask of a mutable index (``core/mutation.py``):
        dead nodes route the walk but never appear in the results.
        ``valid`` is the [B] bucket-padding mask (``search.beam_search``):
        pad rows come back as ids -1 at no evaluation, valid rows as an
        unpadded search gives them.  ``capturable`` reads nothing back
        (``steps`` stays on the device), so the search can be captured in a
        CUDA graph.  ``trace`` is an optional ``obs.TraceContext``: the
        result then carries ``SearchResult.trace`` at unchanged walk outputs
        (``search.beam_search``)."""
        if self.graph is None:
            raise RuntimeError("call build() first")
        st = storage if storage is not None else self.storage
        store = self._resolve_store(st)
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        init = self.graph.entry.expand(q.shape[0], 1)
        return beam_search(
            self.graph, q, init, pool_size=max(ef, k),
            max_steps=max_steps if max_steps is not None else 2 * ef, k=k,
            storage=st, store=store, live=live, valid=_as_mask(valid, self.device),
            capturable=capturable, trace=trace,
        )


def _as_mask(valid, device: str) -> Optional[torch.Tensor]:
    """A [B] bool mask on ``device`` (None stays None)."""
    return None if valid is None else torch.as_tensor(valid, dtype=torch.bool, device=device)
