"""Hierarchical NSW (the paper's footnote: "ip-NSW actually adopts multiple
hierarchical layers of NSW (known as HNSW)").

Level assignment: item level ~ floor(-ln(U) * mL), mL = 1/ln(M) (Malkov &
Yashunin).  Level k holds every item with level >= k as its own NSW graph
(built by core/build.py over the subset); level 0 holds all items.

Search descends: greedy walk (beam=1) from the top level's entry to level 1,
then a full beam search on level 0 seeded at the descent result.  Upper
levels are tiny (N/M^k items), so the descent costs O(levels * M) extra
evaluations but starts the level-0 walk near the query's neighborhood --
useful when the entry-point heuristic (max-norm item) is weak, e.g. flat
norm distributions.

Every level is a dense ``GraphIndex`` on the device; ``ids[level]`` maps a
level's local ids to global ids and ``inv[level]`` back (-1 where absent).
Each level's walk is one ``beam_search``: on the card one ``beam_walk``
launch for every query at once, a pool of one on the upper levels, whose
walks read nothing back (``capturable=True``); only level 0's step count
is read, as the result's ``steps``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.build import build_graph, validate_build_backend
from repro_torch.core.graph import GraphIndex
from repro_torch.core.search import SearchResult, beam_search
from repro_torch.core.similarity import Similarity
from repro_torch.core.storage import ItemStore, make_store, validate_storage


def assign_levels(n: int, max_degree: int, seed: int = 0, max_levels: int = 6):
    rng = np.random.default_rng(seed)
    ml = 1.0 / np.log(max(max_degree, 2))
    lv = np.floor(-np.log(rng.uniform(1e-12, 1.0, n)) * ml).astype(np.int32)
    return np.minimum(lv, max_levels - 1)


@dataclass
class HierarchicalIpNSW:
    """ip-NSW with HNSW-style layers (inner-product similarity on every
    level).  Level 0 is built with ``max_degree`` and ``ef_construction``,
    the upper levels with half the degree and a quarter of the pool (at
    least 8).  ``build_backend`` is the insertion driver of every level
    ("host" | "scan", ``build.BUILD_BACKENDS``); ``storage`` the item
    representation search streams, one store per level.  The index lives
    on ``device``; the default is the card."""

    max_degree: int = 16
    ef_construction: int = 64
    insert_batch: int = 256
    seed: int = 0
    build_backend: str = "host"
    storage: str = "f32"
    device: str = "cuda"
    levels: List[GraphIndex] = field(default_factory=list)
    ids: List[torch.Tensor] = field(default_factory=list)   # level -> global ids, int32
    inv: List[torch.Tensor] = field(default_factory=list)   # global -> local (-1), int32 [N]
    stores: List[Optional[ItemStore]] = field(default_factory=list)

    def build(self, items, progress: bool = False) -> "HierarchicalIpNSW":
        validate_storage(self.storage)
        validate_build_backend(self.build_backend)
        items = torch.as_tensor(items, dtype=torch.float32, device=self.device)
        n = items.shape[0]
        lv = assign_levels(n, self.max_degree, self.seed)
        self.levels, self.ids, self.inv = [], [], []
        for level in range(int(lv.max()) + 1):
            sel = np.nonzero(lv >= level)[0].astype(np.int32)
            if len(sel) < 2:
                break
            sel_t = torch.as_tensor(sel, device=self.device)
            g = build_graph(
                items[sel_t.long()],
                similarity=Similarity.INNER_PRODUCT,
                max_degree=self.max_degree if level == 0 else self.max_degree // 2 or 2,
                ef_construction=self.ef_construction if level == 0 else max(
                    self.ef_construction // 4, 8
                ),
                insert_batch=self.insert_batch,
                build_backend=self.build_backend,
                progress=progress and level == 0,
            )
            inv = torch.full((n,), -1, dtype=torch.int32, device=self.device)
            inv[sel_t.long()] = torch.arange(len(sel), dtype=torch.int32, device=self.device)
            self.levels.append(g)
            self.ids.append(sel_t)
            self.inv.append(inv)
        # One store per level (levels are distinct item subsets); the upper
        # levels are tiny (N/M^k rows), so the extra stores cost ~nothing.
        self.stores = [make_store(g.items, self.storage) for g in self.levels]
        return self

    def _resolve_stores(self, storage: str) -> List[Optional[ItemStore]]:
        validate_storage(storage)
        if storage == "f32":
            return [None] * len(self.levels)
        if not self.stores or self.stores[0] is None:
            self.stores = [make_store(g.items, storage) for g in self.levels]
        return self.stores

    def search(self, queries, k: int = 10, ef: int = 64,
               max_steps: Optional[int] = None,
               storage: Optional[str] = None) -> SearchResult:
        """The descent and the level-0 search; ``evals`` counts both.
        ``storage`` overrides the index's own for this call."""
        if not self.levels:
            raise RuntimeError("call build() first")
        storage = storage if storage is not None else self.storage
        stores = self._resolve_stores(storage)
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        b = q.shape[0]
        extra_evals = torch.zeros(b, dtype=torch.int32, device=self.device)

        # descend from the top level down to level 1
        cur_global = None
        for level in range(len(self.levels) - 1, 0, -1):
            g = self.levels[level]
            if cur_global is None:
                init = g.entry.expand(b, 1)
            else:
                local = self.inv[level][cur_global]
                init = torch.where(local >= 0, local, g.entry)[:, None]
            # the descent's step counts are not returned: nothing read back
            r = beam_search(g, q, init.to(torch.int32), pool_size=1,
                            max_steps=4 * self.max_degree, k=1, storage=storage,
                            store=stores[level], capturable=True)
            cur_global = self.ids[level][r.ids[:, 0].clamp_min(0).long()].long()
            extra_evals = extra_evals + r.evals

        g0 = self.levels[0]
        if cur_global is None:
            init0 = g0.entry.expand(b, 1)
        else:
            init0 = cur_global[:, None]  # level-0 local == global
        res = beam_search(g0, q, init0.to(torch.int32), pool_size=max(ef, k),
                          max_steps=max_steps if max_steps is not None else 2 * ef, k=k,
                          storage=storage, store=stores[0])
        return SearchResult(
            ids=res.ids,
            scores=res.scores,
            evals=res.evals + extra_evals,
            steps=res.steps,
            visited=res.visited,
        )
