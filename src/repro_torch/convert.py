"""Carry the JAX package's index state into the port.

The functions take numpy arrays only -- ``np.asarray`` of the JAX package's
``GraphIndex`` fields, and of its ``ItemStore`` as ``(codes, scales)`` -- so
this module imports nothing of that package.  A graph (and int8 store) built
by JAX can then be searched by the port and the ids compared, and a JAX
``MutableIndex`` carried across in mid-churn can go on mutating in the port.
"""
from __future__ import annotations

from collections import deque
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.graph import GraphIndex
from repro_torch.core.ipnsw import IpNSW
from repro_torch.core.ipnsw_plus import IpNSWPlus
from repro_torch.core.mutation import MutableIndex
from repro_torch.core.storage import ItemStore


def graph_from_arrays(
    adj: np.ndarray,
    items: np.ndarray,
    size,
    entry,
    entry_norm: float,
    *,
    device: str = "cuda",
) -> GraphIndex:
    """A ``GraphIndex`` on ``device`` from numpy state, copied (the build
    writes ``adj`` in place)."""
    return GraphIndex(
        adj=torch.tensor(np.asarray(adj, np.int32), device=device),
        items=torch.tensor(np.asarray(items, np.float32), device=device),
        size=torch.tensor(int(size), dtype=torch.int64, device=device),
        entry=torch.tensor(int(entry), dtype=torch.int64, device=device),
        entry_norm=torch.tensor(float(entry_norm), dtype=torch.float32, device=device),
    )


def store_from_arrays(codes: np.ndarray, scales: np.ndarray, *,
                      device: str = "cuda") -> ItemStore:
    """An int8 ``ItemStore`` on ``device`` from numpy ``codes [N, d]`` and
    ``scales [N]``."""
    return ItemStore(
        codes=torch.tensor(np.asarray(codes, np.int8), device=device),
        scales=torch.tensor(np.asarray(scales, np.float32), device=device),
    )


def _store(arrays: Optional[Sequence[np.ndarray]], device: str) -> Optional[ItemStore]:
    return None if arrays is None else store_from_arrays(*arrays, device=device)


def ipnsw_from_arrays(adj, items, size, entry, entry_norm, *,
                      store: Optional[Sequence[np.ndarray]] = None,
                      device: str = "cuda", **params) -> IpNSW:
    """An ``IpNSW`` around one graph's numpy state, and its int8 store as
    ``(codes, scales)`` if it has one; ``params`` are its knobs
    (``max_degree`` defaults to the adjacency's width)."""
    params.setdefault("max_degree", np.asarray(adj).shape[1])
    index = IpNSW(device=device, **params)
    index.graph = graph_from_arrays(adj, items, size, entry, entry_norm, device=device)
    index.store = _store(store, device)
    return index


def ipnsw_plus_from_arrays(ang: Mapping[str, np.ndarray], ip: Mapping[str, np.ndarray],
                           *, ang_store: Optional[Sequence[np.ndarray]] = None,
                           ip_store: Optional[Sequence[np.ndarray]] = None,
                           device: str = "cuda", **params) -> IpNSWPlus:
    """An ``IpNSWPlus`` around both graphs' numpy state; ``ang`` and ``ip``
    hold the ``graph_from_arrays`` arguments (adj, items, size, entry,
    entry_norm) of the angular and the inner-product graph, ``ang_store``
    and ``ip_store`` their int8 stores as ``(codes, scales)``."""
    params.setdefault("ang_degree", np.asarray(ang["adj"]).shape[1])
    params.setdefault("max_degree", np.asarray(ip["adj"]).shape[1])
    index = IpNSWPlus(device=device, **params)
    index.ang_graph = graph_from_arrays(**ang, device=device)
    index.ip_graph = graph_from_arrays(**ip, device=device)
    index.ang_store = _store(ang_store, device)
    index.ip_store = _store(ip_store, device)
    return index


def mutable_from_arrays(index: Union[IpNSW, IpNSWPlus], *, norms: np.ndarray,
                        live: np.ndarray, free: Sequence[int], next_fresh: int,
                        mutation_count: int = 0, mutation_batch: int = 32,
                        relink_threshold: float = 0.3) -> MutableIndex:
    """A ``MutableIndex`` with a JAX ``MutableIndex``'s state.  ``index``
    holds its padded graphs and stores (``ipnsw_from_arrays`` /
    ``ipnsw_plus_from_arrays`` of ``m.index``'s fields); the rest is its
    ``norms [capacity]``, ``live [capacity]`` bool, the free-slot deque
    ``_free`` in order, ``_next_fresh``, ``mutation_count``, and its
    ``mutation_batch`` and ``relink_threshold`` knobs."""
    m = MutableIndex(index, mutation_batch=mutation_batch, relink_threshold=relink_threshold)
    m.norms.copy_(torch.tensor(np.asarray(norms, np.float32)))
    m._live_host = np.asarray(live, bool).copy()
    m.live.copy_(torch.tensor(m._live_host))
    m._free = deque(int(i) for i in free)
    m._next_fresh = int(next_fresh)
    m.mutation_count = int(mutation_count)
    return m
