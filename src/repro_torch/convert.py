"""Carry the JAX package's index state into the port.

The functions take numpy arrays only -- ``np.asarray`` of the JAX package's
``GraphIndex`` fields, and of its ``ItemStore`` as ``(codes, scales)`` -- so
this module imports nothing of that package.  A graph (and int8 store) built
by JAX can then be searched by the port and the ids compared, a JAX
``MutableIndex`` carried across in mid-churn can go on mutating in the port,
a JAX ``TraceContext``'s tables can trace the port's walks, a JAX
``ShardedIndex`` can be searched by the port's sharded drivers, and a JAX
``HierarchicalIpNSW``, ``SimpleLSH`` or ``NormFilteredIndex`` by the port's
class of the same name.  ``params_from_arrays`` and ``adamw_from_arrays``
carry a model's parameter tree (a JAX ``init``'s, as numpy arrays) and its
AdamW state, so that the port trains and serves from JAX's values.
"""
from __future__ import annotations

from collections import deque
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.distributed import ShardedIndex, with_flat_adjacency
from repro_torch.core.graph import GraphIndex
from repro_torch.core.hnsw import HierarchicalIpNSW
from repro_torch.core.ipnsw import IpNSW
from repro_torch.core.ipnsw_plus import IpNSWPlus
from repro_torch.core.lsh import SimpleLSH
from repro_torch.core.mutation import MutableIndex
from repro_torch.core.norm_filter import NormFilteredIndex
from repro_torch.core.storage import ItemStore
from repro_torch.obs.trace import TraceContext
from repro_torch.train.optimizer import AdamWState


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


def trace_context_from_arrays(band_ids: np.ndarray, hub_mask: np.ndarray,
                              band_edges: np.ndarray, *, trace_cap: int, n_bands: int,
                              device: str = "cuda") -> TraceContext:
    """A ``TraceContext`` on ``device`` from a JAX ``TraceContext``'s numpy
    tables: ``band_ids [N]`` int32, ``hub_mask [N]`` bool, ``band_edges
    [n_bands + 1]`` fp32, and its ``trace_cap`` and ``n_bands``."""
    return TraceContext(
        torch.tensor(np.asarray(band_ids, np.int32), device=device),
        torch.tensor(np.asarray(hub_mask, bool), device=device),
        torch.tensor(np.asarray(band_edges, np.float32), device=device),
        trace_cap=trace_cap, n_bands=n_bands,
    )


def sharded_from_arrays(ip: Mapping[str, np.ndarray], ang: Optional[Mapping[str, np.ndarray]],
                        *, offset: np.ndarray, count: Optional[np.ndarray] = None,
                        store: Optional[Sequence[np.ndarray]] = None,
                        ang_store: Optional[Sequence[np.ndarray]] = None,
                        live: Optional[np.ndarray] = None, gid: Optional[np.ndarray] = None,
                        max_norm: Optional[np.ndarray] = None,
                        device: str = "cuda") -> ShardedIndex:
    """A ``ShardedIndex`` on ``device`` from a JAX ``ShardedIndex``'s numpy
    state: ``ip`` and ``ang`` (None for ip-NSW) hold the stacked graph
    fields (adj [P, Nloc, M], items [P, Nloc, d], size, entry, entry_norm
    [P]); the int8 stores as ``(codes [P, Nloc, d], scales [P, Nloc])``;
    ``offset`` / ``count`` [P], ``live`` / ``gid`` [P, Nloc] and
    ``max_norm`` [P].  The flat adjacency of the fan-out is made here."""
    def graph(g: Mapping[str, np.ndarray]) -> GraphIndex:
        return GraphIndex(
            adj=torch.tensor(np.asarray(g["adj"], np.int32), device=device),
            items=torch.tensor(np.asarray(g["items"], np.float32), device=device),
            size=torch.tensor(np.asarray(g["size"], np.int64), device=device),
            entry=torch.tensor(np.asarray(g["entry"], np.int64), device=device),
            entry_norm=torch.tensor(np.asarray(g["entry_norm"], np.float32), device=device))

    def tensor(x, dtype) -> Optional[torch.Tensor]:
        return None if x is None else torch.tensor(np.asarray(x, dtype), device=device)

    return with_flat_adjacency(ShardedIndex(
        ip=graph(ip), ang=None if ang is None else graph(ang),
        offset=tensor(offset, np.int32), count=tensor(count, np.int32),
        store=_store(store, device), ang_store=_store(ang_store, device),
        live=tensor(live, bool), gid=tensor(gid, np.int32),
        max_norm=tensor(max_norm, np.float32)))


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


def hnsw_from_arrays(levels: Sequence[Mapping[str, np.ndarray]], ids: Sequence[np.ndarray],
                     inv: Sequence[np.ndarray], *,
                     stores: Optional[Sequence[Sequence[np.ndarray]]] = None,
                     device: str = "cuda", **params) -> HierarchicalIpNSW:
    """A ``HierarchicalIpNSW`` around a JAX hierarchy's numpy state:
    ``levels`` hold each level's ``graph_from_arrays`` arguments (adj,
    items, size, entry, entry_norm), ``ids`` and ``inv`` each level's
    local -> global and global -> local int32 maps, ``stores`` each level's
    int8 store as ``(codes, scales)``; ``params`` are its knobs
    (``max_degree`` defaults to level 0's adjacency width)."""
    params.setdefault("max_degree", np.asarray(levels[0]["adj"]).shape[1])
    index = HierarchicalIpNSW(device=device, **params)
    index.levels = [graph_from_arrays(**g, device=device) for g in levels]
    index.ids = [torch.tensor(np.asarray(x, np.int32), device=device) for x in ids]
    index.inv = [torch.tensor(np.asarray(x, np.int32), device=device) for x in inv]
    index.stores = ([None] * len(levels) if stores is None
                    else [_store(s, device) for s in stores])
    return index


def lsh_from_arrays(codes: np.ndarray, planes: np.ndarray, items: np.ndarray, *,
                    device: str = "cuda", **params) -> SimpleLSH:
    """A ``SimpleLSH`` around a JAX index's ``codes [N, n_bits]`` (±1),
    ``planes [d + 1, n_bits]`` and ``items [N, d]``; ``n_bits`` defaults
    to the codes' width."""
    params.setdefault("n_bits", np.asarray(codes).shape[1])
    index = SimpleLSH(device=device, **params)
    index.codes = torch.tensor(np.asarray(codes, np.float32), device=device)
    index.planes = torch.tensor(np.asarray(planes, np.float32), device=device)
    index.items = torch.tensor(np.asarray(items, np.float32), device=device)
    return index


def norm_filtered_from_arrays(global_ids: np.ndarray, ip: Mapping[str, np.ndarray],
                              ang: Optional[Mapping[str, np.ndarray]] = None, *,
                              ip_store: Optional[Sequence[np.ndarray]] = None,
                              ang_store: Optional[Sequence[np.ndarray]] = None,
                              device: str = "cuda", **params) -> NormFilteredIndex:
    """A ``NormFilteredIndex`` around a JAX filter's ``global_ids`` and its
    inner index's graphs: ``ip`` (and ``ang`` for an ip-NSW+ inner index,
    which sets ``plus``) hold ``graph_from_arrays`` arguments, ``ip_store``
    and ``ang_store`` the int8 stores as ``(codes, scales)``.  The inner
    index's ``max_degree`` follows ``ip``'s adjacency width."""
    params.setdefault("max_degree", np.asarray(ip["adj"]).shape[1])
    index = NormFilteredIndex(plus=ang is not None, device=device, **params)
    knobs = dict(max_degree=index.max_degree, ef_construction=index.ef_construction,
                 insert_batch=index.insert_batch, build_backend=index.build_backend,
                 storage=index.storage)
    if ang is None:
        index.inner = ipnsw_from_arrays(**ip, store=ip_store, device=device, **knobs)
    else:
        index.inner = ipnsw_plus_from_arrays(ang, ip, ang_store=ang_store, ip_store=ip_store,
                                             device=device, **knobs)
    index.global_ids = torch.tensor(np.asarray(global_ids, np.int32), device=device)
    return index


def params_from_arrays(tree, *, device: str = "cuda"):
    """A nested dict / list / tuple of numpy arrays (a JAX ``init``'s tree,
    ``np.asarray`` of each leaf) as the same tree of tensors on ``device``.
    A bfloat16 leaf (numpy's ``ml_dtypes.bfloat16``, which torch cannot
    take) is carried bit for bit through its 16-bit pattern."""
    if isinstance(tree, dict):
        return {k: params_from_arrays(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_arrays(v, device=device) for v in tree)
    a = np.array(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def adamw_from_arrays(step, mu, nu, *, device: str = "cuda") -> AdamWState:
    """A JAX ``AdamWState``'s fields (as numpy) as the port's."""
    return AdamWState(step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
                      mu=params_from_arrays(mu, device=device),
                      nu=params_from_arrays(nu, device=device))
