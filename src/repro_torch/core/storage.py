"""Quantized item store: the ``storage=`` knob (the JAX package's
DESIGN.md §8).

The catalog is stored as symmetric per-row int8 codes plus one fp32 scale
per row, so a walk streams d bytes per item row instead of 4*d.  Per-row
scales because of the paper's norm bias: the large-norm hubs span a heavy
norm tail, and one global scale would crush the small-norm rows into a few
code levels.

Contract:
  * ``scale_i = max(|x_i|, 1e-12) / 127``, ``codes_i = round(x_i / scale_i)``
    clamped to [-127, 127]: a true divide (not a multiply by the reciprocal)
    and round-half-to-even, so the codes and scales equal the JAX package's
    eager ``quantize_items`` bit for bit on the same fp32 items;
  * the score of row i is ``(q . codes_i) * scale_i``: the fp32 dot over the
    cast codes, then one multiply (``kernels/quant_score/ref.py`` defines it;
    every kernel of the int8 walk does the same arithmetic);
  * the graph is built on fp32 items and the store is derived once from the
    frozen items after the build; the walk's final pool is re-scored exactly
    in fp32 (``core.search.beam_search``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.quant_score import quant_score

STORAGE_BACKENDS = ("f32", "int8")

_EPS = 1e-12


class ItemStore(NamedTuple):
    """codes: [N, d] int8 in [-127, 127]; scales: [N] fp32, with
    ``items ~= codes * scales[:, None]``."""

    codes: torch.Tensor
    scales: torch.Tensor


def validate_storage(storage: str) -> None:
    """Raise before any work for a storage the port does not know."""
    if storage not in STORAGE_BACKENDS:
        raise ValueError(f"storage must be one of {STORAGE_BACKENDS}, got {storage!r}")


def quantize_items(items: torch.Tensor) -> ItemStore:
    """[N, d] -> symmetric per-row int8 store, computed in fp32 (cast the
    items first: float64 input would round other codes).  An all-zero row
    gets the clamped scale and zero codes, so it scores exactly 0.0."""
    items = items.float()
    scales = items.abs().amax(dim=-1).clamp_min(_EPS) / 127.0
    codes = torch.round(items / scales[..., None]).clamp(-127.0, 127.0).to(torch.int8)
    return ItemStore(codes=codes.contiguous(), scales=scales.contiguous())


def dequantize(store: ItemStore) -> torch.Tensor:
    """fp32 items back; each element is within scale/2 of the original."""
    return store.codes.float() * store.scales[..., None]


def make_store(items: torch.Tensor, storage: str) -> Optional[ItemStore]:
    """``None`` for "f32" (the graph's items are the store), the quantized
    store for "int8"."""
    validate_storage(storage)
    if storage == "f32":
        return None
    return quantize_items(items)


def write_store_rows(store: ItemStore, rows: torch.Tensor, new_items: torch.Tensor) -> None:
    """Requantize ``rows`` (in [0, N)) of ``store`` from ``new_items`` in
    place, as a whole requantization would give them: the store's tensors
    keep their addresses, so a captured CUDA graph that reads or writes
    them stays valid, and nothing is read back.  A row may repeat only
    with equal values: a mutation chunk's pad rows repeat one of its valid
    rows with that row's payload (``MutableIndex._chunks``), so writing
    them changes nothing, as the JAX package's dropped pad rows do not."""
    part = quantize_items(new_items)
    rows = rows.long()
    store.codes[rows] = part.codes
    store.scales[rows] = part.scales


def update_store_rows(store: ItemStore, rows: torch.Tensor,
                      new_items: torch.Tensor) -> ItemStore:
    """A new store with ``rows`` requantized from ``new_items``, as a whole
    requantization would give them.  Indexing is the JAX scatter's: rows in
    ``[-N, 0)`` count from the end, and rows outside ``[-N, N)`` (the pad
    rows ``rows == N``) are dropped."""
    n = store.codes.shape[0]
    rows = rows.long()
    rows = torch.where(rows < 0, rows + n, rows)
    keep = (rows >= 0) & (rows < n)
    out = ItemStore(codes=store.codes.clone(), scales=store.scales.clone())
    write_store_rows(out, rows[keep], new_items[keep])
    return out


def store_scores(queries: torch.Tensor, store: ItemStore, ids: torch.Tensor) -> torch.Tensor:
    """Gathered quantized scores ``(q . codes[id]) * scales[id]``, -1 ids
    -inf: the ``quant_score`` kernel on the card, its plain version on the
    CPU."""
    return quant_score(queries, store.codes, store.scales, ids)
