"""Plain PyTorch versions of mips_topk: exact MIPS, ``top_k(q @ items^T)``
per query in ``lax.top_k``'s order (``similarity.top_l``).

With ``scales`` given, ``items`` holds the int8 store's codes and the scores
follow its convention ``(q . codes) * scale`` (``quant_score/ref.py``): the
fp32 product over the cast codes, then one multiply per column.

``select_candidates_ref`` and ``select_top_k_ref`` model the select route
(k > 32) step by step: the threshold bin of a histogram of each key's top 11
bits, the candidates at or above it, and the sort of the candidates in
rounds of ``SORT_MAX`` keys."""
from __future__ import annotations

import torch

from repro_torch.core.similarity import order_key, pair_scores, top_l

BIN_BITS = 11     # kBinBits in csrc/mips_topk.cu
SORT_MAX = 4096   # kSortMax: keys one round of the sort holds


def _scores(queries, items, scales):
    scores = pair_scores(queries, items)
    return scores if scales is None else scores * scales[None, :]


def mips_topk_ref(queries: torch.Tensor, items: torch.Tensor, *, k: int,
                  scales: "torch.Tensor | None" = None):
    """[B, d] x [N, d] -> (scores [B, k] fp32, ids [B, k] int32)."""
    vals, ids = top_l(_scores(queries, items, scales), k)
    return vals, ids.to(torch.int32)


def select_keys(scores: torch.Tensor) -> torch.Tensor:
    """int64 keys in the select's strict total order, larger first: the
    unsigned order key of the score (select_key's upper word), then the
    complement of the position in 31 bits -- the kernel's 64-bit key,
    ordered alike."""
    hi = (order_key(scores).long() & 0xFFFFFFFF) ^ 0x80000000
    pos = torch.arange(scores.shape[-1], device=scores.device)
    return hi * 2**31 + (2**31 - 1 - pos)


def select_candidates_ref(queries: torch.Tensor, items: torch.Tensor, *, k: int,
                          scales: "torch.Tensor | None" = None, scores=None):
    """The select's threshold and candidate step over the [B, N] scores (or
    ``scores`` given): (threshold bin [B], candidate count [B] int32,
    candidate mask [B, N]).  The bin of a key is its top ``BIN_BITS`` bits;
    the threshold bin is the highest bin whose count from the top reaches
    k; the candidates are the keys at or above it, so they hold the top k."""
    if scores is None:
        scores = _scores(queries, items, scales)
    bins = select_keys(scores) >> (63 - BIN_BITS)
    hist = torch.zeros(scores.shape[0], 1 << BIN_BITS, dtype=torch.long, device=scores.device)
    hist.scatter_add_(1, bins, torch.ones_like(bins))
    from_top = hist.flip(1).cumsum(1).flip(1)       # keys in bins >= b, non-increasing
    thresh = (from_top >= k).sum(1) - 1
    take = bins >= thresh[:, None]
    return thresh, take.sum(1).to(torch.int32), take


def select_top_k_ref(scores: torch.Tensor, take: torch.Tensor, k: int):
    """The sort step on one row: the top k of the candidate keys (``take``,
    a mask over the row's scores), in rounds of at most ``SORT_MAX`` keys,
    each the largest below the last round's smallest.  Returns (scores [k],
    ids [k] int32)."""
    keys = select_keys(scores[None])[0][take]
    out = []
    bound = None
    for off in range(0, k, SORT_MAX):
        below = keys if bound is None else keys[keys < bound]
        top = torch.sort(below, descending=True).values[: min(SORT_MAX, k - off)]
        out.append(top)
        bound = top[-1]
    ids = (2**31 - 1 - torch.cat(out) % 2**31).to(torch.int32)
    return scores[ids.long()], ids
