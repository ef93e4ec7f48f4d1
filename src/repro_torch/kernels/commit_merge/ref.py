"""Plain PyTorch versions of commit_merge, the reverse-link top-M merge of
one build batch.

``commit_merge_ref`` is the JAX package's two-sort oracle, ported: it
defines the semantics.
  * every proposal ``(targets[i], cands[i], scores[i])`` offers ``cands[i]``
    as a neighbor of ``targets[i]``; ``targets[i] < 0`` is padding;
  * every row whose target appears with ``targets[i] >= 0`` (even when all
    its cands are -1) is rewritten: its existing edges are rescored against
    the target's vector and re-ranked together with the proposals;
  * repeated ``(target, cand)`` pairs collapse to the first proposal in
    input order; a proposal that repeats an existing edge replaces it;
  * each rewritten row keeps its top M by score, ties to the smaller cand
    id; a valid -inf edge outranks an empty slot; empty slots are -1.

``commit_rows_ref`` is the plain version of the CUDA kernel: the same merge
over the kernel's own inputs, the proposals as the wrapper's pre-pass
(``ops.sort_proposals``) sorts them.  On the CPU ``ops.commit_merge`` runs
the pre-pass and this function.
"""
from __future__ import annotations

import torch

from repro_torch.core.similarity import NEG_INF


def _stable_sort_by(keys, *cols):
    """Permute ``cols`` by ``keys`` (a list, primary first) with stable
    single-key sorts from the last key to the first."""
    order = torch.arange(cols[0].shape[0], device=cols[0].device)
    for key in reversed(keys):
        order = order[torch.sort(key[order], stable=True).indices]
    return [c[order] for c in cols]


def commit_merge_ref(
    adj: torch.Tensor,      # [N, M] int32
    items: torch.Tensor,    # [N, d] fp32
    targets: torch.Tensor,  # [E] int32 reverse-edge targets (-1 invalid)
    cands: torch.Tensor,    # [E] int32 proposed neighbors (-1 invalid)
    scores: torch.Tensor,   # [E] fp32 s(target, cand)
) -> torch.Tensor:
    """The merged adjacency (a new tensor), by two stable lexicographic
    sorts over the table of proposals and existing edges."""
    n, m = adj.shape
    e = targets.shape[0]
    big = n + 1
    dev = adj.device
    targets, cands = targets.long(), cands.long()

    # existing edges of touched targets, contributed once per target
    order = torch.sort(torch.where(targets >= 0, targets, big), stable=True).indices
    t_s, c_s, s_s = targets[order], cands[order], scores[order].float()
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), t_s[1:] != t_s[:-1]])
    first &= t_s >= 0
    safe_t = t_s.clamp_min(0)
    ex_ids = adj[safe_t].long()                                     # [E, M]
    ex_valid = (ex_ids >= 0) & first[:, None]
    ex_scores = torch.einsum(
        "ed,emd->em", items[safe_t].float(), items[ex_ids.clamp_min(0)].float()
    )

    # the edge table
    tab_t = torch.cat([t_s, t_s[:, None].expand(e, m).reshape(-1)])
    tab_c = torch.cat([c_s, ex_ids.reshape(-1)])
    tab_s = torch.cat([s_s, ex_scores.reshape(-1)])
    tab_v = torch.cat([t_s >= 0, ex_valid.reshape(-1)]) & (tab_c >= 0)

    # pass 1: drop repeated (target, neighbor) pairs, the first one winning
    k1 = torch.where(tab_v, tab_t, big)
    k2 = torch.where(tab_v, tab_c, big)
    k1, k2, tab_t, tab_c, tab_s, tab_v = _stable_sort_by(
        [k1, k2], k1, k2, tab_t, tab_c, tab_s, tab_v
    )
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                     (k1[1:] == k1[:-1]) & (k2[1:] == k2[:-1])])
    tab_v = tab_v & ~dup

    # pass 2: rank by score within each target's segment
    k1 = torch.where(tab_v, tab_t, big)
    nk = torch.where(tab_v, -tab_s, float("inf"))
    k1, tab_t, tab_c, tab_v = _stable_sort_by([k1, nk], k1, tab_t, tab_c, tab_v)
    idx = torch.arange(k1.shape[0], device=dev)
    seg_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), k1[1:] != k1[:-1]])
    seg_start = torch.cummax(torch.where(seg_first, idx, 0), dim=0).values
    rank = idx - seg_start
    keep = tab_v & (rank < m)

    # scatter the rewritten rows back (touched rows cleared first)
    adj_pad = torch.cat([adj, torch.full((1, m), -1, dtype=adj.dtype, device=dev)])
    adj_pad[torch.where(first, safe_t, n)] = -1
    adj_pad[tab_t[keep], rank[keep]] = tab_c[keep].to(adj.dtype)
    return adj_pad[:n]


def commit_rows_ref(
    adj: torch.Tensor,      # [N, M] int32
    items: torch.Tensor,    # [N, d] fp32
    targets: torch.Tensor,  # [E] int32 sorted ascending, invalid (-1) last
    cands: torch.Tensor,    # [E] int32 ascending within a target's run, -1 invalid
    scores: torch.Tensor,   # [E] fp32
):
    """The rewritten rows from the sorted proposals, as the kernel merges
    them: (targets [U] int64, rows [U, M] int32), one row per target's run.
    A run's repeated (target, cand) pair counts once, the first winning."""
    m = adj.shape[1]
    dev = adj.device
    t, c = targets.long(), cands.long()
    valid_t = t >= 0
    head = valid_t & torch.cat([torch.ones(1, dtype=torch.bool, device=dev), t[1:] != t[:-1]])
    repeat = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                        (t[1:] == t[:-1]) & (c[1:] == c[:-1])])
    proposal = valid_t & (c >= 0) & ~repeat
    tgt = t[head]
    u = tgt.shape[0]
    seg = (torch.cumsum(head, dim=0) - 1)[valid_t]
    counts = torch.bincount(seg, minlength=u)
    offsets = torch.cumsum(counts, dim=0) - counts
    k = int(counts.max()) if u else 0
    pos = torch.arange(seg.shape[0], device=dev) - offsets[seg]
    new_ids = torch.full((u, k), -1, dtype=torch.long, device=dev)
    new_ids[seg, pos] = torch.where(proposal, c, -1)[valid_t]
    new_s = torch.full((u, k), NEG_INF, dtype=torch.float32, device=dev)
    new_s[seg, pos] = scores.float()[valid_t]
    new_valid = new_ids >= 0

    ex = adj[tgt].long()                                             # [U, M]
    in_new = ((ex[:, :, None] == new_ids[:, None, :]) & new_valid[:, None, :]).any(-1)
    earlier = torch.ones(m, m, dtype=torch.bool, device=dev).tril(-1)
    ex_dup = ((ex[:, :, None] == ex[:, None, :]) & earlier).any(-1)
    ex_valid = (ex >= 0) & ~in_new & ~ex_dup
    ex_s = torch.einsum("ud,umd->um", items[tgt].float(), items[ex.clamp_min(0)].float())
    ex_s = torch.where(ex_valid, ex_s, NEG_INF)

    cand_i = torch.cat([new_ids, torch.where(ex_valid, ex, -1)], dim=1)
    cand_s = torch.cat([new_s, ex_s], dim=1)
    cand_v = torch.cat([new_valid, ex_valid], dim=1)
    # ranked_top_m order: valid first, score descending, id ascending
    order = torch.sort(cand_i, dim=1, stable=True).indices
    for key in (-cand_s, (~cand_v).to(torch.int8)):
        order = order.gather(1, torch.sort(key.gather(1, order), dim=1, stable=True).indices)
    ids = torch.where(cand_v.gather(1, order), cand_i.gather(1, order), -1)[:, :m]
    if ids.shape[1] < m:
        ids = torch.cat([ids, ids.new_full((u, m - ids.shape[1]), -1)], dim=1)
    return tgt, ids.to(torch.int32)
