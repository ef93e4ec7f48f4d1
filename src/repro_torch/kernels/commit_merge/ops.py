"""commit_merge wrapper: the pre-pass in plain PyTorch on either device (one
stable sort: static shapes, no read-back from the card), then the row merge
-- the kernel of ``csrc/commit_merge.cu`` for CUDA tensors,
``commit_rows_ref`` for CPU tensors.

The wrapper owns ``adj``: it writes the merged rows into it in place and
returns it.  ``commit_merge.launches`` counts kernel launches."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.commit_merge.ref import commit_rows_ref


class SortedProposals(NamedTuple):
    targets: torch.Tensor  # [E] int32 ascending, invalid (-1) last
    cands: torch.Tensor    # [E] int32 ascending within a target's run, invalid (-1) last
    scores: torch.Tensor   # [E] fp32


def sort_proposals(
    n: int, targets: torch.Tensor, cands: torch.Tensor, scores: torch.Tensor
) -> SortedProposals:
    """Sort the proposals stably by (target, cand): a target's proposals
    form one run, a repeated pair stays in input order (the first wins), and
    a proposal with target -1 (padding) or cand -1 sorts after the valid
    ones, with -1 written in its invalid fields.  Every shape is E: nothing
    is read back from the device."""
    big = n + 1
    t, c = targets.long(), cands.long()
    k1 = torch.where(t >= 0, t, big)
    k2 = torch.where((t >= 0) & (c >= 0), c, big)
    key, order = torch.sort(k1 * (big + 1) + k2, stable=True)
    k1s, k2s = key // (big + 1), key % (big + 1)
    return SortedProposals(
        targets=torch.where(k1s < big, k1s, -1).to(torch.int32),
        cands=torch.where(k2s < big, k2s, -1).to(torch.int32),
        scores=scores.float().index_select(0, order),
    )


def commit_rows(adj: torch.Tensor, items: torch.Tensor, props: SortedProposals) -> None:
    """Rewrite the rows of the targets of ``props`` in ``adj``, in place."""
    if not _lib.on_cuda(adj):
        tgt, rows = commit_rows_ref(adj, items, *props)
        adj[tgt] = rows
        return
    dev = adj.device
    n, m = adj.shape
    d = items.shape[1]
    e = props.targets.shape[0]
    _lib.expect(adj, "adj", torch.int32, (n, m), dev)
    _lib.expect(items, "items", torch.float32, (n, d), dev)
    _lib.expect(props.targets, "targets", torch.int32, (e,), dev)
    _lib.expect(props.cands, "cands", torch.int32, (e,), dev)
    _lib.expect(props.scores, "scores", torch.float32, (e,), dev)
    if e == 0:
        return
    rc = _lib.lib().commit_merge_f32(
        props.targets.data_ptr(), props.cands.data_ptr(), props.scores.data_ptr(),
        adj.data_ptr(), items.data_ptr(), e, m, d, _lib.stream(dev),
    )
    _lib.check(rc, "commit_merge")
    commit_merge.launches += 1


def commit_merge(
    adj: torch.Tensor,      # [N, M] int32, updated in place
    items: torch.Tensor,    # [N, d] fp32
    targets: torch.Tensor,  # [E] int32 reverse-edge targets (-1 invalid)
    cands: torch.Tensor,    # [E] int32 proposed neighbors (-1 invalid)
    scores: torch.Tensor,   # [E] fp32 s(target, cand)
) -> torch.Tensor:
    """Merge reverse-edge proposals into ``adj`` (in place; returned).  The
    result equals ``commit_merge_ref`` on the same inputs."""
    if targets.shape[0]:
        commit_rows(adj, items, sort_proposals(adj.shape[0], targets, cands, scores))
    return adj


commit_merge.launches = 0
