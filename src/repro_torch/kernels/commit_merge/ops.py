"""commit_merge wrapper: the CSR pre-pass in plain PyTorch on either device,
then the row merge -- the kernel of ``csrc/commit_merge.cu`` for CUDA
tensors, ``commit_rows_ref`` for CPU tensors.

The wrapper owns ``adj``: it writes the merged rows into it in place and
returns it.  ``commit_merge.launches`` counts kernel launches."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.commit_merge.ref import commit_rows_ref

MAX_SHARED_BYTES = 227 * 1024  # dynamic shared memory one H100 block can use


class CsrProposals(NamedTuple):
    utgt: torch.Tensor         # [U] int32 unique targets, ascending
    offsets: torch.Tensor      # [U+1] int32 segment offsets into the cands
    cand_ids: torch.Tensor     # [P] int32, ascending within each segment
    cand_scores: torch.Tensor  # [P] fp32
    max_seg: int               # longest segment


def csr_proposals(
    n: int, targets: torch.Tensor, cands: torch.Tensor, scores: torch.Tensor
) -> CsrProposals:
    """Sort the proposals stably by (target, cand), drop repeated pairs
    (the first in input order wins) and lay them out as one segment per
    unique target.  A target whose cands are all -1 keeps an empty segment:
    its row is still rewritten."""
    big = n + 1
    t, c = targets.long(), cands.long()
    k1 = torch.where(t >= 0, t, big)
    k2 = torch.where((t >= 0) & (c >= 0), c, big)
    key, order = torch.sort(k1 * (big + 1) + k2, stable=True)
    k1s, k2s = k1[order], k2[order]
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=key.device),
                     key[1:] == key[:-1]])
    survive = (k1s < big) & (k2s < big) & ~dup
    new_t = torch.cat([k1s[:1] < big, (k1s[1:] != k1s[:-1]) & (k1s[1:] < big)])
    seg = torch.cumsum(new_t, dim=0) - 1
    utgt = k1s[new_t]
    counts = torch.bincount(seg[survive], minlength=utgt.shape[0])
    offsets = torch.zeros(utgt.shape[0] + 1, dtype=torch.long, device=key.device)
    offsets[1:] = torch.cumsum(counts, dim=0)
    return CsrProposals(
        utgt=utgt.to(torch.int32),
        offsets=offsets.to(torch.int32),
        cand_ids=k2s[survive].to(torch.int32),
        cand_scores=scores[order][survive].float(),
        max_seg=int(counts.max()) if counts.numel() else 0,
    )


def commit_rows(adj: torch.Tensor, items: torch.Tensor, csr: CsrProposals) -> None:
    """Rewrite the rows of ``csr.utgt`` in ``adj``, in place."""
    if not _lib.on_cuda(adj):
        adj[csr.utgt.long()] = commit_rows_ref(adj, items, *csr[:4])
        return
    dev = adj.device
    n, m = adj.shape
    d = items.shape[1]
    u, p = csr.utgt.shape[0], csr.cand_ids.shape[0]
    _lib.expect(adj, "adj", torch.int32, (n, m), dev)
    _lib.expect(items, "items", torch.float32, (n, d), dev)
    _lib.expect(csr.utgt, "utgt", torch.int32, (u,), dev)
    _lib.expect(csr.offsets, "offsets", torch.int32, (u + 1,), dev)
    _lib.expect(csr.cand_ids, "cand_ids", torch.int32, (p,), dev)
    _lib.expect(csr.cand_scores, "cand_scores", torch.float32, (p,), dev)
    smem = 4 * (-(-d // 4) * 4) + 9 * (csr.max_seg + m)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"commit_merge: a target with {csr.max_seg} proposals at d={d} needs "
            f"{smem} bytes of shared memory, more than {MAX_SHARED_BYTES}"
        )
    if u == 0:
        return
    rc = _lib.lib().commit_merge_f32(
        csr.utgt.data_ptr(), csr.offsets.data_ptr(), csr.cand_ids.data_ptr(),
        csr.cand_scores.data_ptr(), adj.data_ptr(), items.data_ptr(),
        u, m, d, csr.max_seg, _lib.stream(dev),
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
        commit_rows(adj, items, csr_proposals(adj.shape[0], targets, cands, scores))
    return adj


commit_merge.launches = 0
