from repro_torch.kernels.commit_merge.ops import (
    SortedProposals,
    commit_merge,
    commit_rows,
    sort_proposals,
)
from repro_torch.kernels.commit_merge.ref import commit_merge_ref, commit_rows_ref

__all__ = [
    "SortedProposals",
    "commit_merge",
    "commit_merge_ref",
    "commit_rows",
    "commit_rows_ref",
    "sort_proposals",
]
