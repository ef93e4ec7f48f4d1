from repro_torch.kernels.commit_merge.ops import (
    CsrProposals,
    commit_merge,
    commit_rows,
    csr_proposals,
)
from repro_torch.kernels.commit_merge.ref import commit_merge_ref, commit_rows_ref

__all__ = [
    "CsrProposals",
    "commit_merge",
    "commit_merge_ref",
    "commit_rows",
    "commit_rows_ref",
    "csr_proposals",
]
