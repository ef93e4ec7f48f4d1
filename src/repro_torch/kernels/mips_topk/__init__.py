from repro_torch.kernels.mips_topk.ops import mips_topk, mips_topk_select
from repro_torch.kernels.mips_topk.ref import (
    mips_topk_ref,
    select_candidates_ref,
    select_top_k_ref,
)

__all__ = ["mips_topk", "mips_topk_ref", "mips_topk_select", "select_candidates_ref",
           "select_top_k_ref"]
