from repro_torch.kernels.mips_topk.ops import mips_topk
from repro_torch.kernels.mips_topk.ref import mips_topk_ref

__all__ = ["mips_topk", "mips_topk_ref"]
