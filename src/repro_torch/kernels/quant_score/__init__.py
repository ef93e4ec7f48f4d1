from repro_torch.kernels.quant_score.ops import quant_score
from repro_torch.kernels.quant_score.ref import quant_score_ref

__all__ = ["quant_score", "quant_score_ref"]
