from repro_torch.kernels.gather_score.ops import gather_score
from repro_torch.kernels.gather_score.ref import gather_score_ref

__all__ = ["gather_score", "gather_score_ref"]
