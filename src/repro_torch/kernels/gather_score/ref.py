"""Plain PyTorch version of gather_score: the gathered fp32 inner products
``q[b] . items[ids[b, w]]`` (the JAX package's ``gather_score_ref``).  It is
``core.similarity.gather_scores``, which ``beam_step_ref`` also scores with,
so it stays plain there."""
from repro_torch.core.similarity import gather_scores as gather_score_ref

__all__ = ["gather_score_ref"]
