from repro_torch.obs.recall import recall_at_k, recall_curve

__all__ = ["recall_at_k", "recall_curve"]
