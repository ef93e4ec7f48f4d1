"""Recall / evaluation-count metrics (paper §5), numpy only."""
from __future__ import annotations

import numpy as np


def recall_at_k(pred_ids: np.ndarray, true_ids: np.ndarray) -> float:
    """Mean recall@k over queries.

    pred_ids: [B, k'] (k' >= k allowed; -1 padding ignored)
    true_ids: [B, k]  ground-truth ids
    """
    pred = np.asarray(pred_ids)
    true = np.asarray(true_ids)
    b, k = true.shape
    hit = (pred[:, :, None] == true[:, None, :]) & (true[:, None, :] >= 0)
    per_query = hit.any(axis=1).sum(axis=-1) / k
    return float(per_query.mean())


def recall_curve(results: list, true_ids: np.ndarray) -> list:
    """[(evals_mean, recall)] for results at increasing search effort (the
    paper's Fig-8a axis).  Each result has ``ids`` and ``evals`` tensors."""
    return [(float(res.evals.float().mean()), recall_at_k(res.ids.cpu().numpy(), true_ids))
            for res in results]
