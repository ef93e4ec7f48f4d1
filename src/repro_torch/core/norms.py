"""Norm-bias analysis utilities (paper §2, Figures 1-3, Theorems 1-2).

Everything here is host-side analysis used by the benchmarks; the search path
never calls into this module.  numpy only, but for ``erf``: Theorem 1's inner
integral takes ``torch.special.erf`` in float64.  The JAX package computes
that ``erf`` in float32 (JAX's default precision), so ``theorem1_probability``
and ``cardinality_win_probability`` agree with it to about 1e-6, not bit for
bit; every other function here is the JAX package's numpy, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Norm groups (Figures 1, 4, 5)
# ---------------------------------------------------------------------------


def norm_group_of(norms: np.ndarray, n_groups: int = 20) -> np.ndarray:
    """Rank-based norm group per item: 0 = top ``100/n_groups`` % in norm,
    1 = next slice, ... ``n_groups-1`` = smallest norms.

    Matches the paper's partition "items ranking top 5% in norm", "top
    20%-25%", ... for ``n_groups=20``.
    """
    norms = np.asarray(norms)
    n = norms.shape[0]
    # rank 0 = largest norm
    rank = np.empty(n, dtype=np.int64)
    rank[np.argsort(-norms, kind="stable")] = np.arange(n)
    group = (rank * n_groups) // n
    return group.astype(np.int32)


def group_occupancy(
    result_ids: np.ndarray, groups: np.ndarray, n_groups: int = 20
) -> np.ndarray:
    """Fraction of the (flattened, duplicates-allowed) result set that falls
    in each norm group -- the quantity plotted in Figure 1 / Figure 5."""
    ids = np.asarray(result_ids).reshape(-1)
    ids = ids[ids >= 0]
    counts = np.bincount(groups[ids], minlength=n_groups).astype(np.float64)
    total = counts.sum()
    return counts / max(total, 1.0)


def top_group_share(result_ids: np.ndarray, norms: np.ndarray, pct: float = 5.0) -> float:
    """Share of results occupied by items ranking in the top ``pct`` % by
    norm (the headline 87.5-100 % numbers of the paper)."""
    n_groups = int(round(100.0 / pct))
    groups = norm_group_of(norms, n_groups)
    return float(group_occupancy(result_ids, groups, n_groups)[0])


def tailing_factor(norms: np.ndarray) -> float:
    """TF = 95th-percentile norm / median norm (paper §5, Fig 8c)."""
    norms = np.asarray(norms)
    return float(np.percentile(norms, 95) / np.median(norms))


def in_degree_by_group(
    in_deg: np.ndarray, groups: np.ndarray, n_groups: int = 20
) -> np.ndarray:
    """Average in-degree per norm group, normalized by dataset average
    (Figure 4's y-axis is the raw average; we report both)."""
    out = np.zeros(n_groups)
    for g in range(n_groups):
        m = groups == g
        out[g] = in_deg[m].mean() if m.any() else 0.0
    return out


# ---------------------------------------------------------------------------
# Theorem 1 -- P[qx >= qy | qx >= 0, qy >= 0] for x_i ~ N(0, alpha), y_i ~ N(0,1)
# ---------------------------------------------------------------------------


def theorem1_probability(alpha: float, n_grid: int = 8192) -> float:
    """Numerical evaluation of the paper's Theorem-1 double integral:

        P = 2 / (pi * sqrt(alpha)) * int_0^inf e^{-a^2/(2 alpha)}
                                       int_0^a e^{-b^2/2} db da

    The inner integral is sqrt(pi/2) * erf(a / sqrt(2)).
    Sanity: alpha = 1  ->  P = 0.5 exactly.
    """
    alpha = float(alpha)
    hi = 12.0 * max(np.sqrt(alpha), 1.0)
    a = np.linspace(0.0, hi, n_grid)
    inner = np.sqrt(np.pi / 2.0) * torch.special.erf(torch.from_numpy(a / np.sqrt(2.0))).numpy()
    integrand = np.exp(-(a**2) / (2.0 * alpha)) * inner
    val = np.trapezoid(integrand, a)
    return float(2.0 / (np.pi * np.sqrt(alpha)) * val)


def cardinality_win_probability(alpha: float, m: int) -> float:
    """Paper §2 cardinality argument: probability that a modest-norm item
    beats all ``m`` items whose norm is ``sqrt(alpha)`` times larger,
    assuming independence: (1 - P(alpha))^m with P from Theorem 1."""
    p_single = theorem1_probability(alpha)
    return float((1.0 - p_single) ** m)


# ---------------------------------------------------------------------------
# Theorem 2 -- x.z | y.z = gamma  ~  N(gamma*beta*|x|/|y|, |x|^2 (1-beta^2))
# ---------------------------------------------------------------------------


def theorem2_conditional(
    beta: float, gamma: float, x_norm: float, y_norm: float
) -> tuple[float, float]:
    """Mean and std of x.z given y.z = gamma under Theorem 2's model."""
    mean = gamma * beta * x_norm / y_norm
    std = x_norm * np.sqrt(max(1.0 - beta**2, 0.0))
    return float(mean), float(std)
