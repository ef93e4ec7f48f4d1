"""The port's tolerance contract, numpy only.

How a result of the port is held against the JAX package, and how a CUDA
kernel is held against its plain PyTorch version:

  * scores agree within ``rtol=1e-5, atol=1e-6`` (fp32 sums taken in another
    order differ in the last bits);
  * ids are identical, except at near-ties: a position where the two results
    hold different ids whose scores differ by less than that tolerance;
  * on integer-valued inputs every fp32 dot product is exact in any order, so
    ids, scores and flags must be bit-identical, ties included;
  * whole builds are compared by graph invariants and recall, not by
    bit-identical adjacency: a one-ulp difference early in a build cascades
    through every batch after it.  Where every score is exact (an IpNSW
    build on integer items) the adjacency is compared bit for bit.
"""
from __future__ import annotations

import numpy as np

RTOL = 1e-5
ATOL = 1e-6
RECALL_MARGIN = 0.02  # |recall(port) - recall(JAX)| on the same seeded build


def scores_close(a, b) -> np.ndarray:
    """Elementwise tolerance test; -inf matches -inf."""
    return np.isclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                      rtol=RTOL, atol=ATOL)


def near_tie_rows(ids_a, ids_b, scores_a, scores_b) -> np.ndarray:
    """Indices of the rows whose ids differ; raises unless every differing
    position is a near-tie (its two scores agree within the tolerance)."""
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    diff = ids_a != ids_b
    ok = scores_close(scores_a, scores_b)
    bad = diff & ~ok
    if bad.any():
        r, c = np.argwhere(bad)[0]
        raise AssertionError(
            f"ids differ beyond a near-tie at row {r}, slot {c}: "
            f"{ids_a[r, c]} ({scores_a[r, c]!r}) vs {ids_b[r, c]} ({scores_b[r, c]!r})"
        )
    return np.flatnonzero(diff.any(axis=-1))


def assert_topk_match(ids_a, scores_a, ids_b, scores_b) -> np.ndarray:
    """Scores within tolerance and ids identical up to near-ties; returns the
    rows that needed the near-tie exception."""
    ok = scores_close(scores_a, scores_b)
    if not ok.all():
        r, c = np.argwhere(~ok)[0]
        raise AssertionError(
            f"scores differ at row {r}, slot {c}: {scores_a[r, c]!r} vs {scores_b[r, c]!r}"
        )
    return near_tie_rows(ids_a, ids_b, scores_a, scores_b)
