"""Synthetic MIPS datasets (numpy), bit-identical to the JAX package's
generator for the same arguments.

The paper's real datasets are not in the repository; ``mips_dataset`` draws
embedding sets whose NORM PROFILE follows the paper's Figure-2 families,
which is the property its analyses key on:

  gaussian      iid N(0, 1/d): tight norms (Yahoo!Music / Tiny5M shape)
  lognormal     heavy right tail of norms (WordVector / ImageNet shape)
  uniform_norm  random directions with norms uniform in [0.2, 1.0]
  shift (+c)    ImageNet-A/-B transform of §5: add c to every norm

``SyntheticLMStream`` and ``SyntheticClickStream`` are the training streams:
``batch_at(step)`` is a pure function of ``(seed, step)``, so the pipeline
state a checkpoint needs is the step counter.
"""
from __future__ import annotations

import numpy as np


def mips_dataset(
    n: int,
    d: int,
    profile: str = "gaussian",
    seed: int = 0,
    shift: float = 0.0,
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32) / np.sqrt(d)
    if profile == "gaussian":
        pass
    elif profile == "lognormal":
        scale = rng.lognormal(mean=0.0, sigma=0.6, size=(n, 1)).astype(np.float32)
        x = x * scale
    elif profile == "uniform_norm":
        target = rng.uniform(0.2, 1.0, size=(n, 1)).astype(np.float32)
        x = x / np.linalg.norm(x, axis=1, keepdims=True) * target
    else:
        raise ValueError(profile)
    if shift != 0.0:
        norms = np.linalg.norm(x, axis=1, keepdims=True)
        x = x * (norms + shift) / np.maximum(norms, 1e-12)
    return x


def mips_queries(n: int, d: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)


class SyntheticLMStream:
    """Deterministic, resumable token stream: ``batch_at(step)`` is a pure
    function of (seed, step)."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 32) + step)
        toks = rng.integers(0, self.vocab, size=(self.batch, self.seq + 1))
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


class SyntheticClickStream:
    """CTR / click batches for the recsys towers (the same determinism
    contract).  ``pos`` is [B, S] (SASRec's per-position next item)."""

    def __init__(self, n_items: int, batch: int, seq: int, n_sparse: int = 26,
                 n_dense: int = 13, seed: int = 0):
        self.n_items, self.batch, self.seq = n_items, batch, seq
        self.n_sparse, self.n_dense, self.seed = n_sparse, n_dense, seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 32) + step)
        b, s = self.batch, self.seq
        hist = rng.integers(0, self.n_items, size=(b, s)).astype(np.int32)
        # ragged histories: a random valid prefix per row, -1 after it
        lengths = rng.integers(1, s + 1, size=(b, 1))
        hist = np.where(np.arange(s)[None, :] < lengths, hist, -1)
        return {
            "hist": hist,
            "pos": rng.integers(0, self.n_items, size=(b, s)).astype(np.int32),
            "neg": rng.integers(0, self.n_items, size=(b, s, 4)).astype(np.int32),
            "target": rng.integers(0, self.n_items, size=(b,)).astype(np.int32),
            "labels": rng.integers(0, 2, size=(b,)).astype(np.float32),
            "aux_neg": rng.integers(0, self.n_items, size=(b, s)).astype(np.int32),
            "dense": rng.normal(size=(b, self.n_dense)).astype(np.float32),
            "sparse": rng.integers(0, self.n_items, size=(b, self.n_sparse)).astype(np.int32),
        }
