"""Synthetic MIPS datasets (numpy), bit-identical to the JAX package's
generator for the same arguments.

The paper's real datasets are not in the repository; ``mips_dataset`` draws
embedding sets whose NORM PROFILE follows the paper's Figure-2 families,
which is the property its analyses key on:

  gaussian      iid N(0, 1/d): tight norms (Yahoo!Music / Tiny5M shape)
  lognormal     heavy right tail of norms (WordVector / ImageNet shape)
  uniform_norm  random directions with norms uniform in [0.2, 1.0]
  shift (+c)    ImageNet-A/-B transform of §5: add c to every norm
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
