"""SimpleLSH, port vs JAX (``core/lsh.py`` of each).

Sizes: ``tests/test_core.py``'s set (N = 3,000, D = 32, lognormal, 64
queries) at its 96 bits, so that T = 800 candidates is a quarter of the
catalog; and integer items, where the exact rerank is exact in any order.
The port runs on ``device="cpu"``: the Hamming ranking is ``mips_topk``'s
plain version and the rerank ``gather_score``'s.

  * JAX's codes and planes carried across (``convert.lsh_from_arrays``):
    ids, scores and evals equal to JAX's at T 50, 100 and 800 (integer
    items bit for bit; lognormal ids up to near-ties);
  * the Hamming stage is ``lax.top_k`` of the agreements, ties and all:
    every agreement is an even integer, and the cut falls inside a tie
    group, where the lowest ids win;
  * the build's codes equal JAX's for JAX's planes, except where a
    projection lies within ``SIGN_TOL`` of 0 (its sign is the rounding's);
  * the port's own planes come from its seed; recall rises with T, exceeds
    0.5 at T = 800 (``tests/test_core.py``'s claim) and sits within 0.05 of
    JAX's (the planes differ).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import SimpleLSH as JaxSimpleLSH
from repro.core import exact_topk as jax_exact_topk
from repro.core import recall_at_k
from repro.data import mips_dataset, mips_queries

from repro_torch.convert import lsh_from_arrays
from repro_torch.core import LSHResult, SimpleLSH
from repro_torch.core.lsh import augment_items, augment_queries, sign_codes
from repro_torch.kernels.mips_topk import mips_topk
from repro_torch.testing import assert_topk_match
from test_torch_build import one_torch_thread  # noqa: F401 -- an autouse fixture

N, D, K, BITS = 3000, 32, 10, 96
CANDIDATES = (50, 100, 800)
SIGN_TOL = 1e-5      # |projection| under which the two packages may disagree on its sign
LSH_RECALL_MARGIN = 0.05  # own planes against JAX's


@functools.lru_cache(maxsize=None)
def _items(profile):
    if profile == "integer":
        return np.random.default_rng(2).integers(-3, 4, (N, D)).astype(np.float32)
    return mips_dataset(N, D, "lognormal", seed=0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _queries(profile):
    if profile == "integer":
        return np.random.default_rng(3).integers(-3, 4, (64, D)).astype(np.float32)
    return mips_queries(64, D, seed=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_index(profile):
    return JaxSimpleLSH(n_bits=BITS).build(jnp.asarray(_items(profile)))


@functools.lru_cache(maxsize=None)
def _gt():
    _, gt = jax_exact_topk(jnp.asarray(_queries("lognormal")), jnp.asarray(_items("lognormal")),
                           k=K)
    return np.asarray(gt)


def _carried(profile):
    j = _jax_index(profile)
    return lsh_from_arrays(np.asarray(j.codes), np.asarray(j.planes), np.asarray(j.items),
                           device="cpu")


def test_lsh_from_arrays_round_trip():
    j, t = _jax_index("lognormal"), _carried("lognormal")
    assert t.n_bits == BITS and t.device == "cpu"
    for name in ("codes", "planes", "items"):
        x = getattr(t, name)
        assert x.dtype == torch.float32 and np.array_equal(x.numpy(), np.asarray(getattr(j, name)))


@pytest.mark.parametrize("n_candidates", CANDIDATES)
@pytest.mark.parametrize("profile", ["integer", "lognormal"])
def test_carried_lsh_equals_jax(profile, n_candidates):
    q = _queries(profile)
    j = _jax_index(profile).search(jnp.asarray(q), k=K, n_candidates=n_candidates)
    t = _carried(profile).search(q, k=K, n_candidates=n_candidates)
    assert isinstance(t, LSHResult)
    assert t.ids.dtype == torch.int32 and t.evals.dtype == torch.int32
    assert np.array_equal(t.evals.numpy(), np.asarray(j.evals))
    assert (t.evals == n_candidates).all()
    if profile == "integer":
        assert np.array_equal(t.ids.numpy(), np.asarray(j.ids))
        assert np.array_equal(t.scores.numpy().view(np.int32),
                              np.asarray(j.scores).view(np.int32))
    else:
        assert_topk_match(t.ids.numpy(), t.scores.numpy(), np.asarray(j.ids),
                          np.asarray(j.scores))


def _jax_hamming(j, q, n_candidates):
    """The Hamming stage of the JAX package's ``_lsh_search``, spelled out:
    (query codes, agreements, candidates)."""
    qn = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    q_aug = jnp.concatenate([qn, jnp.zeros(qn.shape[:-1] + (1,), qn.dtype)], -1)
    q_codes = jnp.where(q_aug @ j.planes >= 0, 1.0, -1.0).astype(jnp.float32)
    agreement = jnp.einsum("bh,nh->bn", q_codes, j.codes, preferred_element_type=jnp.float32)
    return np.asarray(q_codes), np.asarray(agreement), np.asarray(
        jax.lax.top_k(agreement, n_candidates)[1])


@pytest.mark.parametrize("n_candidates", CANDIDATES)
def test_hamming_stage_is_lax_top_k_under_bulk_ties(n_candidates):
    j, t = _jax_index("lognormal"), _carried("lognormal")
    q = _queries("lognormal")
    jq, agreement, jcand = _jax_hamming(j, jnp.asarray(q), n_candidates)
    q_codes = sign_codes(augment_queries(torch.from_numpy(q)), t.planes)
    assert np.array_equal(q_codes.numpy(), jq)
    scores, cand = mips_topk(q_codes, t.codes, k=n_candidates)
    assert np.array_equal(cand.numpy(), jcand)
    assert np.array_equal(scores.numpy(), np.take_along_axis(agreement, jcand, 1))
    # every agreement an even integer in [-BITS, BITS], and the cut inside a
    # tie group on most rows: the tie rule decides the candidates
    assert np.all(agreement % 2 == 0) and np.abs(agreement).max() <= BITS
    kth = np.take_along_axis(agreement, jcand[:, -1:], 1)
    split = ((agreement == kth).sum(1) > (np.take_along_axis(agreement, jcand, 1) == kth).sum(1))
    assert split.mean() > 0.5


def test_build_codes_equal_jax_for_the_same_planes():
    j = _jax_index("lognormal")
    planes = torch.tensor(np.asarray(j.planes))
    aug = augment_items(torch.from_numpy(_items("lognormal")))
    codes = sign_codes(aug, planes)
    proj = (aug.double() @ planes.double()).numpy()
    differ = codes.numpy() != np.asarray(j.codes)
    assert not (differ & (np.abs(proj) >= SIGN_TOL)).any()
    assert differ.sum() <= (np.abs(proj) < SIGN_TOL).sum()
    assert set(np.unique(codes.numpy())) == {-1.0, 1.0}


def test_port_planes_reproducible_from_seed():
    x = _items("lognormal")
    a = SimpleLSH(n_bits=BITS, device="cpu").build(x)
    b = SimpleLSH(n_bits=BITS, device="cpu").build(x)
    c = SimpleLSH(n_bits=BITS, seed=1, device="cpu").build(x)
    assert a.planes.shape == (D + 1, BITS) and a.codes.shape == (N, BITS)
    assert torch.equal(a.planes, b.planes) and torch.equal(a.codes, b.codes)
    assert not torch.equal(a.planes, c.planes)
    g = torch.Generator().manual_seed(0)
    assert torch.equal(a.planes, torch.randn((D + 1, BITS), generator=g))


def test_recall_rises_with_candidates_and_tracks_jax():
    q, gt = _queries("lognormal"), _gt()
    t = SimpleLSH(n_bits=BITS, device="cpu").build(_items("lognormal"))
    rec = [recall_at_k(t.search(q, k=K, n_candidates=c).ids.numpy(), gt) for c in CANDIDATES]
    assert rec[0] < rec[1] < rec[2] and rec[2] > 0.5, rec
    j = _jax_index("lognormal")
    rec_j = recall_at_k(np.asarray(j.search(jnp.asarray(q), k=K, n_candidates=800).ids), gt)
    assert abs(rec[2] - rec_j) <= LSH_RECALL_MARGIN, (rec[2], rec_j)


def test_search_before_build_raises():
    with pytest.raises(RuntimeError):
        SimpleLSH(device="cpu").search(_queries("lognormal"))
