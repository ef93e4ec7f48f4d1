"""The port's MoE layer against the JAX package's, on the CPU: routing in
``lax.top_k``'s order, the sort-based dispatch with capacity drops, the
expert split, the combine and the aux loss.  Inputs are seeded numpy draws
and JAX's parameters are carried across.  Outputs within 2e-5 of their
largest value and the aux loss within rtol 1e-6 (fp32; the CPU's
scatter-add keeps JAX's order, the card's atomics do not)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro_torch.convert import params_from_arrays
from repro_torch.models import moe as TM
from test_torch_build import one_torch_thread  # noqa: F401 -- an autouse fixture

RTOL = 2e-5
# JAX's references, jitted (op by op, a dispatch takes seconds)
J_MOE = jax.jit(JM.moe_apply, static_argnames=("n_experts", "top_k", "capacity_factor"))
J_DISPATCH = jax.jit(JM._dispatch_local, static_argnames=("top_k", "capacity", "split"))


def _t(tree):
    return params_from_arrays(jax.tree.map(np.asarray, tree), device="cpu")


def _close(got, want, what):
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= RTOL * float(np.abs(want).max()), f"{what}: {err}"


def _capacity_drops(x2d, router, top_k, capacity, split=1):
    """Choices the capacity drops: per expert, choices beyond capacity."""
    _, _, idx = TM.route(torch.as_tensor(x2d), torch.as_tensor(np.array(router)), top_k)
    counts = np.bincount(idx.numpy().ravel(), minlength=router.shape[1]) * split
    return int(np.maximum(counts - capacity * split, 0).sum())


@pytest.mark.parametrize("capacity_factor,top_k", [(1.25, 2), (0.5, 2), (0.25, 3)])
def test_moe_apply_matches_jax(capacity_factor, top_k):
    d, f, e = 32, 48, 8
    p, _ = JM.moe_init(jax.random.PRNGKey(0), d, f, e, jnp.float32)
    x = np.random.default_rng(0).normal(size=(2, 24, d)).astype(np.float32)
    want, waux = J_MOE(p, jnp.asarray(x), n_experts=e, top_k=top_k,
                       capacity_factor=capacity_factor)
    got, aux = TM.moe_apply(_t(p), torch.as_tensor(x), n_experts=e, top_k=top_k,
                            capacity_factor=capacity_factor)
    _close(got, want, "moe out")
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)
    capacity = max(8, int(48 * top_k / e * capacity_factor))
    dropped = _capacity_drops(x.reshape(-1, d), p["router"], top_k, capacity)
    assert dropped > 0 or capacity_factor > 1.0, dropped


def test_dispatch_with_expert_split_matches_jax():
    """_dispatch_local with split 2 (grok's), capacity drops included."""
    d, f, e = 16, 32, 4
    p, _ = JM.moe_init(jax.random.PRNGKey(1), d, f, e, jnp.float32, expert_split=2)
    x = np.random.default_rng(1).normal(size=(40, d)).astype(np.float32)
    want, waux = J_DISPATCH(jnp.asarray(x), p["router"], p["w_gate"], p["w_in"],
                            p["w_out"], jnp.int32(0), top_k=2, capacity=12, split=2)
    tp = _t(p)
    got, aux = TM._dispatch_local(torch.as_tensor(x), tp["router"], tp["w_gate"], tp["w_in"],
                                  tp["w_out"], 0, top_k=2, capacity=12, split=2)
    _close(got, want, "split dispatch")
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)
    assert _capacity_drops(x, p["router"], 2, 12) > 0


def test_expert_split_is_exact():
    """split 2 half-experts reproduce the unsplit MoE from the same weights
    (tests/test_arch_smoke.py's test_grok_expert_split_is_exact on the
    port)."""
    d, f, e = 16, 32, 4
    p = TM.moe_init(torch.Generator().manual_seed(0), d, f, e, torch.float32, device="cpu")
    half = f // 2

    def halves(w, axis):
        a, b = torch.split(w, half, dim=axis)
        return torch.stack([a, b], dim=1).reshape(e * 2, *a.shape[1:])

    sp = {"router": p["router"], "w_gate": halves(p["w_gate"], 2),
          "w_in": halves(p["w_in"], 2), "w_out": halves(p["w_out"], 1)}
    x = torch.randn((2, 6, d), generator=torch.Generator().manual_seed(1))
    a, aux_a = TM.moe_apply(p, x, n_experts=e, top_k=2)
    b, aux_b = TM.moe_apply(sp, x, n_experts=e, top_k=2, expert_split=2)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert float(aux_a) == float(aux_b)


def test_router_ties_take_lax_top_k_order():
    """Tied router probs (a zero router: every expert 1/E): the lowest ids
    win, as lax.top_k picks them, and the outputs equal JAX's."""
    d, f, e = 16, 24, 6
    p, _ = JM.moe_init(jax.random.PRNGKey(2), d, f, e, jnp.float32)
    p["router"] = jnp.zeros_like(p["router"])
    x = np.random.default_rng(2).normal(size=(1, 10, d)).astype(np.float32)
    _, _, idx = TM.route(torch.as_tensor(x[0]), torch.zeros((d, e)), 3)
    assert (idx.numpy() == np.arange(3)).all()
    want, waux = J_MOE(p, jnp.asarray(x), n_experts=e, top_k=3)
    got, aux = TM.moe_apply(_t(p), torch.as_tensor(x), n_experts=e, top_k=3)
    _close(got, want, "tied router")
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


def test_expert_chunks_keep_each_expert(monkeypatch):
    """A prefill's expert chunks (FFN_CHUNK_VALUES) leave the output as it
    was; bf16 weights give a bf16 output."""
    d, f, e = 16, 32, 8
    p, _ = JM.moe_init(jax.random.PRNGKey(3), d, f, e, jnp.float32)
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(2, 16, d)).astype(np.float32))
    tp = _t(p)
    whole, _ = TM.moe_apply(tp, x, n_experts=e, top_k=2)
    monkeypatch.setattr(TM, "FFN_CHUNK_VALUES", 8 * f * 3)
    chunked, _ = TM.moe_apply(tp, x, n_experts=e, top_k=2)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)
    bf = {k: (v if k == "router" else v.to(torch.bfloat16)) for k, v in tp.items()}
    out, _ = TM.moe_apply(bf, x.to(torch.bfloat16), n_experts=e, top_k=2)
    assert out.dtype == torch.bfloat16
    with pytest.raises(TypeError, match="DeviceMesh"):  # before any work
        TM.moe_apply({}, x, n_experts=e, top_k=2, mesh=object())
