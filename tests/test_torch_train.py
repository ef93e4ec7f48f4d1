"""The port's training substrate against the JAX package's, on the CPU:
streams, AdamW and its schedule, checkpoints (across the two packages,
both ways), the resumable loop, the train launcher and the train-then-serve
example."""
import dataclasses
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jax_train_launcher
from repro.data import SyntheticClickStream as JaxClickStream
from repro.data import SyntheticLMStream as JaxLMStream
from repro.models.recsys import sasrec as jax_sasrec
from repro.train import adamw_init as jax_adamw_init
from repro.train import adamw_update as jax_adamw_update
from repro.train import checkpoint as jax_ckpt
from repro.train import cosine_schedule as jax_cosine
from repro.train import global_norm as jax_global_norm
from repro.train import loop as jax_loop
from repro_torch.configs import get_arch
from repro_torch.convert import adamw_from_arrays, params_from_arrays
from repro_torch.data import SyntheticClickStream, SyntheticLMStream
from repro_torch.launch import train as train_launcher
from repro_torch.models.recsys import sasrec
from repro_torch.train import (
    adamw_init,
    adamw_update,
    checkpoint as ckpt,
    cosine_schedule,
    global_norm,
    loop,
    value_and_grad,
)
from repro_torch.train.tree import named_leaves
from test_torch_build import one_torch_thread  # noqa: F401 -- an autouse fixture

ROOT = Path(__file__).resolve().parents[1]


def _t(tree):
    return params_from_arrays(jax.tree.map(np.asarray, tree), device="cpu")


def _np_tree(tree):
    return {n: leaf.detach().numpy() for n, leaf in named_leaves(tree)}


def _jax_named(tree):
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in paths}


# ------------------------------------------------------------------ streams


@pytest.mark.parametrize("kind", ["lm", "click"])
def test_streams_are_jax_bit_for_bit(kind):
    if kind == "lm":
        ours, theirs = SyntheticLMStream(97, 3, 11, seed=5), JaxLMStream(97, 3, 11, seed=5)
    else:
        ours = SyntheticClickStream(1_000, 4, 9, seed=5)
        theirs = JaxClickStream(1_000, 4, 9, seed=5)
    for step in (0, 1, 17, 123_456):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------- optimizer


def _opt_tree(rng, scale):
    return {"a": (rng.normal(size=(4, 3)) * scale).astype(np.float32),
            "blocks": [{"w": (rng.normal(size=(5,)) * scale).astype(np.float32)},
                       {"w": (rng.normal(size=(2, 2)) * scale).astype(np.float32)}],
            "emb": (rng.normal(size=(7, 3)) * scale).astype(np.float32)}


@pytest.mark.parametrize("grad_scale", [1e-2, 1e3], ids=["unclipped", "clipped"])
def test_adamw_update_matches_jax(grad_scale):
    """Two steps on the same carried grads (the second from a non-zero
    state): params, mu, nu within rtol 1e-6, atol 1e-7; the global norm
    too.  A 0-dim lr tensor, as the cells pass it."""
    rng = np.random.default_rng(0)
    params = _opt_tree(rng, 1.0)
    grads = [_opt_tree(rng, grad_scale), _opt_tree(rng, grad_scale)]
    jp, jo = params, jax_adamw_init(params)
    tp, to = _t(params), adamw_init(_t(params))
    for g in grads:
        np.testing.assert_allclose(float(global_norm(_t(g))), float(jax_global_norm(g)),
                                   rtol=1e-6)
        jp, jo = jax_adamw_update(g, jo, jp, lr=jnp.float32(3e-2))
        tp, to = adamw_update(_t(g), to, tp, lr=torch.tensor(3e-2))
    assert int(to.step) == int(jo.step) == 2
    for ours, theirs in ((tp, jp), (to.mu, jo.mu), (to.nu, jo.nu)):
        want = _jax_named(theirs)
        for name, got in _np_tree(ours).items():
            np.testing.assert_allclose(got, want[name], rtol=1e-6, atol=1e-7, err_msg=name)


def test_cosine_schedule_matches_jax():
    steps = np.arange(0, 121)
    got = cosine_schedule(torch.as_tensor(steps, dtype=torch.int32), base_lr=1e-3, warmup=20,
                          total=100).numpy()
    want = np.asarray(jax_cosine(jnp.asarray(steps, jnp.int32), base_lr=1e-3, warmup=20,
                                 total=100))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_adamw_converges_least_squares(rng):
    a = torch.as_tensor(rng.normal(size=(64, 8)).astype(np.float32))
    w_true = torch.as_tensor(rng.normal(size=(8,)).astype(np.float32))
    y = a @ w_true
    params = {"w": torch.zeros(8)}
    opt = adamw_init(params)
    grad_fn = value_and_grad(lambda p: torch.mean((a @ p["w"] - y) ** 2))
    for _ in range(300):
        loss, g = grad_fn(params)
        params, opt = adamw_update(g, opt, params, lr=3e-2, weight_decay=0.0)
    assert float(loss) < 1e-2


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(4)}
    p2, _ = adamw_update({"w": torch.full((4,), 1e9)}, adamw_init(params), params, lr=1.0,
                         clip=1.0, weight_decay=0.0)
    assert float(p2["w"].abs().max()) < 10.0


def test_cosine_schedule_shape():
    assert float(cosine_schedule(torch.tensor(0, dtype=torch.int32), base_lr=1.0, warmup=10,
                                 total=100)) == 0.0
    mid = cosine_schedule(torch.tensor(10, dtype=torch.int32), base_lr=1.0, warmup=10, total=100)
    assert abs(float(mid) - 1.0) < 1e-6
    end = cosine_schedule(torch.tensor(100, dtype=torch.int32), base_lr=1.0, warmup=10, total=100)
    assert float(end) <= 0.11


# --------------------------------------------------------------- checkpoints


@pytest.fixture(scope="module")
def sasrec_state():
    """A SASRec train state after one JAX AdamW step (non-zero moments), the
    tables cut to 500 rows: JAX's tree and the port's carried copy."""
    cfg = dataclasses.replace(jax_sasrec.SASRecConfig(), n_items=500)
    params, _ = jax_sasrec.init(jax.random.PRNGKey(0), cfg)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.01), params)
    p, o = jax_adamw_update(grads, jax_adamw_init(params), params, lr=1e-3)
    jstate = {"params": p, "opt": o}
    tstate = {"params": _t(p), "opt": adamw_from_arrays(o.step, o.mu, o.nu, device="cpu")}
    return jstate, tstate


def test_checkpoint_roundtrip_and_commit(tmp_path, rng):
    tree = {"a": torch.as_tensor(rng.normal(size=(4, 3)).astype(np.float32)),
            "b": {"c": torch.arange(5, dtype=torch.int32)}}
    d = str(tmp_path)
    ckpt.save(d, 3, tree, extra={"note": "x"})
    assert ckpt.latest_step(d) == 3
    template = {"a": torch.empty((4, 3), device="meta"),
                "b": {"c": torch.empty(5, dtype=torch.int32, device="meta")}}
    out, manifest = ckpt.restore(d, template, device="cpu")
    assert manifest["step"] == 3 and manifest["extra"] == {"note": "x"}
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["b"]["c"], tree["b"]["c"])
    with pytest.raises(ValueError, match="needs a device"):
        ckpt.restore(d, template)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_the_packages(direction, tmp_path, sasrec_state):
    """The same leaf names in the same order, every value bit for bit, and
    the manifest's step, leaves and extra."""
    jstate, tstate = sasrec_state
    d = str(tmp_path)
    extra = {"arch": "sasrec"}
    if direction == "jax_to_port":
        jax_ckpt.save(d, 7, jstate, extra=extra)
        out, manifest = ckpt.restore(d, tstate)
        got, want = _np_tree(out), _jax_named(jstate)
    else:
        ckpt.save(d, 7, tstate, extra=extra)
        out, manifest = jax_ckpt.restore(d, jax.eval_shape(lambda: jstate))
        got, want = _jax_named(out), _np_tree(tstate)
    assert list(got) == list(want)
    assert "['opt'].mu['blocks'][0]['wq']" in got and "['opt'].step" in got
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert manifest["step"] == 7 and manifest["extra"] == extra
    assert manifest["leaves"] == {n: {"shape": list(a.shape), "dtype": str(a.dtype)}
                                  for n, a in want.items()}


def test_checkpoint_crash_leaves_no_partial(tmp_path):
    """A *.tmp directory (a crashed writer) is ignored by restore."""
    tree = {"a": torch.ones(2)}
    d = str(tmp_path)
    ckpt.save(d, 1, tree)
    os.makedirs(os.path.join(d, "step_00000002.tmp"))
    assert ckpt.latest_step(d) == 1
    out, _ = ckpt.restore(d, tree)
    assert float(out["a"][0]) == 1.0


def test_checkpoint_latest_pointer_ahead_of_commit(tmp_path):
    """LATEST pointing at a missing step directory counts as absent."""
    d = str(tmp_path)
    ckpt.save(d, 1, {"a": torch.ones(2)})
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("99")
    assert ckpt.latest_step(d) is None


# ---------------------------------------------------------------------- loop


def test_loop_resume_is_deterministic(tmp_path):
    """Run 10 steps; separately run 5, stop, and resume to 10 from the
    step-5 checkpoint: the same final state (tests/test_train.py's)."""
    params0 = {"w": torch.zeros(3)}

    def step(state, batch):
        g = {"w": torch.as_tensor(batch["tokens"][0, :3], dtype=torch.float32) * 1e-3}
        p, o = adamw_update(g, state["opt"], state["params"], lr=1e-2)
        return {"params": p, "opt": o}, {"loss": torch.sum(p["w"])}

    stream = SyntheticLMStream(vocab=100, batch=2, seq=8, seed=7)
    state0 = {"params": params0, "opt": adamw_init(params0)}
    full = loop.run(step, state0, stream, n_steps=10, ckpt_dir=str(tmp_path / "run1"),
                    ckpt_every=5, verbose=False)
    d2 = str(tmp_path / "run2")
    loop.run(step, state0, stream, n_steps=5, ckpt_dir=d2, ckpt_every=5, verbose=False)
    resumed = loop.run(step, state0, stream, n_steps=10, ckpt_dir=d2, ckpt_every=5,
                       verbose=False)
    assert len(resumed.history) == 5
    assert torch.equal(full.state["params"]["w"], resumed.state["params"]["w"])
    assert torch.equal(full.state["opt"].nu["w"], resumed.state["opt"].nu["w"])


def test_sasrec_loop_history_matches_jax(sasrec_state):
    """Three SASRec steps through loop.run on the same carried params and
    click stream: the loss history within rtol 1e-4 of JAX's."""
    jstate, _ = sasrec_state
    jcfg = dataclasses.replace(jax_sasrec.SASRecConfig(), n_items=500)
    tcfg = dataclasses.replace(sasrec.SASRecConfig(), n_items=500)
    params = jstate["params"]
    stream = SyntheticClickStream(500, 4, 50, seed=2)

    @jax.jit
    def jstep(state, batch):
        batch = jax.tree.map(jnp.asarray, batch)
        loss, g = jax.value_and_grad(jax_sasrec.sampled_softmax_loss)(state["params"], batch,
                                                                       jcfg)
        lr = jax_cosine(state["opt"].step, base_lr=1e-2, warmup=1, total=3)
        p, o = jax_adamw_update(g, state["opt"], state["params"], lr=lr)
        return {"params": p, "opt": o}, {"loss": loss}

    grad_fn = value_and_grad(sasrec.sampled_softmax_loss)

    def tstep(state, batch):
        loss, g = grad_fn(state["params"], {k: torch.as_tensor(v) for k, v in batch.items()},
                          tcfg)
        lr = cosine_schedule(state["opt"].step, base_lr=1e-2, warmup=1, total=3)
        p, o = adamw_update(g, state["opt"], state["params"], lr=lr)
        return {"params": p, "opt": o}, {"loss": loss}

    want = jax_loop.run(jstep, {"params": params, "opt": jax_adamw_init(params)}, stream,
                        n_steps=3, verbose=False).history
    tparams = _t(params)
    got = loop.run(tstep, {"params": tparams, "opt": adamw_init(tparams)}, stream, n_steps=3,
                   verbose=False).history
    np.testing.assert_allclose([h["loss"] for h in got], [h["loss"] for h in want], rtol=1e-4)


# ------------------------------------------------------------------ launcher


@pytest.mark.parametrize("arch_id", ["sasrec", "dien", "dlrm-rm2"])
def test_train_launcher_runs_on_cpu(arch_id, capsys):
    res = train_launcher.main(["--arch", arch_id, "--device", "cpu", "--steps", "3",
                               "--batch", "4"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"[train] {arch_id}: loss ")
    assert " over 3 steps; " in line and line.endswith(" straggler steps")
    assert len(res.history) == 3 and all(np.isfinite(h["loss"]) for h in res.history)


def test_train_launcher_mind_fails_in_both_packages(monkeypatch):
    """The click stream gives MIND's loss SASRec's pos [B, S]: a ValueError
    in the JAX launcher (its einsum) and in the port's (named)."""
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "mind", "--steps", "3", "--batch", "4"])
    with pytest.raises(ValueError, match="Einstein sum subscript 'bd'"):
        jax_train_launcher.main()
    with pytest.raises(ValueError, match=r"pos \[B\].*got pos \[4, 50\]"):
        train_launcher.main(["--arch", "mind", "--device", "cpu", "--steps", "3", "--batch", "4"])


def test_train_launcher_rejects_unported_families():
    """No family is left unported: the GNN id resolves (it trains:
    tests/test_torch_gnn.py), as every id of the registry does."""
    from repro_torch.configs import ARCH_IDS, PORTED_ARCH_IDS

    assert get_arch("meshgraphnet").family == "gnn"
    assert PORTED_ARCH_IDS == ARCH_IDS
    assert {get_arch(a).family for a in ARCH_IDS} == {"lm", "gnn", "recsys"}


# ------------------------------------------------------------------- example


def test_train_and_serve_example_matches_jax_math():
    """The example at a tiny size on JAX's initial values: the trained item
    table within rtol 1e-4 of the JAX example's step math (MF loss, AdamW at
    lr 3e-3 without decay) over the same stream; recall is reported only."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import train_and_serve_torch as example
    finally:
        sys.path.remove(str(ROOT / "examples"))
    n_users, n_items, dim, steps = 200, 1500, 32, 20
    ku, kv = jax.random.split(jax.random.PRNGKey(0))
    params = {"user": jax.random.normal(ku, (n_users, dim)) * 0.1,
              "item": jax.random.normal(kv, (n_items, dim)) * 0.1}

    def mf_loss(p, batch):
        pred = jnp.sum(p["user"][batch["users"]] * p["item"][batch["items"]], axis=-1)
        return jnp.mean((pred - batch["ratings"]) ** 2)

    @jax.jit
    def jstep(state, batch):
        batch = jax.tree.map(jnp.asarray, batch)
        loss, g = jax.value_and_grad(mf_loss)(state["params"], batch)
        p, o = jax_adamw_update(g, state["opt"], state["params"], lr=3e-3, weight_decay=0.0)
        return {"params": p, "opt": o}, {"loss": loss}

    rng = np.random.default_rng(0)
    u_true, v_true = example.make_interactions(n_users, n_items, dim, rng)
    stream = example.InteractionStream(u_true, v_true, batch=example.BATCH)
    want = jax_loop.run(jstep, {"params": params, "opt": jax_adamw_init(params)}, stream,
                        n_steps=steps, verbose=False)
    got = example.train(n_users, n_items, dim, steps, device="cpu", params=_t(params),
                        verbose=False)
    np.testing.assert_allclose(got.state["params"]["item"].numpy(),
                               np.asarray(want.state["params"]["item"]), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose([h["loss"] for h in got.history],
                               [h["loss"] for h in want.history], rtol=1e-4)
