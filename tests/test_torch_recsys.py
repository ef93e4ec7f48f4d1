"""The port's recsys towers and their cells against the JAX package's, on
the CPU: the same seeded inputs, JAX's initial values carried across
(``convert.params_from_arrays``).  Each JAX reference is jitted once a
module (module-scoped fixtures)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch.mesh import make_mesh_compat
from repro.models.recsys import dien as jax_dien
from repro.models.recsys import dlrm as jax_dlrm
from repro.models.recsys import embedding as jax_emb
from repro.models.recsys import mind as jax_mind
from repro.models.recsys import sasrec as jax_sasrec
from repro_torch.configs import PORTED_ARCH_IDS, all_cells, get_arch
from repro_torch.configs.common import RECSYS_SHAPES, interest_topk
from repro_torch.convert import adamw_from_arrays, params_from_arrays
from repro_torch.models.recsys import dien, dlrm, embedding, mind, sasrec
from repro_torch.testing import assert_topk_match
from repro_torch.train import value_and_grad
from repro_torch.train.tree import named_leaves
from test_torch_build import one_torch_thread  # noqa: F401 -- an autouse fixture

TOWER_ROWS = 500     # tests/test_arch_smoke.py's reduced tables
CELL_ROWS = 2_000
BATCH = 4
CELL_CANDIDATES = 3_000  # DLRM's retrieval rows at the reduced config

# the recsys ids of the registry (the LM family's are tests/test_torch_lm.py's)
RECSYS_IDS = [a for a in PORTED_ARCH_IDS if get_arch(a).family == "recsys"]
TOWERS = {  # arch id: (JAX module, port module, loss name)
    "sasrec": (jax_sasrec, sasrec, "sampled_softmax_loss"),
    "mind": (jax_mind, mind, "sampled_softmax_loss"),
    "dien": (jax_dien, dien, "bce_loss"),
    "dlrm-rm2": (jax_dlrm, dlrm, "bce_loss"),
}


def _cfgs(arch_id, rows):
    """(JAX config, port config) of the arch's published widths at ``rows``."""
    field = "n_rows" if arch_id == "dlrm-rm2" else "n_items"
    jcfg = dataclasses.replace(jax_get_arch(arch_id).cfg, **{field: rows})
    tcfg = dataclasses.replace(get_arch(arch_id).cfg, **{field: rows})
    return jcfg, tcfg


def _batch(arch_id, cfg, rows, rng, b=BATCH):
    """A seeded numpy batch for the arch's loss (tests/test_arch_smoke.py's)."""
    if arch_id == "dlrm-rm2":
        return dict(dense=rng.normal(size=(b, cfg.n_dense)).astype(np.float32),
                    sparse=rng.integers(0, rows, (b, cfg.n_sparse)).astype(np.int32),
                    labels=rng.integers(0, 2, b).astype(np.float32))
    s = cfg.seq_len
    out = dict(hist=rng.integers(-1, rows, (b, s)).astype(np.int32))
    if arch_id == "sasrec":
        out.update(pos=rng.integers(0, rows, (b, s)).astype(np.int32),
                   neg=rng.integers(0, rows, (b, s, 4)).astype(np.int32))
    elif arch_id == "mind":
        out.update(pos=rng.integers(0, rows, b).astype(np.int32),
                   neg=rng.integers(0, rows, (b, 20)).astype(np.int32))
    else:
        out.update(target=rng.integers(0, rows, b).astype(np.int32),
                   labels=rng.integers(0, 2, b).astype(np.float32),
                   aux_neg=rng.integers(0, rows, (b, s)).astype(np.int32))
    return out


def _t(tree):
    return params_from_arrays(jax.tree.map(np.asarray, tree), device="cpu")


def _assert_tree_close(got, want_jax, rtol, atol, what):
    want = dict(named_leaves(_t(want_jax)))
    names = [n for n, _ in named_leaves(got)]
    assert names == list(want), f"{what}: leaf names differ"
    for name, leaf in named_leaves(got):
        np.testing.assert_allclose(leaf.detach().numpy(), want[name].numpy(), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {name}")


def _jax_tower(jmod, loss_name, jcfg):
    """One jitted JAX function of an arch: loss, gradients, and its
    retrieval scores (DLRM: logits; DIEN: also its forward; MIND: also its
    interests)."""
    loss_fn = getattr(jmod, loss_name)

    def run(params, batch):
        loss, grads = jax.value_and_grad(lambda p: loss_fn(p, batch, jcfg))(params)
        extra = {}
        if jmod is jax_dlrm:
            extra["scores"] = jax_dlrm.forward(params, batch, jcfg)
        else:
            extra["scores"] = jmod.retrieval_scores(params, batch["hist"][:2], jcfg)
        if jmod is jax_dien:
            extra["forward"] = jax_dien.forward(params, batch, jcfg)
        if jmod is jax_mind:
            extra["interests"] = jax_mind.interest_capsules(params, batch["hist"], jcfg)
        return loss, grads, extra

    return jax.jit(run)


@pytest.fixture(scope="module")
def towers():
    """Per arch: JAX's params, a batch, and its jitted tower's outputs."""
    out = {}
    for aid, (jmod, _, loss_name) in TOWERS.items():
        jcfg, tcfg = _cfgs(aid, TOWER_ROWS)
        params, _ = jmod.init(jax.random.PRNGKey(0), jcfg)
        batch = _batch(aid, jcfg, TOWER_ROWS, np.random.default_rng(0))
        fn = _jax_tower(jmod, loss_name, jcfg)
        loss, grads, extra = fn(params, jax.tree.map(jnp.asarray, batch))
        out[aid] = dict(params=params, batch=batch, loss=float(loss), grads=grads, extra=extra,
                        jcfg=jcfg, tcfg=tcfg, fn=fn)
    return out


@pytest.mark.parametrize("arch_id", list(TOWERS))
def test_tower_loss_grads_and_retrieval_match_jax(arch_id, towers):
    ref = towers[arch_id]
    jmod, tmod, loss_name = TOWERS[arch_id]
    params = _t(ref["params"])
    batch = {k: torch.as_tensor(v) for k, v in ref["batch"].items()}
    loss, grads = value_and_grad(getattr(tmod, loss_name))(params, batch, ref["tcfg"])
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5, atol=1e-6)
    _assert_tree_close(grads, ref["grads"], 1e-4, 1e-6, f"{arch_id} grad")
    if arch_id == "dlrm-rm2":
        got = dlrm.forward(params, batch, ref["tcfg"])
    else:
        got = tmod.retrieval_scores(params, batch["hist"][:2], ref["tcfg"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref["extra"]["scores"]), rtol=1e-5,
                               atol=1e-6)


def test_mind_interests_and_dien_states_match_jax(towers):
    ref = towers["mind"]
    got = mind.interest_capsules(_t(ref["params"]), torch.as_tensor(ref["batch"]["hist"]),
                                 ref["tcfg"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref["extra"]["interests"]), rtol=1e-5,
                               atol=1e-6)
    assert float(torch.linalg.vector_norm(got, dim=-1).max()) <= 1.0 + 1e-5  # squash
    ref = towers["dien"]
    logit, states = dien.forward(_t(ref["params"]),
                                 {k: torch.as_tensor(ref["batch"][k]) for k in ("hist", "target")},
                                 ref["tcfg"])
    jlogit, jstates = ref["extra"]["forward"]
    np.testing.assert_allclose(states.numpy(), np.asarray(jstates), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(logit.numpy(), np.asarray(jlogit), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bags_match_jax(mode):
    rng = np.random.default_rng(3)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    ids = rng.integers(-1, 50, (3, 5, 7)).astype(np.int32)
    np.testing.assert_allclose(
        embedding.embedding_bag(torch.as_tensor(table), torch.as_tensor(ids), mode).numpy(),
        np.asarray(jax_emb.embedding_bag(jnp.asarray(table), jnp.asarray(ids), mode)),
        rtol=1e-6, atol=1e-6)
    flat = rng.integers(-1, 50, 30).astype(np.int32)
    offsets = np.array([0, 4, 4, 11, 25], np.int32)  # an empty bag; 5 ids past the last
    np.testing.assert_allclose(
        embedding.embedding_bag_ragged(torch.as_tensor(table), torch.as_tensor(flat),
                                       torch.as_tensor(offsets), mode).numpy(),
        np.asarray(jax_emb.embedding_bag_ragged(jnp.asarray(table), jnp.asarray(flat),
                                                jnp.asarray(offsets), mode)),
        rtol=1e-6, atol=1e-6)
    tables = rng.normal(size=(3, 20, 4)).astype(np.float32)
    fids = rng.integers(-1, 20, (6, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        embedding.multi_table_lookup(torch.as_tensor(tables), torch.as_tensor(fids)).numpy(),
        np.asarray(jax_emb.multi_table_lookup(jnp.asarray(tables), jnp.asarray(fids))))


def test_sasrec_leading_padding_gives_finite_gradients(towers):
    """Rows whose first positions are -1 attend to no key there: zeros
    forward and a NaN-free gradient, in both packages."""
    ref = towers["sasrec"]
    batch = dict(ref["batch"])
    hist = batch["hist"].copy()
    hist[:, :7] = -1
    hist[0] = -1  # a row with no valid position at all
    batch["hist"] = hist
    _, jgrads, _ = ref["fn"](ref["params"], jax.tree.map(jnp.asarray, batch))
    assert all(np.isfinite(np.asarray(g)).all() for g in jax.tree.leaves(jgrads))
    _, grads = value_and_grad(sasrec.sampled_softmax_loss)(
        _t(ref["params"]), {k: torch.as_tensor(v) for k, v in batch.items()}, ref["tcfg"])
    for name, g in named_leaves(grads):
        assert torch.isfinite(g).all(), name
    _assert_tree_close(grads, jgrads, 1e-4, 1e-6, "sasrec padded grad")


# ---------------------------------------------------------------- the cells


def _cell_inputs(arch_id, shape, jcfg, rng):
    """Numpy inputs of a cell's step at BATCH rows (DLRM's retrieval:
    CELL_CANDIDATES candidate rows)."""
    kind = RECSYS_SHAPES[shape]["kind"]
    if kind == "train":
        return _batch(arch_id, jcfg, CELL_ROWS, rng)
    if arch_id == "dlrm-rm2":
        b = CELL_CANDIDATES if kind == "retrieval" else BATCH
        return dict(dense=rng.normal(size=(b, jcfg.n_dense)).astype(np.float32),
                    sparse=rng.integers(0, CELL_ROWS, (b, jcfg.n_sparse)).astype(np.int32))
    hist = rng.integers(-1, CELL_ROWS, (BATCH, jcfg.seq_len)).astype(np.int32)
    if kind == "retrieval":
        return hist
    if arch_id == "dien":
        return dict(hist=hist, target=rng.integers(0, CELL_ROWS, BATCH).astype(np.int32))
    return dict(hist=hist, cand=rng.integers(-1, CELL_ROWS, (BATCH, 50)).astype(np.int32))


@pytest.fixture(scope="module")
def cells():
    """Per (arch, shape): JAX's params, inputs and its jitted step's output."""
    mesh = make_mesh_compat((1,), ("data",))
    out = {}
    for aid in RECSYS_IDS:
        jcfg, tcfg = _cfgs(aid, CELL_ROWS)
        jarch = dataclasses.replace(jax_get_arch(aid), cfg=jcfg)
        params, _ = jarch.mod.init(jax.random.PRNGKey(1), jcfg)
        rng = np.random.default_rng(1)
        for shape in ("train_batch", "serve_p99", "retrieval_cand"):
            cell = jarch.build_cell(shape, mesh)
            inputs = _cell_inputs(aid, shape, jcfg, rng)
            jin = jax.tree.map(jnp.asarray, inputs)
            if shape == "train_batch":
                from repro.train import adamw_init
                res = jax.jit(cell.step_fn)(params, adamw_init(params), jin)
            else:
                res = jax.jit(cell.step_fn)(params, jin)
            out[aid, shape] = dict(params=params, inputs=inputs, out=res, tcfg=tcfg)
    return out


@pytest.mark.parametrize("arch_id,shape", [(a, s) for a, s in all_cells()
                                           if a in RECSYS_IDS and s != "serve_bulk"])
def test_cell_steps_match_jax(arch_id, shape, cells):
    """serve_bulk is serve_p99's step at another batch."""
    ref = cells[arch_id, shape]
    arch = dataclasses.replace(get_arch(arch_id), cfg=ref["tcfg"])
    cell = arch.build_cell(shape, device="cpu")
    assert cell.name == f"{arch_id}/{shape}"
    assert all(t.device.type == "meta" for _, t in named_leaves(cell.args))
    params = _t(ref["params"])
    inputs = jax.tree.map(torch.as_tensor, ref["inputs"])
    if shape == "train_batch":
        opt = adamw_from_arrays(0, jax.tree.map(np.zeros_like, ref["params"]),
                                jax.tree.map(np.zeros_like, ref["params"]), device="cpu")
        new_p, new_o, loss = cell.step_fn(params, opt, inputs)
        jp, jo, jloss = ref["out"]
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-6)
        assert int(new_o.step) == int(jo.step) == 1
        # an Adam step moves each weight by about lr: hold the moments and the params
        _assert_tree_close(new_o.mu, jo.mu, 1e-4, 1e-7, "mu")
        _assert_tree_close(new_o.nu, jo.nu, 1e-4, 1e-12, "nu")
        _assert_tree_close(new_p, jp, 1e-5, 1e-6, "params")
    elif shape == "serve_p99":
        got = cell.step_fn(params, inputs)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref["out"]), rtol=1e-5, atol=1e-6)
    else:
        got = cell.step_fn(params, inputs)
        want = jax.tree.map(np.asarray, ref["out"])
        if arch_id == "dlrm-rm2":
            assert_topk_match(got["ids"].numpy()[None], got["scores"].numpy()[None],
                              want["ids"][None], want["scores"][None])
        else:
            assert_topk_match(got["ids"].numpy(), got["scores"].numpy(), want["ids"],
                              want["scores"])


def test_cell_steps_stay_on_their_device():
    arch = dataclasses.replace(get_arch("sasrec"), cfg=_cfgs("sasrec", 100)[1])
    cell = arch.build_cell("serve_p99", device="meta")
    params = arch.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="runs on meta"):
        cell.step_fn(params, {"hist": torch.zeros((2, 50), dtype=torch.int32),
                              "cand": torch.zeros((2, 5), dtype=torch.int32)})


def test_mind_interest_topk_is_jax_top_k_of_the_max_on_integer_values():
    """Every score exact (integer interests and items, heavy ties): the
    merged per-interest top 100 equals lax.top_k of the max over interests,
    ids and scores, bit for bit."""
    rng = np.random.default_rng(5)
    interests = rng.integers(-3, 4, (3, 4, 16)).astype(np.float32)
    items = rng.integers(-3, 4, (2_000, 16)).astype(np.float32)
    vals, ids = interest_topk(torch.as_tensor(interests), torch.as_tensor(items), 100)
    sc = jnp.max(jnp.einsum("bkd,nd->bkn", interests, items), axis=1)
    jvals, jids = jax.lax.top_k(sc, 100)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_registry_covers_every_arch_id():
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro_torch.configs import ARCH_IDS

    assert ARCH_IDS == JAX_ARCH_IDS
    assert sorted(PORTED_ARCH_IDS) == ["dien", "dlrm-rm2", "gemma3-12b", "granite-3-2b",
                                       "grok-1-314b", "internlm2-20b", "mind",
                                       "qwen3-moe-235b-a22b", "sasrec"]
    assert len(all_cells()) == 16 + 5 * 3 + 1  # recsys 4 x 4; LM 5 x 3 and gemma's long_500k
    for aid in set(ARCH_IDS) - set(PORTED_ARCH_IDS):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            get_arch(aid)
