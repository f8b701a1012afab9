"""The port's optimizer seam against optax 0.2.6: Adam (``mu_dtype`` None
and bf16, f32 and bf16 params), ``sgd``, ``set_to_zero`` and the
frozen-trunk ``multi_transform`` on the same numpy gradients; the state's
leaf names against ``jax.tree_util.keystr`` of optax's state; the planted
``-0.0`` frozen leaf against the JAX Trainer's jitted step; and the
frozen trunk's gradients never requested."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from grit_tpu.train import Trainer as JaxTrainer
from grit_tpu_torch import convert
from grit_tpu_torch.models import llama
from grit_tpu_torch.train import optim
from grit_tpu_torch.train.trainer import Trainer
from grit_tpu_torch.tree import flatten_with_names
from grit_tpu_torch.workload import llama_trainer

SHAPES = {"final_norm": (8,), "lm_head": (8, 12),
          "layers": {"attn": {"wq": (2, 8, 8)}, "mlp_norm": (2, 8)},
          "tok_emb": (12, 8)}


def _jax_labels(params):
    """``bench.py``'s labels (``bench.py:670-675``)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, _: "train" if jax.tree_util.keystr(path).startswith(
            ("['final_norm']", "['lm_head']")) else "freeze", params)


def _jnp_dtype(dtype):
    return {None: None, torch.float32: jnp.float32,
            torch.bfloat16: jnp.bfloat16}[dtype]


def _numpy_tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)

    def build(spec):
        if isinstance(spec, dict):
            return {k: build(v) for k, v in spec.items()}
        return rng.standard_normal(spec).astype(dtype)

    return build(SHAPES)


def _pair(kind, torch_dtype=None):
    """The same transform in both packages."""
    jd = _jnp_dtype(torch_dtype)
    if kind == "adam":
        return optax.adam(1e-2, mu_dtype=jd), optim.adam(1e-2, mu_dtype=torch_dtype)
    if kind == "sgd":
        return optax.sgd(0.5), optim.sgd(0.5)
    if kind == "set_to_zero":
        return optax.set_to_zero(), optim.set_to_zero()
    if kind == "frozen-trunk":
        return (optax.multi_transform({"train": optax.sgd(0.5),
                                       "freeze": optax.set_to_zero()},
                                      _jax_labels),
                optim.frozen_trunk(0.5))
    if kind == "adam on the trainable slice":
        return (optax.multi_transform({"train": optax.adam(1e-2),
                                       "freeze": optax.set_to_zero()},
                                      _jax_labels),
                optim.multi_transform({"train": optim.adam(1e-2),
                                       "freeze": optim.set_to_zero()},
                                      optim.frozen_trunk_label))
    raise ValueError(kind)


def _to_jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _to_port(tree, dtype):
    return convert.params_from_jax(jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, _jnp_dtype(dtype))), tree))


def _assert_trees(got, want, *, exact, rtol=0.0, what=""):
    """``got`` (port) against ``want`` (JAX): same leaf names, dtypes and
    shapes; bytes equal when ``exact``, else within ``rtol`` of the
    leaf's max."""
    jflat = jax.tree_util.tree_flatten_with_path(want)[0]
    pflat = flatten_with_names(got)
    assert [n for n, _ in pflat] == [jax.tree_util.keystr(p) for p, _ in jflat]
    for (name, t), (_, a) in zip(pflat, jflat):
        a = np.asarray(a)
        assert str(t.dtype).removeprefix("torch.") == str(a.dtype), name
        assert tuple(t.shape) == a.shape, name
        b = convert.tensor_to_numpy(t)
        a32 = a.astype(np.float32) if a.dtype.name == "bfloat16" else a
        if exact:
            assert np.array_equal(b.reshape(-1).view(np.uint8),
                                  np.ascontiguousarray(a32).reshape(-1).view(
                                      np.uint8)), f"{what}{name}"
        else:
            scale = max(float(np.max(np.abs(a32))), 1e-30)
            np.testing.assert_allclose(b, a32, rtol=0, atol=rtol * scale,
                                       err_msg=f"{what}{name}")


# Adam's bias corrections go through pow in each package: f32 leaves agree
# to 1e-6 of the leaf's max; bf16 leaves, where each package rounds every
# operation (the constants too) to bf16, bit for bit.
F32_RTOL = 1e-6


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mu_dtype", [None, torch.bfloat16],
                         ids=["mu-param", "mu-bf16"])
def test_adam_matches_optax_over_three_steps(param_dtype, mu_dtype):
    """The in-place ``apply_`` against optax's ``update`` +
    ``apply_updates``: params and state (count int32, mu in ``mu_dtype``,
    nu in the param dtype) after each of three steps; bf16 params bit for
    bit."""
    jd = _jnp_dtype(param_dtype)
    jtx, ptx = _pair("adam", mu_dtype)
    jparams = _to_jax(_numpy_tree(0), jd)
    jstate = jtx.init(jparams)
    pparams = _to_port(_numpy_tree(0), param_dtype)
    pstate = ptx.init(pparams)
    check = dict(exact=param_dtype == torch.bfloat16, rtol=F32_RTOL)
    for step in range(3):
        g = _numpy_tree(10 + step)
        jupd, jstate = jtx.update(_to_jax(g, jd), jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
        pstate = ptx.apply_(pparams, _to_port(g, param_dtype), pstate)
        _assert_trees(pparams, jparams, **check)
        _assert_trees(pstate, jstate, **check)
        assert pstate[0].count.dtype == torch.int32
        assert int(pstate[0].count) == int(jstate[0].count) == step + 1
    want_mu = mu_dtype or param_dtype
    assert all(t.dtype == want_mu for _, t in flatten_with_names(pstate[0].mu))
    assert all(t.dtype == param_dtype
               for _, t in flatten_with_names(pstate[0].nu))


@pytest.mark.parametrize("kind", ["sgd", "set_to_zero", "frozen-trunk"])
def test_sgd_zero_and_frozen_trunk_updates_are_optax_bitwise(kind):
    """f32 params: ``apply_`` in place leaves the bytes of optax's
    ``update`` + ``apply_updates`` over two steps (no ``-0.0`` in play
    here), and the frozen leaves their starting bytes."""
    jtx, ptx = _pair(kind)
    jparams = _to_jax(_numpy_tree(1), jnp.float32)
    jstate = jtx.init(jparams)
    pparams = _to_port(_numpy_tree(1), torch.float32)
    pstate = ptx.init(pparams)
    for step in range(2):
        g = _numpy_tree(20 + step)
        jupd, jstate = jtx.update(_to_jax(g, jnp.float32), jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
        pstate = ptx.apply_(pparams, _to_port(g, torch.float32), pstate)
        _assert_trees(pparams, jparams, exact=True)
        _assert_trees(pstate, jstate, exact=True)
    if kind != "sgd":
        frozen = [n for n, _ in flatten_with_names(pparams)
                  if kind == "set_to_zero"
                  or optim.frozen_trunk_label(n) == "freeze"]
        start = dict(flatten_with_names(_to_port(_numpy_tree(1), torch.float32)))
        for name, t in flatten_with_names(pparams):
            if name in frozen:
                assert torch.equal(t, start[name]), name


@pytest.mark.parametrize("kind", [
    "adam", "adam-mu-bf16", "sgd", "set_to_zero", "frozen-trunk",
    "adam on the trainable slice"])
def test_state_leaf_names_are_optax_keystr(kind):
    """The state flattens to optax's leaves: the same ``keystr`` names in
    the same order, dtypes and shapes (so the two packages' snapshots of
    it cross-restore). The frozen-trunk state has no array leaf."""
    mu = torch.bfloat16 if kind == "adam-mu-bf16" else None
    jtx, ptx = _pair(kind.removesuffix("-mu-bf16"), mu)
    jstate = jtx.init(_to_jax(_numpy_tree(2), jnp.float32))
    pstate = ptx.init(_to_port(_numpy_tree(2), torch.float32))
    jflat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    pflat = flatten_with_names(pstate)
    assert [n for n, _ in pflat] == [jax.tree_util.keystr(p) for p, _ in jflat]
    for (name, t), (_, a) in zip(pflat, jflat):
        assert str(t.dtype).removeprefix("torch.") == str(np.asarray(a).dtype)
        assert tuple(t.shape) == np.shape(a), name
    if kind in ("sgd", "set_to_zero", "frozen-trunk"):
        assert pflat == [] and jflat == []
    assert type(pstate).__name__ == type(jstate).__name__


def test_unknown_label_raises():
    tx = optim.multi_transform({"train": optim.sgd(0.1)},
                               optim.frozen_trunk_label)
    with pytest.raises(ValueError, match="freeze"):
        tx.init(_to_port(_numpy_tree(3), torch.float32))


def test_frozen_trunk_reads_only_the_trainable_gradients():
    reads = optim.frozen_trunk().reads_grad(_to_port(_numpy_tree(3),
                                                     torch.float32))
    assert {n for n, r in reads.items() if r} == {"['final_norm']",
                                                  "['lm_head']"}
    assert len(reads) == 5


# -- against the JAX Trainer's jitted step ---------------------------------------------


def _planted_init():
    """A frozen trunk holding ``-0.0`` beside ordinary values, f32 and
    bf16, and a trainable head."""
    w = np.array([-0.0, 1.0, -2.0, 0.0, -0.0, 0.5, 3.0, -0.25], np.float32)
    rng = np.random.default_rng(4)
    return {"final_norm": np.ones(8, np.float32),
            "lm_head": rng.standard_normal((8, 4)).astype(np.float32),
            "trunk": w, "trunk_bf16": w}


def _jax_planted_loss(p, x):
    h = (p["trunk"] + p["trunk_bf16"].astype(jnp.float32)) * x
    return jnp.sum(jnp.tanh((h * p["final_norm"]) @ p["lm_head"]))


def _port_planted_loss(p, x):
    h = (p["trunk"] + p["trunk_bf16"].float()) * x
    return torch.tanh((h * p["final_norm"]) @ p["lm_head"]).sum()


def test_planted_negative_zero_frozen_leaf_keeps_the_jitted_steps_bytes():
    """The JAX Trainer's jitted step folds ``p + 0`` to ``p``: a frozen
    ``-0.0`` stays ``-0.0`` (eager ``optax.apply_updates`` would write
    ``+0.0``). The port's step leaves the frozen leaves' bytes as the
    jitted step does, and trains the head as it does."""
    init = _planted_init()
    x = np.linspace(-1.0, 1.0, 8).astype(np.float32)

    def jinit(_key):
        p = jax.tree.map(jnp.asarray, init)
        return {**p, "trunk_bf16": p["trunk_bf16"].astype(jnp.bfloat16)}

    jt = JaxTrainer(
        loss_fn=_jax_planted_loss, init_params=jinit,
        batch_fn=lambda rng: jnp.asarray(x),
        optimizer=optax.multi_transform(
            {"train": optax.sgd(0.5), "freeze": optax.set_to_zero()},
            _jax_labels))
    jt.run(2)
    jparams = jax.tree.map(np.asarray, jt.state["params"])

    def pinit(_gen, dev):
        p = convert.params_from_jax(init, dev)
        return {**p, "trunk_bf16": p["trunk_bf16"].to(torch.bfloat16)}

    pt = Trainer(loss_fn=_port_planted_loss, init_params=pinit,
                 batch_fn=lambda gen: torch.from_numpy(x),
                 optimizer=optim.frozen_trunk(0.5), device="cpu")
    pt.run(2)
    pparams = pt.state["params"]
    for name in ("trunk", "trunk_bf16"):
        got = convert.tensor_to_numpy(pparams[name])
        want = np.asarray(jparams[name]).astype(np.float32)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), name
        assert np.signbit(got[0]) and np.signbit(got[4]), name
    eager = optax.apply_updates({"w": jnp.asarray(init["trunk"])},
                                {"w": jnp.zeros(8, jnp.float32)})["w"]
    assert not np.signbit(np.asarray(eager)[0])  # what the jit avoids
    for name in ("final_norm", "lm_head"):
        np.testing.assert_allclose(pparams[name].detach().numpy(), jparams[name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        assert not np.array_equal(pparams[name].detach().numpy(), init[name])


def test_frozen_trunk_step_requests_no_trunk_gradient(monkeypatch):
    """A frozen-trunk llama step asks autograd for ``final_norm`` and
    ``lm_head`` only; the trunk runs without autograd state and keeps its
    bytes, the head moves."""
    cfg = llama.LlamaConfig.tiny(dim=256, n_heads=2, n_kv_heads=2,
                                 param_dtype=torch.float32,
                                 dtype=torch.float32)
    tr = llama_trainer(cfg, batch=2, seq=64, optimizer=optim.frozen_trunk(0.5),
                       device="cpu")
    before = {n: t.clone() for n, t in flatten_with_names(tr.state["params"])}
    by_id = {id(t): n for n, t in flatten_with_names(tr.state["params"])}
    asked: list[list[str]] = []
    grad = torch.autograd.grad

    def spy(outputs, inputs, *args, **kwargs):
        asked.append([by_id[id(t)] for t in inputs])
        return grad(outputs, inputs, *args, **kwargs)

    monkeypatch.setattr(torch.autograd, "grad", spy)
    losses = tr.run(2)
    assert all(np.isfinite(losses))
    assert asked == [["['final_norm']", "['lm_head']"]] * 2
    for name, t in flatten_with_names(tr.state["params"]):
        trainable = name in ("['final_norm']", "['lm_head']")
        assert t.requires_grad is trainable, name
        assert torch.equal(t, before[name]) is not trainable, name
    assert flatten_with_names(tr.state["opt_state"]) == []
