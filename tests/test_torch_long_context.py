"""The port's long-context llama (``grit_tpu_torch/models/long_context.py``)
against the JAX package's: the same numpy inputs and converted weights,
the port on four gloo CPU ranks (and two-rank groups), every rank holding
its shard of the sequence. Logits of both schemes against JAX's
``forward_sp`` at 2e-4; the loss (global token mean, masked and not)
against the dense JAX loss at 1e-5 relative and every parameter gradient
at 5e-4, with remat off and on, the same on every rank (as
``tests/test_long_context.py``); ten training steps of the unchanged
Trainer on four ranks lower the loss and leave the same state on every
rank; rank 0's snapshot restores into a dense Trainer byte for byte, and
a dense Trainer's snapshot restores into the sequence-parallel one."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from grit_tpu.models import llama as jllama
from grit_tpu.models import long_context as jlong
from grit_tpu_torch import convert
from grit_tpu_torch.models import llama
from grit_tpu_torch.parallel.launch import run_ranks
from grit_tpu_torch.train import optim
from grit_tpu_torch.train.trainer import Trainer, TrainerConfig
from grit_tpu_torch.tree import flatten_with_names
from tests import torch_ranks

# f32 end to end, kv heads 4 so Ulysses shards them on four ranks.
JCFG = dataclasses.replace(
    jllama.LlamaConfig.tiny(n_kv_heads=4, max_seq_len=256), dtype=jnp.float32)
PCFG = dataclasses.replace(
    llama.LlamaConfig.tiny(n_kv_heads=4, max_seq_len=256), dtype=torch.float32)
LOGIT_TOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 5e-4
IMPLS = ("ring", "ulysses")


def toks(batch=2, seq=64, seed=1):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size,
                                                (batch, seq), dtype=np.int32)


def seq_mesh(n: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:n]), (jlong.SEQ_AXIS,))


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, jllama.init_params(JCFG, jax.random.key(0)))


def _dense_trainer(params_np):
    return Trainer(
        loss_fn=lambda p, b: llama.loss_fn(PCFG, p, b[0], b[1]),
        init_params=lambda gen, device: convert.params_from_jax(params_np,
                                                                device),
        batch_fn=lambda gen: None, cfg=TrainerConfig(seed=0), device="cpu",
        optimizer=optim.sgd(0.05))


@pytest.fixture(scope="module")
def case(jparams, tmp_path_factory):
    """Inputs, and one launch of four ranks over all of them."""
    tmp = tmp_path_factory.mktemp("long-context")
    train_params = jax.tree.map(np.asarray,
                                jllama.init_params(JCFG, jax.random.key(3)))
    dense_dir = str(tmp / "dense")
    _dense_trainer(train_params).snapshot(dense_dir)
    inp = {"params": jparams, "tokens": toks(), "inp": toks(seq=32),
           "tgt": toks(seq=32, seed=2),
           "mask": np.random.default_rng(4).random((2, 32)) > 0.3,
           "train_params": train_params, "train_inp": toks(seq=32, seed=4),
           "train_tgt": toks(seq=32, seed=5), "snap_dir": str(tmp / "sp"),
           "dense_dir": dense_dir}
    return inp, run_ranks(torch_ranks.long_context_cases, 4, inp,
                          backend="gloo")


AXES = [("world", (0, 1, 2, 3)), ("pair", (0, 1)), ("pair", (2, 3))]


def test_ranks_import_nothing_of_jax(case):
    assert all(r["foreign"] == [] for r in case[1])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("axis,members", AXES)
def test_logits_match_jax_forward_sp(case, jparams, impl, axis, members):
    inp, ranks = case
    got = np.concatenate([ranks[r][axis]["logits"][impl] for r in members],
                         axis=1)
    want = jlong.forward_sp(JCFG, jparams, inp["tokens"],
                            mesh=seq_mesh(len(members)), attn_impl=impl)
    np.testing.assert_allclose(got, np.asarray(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jllama.forward(JCFG, jparams, inp["tokens"])),
        rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.fixture(scope="module")
def dense_grads(case, jparams):
    inp = case[0]
    mask = jnp.asarray(inp["mask"])
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jllama.loss_fn(
        JCFG, p, inp["inp"], inp["tgt"], mask)))(jparams)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(grads)[0]]
    return float(loss), dict(zip(names, (np.asarray(g)
                                         for g in jax.tree.leaves(grads))))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("axis,members", AXES)
def test_loss_and_gradients_match_dense(case, dense_grads, impl, remat, axis,
                                        members):
    """The masked global token mean and every parameter gradient equal
    the dense model's on every rank of the group: summed over the ranks'
    positions once, never N-fold."""
    want_loss, want = dense_grads
    key = f"{impl}-remat={remat}"
    first = case[1][members[0]][axis]["grads"][key]
    for r in members:
        loss, grads = case[1][r][axis]["grads"][key]
        assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
        assert set(grads) == set(want)
        for name, g in grads.items():
            np.testing.assert_allclose(g, want[name], rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=name)
            np.testing.assert_array_equal(g, first[1][name], err_msg=name)


def test_training_lowers_the_loss_with_identical_state_on_every_rank(case):
    train = [r["train"] for r in case[1]]
    losses = train[0]["losses"]
    assert losses[-1] < losses[0], losses
    for t in train[1:]:
        assert t["losses"] == losses
        assert t["state"].keys() == train[0]["state"].keys()
        for name, a in t["state"].items():
            np.testing.assert_array_equal(a, train[0]["state"][name],
                                          err_msg=name)


def test_rank0_snapshot_restores_into_a_dense_trainer(case):
    inp, ranks = case
    dense = _dense_trainer(inp["train_params"])
    assert dense.restore(inp["snap_dir"]) == 10
    want = ranks[0]["train"]["state"]
    got = dict(flatten_with_names(dense.state))
    assert got.keys() == want.keys()
    for name, t in got.items():
        np.testing.assert_array_equal(convert.tensor_to_numpy(t), want[name],
                                      err_msg=name)
    # The dense trainer steps on from the sequence-parallel state.
    dense.batch_fn = lambda gen: (torch.from_numpy(inp["train_inp"]),
                                  torch.from_numpy(inp["train_tgt"]).long())
    assert np.isfinite(dense.run(1)[0])


def test_dense_snapshot_restores_into_the_sequence_parallel_trainer(case):
    inp, ranks = case
    dense = _dense_trainer(inp["train_params"])
    dense.restore(inp["dense_dir"])
    with torch.no_grad():
        want = llama.forward(PCFG, dense.state["params"],
                             torch.from_numpy(inp["tokens"])).numpy()
    assert all(r["train"]["restored_step"] == 0 for r in ranks)
    got = np.concatenate([r["train"]["restored_logits"] for r in ranks], axis=1)
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
