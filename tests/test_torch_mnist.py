"""The port's MNIST MLP against ``grit_tpu.models.mnist``: forward and loss
on the same numpy params and inputs (f32, 1e-5 relative), the parameter
tree's names, shapes and dtypes, the synthetic batch's structure, and the
harness workload's twin (``--model mnist``): a bit-identical resume and
snapshots that cross-restore with the JAX harness trainer's."""

from __future__ import annotations

import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu.device import snapshot as jsnap
from grit_tpu.models import mnist as jmnist
from grit_tpu.train import Trainer as JaxTrainer
from grit_tpu_torch import convert
from grit_tpu_torch.device import snapshot as psnap
from grit_tpu_torch.models import mnist
from grit_tpu_torch.tree import flatten_with_names
from grit_tpu_torch.workload import MNIST, MNIST_BATCH, mnist_trainer
from tests.test_torch_agentlet import REPO

CONFIGS = {"harness": (16, 2), "default": (256, 2), "one-layer": (32, 1),
           "three-layers": (24, 3)}
RTOL = 1e-5


def _cfgs(name):
    hidden, n_hidden = CONFIGS[name]
    return (jmnist.MnistConfig(hidden_dim=hidden, n_hidden=n_hidden),
            mnist.MnistConfig(hidden_dim=hidden, n_hidden=n_hidden))


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=RTOL * scale)


@pytest.fixture
def case(request):
    jcfg, cfg = _cfgs(request.param)
    jparams = jax.tree.map(np.asarray,
                           jmnist.init_params(jcfg, jax.random.PRNGKey(3)))
    batch = jax.tree.map(np.asarray,
                         jmnist.synthetic_batch(jcfg, jax.random.PRNGKey(4), 8))
    return jcfg, cfg, jparams, batch


@pytest.mark.parametrize("case", sorted(CONFIGS), indirect=True)
def test_forward_matches_jax(case):
    jcfg, cfg, jparams, batch = case
    want = jmnist.forward(jcfg, jax.tree.map(jnp.asarray, jparams),
                          jnp.asarray(batch["image"]))
    got = mnist.forward(cfg, convert.params_from_jax(jparams),
                        torch.tensor(batch["image"]))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("case", sorted(CONFIGS), indirect=True)
def test_loss_and_grads_match_jax(case):
    jcfg, cfg, jparams, batch = case
    jbatch = jax.tree.map(jnp.asarray, batch)
    want, jgrads = jax.value_and_grad(partial(jmnist.loss_fn, jcfg))(
        jax.tree.map(jnp.asarray, jparams), jbatch)
    params = convert.params_from_jax(jparams)
    leaves = [p.requires_grad_(True) for _, p in flatten_with_names(params)]
    got = mnist.loss_fn(cfg, params, {
        "image": torch.tensor(batch["image"]),
        "label": torch.tensor(batch["label"]).long()})
    assert abs(float(got.detach()) - float(want)) <= RTOL * abs(float(want))
    grads = torch.autograd.grad(got, leaves)
    for g, (path, jg) in zip(grads,
                             jax.tree_util.tree_flatten_with_path(jgrads)[0]):
        _close(g, jg)


@pytest.mark.parametrize("name", ["harness", "three-layers"])
def test_init_tree_matches_jax(name):
    """Same leaf names, shapes and dtypes; weights N(0, 1/fan_in) (checked
    on the default's 784 x 256 first layer), biases zero."""
    jcfg, cfg = _cfgs(name)
    jparams = jmnist.init_params(jcfg, jax.random.PRNGKey(0))
    params = mnist.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    flat = flatten_with_names(params)
    assert [n for n, _ in flat] == [jax.tree_util.keystr(p) for p, _ in jflat]
    for (name_, t), (_, a) in zip(flat, jflat):
        assert t.dtype == torch.float32 and str(a.dtype) == "float32", name_
        assert tuple(t.shape) == a.shape, name_
        if name_.startswith("['b"):
            assert not t.any(), name_
    meta = mnist.init_params(cfg, None, torch.device("meta"))
    assert [(n, t.shape) for n, t in flatten_with_names(meta)] == \
        [(n, t.shape) for n, t in flat]
    big = mnist.init_params(mnist.MnistConfig(), torch.Generator().manual_seed(1),
                            "cpu")["w0"]
    assert abs(float(big.std()) * 784 ** 0.5 - 1.0) < 0.01


def test_synthetic_batch_is_the_reference_construction():
    """Labels in range; every image is its label's one-hot tiled across
    784 inputs plus N(0, 0.25) noise, as the JAX batch is (its stream is
    threefry's, this one a torch generator's: a stated divergence)."""
    cfg = mnist.MnistConfig()
    b = mnist.synthetic_batch(cfg, torch.Generator().manual_seed(5), 64)
    assert b["image"].shape == (64, 784) and b["image"].dtype == torch.float32
    assert b["label"].dtype == torch.int64
    assert int(b["label"].min()) >= 0 and int(b["label"].max()) < 10
    proto = torch.nn.functional.one_hot(b["label"], 10).float().repeat(1, 79)
    noise = b["image"] - proto[:, :784]
    assert abs(float(noise.std()) - 0.5) < 0.02
    again = mnist.synthetic_batch(cfg, torch.Generator().manual_seed(5), 64)
    assert all(torch.equal(b[k], again[k]) for k in b)


def test_workload_twin_resumes_bit_identically(tmp_path):
    """The harness workload's twin: cut at step 3, restore in a fresh
    Trainer, the next losses are the uninterrupted run's bit for bit."""
    a = mnist_trainer(device="cpu")
    a.run(3)
    d = str(tmp_path / "snap")
    a.snapshot(d)
    want = a.run(4)
    b = mnist_trainer(device="cpu")
    assert b.restore(d) == 3
    assert b.run(4) == want
    assert (MNIST.hidden_dim, MNIST_BATCH) == (16, 16)


def test_jax_harness_trainer_snapshot_restores_into_the_twin(tmp_path,
                                                             monkeypatch):
    """The JAX harness trainer's state (params and Adam moments) restores
    into the twin byte for byte, and the twin trains on from it."""
    monkeypatch.setattr(jsnap, "_chunk_writer",
                        lambda path, durable: jsnap._PyChunkWriter(path, durable))
    jcfg = jmnist.MnistConfig(hidden_dim=16)
    jt = JaxTrainer(loss_fn=partial(jmnist.loss_fn, jcfg),
                    init_params=partial(jmnist.init_params, jcfg),
                    batch_fn=lambda rng: jmnist.synthetic_batch(jcfg, rng, 16))
    jt.run(3)
    d = str(tmp_path / "jax")
    jt.snapshot(d)
    jstate = jax.tree.map(np.asarray, jt.state)
    pt = mnist_trainer(device="cpu")
    like = pt.abstract_state()
    like.pop("rng")
    got = psnap.restore_snapshot(d, like=like, device="cpu")
    want = convert.state_from_jax(jstate, seed=0)
    for (name, a), (_, b) in zip(flatten_with_names(got),
                                 flatten_with_names({k: want[k] for k in got})):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    pt._state = {**got, "rng": want["rng"]}
    losses = pt.run(2)
    assert all(np.isfinite(losses)) and pt.step == 5


def test_mnist_workload_runs_and_refuses_the_frozen_trunk():
    out = subprocess.run(
        [sys.executable, "-m", "grit_tpu_torch.workload", "--model", "mnist",
         "--device", "cpu"], cwd=REPO, env=dict(os.environ, N_STEPS="3"),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "READY" and lines[-1] == "DONE"
    losses = [float(x.split()[2]) for x in lines if x.startswith("STEP")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    bad = subprocess.run(
        [sys.executable, "-m", "grit_tpu_torch.workload", "--model", "mnist",
         "--optimizer", "frozen-trunk", "--device", "cpu"], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert bad.returncode == 2 and "frozen-trunk" in bad.stderr
