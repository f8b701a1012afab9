"""The port's Ulysses attention (``grit_tpu_torch/ops/ulysses.py``)
against the JAX package's ``ulysses_attention``: the same numpy inputs,
the port on four gloo CPU ranks (and two-rank groups), local outputs
concatenated in rank order. GQA at 2e-5 (f32, as
``tests/test_ulysses.py``), the ring and Ulysses interchangeable at
2e-5, an axis given as a 1-D ``DeviceMesh``, the q/k/v gradients against
JAX's at 2e-4, the head-count error, and the long-context model run
with both schemes against the dense JAX forward at 3e-4."""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from grit_tpu.models import llama as jllama
from grit_tpu.models.long_context import forward_sp
from grit_tpu.ops.attention import attention_reference
from grit_tpu.ops.ring_attention import ring_attention
from grit_tpu.ops.ulysses import ulysses_attention
from grit_tpu_torch.parallel.launch import run_ranks
from tests import torch_ranks
from tests.test_torch_ring_attention import gathered, make_qkv

TOL = 2e-5
GRAD_TOL = 2e-4
MODEL_TOL = 3e-4
JCFG = jllama.LlamaConfig.tiny(n_kv_heads=4, dtype=jnp.float32)


INPUTS = {"gqa": make_qkv(2, 64, 8, 4, 16), "swap": make_qkv(2, 32, 4, 4, 8, seed=7),
          "grad": make_qkv(1, 32, 4, 4, 8, seed=11),
          "bad_heads": make_qkv(1, 32, 4, 2, 8)}  # kv heads 2 on 4 ranks


@pytest.fixture(scope="module")
def model():
    """(JAX params as numpy, tokens (2, 32)) of the model integration."""
    params = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, JCFG.vocab_size, (2, 32),
                                               dtype=np.int32)
    return jax.tree.map(np.asarray, params), tokens


@pytest.fixture(scope="module")
def ranks(model):
    return run_ranks(torch_ranks.ulysses_cases, 4,
                     {**INPUTS, "model_params": model[0],
                      "model_tokens": model[1]}, backend="gloo")


def seq_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("seq",))


def put(mesh, *xs):
    sh = NamedSharding(mesh, P(None, "seq", None, None))
    return tuple(jax.device_put(x, sh) for x in xs)


@lru_cache(maxsize=None)
def jax_ulysses(n: int, case: str):
    mesh = seq_mesh(n)
    fn = jax.jit(lambda q, k, v: ulysses_attention(q, k, v, mesh, axis="seq"))
    return np.asarray(fn(*put(mesh, *INPUTS[case])))


def test_ranks_import_nothing_of_jax(ranks):
    assert all(r["foreign"] == [] for r in ranks)


@pytest.mark.parametrize("axis,members", [("world", (0, 1, 2, 3)),
                                          ("pair", (0, 1)), ("pair", (2, 3))])
def test_matches_jax_gqa(ranks, axis, members):
    got = gathered(ranks, axis, ("gqa",), members)
    np.testing.assert_allclose(got, jax_ulysses(len(members), "gqa"),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        got, np.asarray(attention_reference(*INPUTS["gqa"])), rtol=TOL, atol=TOL)


def test_interchangeable_with_ring(ranks):
    uly = gathered(ranks, "world", ("swap", 0))
    ring = gathered(ranks, "world", ("swap", 1))
    np.testing.assert_allclose(uly, ring, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(uly, jax_ulysses(4, "swap"), rtol=TOL, atol=TOL)
    mesh = seq_mesh(4)
    jring = jax.jit(lambda q, k, v: ring_attention(q, k, v, mesh, axis="seq"))
    np.testing.assert_allclose(ring, np.asarray(jring(*put(mesh, *INPUTS["swap"]))),
                               rtol=TOL, atol=TOL)


def test_device_mesh_axis_is_the_group(ranks):
    np.testing.assert_array_equal(gathered(ranks, "world", ("mesh",)),
                                  gathered(ranks, "world", ("swap", 0)))


def test_grad_matches_jax(ranks):
    mesh = seq_mesh(4)

    def loss(q, k, v):
        return jnp.sum(ulysses_attention(q, k, v, mesh, axis="seq") ** 2)

    def loss_dense(q, k, v):
        return jnp.sum(attention_reference(q, k, v) ** 2)

    gs = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*put(mesh, *INPUTS["grad"]))
    gd = jax.grad(loss_dense, argnums=(0, 1, 2))(*INPUTS["grad"])
    for i, (a, b) in enumerate(zip(gs, gd), start=1):
        got = gathered(ranks, "world", ("grad", i))
        np.testing.assert_allclose(got, np.asarray(a), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
        np.testing.assert_allclose(got, np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_head_count_constraint_rejected(ranks):
    """Both packages refuse kv heads that do not divide by the axis, and
    name the ring as the way out."""
    with pytest.raises(ValueError, match="ring_attention"):
        ulysses_attention(*put(seq_mesh(4), *INPUTS["bad_heads"]), seq_mesh(4),
                          axis="seq")
    msg = ranks[0]["world"]["error"]
    assert msg is not None and "ring_attention" in msg
    assert "kv heads 2" in msg


def test_model_integration_forward_sp(ranks, model):
    """The long-context family with attn_impl='ulysses' and 'ring'
    against the dense JAX trunk and JAX's own forward_sp."""
    params, tokens = model
    dense = np.asarray(jllama.forward(JCFG, params, tokens))
    mesh = seq_mesh(4)
    for impl in ("ulysses", "ring"):
        got = np.concatenate([r["world"]["model"][impl] for r in ranks], axis=1)
        want = np.asarray(forward_sp(JCFG, params, tokens, mesh=mesh,
                                     attn_impl=impl))
        np.testing.assert_allclose(got, dense, rtol=MODEL_TOL, atol=MODEL_TOL)
        np.testing.assert_allclose(got, want, rtol=MODEL_TOL, atol=MODEL_TOL)
