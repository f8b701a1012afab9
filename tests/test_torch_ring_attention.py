"""The port's ring attention (``grit_tpu_torch/ops/ring_attention.py``)
against the JAX package's ``ring_attention`` on the conftest's virtual
CPU devices: the same numpy inputs, the port on four gloo CPU ranks (and
on two-rank groups) whose local outputs are concatenated in rank order.
GQA and MHA outputs at 2e-5 (f32, as ``tests/test_ring_attention.py``),
causality across shards bitwise, and the q/k/v gradients of
``sum(out ** 2)`` against JAX's at 2e-4 (as ``tests/test_ulysses.py``
holds Ulysses' gradients)."""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from grit_tpu.ops.attention import attention_reference
from grit_tpu.ops.ring_attention import ring_attention
from grit_tpu.parallel import MeshSpec, build_mesh
from grit_tpu_torch.parallel.launch import run_ranks
from tests import torch_ranks

TOL = 2e-5
GRAD_TOL = 2e-4


def make_qkv(B, S, H, KVH, hd, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32)
                 for shape in ((B, S, H, hd), (B, S, KVH, hd), (B, S, KVH, hd)))


def causal_inputs():
    q, k, v = make_qkv(1, 32, 2, 2, 8, seed=3)
    k2, v2 = k.copy(), v.copy()
    k2[:, 24:], v2[:, 24:] = 7.0, -7.0
    return q, k, v, k2, v2


INPUTS = {"gqa": make_qkv(2, 64, 4, 2, 16), "mha": make_qkv(1, 32, 4, 4, 8, seed=5),
          "causal": causal_inputs(), "grad": make_qkv(1, 32, 4, 4, 8, seed=11)}


@pytest.fixture(scope="module")
def ranks():
    """One launch of four CPU ranks runs every case of this file."""
    return run_ranks(torch_ranks.ring_cases, 4, INPUTS, backend="gloo")


def gathered(ranks, axis: str, key, members=None):
    """The ranks' local outputs of ``key`` concatenated along the
    sequence, in rank order (``members``: the ranks of one group)."""
    members = members or (range(4) if axis == "world" else (0, 1))
    parts = [ranks[r][axis] for r in members]
    for k in key:
        parts = [p[k] for p in parts]
    return np.concatenate(parts, axis=1)


def _mesh(n: int):
    mesh = build_mesh(MeshSpec(data=n), jax.devices()[:n])
    return mesh, NamedSharding(mesh, P(None, "data", None, None))


@lru_cache(maxsize=None)
def jax_ring(n: int, case: str):
    mesh, sh = _mesh(n)
    qkv = (jax.device_put(x, sh) for x in INPUTS[case])
    return np.asarray(jax.jit(lambda q, k, v: ring_attention(q, k, v, mesh))(
        *qkv))


@lru_cache(maxsize=None)
def jax_ring_grads(n: int):
    """JAX's output and q/k/v gradients of sum(out ** 2) on the grad case."""
    mesh, sh = _mesh(n)
    qkv = tuple(jax.device_put(x, sh) for x in INPUTS["grad"])

    def loss(q, k, v):
        return jnp.sum(ring_attention(q, k, v, mesh) ** 2)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*qkv)
    return [jax_ring(n, "grad"), *(np.asarray(g) for g in grads)]


def test_ranks_import_nothing_of_jax(ranks):
    assert all(r["foreign"] == [] for r in ranks)


@pytest.mark.parametrize("axis,members", [("world", (0, 1, 2, 3)),
                                          ("pair", (0, 1)), ("pair", (2, 3))])
@pytest.mark.parametrize("case", ["gqa", "mha"])
def test_matches_jax_ring(ranks, axis, members, case):
    n = len(members)
    got = gathered(ranks, axis, (case,), members)
    want = jax_ring(n, case)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        got, np.asarray(attention_reference(*INPUTS[case])), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("axis", ["world", "pair"])
def test_causality_across_shards(ranks, axis):
    """Perturbing the last positions' K/V leaves every earlier output
    bitwise unchanged: the skipped blocks are skipped, not masked."""
    base = gathered(ranks, axis, ("causal", 0))
    moved = gathered(ranks, axis, ("causal", 1))
    np.testing.assert_array_equal(base[:, :24], moved[:, :24])
    assert not np.array_equal(base[:, 24:], moved[:, 24:])


@pytest.mark.parametrize("axis,members", [("world", (0, 1, 2, 3)),
                                          ("pair", (0, 1)), ("pair", (2, 3))])
def test_gradients_match_jax(ranks, axis, members):
    want = jax_ring_grads(len(members))
    np.testing.assert_allclose(gathered(ranks, axis, ("grad", 0), members),
                               want[0], rtol=TOL, atol=TOL)
    for i in (1, 2, 3):
        np.testing.assert_allclose(gathered(ranks, axis, ("grad", i), members),
                                   want[i], rtol=GRAD_TOL, atol=GRAD_TOL)
