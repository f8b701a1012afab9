"""The port's expert layer (``grit_tpu_torch/ops/moe.py``) against the JAX
package's ``moe_mlp``: the same numpy tokens and weights through both,
top-1 and top-2, a capacity that drops tokens and one that does not, with
and without a token mask, f32 and bf16; the output, the aux loss and the
gradients with respect to the tokens and every parameter. Tolerances, as
relative L2 over the whole tensor: f32 1e-5; bf16 1e-3 on the aux loss
(fp32 routing) and 2^-6 on tensors that pass through bf16 products. Router
probabilities are drawn tie-free (``torch.topk`` promises no order among
equal values; ``jax.lax.top_k`` takes the lower index)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu.ops import moe as jmoe
from grit_tpu_torch import convert
from grit_tpu_torch.ops import moe

T, D, H, E = 64, 32, 48, 4
F32_TOL = 1e-5
BF16_AUX_TOL = 1e-3
BF16_TENSOR_TOL = 2.0 ** -6
_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _inputs(dtype, seed=0):
    """Numpy tokens, weights and a mask of a third of the rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D), dtype=np.float32)
    params = {"router": rng.standard_normal((D, E), dtype=np.float32) / D ** 0.5,
              "w_in": rng.standard_normal((E, D, H), dtype=np.float32) / D ** 0.5,
              "w_out": rng.standard_normal((E, H, D), dtype=np.float32) / H ** 0.5}
    mask = rng.random(T) > 0.33
    jdt, tdt = _DTYPES[dtype]
    jx = jnp.asarray(x, jdt)
    jparams = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    px = convert.tensor_from_numpy(np.asarray(jx))
    pparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    assert px.dtype == tdt
    return jx, jparams, px, pparams, mask


def _run_both(dtype, top_k, cf, masked):
    jx, jparams, px, pparams, mask = _inputs(dtype)
    jmask = jnp.asarray(mask) if masked else None
    pmask = torch.from_numpy(mask) if masked else None

    def jloss(x, p):
        y, aux = jmoe.moe_mlp(p, x, capacity_factor=cf, top_k=top_k,
                              token_mask=jmask)
        # A fixed random projection of y plus the aux: every output
        # element and the aux reach the gradient.
        w = jnp.asarray(np.random.default_rng(9).standard_normal(y.shape),
                        jnp.float32)
        return jnp.sum(y.astype(jnp.float32) * w) + aux, (y, aux)

    (_, (jy, jaux)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jx, jparams)
    px.requires_grad_(True)
    for v in pparams.values():
        v.requires_grad_(True)
    py, paux = moe.moe_mlp(pparams, px, capacity_factor=cf, top_k=top_k,
                           token_mask=pmask)
    w = torch.from_numpy(np.random.default_rng(9).standard_normal(
        tuple(py.shape)).astype(np.float32))
    loss = (py.float() * w).sum() + paux
    names = ["router", "w_in", "w_out"]
    pg = torch.autograd.grad(loss, [px] + [pparams[n] for n in names])
    want = {"y": np.asarray(jy, np.float32), "aux": float(jaux),
            "dx": np.asarray(jgrads[0], np.float32),
            **{f"d{n}": np.asarray(jgrads[1][n], np.float32) for n in names}}
    got = {"y": convert.tensor_to_numpy(py), "aux": float(paux.detach()),
           "dx": convert.tensor_to_numpy(pg[0]),
           **{f"d{n}": convert.tensor_to_numpy(g)
              for n, g in zip(names, pg[1:])}}
    return got, want, py


CAPACITY = {"drops": 0.5, "no-drops": float(E)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["all-rows", "masked"])
@pytest.mark.parametrize("capacity", sorted(CAPACITY))
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_mlp_matches_jax(top_k, capacity, masked, dtype):
    got, want, py = _run_both(dtype, top_k, CAPACITY[capacity], masked)
    assert py.dtype == _DTYPES[dtype][1] and py.shape == (T, D)
    aux_tol = F32_TOL if dtype == "f32" else BF16_AUX_TOL
    assert abs(got["aux"] - want["aux"]) <= aux_tol * abs(want["aux"])
    tol = F32_TOL if dtype == "f32" else BF16_TENSOR_TOL
    for key in ("y", "dx", "drouter", "dw_in", "dw_out"):
        assert np.abs(want[key]).max() > 0, key
        assert rel(got[key], want[key]) <= tol, (key, rel(got[key], want[key]))
    # The same tokens are dropped: a row the JAX layer zeroes, the port's
    # zeroes too.
    assert np.array_equal(np.all(got["y"] == 0, axis=1),
                          np.all(want["y"] == 0, axis=1))


def test_a_tight_capacity_drops_tokens_and_a_wide_one_none():
    _jx, _jp, px, pparams, _mask = _inputs("f32")
    y, _ = moe.moe_mlp(pparams, px, capacity_factor=0.5, top_k=1)
    dropped = int(torch.all(y == 0, dim=1).sum())
    assert dropped >= T // 2 - 1  # capacity 8 a expert, 4 experts, 64 tokens
    y, _ = moe.moe_mlp(pparams, px, capacity_factor=float(E), top_k=1)
    assert not torch.all(y == 0, dim=1).any()


def test_masked_rows_route_nowhere_and_leave_the_rest_alone():
    """A masked row gives zero output, and what it holds changes nothing
    for the other rows or the aux."""
    _jx, _jp, px, pparams, mask = _inputs("f32")
    m = torch.from_numpy(mask)
    y1, aux1 = moe.moe_mlp(pparams, px, capacity_factor=1.0, top_k=2,
                           token_mask=m)
    noisy = px.clone()
    noisy[~m] = torch.randn(int((~m).sum()), D) * 100
    y2, aux2 = moe.moe_mlp(pparams, noisy, capacity_factor=1.0, top_k=2,
                           token_mask=m)
    assert not y1[~m].any()
    assert torch.equal(y1[m], y2[m]) and torch.equal(aux1, aux2)


def test_uniform_router_scores_aux_one():
    params = {"router": torch.zeros(D, E), "w_in": torch.zeros(E, D, H),
              "w_out": torch.zeros(E, H, D)}
    # Equal probabilities tie everywhere; the aux does not depend on which
    # expert a tie picks, only on the fractions summing to one.
    _, aux = moe.moe_mlp(params, torch.randn(T, D), top_k=1)
    assert abs(float(aux) - 1.0) < 1e-6


def test_one_hot_of_an_out_of_range_index_is_zero():
    idx = torch.tensor([-1, 0, 2, 3, 7])
    got = moe._one_hot(idx, 3)
    want = np.asarray(jax.nn.one_hot(jnp.asarray(idx.numpy()), 3))
    assert np.array_equal(got.numpy(), want)


def test_top_k_out_of_range_raises():
    _jx, _jp, px, pparams, _mask = _inputs("f32")
    for k in (0, E + 1):
        with pytest.raises(ValueError, match="top_k"):
            moe.moe_mlp(pparams, px, top_k=k)


def test_capacity_matches_the_reference_rule():
    for tokens, k, cf in ((64, 1, 1.25), (8192, 2, 1.25), (5, 1, 0.1),
                          (100, 2, 0.5)):
        want = max(1, int(np.ceil(tokens * k / E * cf)))
        assert moe.capacity_of(tokens, E, k, cf) == want
    # bench.py's MoE step: T 16 x 512, top-2 of 8 experts.
    assert moe.capacity_of(16 * 512, 8, 2, 1.25) == 2560


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_init_moe_params_shapes_dtypes_and_seed(dtype):
    jdt, tdt = _DTYPES[dtype]
    want = jmoe.init_moe_params(jax.random.PRNGKey(0), D, H, E, dtype=jdt)
    a = moe.init_moe_params(torch.Generator().manual_seed(0), D, H, E,
                            dtype=tdt)
    b = moe.init_moe_params(torch.Generator().manual_seed(0), D, H, E,
                            dtype=tdt)
    assert sorted(a) == sorted(want)
    for name in want:
        assert tuple(a[name].shape) == want[name].shape
        assert a[name].dtype == tdt and torch.equal(a[name], b[name])
    assert abs(float(a["w_out"].float().std()) - H ** -0.5) < 0.02


def test_routing_is_deterministic_under_deterministic_algorithms():
    _jx, _jp, px, pparams, _mask = _inputs("f32")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        y1, a1 = moe.moe_mlp(pparams, px, top_k=2)
        y2, a2 = moe.moe_mlp(pparams, px, top_k=2)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)


def _reference_one_hots(topk_idx, gates, mask_f, capacity, n_experts, dtype):
    """The reference's construction, transcribed: fp32 (T, E, C) products
    and sums a slot at a time."""
    tokens, top_k = topk_idx.shape
    dispatch = torch.zeros(tokens, n_experts, capacity)
    combine = torch.zeros(tokens, n_experts, capacity)
    kept = torch.zeros(n_experts)
    for j in range(top_k):
        onehot = moe._one_hot(topk_idx[:, j], n_experts) * mask_f[:, None]
        position = torch.cumsum(onehot, dim=0) - 1.0 + kept[None, :]
        keep = (position < capacity).float() * onehot
        kept = kept + keep.sum(dim=0)
        slot = keep[:, :, None] * moe._one_hot(position.to(torch.int32),
                                               capacity)
        dispatch = dispatch + slot
        combine = combine + slot * gates[:, j][:, None, None]
    return dispatch.to(dtype), combine.to(dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["all-rows", "masked"])
@pytest.mark.parametrize("capacity", sorted(CAPACITY))
@pytest.mark.parametrize("top_k", [1, 2])
def test_scattered_one_hots_equal_the_reference_products(top_k, capacity,
                                                         masked, dtype):
    """The dispatch and combine built by one scatter each hold the values
    of the reference's fp32 products bit for bit, and so does the gates'
    gradient through the combine."""
    _jx, _jp, px, pparams, mask = _inputs(dtype)
    probs = torch.softmax(px.float() @ pparams["router"].float(), dim=-1)
    topk_probs, topk_idx = torch.topk(probs, top_k, dim=-1)
    gates = (topk_probs / topk_probs.sum(dim=-1, keepdim=True)
             if top_k > 1 else topk_probs).detach().requires_grad_(True)
    mask_f = (torch.from_numpy(mask).float() if masked else torch.ones(T))
    cap = moe.capacity_of(T, E, top_k, CAPACITY[capacity])
    tdt = _DTYPES[dtype][1]
    dispatch, combine, onehot0 = moe.route(topk_idx, gates, mask_f, cap, E, tdt)
    want_d, want_c = _reference_one_hots(topk_idx, gates, mask_f, cap, E, tdt)
    assert dispatch.dtype == combine.dtype == tdt
    assert torch.equal(dispatch, want_d) and torch.equal(combine, want_c)
    assert torch.equal(onehot0, moe._one_hot(topk_idx[:, 0], E) * mask_f[:, None])
    w = torch.randn(combine.shape, generator=torch.Generator().manual_seed(4))
    (g_got,) = torch.autograd.grad((combine.float() * w).sum(), gates)
    (g_want,) = torch.autograd.grad((want_c.float() * w).sum(), gates)
    assert torch.equal(g_got, g_want)
    if capacity == "drops":
        assert int(dispatch.sum()) < int(mask_f.sum()) * top_k
