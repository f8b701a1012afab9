"""The port's llama serving functions and chunked cross-entropy against the
JAX package's: ``decode`` (prefill, then single steps), ``decode_ragged``
(mixed positions, an inactive row), the bounds of a cache write, the KV
elision tag, and ``loss_fn(ce_chunk=)``. The same numpy weights, tokens
and caches go through both packages on the CPU."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu.models import llama as jllama
from grit_tpu.models import serving as jserving
from grit_tpu_torch import convert
from grit_tpu_torch.models import llama
from grit_tpu_torch.models import serving

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and oversubscribed spinning threads slow torch's CPU ops many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype="f32"):
    jcfg = jllama.LlamaConfig.tiny(dtype=_DTYPES[dtype][0])
    pcfg = llama.LlamaConfig.tiny(dtype=_DTYPES[dtype][1])
    return jcfg, pcfg


def _carry(jcfg, seed=0):
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, convert.params_from_jax(jax.tree.map(np.asarray, jparams))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = convert.tensor_to_numpy(x)
    return np.asarray(x).astype(np.float32)


def _assert_close(got, want, dtype, what):
    """f32: max |err| within 1e-5 of max(1, max |want|), the dryrun's f32
    bound (``__graft_entry__.py``). bf16: relative L2 error within 2^-6.
    The two frameworks round bf16 activations at different places (XLA
    fuses elementwise ops), so per-element logits of the port's bf16
    forward, training path included, differ from JAX's by up to three
    bf16 ulps (relative L2 0.008-0.011 at this config): the dryrun's bf16
    bound of 1e-3 holds a loss, an average, and no single logit can meet
    it. bf16 has 8 significant bits; 2^-6 is a few of its ulps."""
    got, want = _f32(got), _f32(want)
    if dtype == "f32":
        err = float(np.abs(got - want).max())
        tol = 1e-5 * max(1.0, float(np.abs(want).max()))
        assert err <= tol, f"{what}: max |err| {err} > {tol}"
    else:
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        assert rel <= 2.0 ** -6, f"{what}: relative L2 error {rel}"


def _random_cache(jcfg, B, max_len, seed):
    """A cache full of random K/V (numpy), so an untouched row is a real
    byte-identity check and not zeros against zeros."""
    rng = np.random.default_rng(seed)
    shape = (jcfg.n_layers, B, max_len, jcfg.n_kv_heads, jcfg.head_dim)
    k, v = (rng.standard_normal(shape, dtype=np.float32) for _ in range(2))
    return {"k": k, "v": v, "length": np.asarray(0, np.int32)}


def _both_caches(jcfg, cache):
    jc = {"k": jnp.asarray(cache["k"], jcfg.dtype),
          "v": jnp.asarray(cache["v"], jcfg.dtype),
          "length": jnp.asarray(cache["length"])}
    pc = convert.serving_state_from_jax({"cache": jax.tree.map(np.asarray, jc)}
                                        )["cache"]
    return jc, pc


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_prefill_then_steps_matches_jax(dtype):
    """Prefill 12 tokens, then 5 single steps fed the JAX greedy token:
    logits and the written cache agree within the bound."""
    jcfg, pcfg = _configs(dtype)
    jparams, params = _carry(jcfg)
    B, max_len = 2, 64
    jcache = jllama.init_kv_cache(jcfg, B, max_len)
    pcache = llama.init_kv_cache(pcfg, B, max_len, device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, 12),
                                             dtype=np.int32)
    # The prefill's logits are the training forward's.
    want_forward = llama.forward(pcfg, params, torch.from_numpy(toks))
    for step in range(6):
        jl, jcache = jllama.decode(jcfg, jparams, jnp.asarray(toks), jcache)
        pl, pcache = llama.decode(pcfg, params, torch.from_numpy(toks), pcache)
        assert pl.dtype == torch.float32 and pl.shape == jl.shape
        _assert_close(pl, jl, dtype, f"logits at step {step}")
        if step == 0:
            _assert_close(pl, want_forward, dtype, "prefill vs forward")
        assert int(pcache["length"]) == int(jcache["length"])
        toks = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
    n = int(jcache["length"])
    assert n == 17
    for leaf in ("k", "v"):
        _assert_close(pcache[leaf][:, :, :n], jcache[leaf][:, :, :n], dtype,
                      f"cache {leaf}")
        assert not pcache[leaf][:, :, n:].any()  # nothing written past it


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_ragged_matches_jax_and_keeps_inactive_rows(dtype):
    """Three slots at positions 5, 9 and 2, the middle one inactive, four
    steps: logits and caches agree with the JAX function, and the
    inactive slot's cache rows stay byte-identical."""
    jcfg, pcfg = _configs(dtype)
    jparams, params = _carry(jcfg, seed=2)
    B, max_len = 3, 32
    jcache, pcache = _both_caches(jcfg, _random_cache(jcfg, B, max_len, 3))
    before = {leaf: pcache[leaf][:, 1].clone() for leaf in ("k", "v")}
    lengths = np.asarray([5, 9, 2], np.int32)
    active = np.asarray([True, False, True])
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, 1),
                                             dtype=np.int32)
    for step in range(4):
        jl, jcache = jllama.decode_ragged(jcfg, jparams, jnp.asarray(toks),
                                          jcache, jnp.asarray(lengths),
                                          jnp.asarray(active))
        pl, pcache = llama.decode_ragged(
            pcfg, params, torch.from_numpy(toks), pcache,
            torch.from_numpy(lengths), torch.from_numpy(active))
        _assert_close(pl, jl, dtype, f"logits at step {step}")
        toks = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
        lengths = lengths + active
    for leaf in ("k", "v"):
        _assert_close(pcache[leaf], jcache[leaf], dtype, f"cache {leaf}")
        assert torch.equal(pcache[leaf][:, 1], before[leaf])
    with pytest.raises(ValueError, match="per-token"):
        llama.decode_ragged(pcfg, params, torch.zeros(B, 2, dtype=torch.int32),
                            pcache, torch.from_numpy(lengths),
                            torch.from_numpy(active))


def test_ragged_decode_matches_lockstep():
    """decode_ragged with uniform lengths equals decode within the port."""
    _, pcfg = _configs()
    _, params = _carry(_configs()[0])
    B = 2
    cache_r = llama.init_kv_cache(pcfg, B, 64, device="cpu")
    cache_d = llama.init_kv_cache(pcfg, B, 64, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, pcfg.vocab_size, (B, 1), dtype=np.int32))
    td = tr = tok
    lengths = torch.zeros(B, dtype=torch.int32)
    active = torch.ones(B, dtype=torch.bool)
    for _ in range(5):
        ld, cache_d = llama.decode(pcfg, params, td, cache_d)
        lr, cache_r = llama.decode_ragged(pcfg, params, tr, cache_r, lengths,
                                          active)
        np.testing.assert_allclose(lr.numpy(), ld.numpy(), rtol=2e-5, atol=2e-5)
        td = torch.argmax(ld[:, -1:], dim=-1).to(torch.int32)
        tr = torch.argmax(lr[:, -1:], dim=-1).to(torch.int32)
        lengths = lengths + 1
        assert torch.equal(td, tr)


def test_out_of_range_cache_writes_raise_instead_of_clamping():
    """lax.dynamic_update_slice would clamp these writes; the port raises
    before writing anything. An inactive slot at the cache's end is not a
    write and passes untouched."""
    _, pcfg = _configs()
    _, params = _carry(_configs()[0])
    cache = llama.init_kv_cache(pcfg, 2, 16, device="cpu")
    cache["length"] = torch.tensor(15, dtype=torch.int32)
    with pytest.raises(ValueError, match="overruns max_len=16"):
        llama.decode(pcfg, params, torch.ones(2, 2, dtype=torch.int32), cache)
    assert not cache["k"].any()
    lengths = torch.tensor([16, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="overruns max_len=16"):
        llama.decode_ragged(pcfg, params, torch.ones(2, 1, dtype=torch.int32),
                            cache, lengths, torch.tensor([True, True]))
    assert not cache["k"].any()
    llama.decode_ragged(pcfg, params, torch.ones(2, 1, dtype=torch.int32),
                        cache, lengths, torch.tensor([False, True]))
    assert not cache["k"][:, 0].any() and cache["k"][:, 1, 3].any()


def test_decode_ragged_runs_the_same_in_deterministic_mode():
    """``torch.use_deterministic_algorithms(True)`` (the workload's mode)
    accepts the per-row cache write and changes no bit."""
    jcfg, pcfg = _configs()
    _, params = _carry(jcfg)
    lengths = torch.tensor([5, 9, 2], dtype=torch.int32)
    active = torch.tensor([True, False, True])
    toks = torch.tensor([[1], [2], [3]], dtype=torch.int32)
    out = []
    for mode in (False, True):
        _, cache = _both_caches(jcfg, _random_cache(jcfg, 3, 32, 3))
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(mode)
        try:
            logits, cache = llama.decode_ragged(pcfg, params, toks, cache,
                                                lengths, active)
        finally:
            torch.use_deterministic_algorithms(was)
        out.append((logits, cache["k"], cache["v"]))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_init_kv_cache_layout_matches_jax():
    jcfg, pcfg = _configs("bf16")
    want = jllama.init_kv_cache(jcfg, 3, 32)
    got = llama.init_kv_cache(pcfg, 3, 32, device="cpu")
    for leaf in ("k", "v", "length"):
        assert tuple(got[leaf].shape) == want[leaf].shape, leaf
    assert got["k"].dtype == torch.bfloat16 and got["length"].dtype == torch.int32
    meta = llama.init_kv_cache(pcfg, 3, 32, device="meta")
    assert meta["k"].device.type == "meta" and meta["length"].device.type == "cpu"


def test_tag_elidable_kv_is_byte_equal_to_the_reference():
    jcfg, _ = _configs()
    cache = _random_cache(jcfg, 4, 32, seed=5)
    lengths = np.asarray([3, 31, 0, 17], np.int32)
    active = np.asarray([True, True, False, True])
    jk, jv = jserving._tag_elidable_kv(jnp.asarray(cache["k"]),
                                       jnp.asarray(cache["v"]),
                                       jnp.asarray(lengths),
                                       jnp.asarray(active))
    pk, pv = serving._tag_elidable_kv(torch.from_numpy(cache["k"]),
                                      torch.from_numpy(cache["v"]),
                                      torch.from_numpy(lengths),
                                      torch.from_numpy(active))
    assert pk.numpy().tobytes() == np.asarray(jk).tobytes()
    assert pv.numpy().tobytes() == np.asarray(jv).tobytes()
    assert not pk[:, 2].any() and pk[:, 1].all()  # free slot zero, full kept


@pytest.mark.parametrize("chunk", [16, 7])  # divides B*S = 64; falls back
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_cross_entropy_matches_jax(chunk, masked):
    """``loss_fn(ce_chunk=)`` against the JAX function in value and
    gradients, and against the port's own full-logits loss (as
    ``tests/test_models.py::test_chunked_cross_entropy_matches_full``
    holds the JAX pair)."""
    jcfg, pcfg = _configs()
    jparams, params = _carry(jcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 33),
                                             dtype=np.int32)
    tokens, targets = toks[:, :-1], toks[:, 1:]
    mask = (np.arange(32)[None, :] < 20).astype(np.float32) * np.ones((2, 1),
                                                                  np.float32)
    m = mask if masked else None

    jl, jg = jax.value_and_grad(lambda p: jllama.loss_fn(
        jcfg, p, tokens, targets, mask=m, ce_chunk=chunk))(jparams)
    leaves = [p.requires_grad_(True) for p in _leaves(params)]

    def port_loss(ce_chunk):
        return llama.loss_fn(pcfg, params, torch.from_numpy(tokens),
                             torch.from_numpy(targets).long(),
                             mask=None if m is None else torch.from_numpy(m),
                             ce_chunk=ce_chunk)

    loss = port_loss(chunk)
    grads = torch.autograd.grad(loss, leaves)
    full = port_loss(None)
    full_grads = torch.autograd.grad(full, leaves)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(loss.item(), full.item(), rtol=1e-6)
    for a, b, g in zip(grads, jax.tree_util.tree_leaves(jg), full_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(a.numpy(), g.numpy(), rtol=1e-5, atol=1e-6)


def _leaves(tree):
    from grit_tpu_torch.tree import flatten_with_names

    return [x for _, x in flatten_with_names(tree)]
