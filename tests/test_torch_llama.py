"""The port's llama (training subset) against the JAX model, with the same
weights carried across by ``params_from_jax`` and the same numpy tokens."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu.models import llama as jllama
from grit_tpu_torch import convert
from grit_tpu_torch.models import llama
from grit_tpu_torch.tree import flatten_with_names

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


def _configs(n_kv_heads, dtype="f32", param_dtype="f32"):
    """The JAX tiny config at head dim 128 (the flash kernels' width) and
    its port twin."""
    kw = dict(dim=256, n_heads=2, n_kv_heads=n_kv_heads)
    jcfg = jllama.LlamaConfig.tiny(dtype=_DTYPES[dtype][0],
                                   param_dtype=_DTYPES[param_dtype][0], **kw)
    pcfg = llama.LlamaConfig.tiny(dtype=_DTYPES[dtype][1],
                                  param_dtype=_DTYPES[param_dtype][1], **kw)
    return jcfg, pcfg


def _tokens(cfg, B=2, S=128, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)


def _carry(jcfg):
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    return jparams, convert.params_from_jax(jax.tree.map(np.asarray, jparams))


def test_leaf_names_match_jax_keystr():
    jcfg, pcfg = _configs(2)
    jparams, params = _carry(jcfg)
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert [n for n, _ in flatten_with_names(params)] == want
    abstract = llama.abstract_params(pcfg)
    for (name, a), (_, p) in zip(flatten_with_names(abstract),
                                 flatten_with_names(params)):
        assert a.device.type == "meta", name
        assert (a.shape, a.dtype) == (p.shape, p.dtype), name


@pytest.mark.parametrize("n_kv_heads", [1, 2])
def test_forward_and_loss_match_jax_f32(n_kv_heads):
    jcfg, pcfg = _configs(n_kv_heads)
    jparams, params = _carry(jcfg)
    toks = _tokens(jcfg)
    inp, tgt = toks[:, :-1], toks[:, 1:]
    want_logits = np.asarray(jllama.forward(jcfg, jparams, inp))
    want_loss = float(jllama.loss_fn(jcfg, jparams, inp, tgt))
    ti, tt = torch.from_numpy(inp), torch.from_numpy(tgt).long()
    got_logits = llama.forward(pcfg, params, ti).numpy()
    got_loss = float(llama.loss_fn(pcfg, params, ti, tt))
    np.testing.assert_allclose(got_logits, want_logits, rtol=1e-4, atol=1e-4)
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss), (got_loss, want_loss)


def test_masked_loss_matches_jax():
    jcfg, pcfg = _configs(2)
    jparams, params = _carry(jcfg)
    toks = _tokens(jcfg, seed=3)
    mask = np.random.default_rng(4).random(toks[:, 1:].shape) < 0.7
    want = float(jllama.loss_fn(jcfg, jparams, toks[:, :-1], toks[:, 1:],
                                mask=mask))
    got = float(llama.loss_fn(pcfg, params, torch.from_numpy(toks[:, :-1]),
                              torch.from_numpy(toks[:, 1:]).long(),
                              mask=torch.from_numpy(mask)))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
def test_bf16_loss_matches_jax(param_dtype):
    """bf16 activations round at other places in the two frameworks: the
    loss agrees to 1e-3 relative, the bound the JAX package's own bf16
    dryrun holds its sharded step to."""
    jcfg, pcfg = _configs(2, dtype="bf16", param_dtype=param_dtype)
    jparams, params = _carry(jcfg)
    toks = _tokens(jcfg, seed=1)
    want = float(jllama.loss_fn(jcfg, jparams, toks[:, :-1], toks[:, 1:]))
    got = float(llama.loss_fn(pcfg, params, torch.from_numpy(toks[:, :-1]),
                              torch.from_numpy(toks[:, 1:]).long()))
    assert abs(got - want) <= 1e-3 * abs(want), (got, want)


def test_params_from_jax_keeps_bf16_bytes():
    jcfg, _ = _configs(2, param_dtype="bf16")
    jparams, params = _carry(jcfg)
    a = np.asarray(jparams["layers"]["attn"]["wq"])
    t = params["layers"]["attn"]["wq"]
    assert t.dtype == torch.bfloat16
    assert t.view(torch.int16).numpy().tobytes() == a.tobytes()


def test_init_params_is_seeded_and_scaled():
    _, pcfg = _configs(2)
    a = llama.init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
    b = llama.init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
    for (name, x), (_, y) in zip(flatten_with_names(a), flatten_with_names(b)):
        assert torch.equal(x, y), name
    wq = a["layers"]["attn"]["wq"]
    assert abs(wq.std().item() - pcfg.dim ** -0.5) < 0.1 * pcfg.dim ** -0.5
    assert torch.equal(a["final_norm"], torch.ones(pcfg.dim))
