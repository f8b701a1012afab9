"""llama's per-layer rematerialization (``LlamaConfig.remat``) in the port:
with it on, the backward replays each layer from its input, so the loss
and every gradient are bitwise those of the plain run (the same kernels on
the same inputs), for the dense llama, its LoRA fine-tune and the MoE
family; the attention runs twice per layer and step; only the layers'
inputs are kept for the backward; and the remat loss equals the JAX
package's ``remat`` loss (f32 1e-5 relative)."""

from __future__ import annotations

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu.models import llama as jllama
from grit_tpu_torch import convert
from grit_tpu_torch.models import llama, lora, moe_llama
from grit_tpu_torch.tree import flatten_with_names
from grit_tpu_torch.workload import CONFIGS, lora_base, lora_trainer, moe_trainer

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(vocab, B=2, S=128, seed=0):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, vocab, (B, S + 1)))
    return toks[:, :-1], toks[:, 1:]


def _model(family, dtype, remat):
    """(loss_fn(leaves) -> loss, the leaves autograd differentiates)."""
    dt = _DTYPES[dtype]
    if family == "moe":
        cfg = moe_llama.MoeLlamaConfig.tiny(dim=256, n_heads=2, n_kv_heads=2,
                                            dtype=dt, top_k=2, remat=remat)
        params = moe_llama.init_params(cfg, torch.Generator().manual_seed(0),
                                       "cpu")
        inp, tgt = _tokens(cfg.vocab_size)
        return (lambda: moe_llama.loss_fn(cfg, params, inp, tgt),
                [x.requires_grad_(True) for _, x in flatten_with_names(params)])
    cfg = llama.LlamaConfig.tiny(dim=256, n_heads=2, n_kv_heads=1, dtype=dt,
                                 remat=remat)
    inp, tgt = _tokens(cfg.vocab_size)
    if family == "lora":
        base = lora_base(cfg, "cpu")
        lcfg = lora.LoraConfig(rank=4)
        ad = lora.init_lora(cfg, lcfg, torch.Generator().manual_seed(1), "cpu")
        for name in ("wq_b", "wv_b"):  # non-zero, so A's gradient is too
            ad["layers"]["attn"][name].normal_(
                generator=torch.Generator().manual_seed(2)).mul_(0.05)
        return (lambda: lora.lora_loss_fn(cfg, lcfg, base, ad, inp, tgt),
                [x.requires_grad_(True) for _, x in flatten_with_names(ad)])
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return (lambda: llama.loss_fn(cfg, params, inp, tgt),
            [x.requires_grad_(True) for _, x in flatten_with_names(params)])


def _loss_and_grads(family, dtype, remat):
    loss_fn, leaves = _model(family, dtype, remat)
    loss = loss_fn()
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("family", ["llama", "lora", "moe"])
def test_remat_is_bitwise_neutral(family, dtype):
    plain_loss, plain_grads = _loss_and_grads(family, dtype, remat=False)
    remat_loss, remat_grads = _loss_and_grads(family, dtype, remat=True)
    assert torch.equal(remat_loss, plain_loss)
    assert len(remat_grads) == len(plain_grads)
    for a, b in zip(remat_grads, plain_grads):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_attention_runs_twice_per_layer_under_remat(monkeypatch, remat):
    """The CPU's view of the card's launch count: each layer's attention
    runs once in the forward, and once more in the backward's replay."""
    calls = []
    real = llama.causal_attention
    monkeypatch.setattr(llama, "causal_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    loss_fn, leaves = _model("llama", "f32", remat)
    loss = loss_fn()
    assert len(calls) == 2
    torch.autograd.grad(loss, leaves)
    assert len(calls) == (4 if remat else 2)


def _saved_bytes(family, remat) -> int:
    loss_fn, _leaves = _model(family, "f32", remat)
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss_fn()
    return total[0]


@pytest.mark.parametrize("family", ["llama", "moe"])
def test_remat_keeps_far_fewer_activations(family):
    plain, remat = _saved_bytes(family, False), _saved_bytes(family, True)
    assert remat < plain / 2, (remat, plain)


@pytest.mark.parametrize("n_kv_heads", [1, 2])
def test_remat_loss_matches_jax_remat(n_kv_heads):
    kw = dict(dim=256, n_heads=2, n_kv_heads=n_kv_heads)
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, remat=True, **kw)
    pcfg = llama.LlamaConfig.tiny(dtype=torch.float32, remat=True, **kw)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    inp, tgt = _tokens(jcfg.vocab_size)
    want = float(jllama.loss_fn(jcfg, jparams, inp.numpy().astype(np.int32),
                                tgt.numpy().astype(np.int32)))
    got = float(llama.loss_fn(pcfg, params, inp, tgt))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_return_aux_stacks_each_layers_aux_and_is_neutral_under_remat():
    """An ``mlp_fn`` that runs the dense FFN and reports a per-layer aux:
    the trunk is llama's own, the aux comes back stacked in layer order,
    and remat changes neither."""
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    inp, _ = _tokens(cfg.vocab_size, S=16)

    def mlp_fn(layer_params, normed):
        return (llama._mlp_block(cfg, layer_params["mlp"], normed),
                layer_params["mlp"]["w_gate"].sum())

    want_hidden = llama.forward_hidden(cfg, params, inp)
    want_aux = torch.stack([w.sum() for w in
                            params["layers"]["mlp"]["w_gate"].unbind(0)])
    for remat in (False, True):
        hidden, aux = llama.forward_hidden(replace(cfg, remat=remat), params,
                                           inp, mlp_fn=mlp_fn,
                                           return_aux=True)
        assert torch.equal(hidden, want_hidden)
        assert torch.equal(aux, want_aux)


@pytest.mark.parametrize("family", ["lora", "moe"])
def test_remat_trainer_steps_equal_the_plain_trainer(family):
    def trainer(remat):
        if family == "lora":
            cfg = CONFIGS["lora"]["tiny"](remat=remat)
            return lora_trainer(cfg, lora.LoraConfig(rank=4), batch=2,
                                seq=128, device="cpu")
        return moe_trainer(CONFIGS["moe"]["tiny"](remat=remat), batch=2,
                           seq=128, device="cpu")

    assert trainer(True).run(3) == trainer(False).run(3)
