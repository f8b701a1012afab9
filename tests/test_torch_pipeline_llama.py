"""The port's pipelined llama (``grit_tpu_torch/models/pipeline_llama.py``
and ``moe_llama.forward_pp``) against the JAX package's: converted
weights and the same numpy tokens, the port on four gloo CPU ranks (and
on two-rank groups), each rank holding its stage's layers. Logits
against JAX's ``forward_pp`` and the dense forward at 2e-4, the loss at
1e-5 relative and every gradient (each rank's stage, and the replicated
embedding, final norm and head, the same on every rank) at 5e-4, with
remat off and on (as ``tests/test_pipeline_llama.py``); an SGD loop; the
pipelined MoE against the dense JAX MoE model, forward and gradients;
the stage reshape's round trip; and a dense snapshot run by the
pipelined job."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from grit_tpu.models import llama as jllama
from grit_tpu.models import moe_llama as jmoe
from grit_tpu.models import pipeline_llama as jpp
from grit_tpu.parallel.pipeline import PIPE_AXIS
from grit_tpu_torch import convert
from grit_tpu_torch.device.snapshot import write_snapshot
from grit_tpu_torch.models import llama, pipeline_llama
from grit_tpu_torch.parallel.launch import run_ranks
from grit_tpu_torch.tree import flatten_with_names
from tests import torch_ranks

JCFG = dataclasses.replace(jllama.LlamaConfig.tiny(n_layers=4),
                           dtype=jnp.float32)
PCFG = dataclasses.replace(llama.LlamaConfig.tiny(n_layers=4),
                           dtype=torch.float32)
# Non-binding capacity: the pipeline routes per microbatch, the dense
# model per batch, so parity needs no dropped token (forward_pp's note).
JMCFG = dataclasses.replace(jmoe.MoeLlamaConfig.tiny(n_layers=4),
                            dtype=jnp.float32, capacity_factor=4.0)
TOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 5e-4
AXES = [("world", (0, 1, 2, 3)), ("pair", (0, 1)), ("pair", (2, 3))]


def toks(batch=4, seq=16, seed=1):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size,
                                                (batch, seq), dtype=np.int32)


def pipe_mesh(n: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:n]), (PIPE_AXIS,))


def named(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, jllama.init_params(JCFG, jax.random.key(0)))


@pytest.fixture(scope="module")
def case(jparams, tmp_path_factory):
    dense_dir = str(tmp_path_factory.mktemp("pp") / "dense")
    write_snapshot(dense_dir, convert.params_from_jax(jparams))
    moe = jax.tree.map(np.asarray, jmoe.init_params(JMCFG, jax.random.key(0)))
    inp = {"params": jparams, "tokens": toks(), "inp": toks(), "tgt": toks(seed=2),
           "train_params": jax.tree.map(np.asarray, jllama.init_params(
               JCFG, jax.random.key(3))),
           "moe_params": moe, "moe_tgt": toks(seed=7), "dense_dir": dense_dir}
    return inp, run_ranks(torch_ranks.pipeline_llama_cases, 4, inp,
                          backend="gloo")


def test_ranks_import_nothing_of_jax(case):
    assert all(r["foreign"] == [] for r in case[1])


def test_stage_reshape_roundtrip(jparams):
    params = convert.params_from_jax(jparams)
    staged = pipeline_llama.to_stage_params(PCFG, params, 2)
    want = named(jpp.to_stage_params(JCFG, jparams, 2))
    got = dict(flatten_with_names(staged))
    assert got.keys() == want.keys()
    for name, a in got.items():
        np.testing.assert_array_equal(a.numpy(), want[name], err_msg=name)
    back = pipeline_llama.from_stage_params(staged)
    for (name, a), (_, b) in zip(flatten_with_names(back),
                                 flatten_with_names(params)):
        assert torch.equal(a, b), name
    local = pipeline_llama.stage_slice(staged, 1)
    assert torch.equal(local["layers"]["attn"]["wq"],
                       params["layers"]["attn"]["wq"][2:])
    assert local["tok_emb"] is params["tok_emb"]
    with pytest.raises(ValueError):
        pipeline_llama.to_stage_params(PCFG, params, 3)  # 4 % 3 != 0


@pytest.fixture(scope="module")
def jax_forward_pp(case):
    """JAX's pipelined logits by (stages, microbatches), computed once."""
    inp, cache = case[0], {}

    def get(n_stages: int, n_mb: int) -> np.ndarray:
        if (n_stages, n_mb) not in cache:
            mesh = pipe_mesh(n_stages)
            staged = jpp.to_stage_params(JCFG, inp["params"], n_stages)
            cache[n_stages, n_mb] = np.asarray(jax.jit(
                lambda p, t: jpp.forward_pp(JCFG, p, t, mesh=mesh,
                                            n_microbatches=n_mb))(
                staged, inp["tokens"]))
        return cache[n_stages, n_mb]

    return get


@pytest.mark.parametrize("n_mb", [1, 2, 4])
@pytest.mark.parametrize("axis,members", AXES)
def test_forward_matches_jax(case, jparams, jax_forward_pp, axis, members,
                             n_mb):
    inp, ranks = case
    want = jax_forward_pp(len(members), n_mb)
    dense = np.asarray(jllama.forward(JCFG, jparams, inp["tokens"]))
    for r in members:
        got = ranks[r][axis]["forward"][n_mb]
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, dense, rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def dense_grads(case, jparams):
    inp = case[0]
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jllama.loss_fn(
        JCFG, p, inp["inp"], inp["tgt"])))(jparams)
    return float(loss), grads


def _check_stage_grads(got: dict, want_dense, n_stages: int, stage: int,
                       cfg) -> None:
    """``got``: one rank's gradients of its stage slice, against the
    matching slice of the dense gradients."""
    want = named(jpp.to_stage_params(cfg, want_dense, n_stages))
    assert got.keys() == want.keys()
    for name, g in got.items():
        w = want[name][stage] if name.startswith("['layers']") else want[name]
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"stage {stage} {name}")


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("n_mb", [1, 2])
@pytest.mark.parametrize("axis,members", AXES)
def test_gradients_match_dense(case, dense_grads, axis, members, n_mb, remat):
    want_loss, want = dense_grads
    ranks = case[1]
    key = f"{n_mb}-remat={remat}"
    for stage, r in enumerate(members):
        loss, got = ranks[r][axis]["grads"][key]
        assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
        _check_stage_grads(got, want, len(members), stage, JCFG)
        # The replicated leaves' gradients are the same on every rank.
        first = ranks[members[0]][axis]["grads"][key][1]
        for name in ("['tok_emb']", "['final_norm']", "['lm_head']"):
            np.testing.assert_array_equal(got[name], first[name])


def test_gradients_match_jax_loss_fn_pp(case, dense_grads):
    """The port's gradients against the JAX pipeline's own (2 stages, 2
    microbatches, as tests/test_pipeline_llama.py), whose loss is the
    dense one."""
    inp = case[0]
    staged = jpp.to_stage_params(JCFG, inp["params"], 2)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jpp.loss_fn_pp(
        JCFG, p, inp["inp"], inp["tgt"], mesh=pipe_mesh(2),
        n_microbatches=2)))(staged)
    ranks = case[1]
    want = named(grads)
    for stage in (0, 1):
        _, got = ranks[stage]["pair"]["grads"]["2-remat=False"]
        for name, g in got.items():
            w = want[name][stage] if name.startswith("['layers']") else want[name]
            np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=name)
    assert abs(float(loss) - dense_grads[0]) <= LOSS_RTOL * abs(dense_grads[0])


def test_training_step_reduces_loss(case):
    losses = case[1][0]["pair"]["train"]
    assert losses[-1] < losses[0], losses
    assert all(r["pair"]["train"] == losses for r in case[1][1:])


def test_pipelined_moe_matches_dense(case):
    """moe_llama.forward_pp on four stages against the dense JAX MoE
    model: logits, and the gradients of its cross-entropy."""
    inp, ranks = case
    params = inp["moe_params"]
    dense = np.asarray(jmoe.forward(JMCFG, params, inp["tokens"]))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jllama.token_cross_entropy(
        jmoe.forward(JMCFG, p, inp["tokens"]), inp["moe_tgt"])))(params)
    for stage in range(4):
        logits, got_loss, got = ranks[stage]["world"]["moe"]
        np.testing.assert_allclose(logits, dense, rtol=TOL, atol=TOL)
        assert abs(got_loss - float(loss)) <= LOSS_RTOL * abs(float(loss))
        _check_stage_grads(got, grads, 4, stage, JMCFG)


def test_dense_snapshot_runs_on_the_pipelined_job(case, jparams):
    inp, ranks = case
    dense = np.asarray(jllama.forward(JCFG, jparams, inp["tokens"]))
    for r in range(4):
        np.testing.assert_allclose(ranks[r]["world"]["restored"], dense,
                                   rtol=TOL, atol=TOL)
