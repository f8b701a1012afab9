"""The pipe axis in the port (``stage_sharding``, ``stage_shardings``,
``pp_stage_shardings``, a pipelined Trainer on a pipe mesh) against the
JAX package.

One launch of four gloo CPU ranks, one stage a rank, runs every port
case (``torch_ranks.stage_sharding_cases``); the JAX package runs on the
test process's virtual CPU devices. On the tiny llama (``dim=128,
n_layers=4, n_heads=8, n_kv_heads=4``, f32, one layer a stage):

- ``stage_shardings`` on a four-stage pipe mesh and the MoE's
  ``pp_stage_shardings`` on a (pipe 2, expert 2) mesh give the JAX
  package's descriptor for every leaf;
- a pipelined Trainer (``STAGE_RULES``, the JAX test's table) writes one
  manifest: each layer leaf at its staged (4, 1, ...) shape, rank ``s``
  writing stage ``s``'s chunk, the embedding, final norm and ``lm_head``
  once; its descriptors are the JAX pipelined Trainer's;
- a fresh pipelined Trainer restores it and continues bitwise (the JAX
  test ``test_pipelined_training_job_migrates``'s property);
- the snapshot's staged arrays, through ``from_stage_params``, give a
  dense model whose loss is the pipeline's at the cut (1e-5 relative);
- the JAX pipelined Trainer's snapshot restores in the port, each rank
  its stage, and the port's in the JAX Trainer, byte for byte (``rng``
  differs by design).
"""

from __future__ import annotations

import json
import os
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_ranks
from grit_tpu.device import snapshot as jsnap
from grit_tpu.models import llama as jllama
from grit_tpu.models import moe_llama as jmoe
from grit_tpu.models import pipeline_llama as jpp
from grit_tpu.parallel.pipeline import PIPE_AXIS
from grit_tpu.parallel.sharding import ShardingRules as JaxRules
from grit_tpu.train import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from grit_tpu_torch.device import snapshot as psnap
from grit_tpu_torch.models import llama as pllama
from grit_tpu_torch.models import pipeline_llama as ppp
from grit_tpu_torch.parallel.launch import run_ranks

CFG = dict(dim=128, n_layers=4, n_heads=8, n_kv_heads=4)
N = 4
BOUND = 1e-5  # f32 (__graft_entry__.py:171-192)


def _jcfg():
    return jllama.LlamaConfig.tiny(**CFG, dtype=jnp.float32)


def _descriptor(sharding) -> dict:
    return jsnap._sharding_descriptor(types.SimpleNamespace(
        sharding=sharding))


def _named(tree) -> dict:
    return {jax.tree_util.keystr(p): x
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _manifest(d: str) -> dict:
    with open(os.path.join(d, "MANIFEST.json")) as f:
        return json.load(f)


def _jax_trainer(mesh, tokens):
    cfg = _jcfg()

    def init_staged(key):
        return jpp.to_stage_params(cfg, jllama.init_params(cfg, key), N)

    return JaxTrainer(
        loss_fn=lambda p, b: jpp.loss_fn_pp(
            cfg, p, b[0], b[1], mesh=mesh, n_microbatches=2),
        init_params=init_staged,
        batch_fn=lambda _rng: (tokens[:, :-1], tokens[:, 1:]),
        cfg=JaxConfig(learning_rate=1e-2), mesh=mesh,
        rules=JaxRules(rules=[(r"layers/", P(PIPE_AXIS))]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("stage-sharding"))
    cfg = _jcfg()
    params = jax.tree.map(np.asarray, jllama.init_params(
        cfg, jax.random.PRNGKey(0)))
    tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (4, 17), 0, cfg.vocab_size), np.int64)
    mesh = Mesh(np.array(jax.devices()[:N]), (PIPE_AXIS,))
    jax_dir = os.path.join(work, "jax-pipe")
    with mock.patch.object(jsnap, "_chunk_writer",
                           lambda path, durable: jsnap._PyChunkWriter(
                               path, durable)):
        jt = _jax_trainer(mesh, jnp.asarray(tokens))
        jt.run(2)
        jt.snapshot(jax_dir)
    staged = jpp.to_stage_params(cfg, params, N)
    mcfg = jmoe.MoeLlamaConfig.tiny(**CFG, dtype=jnp.float32)
    mstaged = jpp.to_stage_params(
        mcfg, jmoe.init_params(mcfg, jax.random.PRNGKey(2)), 2)
    ppe = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("pipe", "expert"))
    ranks = run_ranks(torch_ranks.stage_sharding_cases, N,
                      {"work": work, "cfg": CFG, "params": params,
                       "tokens": tokens, "jax_dir": jax_dir},
                      backend="gloo", timeout=600)
    return {
        "work": work, "ranks": ranks, "mesh": mesh, "tokens": tokens,
        "jax_dir": jax_dir, "jax_state": _named(jax.tree.map(np.asarray,
                                                             jt.state)),
        "jax_trainer": jt,
        "stage_shardings": {n: _descriptor(s) for n, s in _named(
            jpp.stage_shardings(mesh, staged)).items()},
        "pp_stage_shardings": {n: _descriptor(s) for n, s in _named(
            jmoe.pp_stage_shardings(ppe, mstaged)).items()}}


@pytest.mark.parametrize("fn", ["stage_shardings", "pp_stage_shardings"])
def test_stage_descriptors_are_the_jax_packages(world, fn):
    want = world[fn]
    for r in world["ranks"]:
        assert r["foreign"] == []
        assert r[fn] == want
    if fn == "pp_stage_shardings":
        w_in = want["['layers']['moe']['w_in']"]
        assert w_in["spec"] == ["pipe", None, "expert"]


def test_a_pipelined_trainer_writes_one_manifest(world):
    m = _manifest(os.path.join(world["work"], "pipe-snap"))
    assert m["process_count"] == N and m["meta"]["step"] == 2
    jax_desc = {r["name"]: r["sharding"]
                for r in _manifest(world["jax_dir"])["arrays"]}
    names = set()
    for rec in m["arrays"]:
        name = rec["name"]
        names.add(name)
        if name != "['rng']":
            assert rec["sharding"] == jax_desc[name], name
        if "['layers']" in name:
            assert rec["shape"][:2] == [N, 1], name
            assert sorted((c["index"][0], c["file"]) for c in rec["chunks"]
                          ) == [([s, s + 1], f"data-h{s:04d}.bin")
                                for s in range(N)], name
        else:
            assert [c["file"] for c in rec["chunks"]] == ["data-h0000.bin"]
    assert names == set(jax_desc)


def test_pipelined_resume_is_bitwise(world):
    for r in world["ranks"]:
        assert r["restored_step"] == 2
        assert r["restored_after"] == r["source_after"]
        for name, (index, a) in r["restored_state"].items():
            want_index, b = r["cut_state"][name]
            assert index == want_index and np.array_equal(a, b), name


def test_pipe_manifest_restores_into_a_dense_model(world):
    """The staged arrays are the ranks' stages, and from_stage_params of
    them is a dense model with the pipeline's loss at the cut."""
    got = psnap.restore_snapshot(os.path.join(world["work"], "pipe-snap"))
    ranks = world["ranks"]
    for name, x in got.items():
        if not name.startswith("['params']"):
            continue
        if "['layers']" in name:
            for s, r in enumerate(ranks):
                assert np.array_equal(x[s].numpy(), r["cut_state"][name][1])
        else:
            assert np.array_equal(x.numpy(), ranks[0]["cut_state"][name][1])
    cfg = pllama.LlamaConfig.tiny(**CFG, dtype=torch.float32)
    like = {"params": ppp.to_stage_params(cfg, pllama.abstract_params(cfg),
                                          N)}
    staged = psnap.restore_snapshot(os.path.join(world["work"], "pipe-snap"),
                                    like=like, device="cpu")["params"]
    dense = ppp.from_stage_params(staged)
    toks = torch.from_numpy(world["tokens"])
    with torch.no_grad():
        loss = float(pllama.loss_fn(cfg, dense, toks[:, :-1], toks[:, 1:]))
    want = ranks[0]["source_after"][0]  # step 3's loss: the cut's params
    assert abs(loss - want) / abs(want) < BOUND, (loss, want)


def test_jax_pipelined_snapshot_restores_in_the_port(world):
    want = world["jax_state"]
    for s, r in enumerate(world["ranks"]):
        got = r["jax_restored"]
        assert set(got) == set(want) - {"['rng']"}
        for name, a in got.items():
            part = want[name][s] if "['layers']" in name else want[name]
            assert np.array_equal(a, part), name


def test_port_pipe_manifest_restores_in_jax(world):
    jt = world["jax_trainer"]
    like = {k: v for k, v in jt._abstract.items() if k != "rng"}
    got = jsnap.restore_snapshot(os.path.join(world["work"], "pipe-snap"),
                                 like=like, mesh=world["mesh"])
    ranks = world["ranks"]
    for name, x in _named(got).items():
        if "['layers']" in name:
            want = np.stack([r["cut_state"][name][1] for r in ranks])
        else:
            want = ranks[0]["cut_state"][name][1]
        assert np.array_equal(np.asarray(x), want), name
        if "['layers']" in name:
            assert x.sharding.spec == P(PIPE_AXIS), name
