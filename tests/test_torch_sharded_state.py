"""Sharded state in the port (the Trainer's ``mesh=``/``rules=``, the
snapshot's ``named`` descriptors and per-shard chunks) against dense and
against the JAX package.

One launch of four gloo CPU ranks runs every port case
(``torch_ranks.sharded_state_cases``); the JAX package runs on the test
process's eight virtual CPU devices. On the same numpy weights
(``convert``) and tokens:

- the tiny llama's (1,2,2) step (``dim=128, n_layers=4, n_heads=8,
  n_kv_heads=4``, as ``__graft_entry__.dryrun_multichip``) equals the
  port's dense step and the JAX package's sharded loss within 1e-3
  relative in bf16 and 1e-5 in f32, the dryrun's bounds;
- a sharded snapshot resumes bitwise on the same mesh (from a delta of
  the same cut too, which writes no byte), and within 1e-2 on (2,1,2) and
  densely (the JAX test's bound for a restore onto another mesh);
- a snapshot the JAX Trainer writes on a (2,2,2) mesh restores in the
  port on (1,2,2), (2,1,2) and densely with byte-identical leaves (bf16
  params and Adam moments), and the port's four-rank snapshot restores
  in the JAX package onto (2,2,2) and (4,1,2), byte-identical; ``rng``
  differs by design (ROADMAP North star);
- both packages' manifests carry the same descriptor for every leaf.
"""

from __future__ import annotations

import json
import os
from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_ranks
from grit_tpu.device import snapshot as jsnap
from grit_tpu.models import llama as jllama
from grit_tpu.parallel.mesh import MeshSpec, build_mesh
from grit_tpu.parallel.sharding import shard_tree
from grit_tpu.train import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from grit_tpu_torch.device import snapshot as psnap
from grit_tpu_torch.models import llama as pllama
from grit_tpu_torch.parallel.launch import run_ranks
from grit_tpu_torch.train.trainer import Trainer, TrainerConfig
from grit_tpu_torch.tree import flatten_with_names

CFG = dict(dim=128, n_layers=4, n_heads=8, n_kv_heads=4)
BOUND = {"bf16": 1e-3, "f32": 1e-5}  # __graft_entry__.py:171-192
RELAYOUT_BOUND = 1e-2                 # tests/test_trainer.py:80-96
JAX_DTYPES = {"bf16": jnp.bfloat16, "f32": jnp.float32}


def _jcfg(label: str):
    dt = JAX_DTYPES[label]
    return jllama.LlamaConfig.tiny(**CFG, dtype=dt, param_dtype=dt)


def _jax_trainer(mesh):
    cfg = _jcfg("bf16")

    def batch_fn(rng):
        toks = jax.random.randint(rng, (4, 17), 0, cfg.vocab_size)
        return toks[:, :-1], toks[:, 1:]

    return JaxTrainer(loss_fn=lambda p, b: jllama.loss_fn(cfg, p, *b),
                      init_params=partial(jllama.init_params, cfg),
                      batch_fn=batch_fn,
                      cfg=JaxConfig(learning_rate=1e-3,
                                    batch_spec=jllama.BATCH_SPEC),
                      mesh=mesh, rules=jllama.LLAMA_RULES)


def _jax_mesh(shape):
    n = int(np.prod(shape))
    return build_mesh(MeshSpec(*shape), jax.devices()[:n])


def _jax_losses(params_np, tokens) -> dict:
    """The JAX package's loss on the numpy weights and tokens: sharded on
    a (1,2,2) mesh by its rule table and batch spec, and dense."""
    from jax.sharding import NamedSharding  # noqa: PLC0415

    out = {}
    mesh = _jax_mesh((1, 2, 2))
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    for label, dt in JAX_DTYPES.items():
        cfg = _jcfg(label)
        params = jax.tree.map(lambda a: jnp.asarray(a, dt), params_np)
        fn = jax.jit(lambda p, i, t: jllama.loss_fn(cfg, p, i, t))
        batch = NamedSharding(mesh, jllama.BATCH_SPEC)
        out[label] = {
            "sharded": float(fn(shard_tree(params, mesh, jllama.LLAMA_RULES),
                                jax.device_put(inp, batch),
                                jax.device_put(tgt, batch))),
            "dense": float(fn(params, inp, tgt))}
    return out


def _state_np(state) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(state)[0]}


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _descriptors(d: str) -> dict:
    with open(os.path.join(d, "MANIFEST.json")) as f:
        return {rec["name"]: rec["sharding"] for rec in json.load(f)["arrays"]}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX side's inputs and snapshots, then the ranks' one launch."""
    work = str(tmp_path_factory.mktemp("sharded"))
    params_np = jax.tree.map(np.asarray, jllama.init_params(
        _jcfg("f32"), jax.random.PRNGKey(0)))
    tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (4, 17), 0, _jcfg("f32").vocab_size), np.int64)
    jax_dirs = {}
    jax_states = {}
    # The JAX writer on its Python plane (crc32 chunks; its native plane
    # writes crc32c).
    with mock.patch.object(jsnap, "_chunk_writer",
                           lambda path, durable: jsnap._PyChunkWriter(
                               path, durable)):
        for key, shape in (("222", (2, 2, 2)), ("122", (1, 2, 2))):
            jt = _jax_trainer(_jax_mesh(shape))
            jt.run(2)
            jax_dirs[key] = os.path.join(work, f"jax-{key}")
            jt.snapshot(jax_dirs[key])
            jax_states[key] = _state_np(jt.state)
    ranks = run_ranks(torch_ranks.sharded_state_cases, 4,
                      {"work": work, "cfg": CFG, "params": params_np,
                       "tokens": tokens, "jax_dir": jax_dirs["222"]},
                      backend="gloo", timeout=600)
    return {"work": work, "ranks": ranks, "jax_dirs": jax_dirs,
            "jax_states": jax_states,
            "jax_losses": _jax_losses(params_np, tokens)}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(1.0, abs(b))


@pytest.mark.parametrize("label", ["bf16", "f32"])
def test_sharded_step_matches_dense_and_jax(world, label):
    ranks = world["ranks"]
    got = ranks[0][label]
    assert all(r[label] == got for r in ranks)  # every rank's loss alike
    for sharded, dense in zip(got["sharded"], got["dense"]):
        assert _rel(sharded, dense) < BOUND[label], (sharded, dense)
    jl = world["jax_losses"][label]
    assert _rel(got["sharded"][0], jl["sharded"]) < BOUND[label], jl
    assert _rel(jl["sharded"], jl["dense"]) < BOUND[label], jl
    assert all(r["foreign"] == [] for r in ranks)


def test_sharded_resume_is_bitwise(world):
    for r in world["ranks"]:
        for key in ("same", "delta"):
            got = r["resumed"][key]
            assert got["step"] == 3
            assert got["losses"] == r["source_after"], key
            assert got["state"].keys() == r["source_state"].keys()
            for name, (index, a) in got["state"].items():
                want_index, b = r["source_state"][name]
                assert index == want_index and a.dtype == b.dtype
                assert np.array_equal(a, b), (key, name)


def test_delta_of_the_same_cut_writes_nothing(world):
    dirty = world["ranks"][0]["delta_dirty"]
    assert dirty["bytes"] == 0 and dirty["chunks"] == 0
    assert dirty["totalChunks"] > 0


@pytest.mark.parametrize("key", ["212", "dense"])
def test_restore_onto_another_layout(world, key):
    for r in world["ranks"]:
        for got, want in zip(r["resumed"][key]["losses"], r["source_after"]):
            assert _rel(got, want) < RELAYOUT_BOUND, (key, got, want)


def test_manifest_records_named_shards(world):
    """Every array's chunks cover it exactly once (one chunk per distinct
    shard), the bytes sum to the state's, and each descriptor is the one
    the JAX Trainer writes for the same leaf on the same mesh."""
    d = os.path.join(world["work"], "port-snap")
    manifest = psnap.SnapshotManifest.load(d)
    assert manifest.process_count == 4
    full = world["ranks"][0]["port_full"]
    total = 0
    for rec in manifest.arrays:
        shape = rec["shape"]
        cells = np.zeros(shape, np.int32)
        for c in rec["chunks"]:
            cells[tuple(slice(a, b) for a, b in c["index"])] += 1
            total += c["nbytes"]
        assert (cells == 1).all(), rec["name"]
        assert rec["sharding"]["type"] == "named"
        assert rec["sharding"]["mesh_shape"] == [1, 2, 2]
    assert total == sum(a.nbytes for a in full.values())
    jax_desc = _descriptors(world["jax_dirs"]["122"])
    port_desc = _descriptors(d)
    assert port_desc.keys() == jax_desc.keys()
    for name, desc in port_desc.items():
        if name != "['rng']":  # rng's shape differs by design
            assert desc == jax_desc[name], name
    wq = port_desc["['params']['layers']['attn']['wq']"]
    assert wq["spec"] == [None, "fsdp", "model"]


@pytest.mark.parametrize("key", ["122", "212"])
def test_jax_snapshot_restores_onto_a_port_mesh(world, key):
    want = world["jax_states"]["222"]
    for r in world["ranks"]:
        got = r["jax_restored"][key]
        assert set(got) == set(want) - {"['rng']"}
        for name, (index, a) in got.items():
            full = _bits(want[name])
            part = full if index is None else full[
                tuple(slice(s, e) for s, e in index)]
            assert a.dtype == part.dtype and np.array_equal(a, part), name


def _dense_port_trainer():
    cfg = pllama.LlamaConfig.tiny(**CFG, dtype=torch.bfloat16,
                                  param_dtype=torch.bfloat16)
    return Trainer(loss_fn=lambda p, b: pllama.loss_fn(cfg, p, *b),
                   init_params=lambda _gen, device: pllama.abstract_params(cfg),
                   batch_fn=lambda _gen: None,
                   cfg=TrainerConfig(learning_rate=1e-3), device="cpu")


def test_jax_snapshot_restores_densely_in_the_port(world):
    like = _dense_port_trainer().abstract_state()
    like.pop("rng")
    got = psnap.restore_snapshot(world["jax_dirs"]["222"], like=like,
                                 device="cpu")
    want = world["jax_states"]["222"]
    for name, t in flatten_with_names(got):
        a = torch_ranks._local_np(t)
        assert np.array_equal(a, _bits(want[name])), name


@pytest.mark.parametrize("shape", [(2, 2, 2), (4, 1, 2)],
                         ids=["222", "412"])
def test_port_snapshot_restores_in_jax(world, shape):
    """The port's four-rank snapshot into the JAX Trainer on another mesh,
    its recorded descriptors re-realised there, byte for byte."""
    mesh = _jax_mesh(shape)
    jt = _jax_trainer(mesh)
    like = {k: v for k, v in jt._abstract.items() if k != "rng"}
    got = jsnap.restore_snapshot(os.path.join(world["work"], "port-snap"),
                                 like=like, mesh=mesh)
    want = world["ranks"][0]["port_full"]
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(flat) == len(want) - 1
    for path, x in flat:
        name = jax.tree_util.keystr(path)
        assert np.array_equal(_bits(np.asarray(x)), want[name]), name
        if x.ndim:
            assert x.sharding.mesh.devices.shape == shape, name
    wq = got["params"]["layers"]["attn"]["wq"]
    assert len({str(s.index) for s in wq.addressable_shards}) == (
        shape[1] * shape[2])  # distinct shards: fsdp x model
