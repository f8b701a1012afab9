"""Expert parallelism in the port (``MOE_LLAMA_RULES``, ``moe_mlp(mesh=)``,
the sharded Trainer of the MoE llama) against dense and against the JAX
package.

One launch of four gloo CPU ranks runs every port case
(``torch_ranks.sharded_state_cases`` with ``moe``); the JAX package runs
on the test process's eight virtual CPU devices. The model is the tiny
MoE llama at ``dim=128, n_layers=4, n_heads=8, n_kv_heads=4`` with top-2
routing at ``capacity_factor=0.5``, where capacity binds: the plain,
global route drops tokens (checked beside the losses), so a port that
routed each batch shard alone would compute other drops. On the same
numpy weights (``convert``) and tokens:

- the (1,2,2) step's loss (two experts a rank, two batch rows a rank)
  equals the port's dense loss and the JAX package's dense and sharded
  losses within 1e-5 relative in f32 and 1e-3 in bf16;
- a sharded snapshot resumes bitwise on the same mesh; restored onto
  (2,1,2) and densely, its state is the source's at the cut byte for
  byte and its losses stay within 1e-2 (densely, for two steps: see the
  test);
- its manifest carries the JAX Trainer's descriptor for every leaf,
  ``w_in``'s ``[None, "model", "fsdp", None]`` included;
- a JAX (2,2,2) snapshot restores in the port on (1,2,2) and (2,1,2), and
  the port's (1,2,2) snapshot in the JAX package on (2,2,2) and (4,1,2),
  with byte-identical leaves.
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
from grit_tpu.models import moe_llama as jmoe
from grit_tpu.parallel.mesh import MeshSpec, build_mesh
from grit_tpu.parallel.sharding import shard_tree
from grit_tpu.train import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from grit_tpu_torch import convert
from grit_tpu_torch.device import snapshot as psnap
from grit_tpu_torch.models import moe_llama as pmoe
from grit_tpu_torch.ops import moe as pmoe_ops
from grit_tpu_torch.parallel.launch import run_ranks

CFG = dict(dim=128, n_layers=4, n_heads=8, n_kv_heads=4,
           capacity_factor=0.5, top_k=2)
BOUND = {"bf16": 1e-3, "f32": 1e-5}  # __graft_entry__.py:171-192
RELAYOUT_BOUND = 1e-2                 # tests/test_trainer.py:80-96
JAX_DTYPES = {"bf16": jnp.bfloat16, "f32": jnp.float32}
B, S = 4, 16


def _jcfg(label: str):
    dt = JAX_DTYPES[label]
    return jmoe.MoeLlamaConfig.tiny(**CFG, dtype=dt, param_dtype=dt)


def _jax_mesh(shape):
    n = int(np.prod(shape))
    return build_mesh(MeshSpec(*shape), jax.devices()[:n])


def _jax_trainer(mesh):
    cfg = _jcfg("bf16")

    def batch_fn(rng):
        toks = jax.random.randint(rng, (B, S + 1), 0, cfg.vocab_size)
        return toks[:, :-1], toks[:, 1:]

    return JaxTrainer(
        loss_fn=lambda p, b: jmoe.loss_fn(cfg, p, *b, mesh=mesh),
        init_params=partial(jmoe.init_params, cfg), batch_fn=batch_fn,
        cfg=JaxConfig(learning_rate=1e-3, batch_spec=jmoe.BATCH_SPEC),
        mesh=mesh, rules=jmoe.MOE_LLAMA_RULES)


def _jax_losses(params_np, tokens) -> dict:
    """The JAX package's loss on the numpy weights and tokens: sharded on
    a (1,2,2) mesh by its rule table and batch spec (its loss given the
    mesh), and dense."""
    from jax.sharding import NamedSharding  # noqa: PLC0415

    out = {}
    mesh = _jax_mesh((1, 2, 2))
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    batch = NamedSharding(mesh, jmoe.BATCH_SPEC)
    for label, dt in JAX_DTYPES.items():
        cfg = _jcfg(label)
        params = jax.tree.map(lambda a: jnp.asarray(a, dt), params_np)
        sharded = jax.jit(lambda p, i, t: jmoe.loss_fn(cfg, p, i, t,
                                                       mesh=mesh))
        dense = jax.jit(lambda p, i, t: jmoe.loss_fn(cfg, p, i, t))
        out[label] = {
            "sharded": float(sharded(shard_tree(params, mesh,
                                                jmoe.MOE_LLAMA_RULES),
                                     jax.device_put(inp, batch),
                                     jax.device_put(tgt, batch))),
            "dense": float(dense(params, inp, tgt))}
    return out


def _drops(params_np, tokens) -> list[int]:
    """Routed slots the port's plain (global) route drops in each layer of
    the dense f32 forward on the test's weights and tokens."""
    cfg = pmoe.MoeLlamaConfig.tiny(**CFG, dtype=torch.float32)
    params = convert.params_from_jax(params_np)
    drops = []
    route = pmoe_ops.route

    def counting(topk_idx, gates, mask_f, *args, **kw):
        dispatch, combine, onehot0 = route(topk_idx, gates, mask_f, *args,
                                           **kw)
        drops.append(int(mask_f.sum()) * topk_idx.shape[1]
                     - int(dispatch.sum()))
        return dispatch, combine, onehot0

    with mock.patch.object(pmoe_ops, "route", counting), torch.no_grad():
        pmoe.forward(cfg, params, torch.from_numpy(tokens[:, :-1]))
    return drops


def _state_np(state) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(state)[0]}


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _descriptors(d: str) -> dict:
    with open(os.path.join(d, "MANIFEST.json")) as f:
        return {rec["name"]: rec["sharding"] for rec in json.load(f)["arrays"]}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(1.0, abs(b))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX side's inputs and snapshots, then the ranks' one launch."""
    work = str(tmp_path_factory.mktemp("moe-mesh"))
    params_np = jax.tree.map(np.asarray, jmoe.init_params(
        _jcfg("f32"), jax.random.PRNGKey(0)))
    tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (B, S + 1), 0, _jcfg("f32").vocab_size),
        np.int64)
    jax_dirs, jax_states = {}, {}
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
                       "tokens": tokens, "jax_dir": jax_dirs["222"],
                       "moe": True},
                      backend="gloo", timeout=600)
    return {"work": work, "ranks": ranks, "jax_dirs": jax_dirs,
            "jax_states": jax_states, "params": params_np,
            "tokens": tokens, "jax_losses": _jax_losses(params_np, tokens)}


def test_capacity_binds(world):
    """The plain route over the whole batch drops routed slots in every
    layer: the parity below is of the global drops, not of a batch that
    fits."""
    drops = _drops(world["params"], world["tokens"])
    assert len(drops) == CFG["n_layers"]
    assert all(d > 0 for d in drops), drops


@pytest.mark.parametrize("label", ["bf16", "f32"])
def test_sharded_moe_loss_matches_dense_and_jax(world, label):
    """The (1,2,2) step's loss on every rank is the port's dense loss and
    the JAX package's dense and sharded losses, within the dryrun's
    bounds. After one Adam update the f32 losses still agree; bf16's first
    update moves the weights by the sign of gradients that bf16 rounding
    can flip, and a binding capacity then drops other tokens, so only the
    first bf16 step is held to the bound."""
    ranks = world["ranks"]
    got = ranks[0][label]
    assert all(r[label] == got for r in ranks)  # every rank's loss alike
    steps = got["sharded"] if label == "f32" else got["sharded"][:1]
    for sharded, dense in zip(steps, got["dense"]):
        assert _rel(sharded, dense) < BOUND[label], (sharded, dense)
    jl = world["jax_losses"][label]
    assert _rel(got["sharded"][0], jl["sharded"]) < BOUND[label], jl
    assert _rel(got["sharded"][0], jl["dense"]) < BOUND[label], jl
    assert _rel(jl["sharded"], jl["dense"]) < BOUND[label], jl
    assert all(r["foreign"] == [] for r in ranks)


def test_sharded_moe_resume_is_bitwise(world):
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


@pytest.mark.parametrize("key", ["212", "dense"])
def test_sharded_moe_restores_onto_another_layout(world, key):
    """The restored state is the source's at the cut, leaf for leaf and
    byte for byte, and its losses stay within the re-layout bound: every
    step on (2,1,2), whose expert layer runs as (1,2,2)'s does; the first
    two densely. The dense bf16 step then drifts from the sharded one
    (1.07e-2 at the third step with these weights): its attention and
    experts sum in another order, bf16 Adam moves each weight by the sign
    of its gradient, and at a binding capacity a flipped route drops other
    tokens."""
    full = world["ranks"][0]["port_full"]
    steps = 3 if key == "212" else 2
    for r in world["ranks"]:
        cut = r["resumed"][key]["cut"]
        assert cut.keys() == full.keys()
        for name, a in cut.items():
            assert a.dtype == full[name].dtype, name
            assert np.array_equal(a, full[name]), (key, name)
        pairs = list(zip(r["resumed"][key]["losses"], r["source_after"]))
        assert len(pairs) == 3
        for got, want in pairs[:steps]:
            assert _rel(got, want) < RELAYOUT_BOUND, (key, got, want)


def test_moe_manifest_descriptors_are_jax_trainers(world):
    """Every leaf's descriptor is the one the JAX Trainer writes for it on
    the same mesh, and every array's chunks cover it once."""
    d = os.path.join(world["work"], "port-snap")
    manifest = psnap.SnapshotManifest.load(d)
    assert manifest.process_count == 4
    for rec in manifest.arrays:
        cells = np.zeros(rec["shape"], np.int32)
        for c in rec["chunks"]:
            cells[tuple(slice(a, b) for a, b in c["index"])] += 1
        assert (cells == 1).all(), rec["name"]
    jax_desc = _descriptors(world["jax_dirs"]["122"])
    port_desc = _descriptors(d)
    assert port_desc.keys() == jax_desc.keys()
    for name, desc in port_desc.items():
        if name != "['rng']":  # rng's shape differs by design
            assert desc == jax_desc[name], name
    moe = "['params']['layers']['moe']"
    assert port_desc[f"{moe}['w_in']"]["spec"] == [None, "model", "fsdp", None]
    assert port_desc[f"{moe}['w_out']"]["spec"] == [None, "model", None, "fsdp"]
    assert port_desc[f"{moe}['router']"]["spec"] == [None, None, None]


@pytest.mark.parametrize("key", ["122", "212"])
def test_jax_moe_snapshot_restores_onto_a_port_mesh(world, key):
    want = world["jax_states"]["222"]
    for r in world["ranks"]:
        got = r["jax_restored"][key]
        assert set(got) == set(want) - {"['rng']"}
        for name, (index, a) in got.items():
            full = _bits(want[name])
            part = full if index is None else full[
                tuple(slice(s, e) for s, e in index)]
            assert a.dtype == part.dtype and np.array_equal(a, part), name


@pytest.mark.parametrize("shape", [(2, 2, 2), (4, 1, 2)],
                         ids=["222", "412"])
def test_port_moe_snapshot_restores_in_jax(world, shape):
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
    w_in = got["params"]["layers"]["moe"]["w_in"]
    assert len({str(s.index) for s in w_in.addressable_shards}) == (
        shape[1] * shape[2])  # distinct shards: model x fsdp
