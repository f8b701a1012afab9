"""Sharded serving grids in the port (``KV_CACHE_RULES`` and both engines'
``mesh=``) against one device and against the JAX package.

One launch of four gloo CPU ranks runs every port case
(``torch_ranks.serving_mesh_cases``); the JAX package runs on the test
process's eight virtual CPU devices. Both families, the tiny llama and
the tiny MoE llama (top-2 at ``capacity_factor=1.0``, so decode steps
drop), at ``dim=128, n_layers=4, n_heads=8, n_kv_heads=4`` in f32, on the
same numpy weights and prompts:

- both engines on (1,2,2) (two slots and half the kv heads a rank) emit
  the single-device port engine's tokens, greedy and sampled at
  temperature 1.0, and the JAX engines' greedy tokens;
- a (1,2,2) grid snapshot taken mid-flight restores onto (1,2,2) and
  continues bitwise (tokens and every rank's shards of the written cache
  pages), and onto
  (1,1,4) (a quarter of the heads a rank) and one device with the
  source's tokens;
- grid snapshots cross-restore with the JAX package both ways with
  byte-identical cache leaves: JAX's (2,2,2) grid onto the port's (1,2,2),
  and the port's (1,2,2) grid onto JAX's (2,2,2); each continues with the
  writer's greedy tokens, as does JAX's grid state carried over as numpy
  (``convert.serving_state_from_jax(shardings=)``);
- both engines' snapshots carry the JAX engines' descriptors;
- ``restore_postcopy`` onto a mesh continues as the blocking restore
  does (tokens and the written cache's shards bitwise).
"""

from __future__ import annotations

import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

import torch_ranks
from grit_tpu.device import snapshot as jsnap
from grit_tpu.models import llama as jllama
from grit_tpu.models import moe_llama as jmoe
from grit_tpu.models import serving as jserving
from grit_tpu.parallel.mesh import MeshSpec, build_mesh
from grit_tpu_torch.parallel.launch import run_ranks

CFG = {"dense": dict(dim=128, n_layers=4, n_heads=8, n_kv_heads=4),
       "moe": dict(dim=128, n_layers=4, n_heads=8, n_kv_heads=4,
                   capacity_factor=1.0, top_k=2)}
MAX_LEN = 64
ROUNDS, CUT = 8, 4
FAMILIES = ["dense", "moe"]


def _jcfg(fam: str):
    kind = jmoe.MoeLlamaConfig if fam == "moe" else jllama.LlamaConfig
    return kind.tiny(**CFG[fam], dtype=jnp.float32)


def _jax_mesh(shape):
    n = int(np.prod(shape))
    return build_mesh(MeshSpec(*shape), jax.devices()[:n])


def _bcfg():
    return jserving.BatchingConfig(n_slots=4, max_seq_len=MAX_LEN,
                                   temperature=0.0, seed=7,
                                   prefill_buckets=(16, 32))


def _drive(eng, prompts, rounds: int) -> list[dict]:
    """The rank function's script (``torch_ranks._drive``) on a JAX
    engine."""
    out = []
    for p in prompts[:2]:
        eng.submit(jnp.asarray(p))
    for r in range(rounds):
        if r == 1:
            for p in prompts[2:]:
                eng.submit(jnp.asarray(p))
        out.append(eng.step())
    return out


def _state_tree(state) -> dict:
    return jax.tree.map(np.asarray, state)


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
    """The JAX engines' tokens and grid snapshots, then the ranks' one
    launch."""
    work = str(tmp_path_factory.mktemp("serving-mesh"))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 9, 3, 12)]
    batch_prompt = rng.integers(0, 256, (4, 6)).astype(np.int32)
    params, jax_tokens, jax_dirs, jax_states = {}, {}, {}, {}
    with mock.patch.object(jsnap, "_chunk_writer",
                           lambda path, durable: jsnap._PyChunkWriter(
                               path, durable)):
        for fam in FAMILIES:
            jcfg = _jcfg(fam)
            family = jmoe if fam == "moe" else jllama
            jp = family.init_params(jcfg, jax.random.PRNGKey(0))
            params[fam] = jax.tree.map(np.asarray, jp)
            solo = jserving.ContinuousBatchingEngine(jcfg, jp, _bcfg())
            lock = jserving.InferenceEngine(
                jcfg, jp, jserving.ServingConfig(batch_size=4,
                                                 max_seq_len=MAX_LEN,
                                                 seed=7))
            first = lock.prefill(jnp.asarray(batch_prompt))
            jax_tokens[fam] = {
                "grid": _drive(solo, prompts, ROUNDS),
                "lockstep": np.concatenate(
                    [np.asarray(first), np.asarray(lock.generate(ROUNDS))],
                    1).tolist()}
            src = jserving.ContinuousBatchingEngine(
                jcfg, jp, _bcfg(), mesh=_jax_mesh((2, 2, 2)))
            _drive(src, prompts, CUT)
            jax_dirs[fam] = os.path.join(work, f"jax-grid-{fam}")
            src.snapshot(jax_dirs[fam])
            jax_states[fam] = _state_tree(src.snapshot_state())
            jax_tokens[fam]["after_cut"] = [src.step()
                                            for _ in range(ROUNDS - CUT)]
    ranks = run_ranks(torch_ranks.serving_mesh_cases, 4,
                      {"work": work, "cfg": CFG, "params": params,
                       "prompts": prompts, "batch_prompt": batch_prompt,
                       "max_len": MAX_LEN, "rounds": ROUNDS, "cut": CUT,
                       "jax_dirs": jax_dirs, "jax_states": jax_states},
                      backend="gloo", timeout=600)
    return {"work": work, "ranks": ranks, "params": params,
            "jax_tokens": jax_tokens, "jax_dirs": jax_dirs,
            "jax_states": {fam: {jax.tree_util.keystr(p): x for p, x in
                                 jax.tree_util.tree_flatten_with_path(t)[0]}
                           for fam, t in jax_states.items()}}


@pytest.mark.parametrize("fam", FAMILIES)
@pytest.mark.parametrize("label", ["greedy", "sampled"])
def test_grid_on_a_mesh_emits_the_single_device_tokens(world, fam, label):
    ranks = world["ranks"]
    got = ranks[0][fam][label]
    assert all(r[fam][label] == got for r in ranks)  # every rank alike
    assert got["mesh"] == got["solo"]
    assert sum(len(r) for r in got["mesh"]) >= 20
    if label == "greedy":
        assert got["mesh"] == world["jax_tokens"][fam]["grid"]
    assert all(r["foreign"] == [] for r in ranks)


@pytest.mark.parametrize("fam", FAMILIES)
@pytest.mark.parametrize("label", ["greedy", "sampled"])
def test_lockstep_engine_on_a_mesh_emits_the_single_device_tokens(
        world, fam, label):
    ranks = world["ranks"]
    got = ranks[0][fam][f"lockstep_{label}"]
    assert all(r[fam][f"lockstep_{label}"] == got for r in ranks)
    assert got["mesh"] == got["solo"]
    assert len(got["mesh"]) == 4 and len(got["mesh"][0]) == ROUNDS + 1
    if label == "greedy":
        assert got["mesh"] == world["jax_tokens"][fam]["lockstep"]


@pytest.mark.parametrize("fam", FAMILIES)
def test_grid_restores_bitwise_on_its_own_mesh(world, fam):
    for r in world["ranks"]:
        res = r[fam]
        assert res["122"]["after"] == res["source"]["after"]
        for name, (index, a) in res["122"]["cache"].items():
            want_index, b = res["source"]["cache"][name]
            assert index == want_index and np.array_equal(a, b), name


@pytest.mark.parametrize("fam", FAMILIES)
@pytest.mark.parametrize("key", ["114", "dense"])
def test_grid_restores_onto_another_layout(world, fam, key):
    """A snapshot of two slots and two kv heads a rank continues on a
    quarter of the heads a rank, and on one device, with the source's
    greedy tokens."""
    for r in world["ranks"]:
        res = r[fam]
        assert res[key]["after"] == res["source"]["after"], key
    assert len(world["ranks"][0][fam]["source"]["after"]) == ROUNDS - CUT


@pytest.mark.parametrize("fam", FAMILIES)
def test_jax_grid_snapshot_restores_onto_a_port_mesh(world, fam):
    """The JAX (2,2,2) grid's leaves land byte for byte in the port's
    (1,2,2) shards, and the port continues with JAX's greedy tokens."""
    want = world["jax_states"][fam]
    for r in world["ranks"]:
        got = r[fam]["jax_restored"]
        assert set(got) == set(want)
        for name, (index, a) in got.items():
            full = _bits(want[name])
            part = full if index is None else full[
                tuple(slice(s, e) for s, e in index)]
            assert a.dtype == part.dtype and np.array_equal(a, part), name
        assert r[fam]["jax_after"] == world["jax_tokens"][fam]["after_cut"]


@pytest.mark.parametrize("fam", FAMILIES)
def test_jax_grid_state_converts_onto_a_port_mesh(world, fam):
    """``convert.serving_state_from_jax(shardings=)``: the JAX (2,2,2)
    grid's state as numpy, each rank keeping its shards, continues with
    JAX's greedy tokens."""
    for r in world["ranks"]:
        got = r[fam]["jax_converted_after"]
        assert got == world["jax_tokens"][fam]["after_cut"]


@pytest.mark.parametrize("fam", FAMILIES)
def test_port_grid_snapshot_restores_in_jax(world, fam):
    """The port's (1,2,2) grid onto the JAX package's (2,2,2) mesh: every
    leaf byte for byte, the cache sharded there, and JAX continues with
    the port's greedy tokens."""
    jp = jax.tree.map(jnp.asarray, world["params"][fam])
    dst = jserving.ContinuousBatchingEngine(_jcfg(fam), jp, _bcfg(),
                                            mesh=_jax_mesh((2, 2, 2)))
    dst.restore(os.path.join(world["work"], f"port-grid-{fam}"))
    want = world["ranks"][0][fam]["port_full"]
    got = _state_np(dst.state)
    assert got.keys() == want.keys()
    for name, a in got.items():
        assert np.array_equal(_bits(a), _bits(want[name])), name
    assert not dst.state["cache"]["k"].sharding.is_fully_replicated
    after = [dst.step() for _ in range(ROUNDS - CUT)]
    assert after == world["ranks"][0][fam]["source"]["after"]


@pytest.mark.parametrize("fam", FAMILIES)
def test_grid_descriptors_are_jax_engines(world, fam):
    """Every leaf of the port's (1,2,2) grid snapshot carries the
    descriptor the JAX engine writes on a (data, fsdp, model) mesh: the
    cache ``[None, ["data", "fsdp"], None, "model", None]``, the rest
    replicated (``[]``)."""
    port = _descriptors(os.path.join(world["work"], f"port-grid-{fam}"))
    jax_desc = _descriptors(world["jax_dirs"][fam])
    assert port.keys() == jax_desc.keys()
    for name, desc in port.items():
        want = dict(jax_desc[name], mesh_shape=[1, 2, 2])
        assert desc == want, name
    assert port["['cache']['k']"]["spec"] == [None, ["data", "fsdp"], None,
                                              "model", None]


def test_postcopy_onto_a_mesh_raises(world):
    """Post-copy onto a mesh no longer raises (the test keeps the name it
    had while it did): the grid restored by post-copy holds the blocking
    restore's cache and continues with its tokens."""
    for r in world["ranks"]:
        for fam in FAMILIES:
            got, want = r[fam]["postcopy"], r[fam]["122"]
            assert got["after"] == want["after"]
            for name, (index, a) in got["cache"].items():
                want_index, b = want["cache"][name]
                assert index == want_index and np.array_equal(a, b), name
