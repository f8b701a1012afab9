"""pp × ep in the port: the pipelined MoE with each stage's experts split
over ``expert`` (``moe_llama.forward_pp(mesh=)``), a pipe mesh's shards
past the stage dim, and a pp × ep snapshot, against the JAX package.

One launch of four gloo CPU ranks on a (pipe 2, expert 2) mesh
(``parallel.mesh.build_pipe_mesh(expert=2)``) runs every port case
(``torch_ranks.pp_ep_cases``); the JAX package runs on the test
process's virtual CPU devices, on its own (pipe 2, expert 2) mesh, the
JAX test's (``tests/test_pipeline_llama.py:118``). On the same numpy
weights (``convert``) of the tiny MoE llama (4 layers, f32, capacity
factor = experts, so nothing drops):

- the pipelined forward's logits equal the JAX package's pp + ep
  forward's and the dense forward's within the JAX test's 2e-4, and each
  rank's cross-entropy gradients are its shard of the dense gradients;
- every rank holds of each staged leaf the slice JAX's
  ``pp_stage_shardings`` assigns its device;
- ``distribute``, ``zeros``, ``held_shape`` and ``global_shape`` agree
  for ``P("pipe")``, ``P("pipe", None, "expert")`` and ``P()`` on (pipe,
  expert) and on (data 1, pipe, expert), and one replica writes each
  distinct shard;
- the four ranks' snapshot is one manifest whose descriptors equal the
  JAX package's; every rank restores its shards bitwise; a dense restore
  through ``from_stage_params`` gives the MoE tree byte for byte; the
  JAX package's pp × ep snapshot restores in the port and the port's in
  the JAX package, byte-identical.

``chip_smoke.py``'s phase 16 pp × ep leg is rehearsed at the end, on
four more CPU ranks at a tiny f32 width.
"""

from __future__ import annotations

import dataclasses
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
from grit_tpu_torch.device import snapshot as psnap
from grit_tpu_torch.models import moe_llama as pmoe
from grit_tpu_torch.models import pipeline_llama as ppp
from grit_tpu_torch.parallel.launch import run_ranks
from grit_tpu_torch.tree import flatten_with_names

N = 4
CFG = dict(n_layers=4, capacity_factor=4.0)  # tiny's 4 experts: no drops
MICRO = 2
BOUND = 2e-4       # tests/test_pipeline_llama.py:140
GRAD_BOUND = 1e-4  # relative L2, f32


def _pcfg():
    return dataclasses.replace(pmoe.MoeLlamaConfig.tiny(**CFG),
                               dtype=torch.float32, param_dtype=torch.float32)


def _jcfg():
    return jmoe.MoeLlamaConfig.tiny(**CFG, dtype=jnp.float32)


LEAVES = [n for n, _ in flatten_with_names(ppp.to_stage_params(
    _pcfg(), pmoe.init_params(_pcfg(), None, "meta"), 2))]


def _named(tree) -> dict:
    return {jax.tree_util.keystr(p): x
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _descriptor(sharding) -> dict:
    return jsnap._sharding_descriptor(types.SimpleNamespace(
        sharding=sharding))


def _manifest(d: str) -> psnap.SnapshotManifest:
    return psnap.SnapshotManifest.load(d)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("pp-ep"))
    cfg = _jcfg()
    params = jmoe.init_params(cfg, jax.random.key(0))
    params_np = jax.tree.map(np.asarray, params)
    tokens = np.asarray(jax.random.randint(
        jax.random.key(1), (4, 17), 0, cfg.vocab_size), np.int64)
    inp, tgt = jnp.asarray(tokens[:, :-1]), jnp.asarray(tokens[:, 1:])
    mesh = Mesh(np.array(jax.devices()[:N]).reshape(2, 2),
                ("pipe", "expert"))
    staged = jpp.to_stage_params(cfg, params, 2)
    shardings = jmoe.pp_stage_shardings(mesh, staged)
    placed = jax.device_put(staged, shardings)
    pp_logits = np.asarray(jax.jit(lambda p, t: jmoe.forward_pp(
        cfg, p, t, mesh=mesh, n_microbatches=MICRO))(placed, inp))
    dense_logits = np.asarray(jmoe.forward(cfg, params, inp))
    grads = jax.grad(lambda p: jllama.token_cross_entropy(
        jmoe.forward(cfg, p, inp), tgt))(params)
    jax_dir = os.path.join(work, "jax-pp-ep")
    with mock.patch.object(jsnap, "_chunk_writer",
                           lambda path, durable: jsnap._PyChunkWriter(
                               path, durable)):
        jsnap.write_snapshot(jax_dir, placed, meta={"step": 1})
    ranks = run_ranks(torch_ranks.pp_ep_cases, N,
                      {"work": work, "cfg": CFG, "params": params_np,
                       "tokens": tokens, "n_microbatches": MICRO,
                       "jax_dir": jax_dir},
                      backend="gloo", timeout=600)
    return {
        "work": work, "ranks": ranks, "mesh": mesh, "placed": placed,
        "params": _named(params_np),
        "staged": _named(jax.tree.map(np.asarray, staged)),
        "jax_shards": {n: {s.device.id: s.index for s in x.addressable_shards}
                       for n, x in _named(placed).items()},
        "jax_descriptors": {n: _descriptor(s)
                            for n, s in _named(shardings).items()},
        "pp_logits": pp_logits, "dense_logits": dense_logits,
        "dense_grads": _named(jax.tree.map(np.asarray, jpp.to_stage_params(
            cfg, grads, 2))),
        "jax_dir": jax_dir, "port_dir": os.path.join(work, "pp-ep-snap")}


def _slice(full: np.ndarray, index) -> np.ndarray:
    return full[tuple(slice(a, b) for a, b in index)]


def _held(world, name: str, rank: int) -> np.ndarray:
    """What rank ``rank`` should hold of the staged leaf ``name``: the
    slice JAX assigns its device, the stage dim dropped."""
    index = world["jax_shards"][name][jax.devices()[rank].id]
    part = world["staged"][name][index]
    return part[0] if "['layers']" in name else part


def test_mesh_is_pipe_by_expert(world):
    for r in world["ranks"]:
        assert r["foreign"] == []
        assert r["mesh"] == {"names": ["pipe", "expert"], "shape": [2, 2],
                             "coord": [r["rank"] // 2, r["rank"] % 2]}


def test_forward_pp_matches_jax_and_dense(world):
    for r in world["ranks"]:
        np.testing.assert_allclose(r["logits"], world["pp_logits"],
                                   rtol=BOUND, atol=BOUND)
        np.testing.assert_allclose(r["logits"], world["dense_logits"],
                                   rtol=BOUND, atol=BOUND)
    assert all(np.array_equal(r["logits"], world["ranks"][0]["logits"])
               for r in world["ranks"])


@pytest.mark.parametrize("name", LEAVES)
def test_gradients_are_the_dense_gradients_shard(world, name):
    for r in world["ranks"]:
        got = r["grads"][name]
        index = world["jax_shards"][name][jax.devices()[r["rank"]].id]
        want = world["dense_grads"][name][index]
        want = want[0] if "['layers']" in name else want
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err < GRAD_BOUND, (name, r["rank"], err)


@pytest.mark.parametrize("name", LEAVES)
def test_each_rank_holds_the_jax_slice(world, name):
    for r in world["ranks"]:
        assert np.array_equal(r["held"][name], _held(world, name, r["rank"]))


@pytest.mark.parametrize("spec", list(torch_ranks.PIPE_SPECS))
@pytest.mark.parametrize("mesh", ["pipe_expert", "data_pipe_expert"])
def test_shard_layouts_agree(world, mesh, spec):
    """distribute, zeros (real and meta), held_shape and global_shape
    agree on a rank's shard; the shards tile the array; one replica
    writes each distinct shard."""
    full = np.arange(np.prod(torch_ranks.PIPE_SHAPE), dtype=np.int32
                     ).reshape(torch_ranks.PIPE_SHAPE)
    stage = spec != "replicated"
    writers: dict = {}
    for r in world["ranks"]:
        got = r["layouts"][mesh][spec]
        part = _slice(full, got["index"])
        want = part[0] if stage else part
        assert np.array_equal(got["held"], want)
        shape = list(want.shape)
        assert got["zeros"] == got["zeros_meta"] == got["held_shape"] == shape
        assert got["global_shape"] == list(torch_ranks.PIPE_SHAPE)
        key = str(got["index"])
        writers[key] = writers.get(key, 0) + bool(got["writes"])
    assert all(v == 1 for v in writers.values()), writers
    split = {"stage": 2, "stage_expert": 4, "replicated": 1}[spec]
    assert len(writers) == split


def test_descriptors_equal_the_jax_packages(world):
    want = world["jax_descriptors"]
    for r in world["ranks"]:
        assert r["descriptors"] == want
    on_disk = {rec["name"]: rec["sharding"]
               for rec in _manifest(world["port_dir"]).arrays}
    assert on_disk == want
    assert want["['layers']['moe']['w_in']"]["spec"] == ["pipe", None,
                                                         "expert"]


def test_one_manifest_each_shard_once(world):
    """Four ranks' chunks in one manifest, covering every array once:
    each (stage, expert) shard of an expert weight, each stage of the
    other layer leaves, and the replicated leaves, one chunk each."""
    m = _manifest(world["port_dir"])
    assert m.process_count == N and m.meta["step"] == 1
    for rec in m.arrays:
        cells = np.zeros(rec["shape"], np.int32)
        for c in rec["chunks"]:
            cells[tuple(slice(a, b) for a, b in c["index"])] += 1
        assert (cells == 1).all(), rec["name"]
        n = {"w_in": 4, "w_out": 4}.get(rec["name"].split("'")[-2],
                                         2 if "['layers']" in rec["name"]
                                         else 1)
        assert len(rec["chunks"]) == n, rec["name"]


def test_port_snapshot_restores_bitwise_onto_the_mesh(world):
    for r in world["ranks"]:
        assert r["restored"].keys() == r["held"].keys()
        for name, a in r["restored"].items():
            assert np.array_equal(a, r["held"][name]), name


def test_dense_restore_gives_the_moe_tree(world):
    cfg = _pcfg()
    like = ppp.to_stage_params(cfg, pmoe.init_params(cfg, None, "meta"), 2)
    got = ppp.from_stage_params(psnap.restore_snapshot(
        world["port_dir"], like=like, device="cpu"))
    named = dict(flatten_with_names(got))
    assert named.keys() == world["params"].keys()
    for name, x in named.items():
        assert np.array_equal(x.numpy(), world["params"][name]), name


@pytest.mark.parametrize("name", LEAVES)
def test_jax_snapshot_restores_in_the_port(world, name):
    for r in world["ranks"]:
        assert np.array_equal(r["jax_restored"][name],
                              _held(world, name, r["rank"]))


@pytest.mark.parametrize("name", LEAVES)
def test_port_snapshot_restores_in_jax(world, name):
    got = _named(jsnap.restore_snapshot(world["port_dir"],
                                        like=world["placed"],
                                        mesh=world["mesh"]))
    x = got[name]
    assert np.array_equal(np.asarray(x), world["staged"][name])
    want_spec = _named(world["placed"])[name].sharding.spec
    assert P(*x.sharding.spec) == P(*want_spec), name


def test_chip_smoke_pp_ep_leg_rehearsal(tmp_path):
    """Phase 16's pp × ep leg (``chip_smoke.pp_ep_leg``) in phase 15 and
    16's four-rank launch at a tiny f32 width: logits and gradients held
    to the dense reference the ``moe`` leg computes, one manifest of the
    staged shards, each rank's restore onto (pipe 2, expert 2) bitwise,
    rank 0's dense restore byte for byte; a planted fault (one expert
    shard swapped between ranks) must make the leg's check raise."""
    import chip_smoke  # noqa: PLC0415
    from grit_tpu_torch.models import llama as pllama  # noqa: PLC0415

    tiny = dict(dim=128, n_heads=8, n_kv_heads=4, dtype=torch.float32,
                vocab_size=32000)
    lc = pllama.LlamaConfig.tiny(n_layers=4, max_seq_len=512, **tiny)
    mcfg = pmoe.MoeLlamaConfig.tiny(n_layers=4, top_k=2, **tiny)
    kw = dict(device="cpu", lc_cfg=lc, lc_seq=256, pp_cfg=lc,
              pp_shape=(4, 64), moe_pp_cfg=mcfg, moe_pp_shape=(8, 32))
    _lc, pp = chip_smoke.phase_parallel(torch, str(tmp_path / "ok"), "cpu",
                                        seed=0, **kw)
    got = pp["pp_ep"]
    assert got["mesh"] == {"pipe": 2, "expert": 2}
    assert got["logit_err"] <= got["logit_bound"]
    assert got["worst_grad_rel_l2"] <= chip_smoke.PAR_GRAD_BOUND
    assert got["restore_bitwise"] and got["dense_restore_bitwise"]
    with pytest.raises(AssertionError, match="pp_ep"):
        chip_smoke.phase_parallel(torch, str(tmp_path / "bad"), "cpu",
                                  seed=0, pp_ep_fault="swap_expert", **kw)
