"""The agentlet's dump of a sharded state (each rank's own leg, described
by its leaves), against ``Trainer.snapshot`` and the JAX package.

One launch of four gloo CPU ranks runs every port case
(``torch_ranks.sharded_agentlet_cases``); the JAX package runs on the
test process's eight virtual CPU devices. The tiny llama (``dim=128,
n_layers=4, n_heads=8, n_kv_heads=4``, bf16) on a (1,2,2) mesh takes two
steps; then, with no ``shardings=`` passed anywhere:

- the port's node hook cuts each rank's ``Agentlet(lambda: tr.state)``
  into its own leg (process k of 4, ``data-h<k>.bin``), through the
  speculative pass (a hashed ``-spec`` leg) and the delta against it,
  a second cut's leg teed into a mirror and a third's over the wire
  into the JAX package's receiver; the legs and their merged
  view carry ``Trainer.snapshot``'s descriptor for every leaf, and the
  merged view its shards with the same bytes;
- a fresh (1,2,2) Trainer restores each rank's leg bitwise and continues
  bitwise, and the leg received over the wire bitwise; a (2,1,2) one restores the merged view byte for byte and
  continues within 1e-2 (the JAX Trainer's re-layout bound);
- the JAX package restores the merged view onto (2,2,2) and (4,1,2) byte
  for byte, and the JAX Trainer's (2,2,2) snapshot reloads into every
  rank through the hook's re-attach, byte for byte (``rng`` differs by
  design);
- a (2,1,2) state described by its leaves names its size-1 axis as the
  rule table does, and a DTensor that carries no sharding (a pending
  reduction, a foreign mesh, a detached copy) raises.
"""

from __future__ import annotations

import json
import os
import threading
import time
from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_ranks
from grit_tpu.agent.copy import StageJournal, WireReceiver
from grit_tpu.agent.copy import WireSender as RefSender
from grit_tpu.device import snapshot as jsnap
from grit_tpu.models import llama as jllama
from grit_tpu.parallel.mesh import MeshSpec, build_mesh
from grit_tpu.train import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from grit_tpu_torch.device import snapshot as psnap
from grit_tpu_torch.parallel.launch import run_ranks

CFG = dict(dim=128, n_layers=4, n_heads=8, n_kv_heads=4)
RELAYOUT_BOUND = 1e-2  # tests/test_trainer.py:80-96
N = 4


def _jcfg():
    return jllama.LlamaConfig.tiny(**CFG, dtype=jnp.bfloat16,
                                   param_dtype=jnp.bfloat16)


def _jax_mesh(shape):
    return build_mesh(MeshSpec(*shape), jax.devices()[:int(np.prod(shape))])


def _jax_trainer(mesh):
    cfg = _jcfg()

    def batch_fn(rng):
        toks = jax.random.randint(rng, (4, 17), 0, cfg.vocab_size)
        return toks[:, :-1], toks[:, 1:]

    return JaxTrainer(loss_fn=lambda p, b: jllama.loss_fn(cfg, p, *b),
                      init_params=partial(jllama.init_params, cfg),
                      batch_fn=batch_fn,
                      cfg=JaxConfig(learning_rate=1e-3,
                                    batch_spec=jllama.BATCH_SPEC),
                      mesh=mesh, rules=jllama.LLAMA_RULES)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _manifest(d: str) -> dict:
    with open(os.path.join(d, "MANIFEST.json")) as f:
        return json.load(f)


def _descriptors(d: str) -> dict:
    return {r["name"]: r["sharding"] for r in _manifest(d)["arrays"]}


def _leg(world, k: int, suffix: str = "") -> str:
    return os.path.join(world["work"], "legs", f"host-{k}", "hbm" + suffix)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(1.0, abs(b))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("sharded-agentlet"))
    cfg = _jcfg()
    params_np = jax.tree.map(np.asarray, jllama.init_params(
        jllama.LlamaConfig.tiny(**CFG, dtype=jnp.float32),
        jax.random.PRNGKey(0)))
    tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (4, 17), 0, cfg.vocab_size), np.int64)
    jax_parent = os.path.join(work, "jax")
    # The JAX writer on its Python plane (crc32 chunks).
    with mock.patch.object(jsnap, "_chunk_writer",
                           lambda path, durable: jsnap._PyChunkWriter(
                               path, durable)):
        jt = _jax_trainer(_jax_mesh((2, 2, 2)))
        jt.run(2)
        jt.snapshot(os.path.join(jax_parent, "hbm"))
    jax_state = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
                 jax.tree_util.tree_flatten_with_path(jt.state)[0]}
    wire_dst = os.path.join(work, "wire-dst")
    recv = WireReceiver(wire_dst, host="127.0.0.1",
                        journal=StageJournal(wire_dst))
    agent = RefSender(recv.endpoint, streams=1)  # dialled first, as the agent
    shipped: dict = {}
    shipper = threading.Thread(target=_ship_legs, args=(
        agent, recv, os.path.join(work, "wlegs"),
        os.path.join(work, "wire-received"), shipped))
    shipper.start()
    try:
        ranks = run_ranks(torch_ranks.sharded_agentlet_cases, N,
                          {"work": work, "cfg": CFG, "params": params_np,
                           "tokens": tokens, "jax_parent": jax_parent,
                           "wire_endpoint": recv.endpoint,
                           "wire_dst": wire_dst},
                          backend="gloo", timeout=600)
    finally:
        shipper.join(180)
        agent.close()
        recv.close()
    return {"work": work, "ranks": ranks, "jax_state": jax_state,
            "wire_dst": wire_dst, "shipped": shipped}


def _ship_legs(agent, recv, legs: str, done: str, shipped: dict) -> None:
    """The source agent's half of a wire migration of the ranks' legs:
    once every rank's dump has teed its data file, the rest of each
    ``host-<k>`` tree over the agent's own session, then the commit
    listing every file; the receiver's verdict goes to ``done``."""
    status = "ok"
    try:
        deadline = time.monotonic() + 300
        while not all(os.path.exists(os.path.join(legs, f"host-{k}.sent"))
                      for k in range(N)):
            if time.monotonic() > deadline:
                raise TimeoutError("the ranks' wire cuts did not finish")
            time.sleep(0.05)
        files: dict = {}
        for k in range(N):
            with open(os.path.join(legs, f"host-{k}.sent")) as f:
                files.update(json.load(f).get("files", {}))
        teed = dict(files)
        for k in range(N):
            top = os.path.join(legs, f"host-{k}")
            for root, _, names in os.walk(top):
                for name in sorted(names):
                    path = os.path.join(root, name)
                    rel = os.path.relpath(path, legs).replace(os.sep, "/")
                    if rel not in files:
                        files[rel] = agent.send_file(rel, path)
        agent.commit(files)
        recv.wait(timeout=60)
        shipped.update(teed=teed, files=files)
    except Exception as exc:  # noqa: BLE001 — the ranks and the test read it
        status = f"{type(exc).__name__}: {exc}"
        shipped["error"] = status
    with open(done + ".tmp", "w") as f:
        f.write(status)
    os.rename(done + ".tmp", done)


def test_the_hook_cut_every_rank_into_its_own_leg(world):
    for r in world["ranks"]:
        assert r["hook_errors"] == [] and r["foreign"] == []
    want = _descriptors(os.path.join(world["work"], "trainer-snap"))
    for k in range(N):
        m = _manifest(_leg(world, k))
        assert m["process_count"] == N and m["meta"]["step"] == 2
        assert {c["file"] for rec in m["arrays"] for c in rec["chunks"]} == {
            f"data-h{k:04d}.bin"}
        assert {r["name"]: r["sharding"] for r in m["arrays"]} == want


def test_merged_legs_match_trainer_snapshot(world):
    """The legs' merged view: the same descriptor for every leaf, the
    same distinct shards, the same bytes as ``Trainer.snapshot``."""
    trainer = os.path.join(world["work"], "trainer-snap")
    merged = os.path.join(world["work"], "merged")
    assert _descriptors(merged) == _descriptors(trainer)
    want = {r["name"]: sorted(map(str, (c["index"] for c in r["chunks"])))
            for r in _manifest(trainer)["arrays"]}
    got = {r["name"]: sorted(map(str, (c["index"] for c in r["chunks"])))
           for r in _manifest(merged)["arrays"]}
    assert got == want
    a = psnap.restore_snapshot(merged)
    b = psnap.restore_snapshot(trainer)
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_speculative_and_delta_dumps_on_dtensor_state(world):
    """The quiesce's speculative pass wrote each rank's hashed ``-spec``
    leg; the parked dump validated it (no step between) and references
    every chunk there: a delta that wrote no byte."""
    for k in range(N):
        spec = _manifest(_leg(world, k, psnap.SPEC_SUFFIX))
        assert spec["process_count"] == N
        assert all("sha256" in c for rec in spec["arrays"]
                   for c in rec["chunks"])
        m = _manifest(_leg(world, k))
        assert m["base"] == "../hbm" + psnap.SPEC_SUFFIX
        assert m["dirty"]["bytes"] == 0 and m["dirty"]["totalChunks"] > 0


def test_a_legs_mirror_is_committed_beside_it(world):
    """A cut with a mirror: each rank's tee commits the mirror of its own
    leg (its ``data-h<k>.bin`` and marker), the leg's manifest and bytes."""
    for k in range(N):
        leg = os.path.join(world["work"], "mlegs", f"host-{k}", "hbm")
        mirror = os.path.join(world["work"], "mlegs",
                              f"host-{k}-mirror", "hbm")
        data = f"data-h{k:04d}.bin"
        with open(os.path.join(mirror, "COMMIT")) as f:
            files = json.loads(f.read().splitlines()[1])["files"]
        assert data in files and "MANIFEST.json" in files
        assert _manifest(mirror) == _manifest(leg)
        with open(os.path.join(mirror, data), "rb") as a, \
                open(os.path.join(leg, data), "rb") as b:
            assert a.read() == b.read()


def test_a_legs_wire_tee_restores_bitwise_on_the_same_mesh(world):
    """A cut with a wire spec: each rank's dump tees its own
    ``data-h<k>.bin`` over the port's ``WireSender`` into the JAX
    package's ``WireReceiver``, the agent ships the rest of the tree; the
    received leg equals the rank's own, and a fresh (1,2,2) Trainer
    restores it bitwise."""
    assert "error" not in world["shipped"], world["shipped"]
    for k, r in enumerate(world["ranks"]):
        rel = f"host-{k}/hbm/data-h{k:04d}.bin"
        leg = os.path.join(world["work"], "wlegs", f"host-{k}", "hbm")
        size = os.path.getsize(os.path.join(leg, f"data-h{k:04d}.bin"))
        assert r["wire"]["ok"], r["wire"]
        assert r["wire"]["files"] == {rel: size} and size > 0
        assert world["shipped"]["teed"][rel] == size
        received = os.path.join(world["wire_dst"], f"host-{k}", "hbm")
        assert _manifest(received) == _manifest(leg)
        with open(os.path.join(received, f"data-h{k:04d}.bin"), "rb") as a, \
                open(os.path.join(leg, f"data-h{k:04d}.bin"), "rb") as b:
            assert a.read() == b.read()
        assert r["wire_step"] == 2
        assert r["wire_state"].keys() == r["cut_state"].keys()
        for name, (index, a) in r["wire_state"].items():
            want_index, b = r["cut_state"][name]
            assert index == want_index and np.array_equal(a, b), name


def test_a_leg_restores_bitwise_on_the_same_mesh(world):
    for r in world["ranks"]:
        assert r["leg_step"] == 2
        assert r["leg_after"] == r["source_after"]
        assert r["leg_state"].keys() == r["cut_state"].keys()
        for name, (index, a) in r["leg_state"].items():
            want_index, b = r["cut_state"][name]
            assert index == want_index and np.array_equal(a, b), name


def test_merged_legs_restore_onto_another_mesh(world):
    for r in world["ranks"]:
        for name, a in r["merged_full"].items():
            assert np.array_equal(a, r["cut_full"][name]), name
        for got, want in zip(r["merged_after"], r["source_after"]):
            assert _rel(got, want) < RELAYOUT_BOUND, (got, want)


@pytest.mark.parametrize("shape", [(2, 2, 2), (4, 1, 2)],
                         ids=["222", "412"])
def test_port_legs_restore_in_jax(world, shape):
    mesh = _jax_mesh(shape)
    jt = _jax_trainer(mesh)
    like = {k: v for k, v in jt._abstract.items() if k != "rng"}
    got = jsnap.restore_snapshot(os.path.join(world["work"], "merged"),
                                 like=like, mesh=mesh)
    want = world["ranks"][0]["cut_full"]
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(flat) == len(want) - 1
    for path, x in flat:
        name = jax.tree_util.keystr(path)
        assert np.array_equal(_bits(np.asarray(x)), want[name]), name


def test_jax_snapshot_reloads_through_the_agentlet(world):
    want = world["jax_state"]
    for r in world["ranks"]:
        got = r["reloaded"]
        assert set(got) == set(want) - {"['rng']"}
        for name, (index, a) in got.items():
            full = _bits(want[name])
            part = full if index is None else full[
                tuple(slice(s, e) for s, e in index)]
            assert np.array_equal(a, part), name


def test_derived_descriptors_name_size_one_axes(world):
    for r in world["ranks"]:
        assert r["leg212"] == r["shardings212"]
        wq = r["leg212"]["['params']['layers']['attn']['wq']"]
        assert wq["mesh_shape"] == [2, 1, 2]
        assert wq["spec"] == [None, "fsdp", "model"]  # fsdp has size 1
        assert r["wq_descriptor"] == _descriptors(_leg(world, 0))[
            "['params']['layers']['attn']['wq']"]


@pytest.mark.parametrize("key", ["partial", "foreign_mesh", "detached"])
def test_an_undescribable_dtensor_raises(world, key):
    for r in world["ranks"]:
        msg, written = r["undescribable"][key]
        assert msg.startswith("ValueError") and "cannot describe" in msg
        assert not written
