"""Eight ranks in the port: the (2,2,2) mesh, the dp × pp × ep step and
sequence parallelism over eight processes, against the JAX package.

One launch of eight gloo CPU ranks (``torch_ranks.mesh8_cases``) runs
every port case; the JAX package runs on the test process's eight
virtual CPU devices. On the same numpy weights (``convert``):

- (a) the tiny llama's (2,2,2) step (``dim=128, n_layers=4, n_heads=8,
  n_kv_heads=4``, as ``__graft_entry__.dryrun_multichip``) equals the
  port's dense step and the JAX package's (2,2,2) loss within 1e-3
  relative in bf16 and 1e-5 in f32; its snapshot resumes bitwise on
  (2,2,2), carries the JAX Trainer's descriptors, and cross-restores
  with the JAX Trainer's (2,2,2) snapshot byte for byte;
- (b) the dryrun's dp × pp × ep step on (data 2, pipe 2, expert 2), on
  the weights and rows of ``_dryrun_pipeline_moe``'s own keys, equals
  the JAX package's ``pipeline_loss`` on its 8-device mesh within 1e-6
  relative, its gradients and SGD update within f32 noise; a mask that
  leaves the two data shards 1 and 2 rows of a microbatch gives the
  global mean over the kept rows, not a mean of the shards' means, and
  a dense stage through the same loss gets each data shard's part of its
  gradient, whose sum over ``data`` is the unsharded one;
- the pipe layouts of the three specs agree on (data 2, pipe 2, expert 2);
- (c) the ring and Ulysses ``forward_sp`` over the eight ranks equal the
  JAX package's dense and sequence-parallel logits within 1e-4.

``chip_smoke.py``'s phase 21 is rehearsed at the end, on eight more CPU
ranks at a tiny width.
"""

from __future__ import annotations

import dataclasses
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
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_ranks
from grit_tpu.device import snapshot as jsnap
from grit_tpu.models import llama as jllama
from grit_tpu.models import long_context as jlc
from grit_tpu.ops.moe import init_moe_params, moe_mlp
from grit_tpu.parallel.mesh import MeshSpec, build_mesh
from grit_tpu.parallel.pipeline import microbatch, pipeline_loss, stack_stage_params
from grit_tpu.parallel.sharding import shard_tree
from grit_tpu.train import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from grit_tpu_torch.parallel.launch import run_ranks

N = 8
CFG = dict(dim=128, n_layers=4, n_heads=8, n_kv_heads=4)
BOUND = {"bf16": 1e-3, "f32": 1e-5}  # __graft_entry__.py:171-192
PP_BOUND = 1e-6                      # __graft_entry__.py:306-312
SP_BOUND = 1e-4                      # __graft_entry__.py:349-354
GRAD_BOUND = 1e-5                    # relative L2, f32 reduction order
JAX_DTYPES = {"bf16": jnp.bfloat16, "f32": jnp.float32}
N_MB, DIM, HIDDEN, EXPERTS = 4, 128, 256, 8
# Kept rows of each microbatch of 4 (rows 0-1 on data shard 0, 2-3 on 1):
# the shards hold 1 and 2, 2 and 1, 2 and 2, 0 and 2 kept rows.
PP_MASK = np.array([[1, 0, 1, 1], [1, 1, 0, 1], [1, 1, 1, 1], [0, 0, 1, 1]],
                   bool)


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


def _stage(params, x):
    y, _aux = moe_mlp(params, x, top_k=2)
    return x + y


def _mse(pred, target):
    return jnp.mean((pred - target) ** 2)


def _pipeline_moe():
    """The JAX side of ``_dryrun_pipeline_moe`` on eight devices, with its
    keys: the stacked weights and rows, the sharded step's loss and
    gradients, and the dense composition's masked global mean and its
    gradients."""
    devices = jax.devices()[:N]
    mesh = Mesh(np.array(devices).reshape(2, 2, 2), ("data", "pipe", "expert"))
    keys = jax.random.split(jax.random.key(0), 2)
    stacked = stack_stage_params([init_moe_params(k, DIM, HIDDEN, EXPERTS)
                                  for k in keys])
    placed = jax.device_put(stacked, {
        "router": NamedSharding(mesh, P("pipe")),
        "w_in": NamedSharding(mesh, P("pipe", "expert")),
        "w_out": NamedSharding(mesh, P("pipe", "expert"))})
    x = jax.random.normal(jax.random.key(1), (N_MB * 4, DIM))
    x_mb = jax.device_put(microbatch(x, N_MB),
                          NamedSharding(mesh, P(None, "data")))
    y_mb = jax.device_put(microbatch(0.5 * x, N_MB),
                          NamedSharding(mesh, P(None, "data")))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: pipeline_loss(
        _stage, _mse, p, x_mb, y_mb, mesh=mesh)))(placed)

    def masked(p):
        per, rows_all = [], []
        for i in range(N_MB):
            h = microbatch(x, N_MB)[i]
            for s in range(2):
                h = _stage(jax.tree.map(lambda a, s=s: a[s], p), h)
            rows = jnp.mean((h - microbatch(0.5 * x, N_MB)[i]) ** 2, axis=-1)
            keep = jnp.asarray(PP_MASK[i])
            per.append(jnp.sum(jnp.where(keep, rows, 0)) / keep.sum())
            rows_all.append(rows)
        return jnp.mean(jnp.stack(per)), jnp.stack(rows_all)

    (m_loss, rows), m_grads = jax.value_and_grad(masked, has_aux=True)(
        stacked)
    rows = np.asarray(rows)
    # What averaging each data shard's own mean would give instead.
    halves = [(r[k:k + 2] * m[k:k + 2]).sum() / max(m[k:k + 2].sum(), 1)
              for r, m in zip(rows, PP_MASK) for k in (0, 2)]
    np_ = partial(jax.tree.map, np.asarray)
    return {"stacked": np_(stacked), "x": np.asarray(x),
            "loss": float(loss), "grads": np_(grads),
            "masked_loss": float(m_loss), "masked_grads": np_(m_grads),
            "global_mean": float(np.mean([(r * m).sum() / m.sum() for r, m
                                          in zip(rows, PP_MASK)])),
            "mean_of_means": float(np.mean(halves))}


def _seq_parallel():
    """The JAX side of ``_dryrun_seq_parallel`` on eight devices, with its
    keys: the weights, tokens, dense logits and each scheme's logits."""
    mesh = Mesh(np.array(jax.devices()[:N]), (jlc.SEQ_AXIS,))
    cfg = dataclasses.replace(
        jllama.LlamaConfig.tiny(max_seq_len=max(16 * N, 128), n_heads=N,
                                n_kv_heads=N), dtype=jnp.float32)
    params = jllama.init_params(cfg, jax.random.key(2))
    tokens = jax.random.randint(jax.random.key(3), (1, 16 * N), 0,
                                cfg.vocab_size)
    out = {"params": jax.tree.map(np.asarray, params),
           "tokens": np.asarray(tokens, np.int64),
           "dense": np.asarray(jllama.forward(cfg, params, tokens))}
    for impl in ("ring", "ulysses"):
        out[impl] = np.asarray(jax.jit(lambda p, t, impl=impl: jlc.forward_sp(
            cfg, p, t, mesh=mesh, attn_impl=impl))(params, tokens))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("mesh8"))
    params_np = jax.tree.map(np.asarray, jllama.init_params(
        _jcfg("f32"), jax.random.PRNGKey(0)))
    tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (4, 17), 0, _jcfg("f32").vocab_size), np.int64)
    mesh = build_mesh(MeshSpec(2, 2, 2), jax.devices()[:N])
    jax_dir = os.path.join(work, "jax-222")
    with mock.patch.object(jsnap, "_chunk_writer",
                           lambda path, durable: jsnap._PyChunkWriter(
                               path, durable)):
        jt = _jax_trainer(mesh)
        jt.run(2)
        jt.snapshot(jax_dir)
    jax_losses = {}
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    for label, dt in JAX_DTYPES.items():
        cfg = _jcfg(label)
        params = jax.tree.map(lambda a: jnp.asarray(a, dt), params_np)
        batch = NamedSharding(mesh, jllama.BATCH_SPEC)
        jax_losses[label] = float(jax.jit(
            lambda p, i, t: jllama.loss_fn(cfg, p, i, t))(
                shard_tree(params, mesh, jllama.LLAMA_RULES),
                jax.device_put(inp, batch), jax.device_put(tgt, batch)))
    pp = _pipeline_moe()
    sp = _seq_parallel()
    ranks = run_ranks(torch_ranks.mesh8_cases, N,
                      {"work": work, "cfg": CFG, "params": params_np,
                       "tokens": tokens, "jax_dir": jax_dir,
                       "pp_stacked": pp["stacked"], "pp_x": pp["x"],
                       "pp_mask": PP_MASK, "sp_params": sp["params"],
                       "sp_tokens": sp["tokens"]},
                      backend="gloo", timeout=900)
    return {"work": work, "ranks": ranks, "mesh": mesh, "jax_dir": jax_dir,
            "jax_state": _state_np(jt.state), "jax_trainer": jt,
            "jax_losses": jax_losses, "pp": pp, "sp": sp}


def test_the_mesh_is_2x2x2(world):
    coords = set()
    for r in world["ranks"]:
        assert r["foreign"] == []
        assert r["mesh"]["shape"] == [2, 2, 2]
        assert r["mesh"]["names"] == ["data", "fsdp", "model"]
        coords.add(tuple(r["mesh"]["coord"]))
        assert r["pp"]["mesh"]["names"] == ["data", "pipe", "expert"]
    assert len(coords) == N


@pytest.mark.parametrize("label", ["bf16", "f32"])
def test_222_step_matches_dense_and_jax(world, label):
    ranks = world["ranks"]
    got = ranks[0][label]
    assert all(r[label] == got for r in ranks)
    assert _rel(got["sharded"][0], got["dense"][0]) < BOUND[label], got
    assert _rel(got["sharded"][0], world["jax_losses"][label]) < \
        BOUND[label], (got, world["jax_losses"])


def test_222_resume_is_bitwise(world):
    for r in world["ranks"]:
        got = r["resumed"]
        assert got["step"] == 2
        assert got["losses"] == r["source_after"]
        for name, (index, a) in got["state"].items():
            want_index, b = r["source_state"][name]
            assert index == want_index and np.array_equal(a, b), name


def test_222_descriptors_are_the_jax_trainers(world):
    port = _descriptors(os.path.join(world["work"], "port-222"))
    jax_desc = _descriptors(world["jax_dir"])
    assert port.keys() == jax_desc.keys()
    for name, desc in port.items():
        if name != "['rng']":  # rng's shape differs by design
            assert desc == jax_desc[name], name
    assert port["['params']['layers']['attn']['wq']"]["mesh_shape"] == \
        [2, 2, 2]


def test_jax_222_snapshot_restores_onto_the_port_222(world):
    want = world["jax_state"]
    for r in world["ranks"]:
        got = r["jax_restored"]
        assert set(got) == set(want) - {"['rng']"}
        for name, (index, a) in got.items():
            full = _bits(want[name])
            part = full if index is None else full[
                tuple(slice(s, e) for s, e in index)]
            assert a.dtype == part.dtype and np.array_equal(a, part), name


def test_port_222_snapshot_restores_in_jax(world):
    jt = world["jax_trainer"]
    like = {k: v for k, v in jt._abstract.items() if k != "rng"}
    got = jsnap.restore_snapshot(os.path.join(world["work"], "port-222"),
                                 like=like, mesh=world["mesh"])
    want = world["ranks"][0]["port_full"]
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(flat) == len(want) - 1
    for path, x in flat:
        name = jax.tree_util.keystr(path)
        assert np.array_equal(_bits(np.asarray(x)), want[name]), name


def test_dp_pp_ep_step_matches_jax_pipeline_loss(world):
    want = world["pp"]["loss"]
    for r in world["ranks"]:
        got = r["pp"]
        assert _rel(got["loss"], want) < PP_BOUND, (got["loss"], want)
        assert got["err"] < PP_BOUND * max(1.0, abs(got["dense"]))


def _shard(full: np.ndarray, name: str, mesh: dict) -> np.ndarray:
    """A (data, pipe, expert) rank's shard of a stacked leaf: its stage,
    and its experts of the expert weights."""
    _d, p, e = mesh["coord"]
    part = full[p]
    if name != "router":
        n = part.shape[0] // 2
        part = part[e * n:(e + 1) * n]
    return part


def _rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.mark.parametrize("name", ["router", "w_in", "w_out"])
def test_dp_pp_ep_gradients_and_update(world, name):
    """Each rank's gradient is its shard of the JAX step's, and its SGD
    update of 0.05 the shard of the JAX update, within f32 noise."""
    pp = world["pp"]
    for r in world["ranks"]:
        mesh = r["pp"]["mesh"]
        want = _shard(pp["grads"][name], name, mesh)
        assert _rel_l2(r["pp"]["grads"][name], want) < GRAD_BOUND, name
        new = _shard(pp["stacked"][name] - 0.05 * pp["grads"][name], name,
                     mesh)
        assert _rel_l2(r["pp"]["updated"][name], new) < GRAD_BOUND, name


def test_masked_microbatch_takes_the_global_mean(world):
    """Shards of one microbatch that keep 1 and 2 rows: the loss is the
    mean over the 3 rows, and the gradients are its; the mean of the
    shards' means differs by far more than the bound."""
    pp = world["pp"]
    assert _rel(pp["global_mean"], pp["masked_loss"]) < PP_BOUND
    for r in world["ranks"]:
        got = r["pp_masked"]
        assert _rel(got["loss"], pp["masked_loss"]) < PP_BOUND, got["loss"]
        for name in ("router", "w_in", "w_out"):
            want = _shard(pp["masked_grads"][name], name, got["mesh"])
            assert _rel_l2(got["grads"][name], want) < GRAD_BOUND, name
    # The shards' means averaged weigh a 1-row shard as a 2-row one.
    assert _rel(pp["mean_of_means"], pp["masked_loss"]) > 1000 * PP_BOUND


def test_dense_stage_gradient_is_each_data_shards_part(world):
    """The data-split loss sums only the loss over ``data``: a stage that
    holds its weight whole gets its own rows' part of the gradient, and
    the parts summed over ``data`` are the unsharded composition's (the
    MoE stage sums them in its expert layer)."""
    for r in world["ranks"]:
        got = r["pp_dense_stage"]
        assert _rel(got["loss"], got["dense"]) < PP_BOUND, got
        assert _rel_l2(got["summed"], got["dense_grad"]) < GRAD_BOUND
        assert _rel_l2(got["grad"], got["dense_grad"]) > 0.1


@pytest.mark.parametrize("spec", list(torch_ranks.PIPE_SPECS))
def test_pipe_layouts_on_data_pipe_expert(world, spec):
    full = np.arange(np.prod(torch_ranks.PIPE_SHAPE), dtype=np.int32
                     ).reshape(torch_ranks.PIPE_SHAPE)
    writers: dict = {}
    for r in world["ranks"]:
        got = r["layouts"][spec]
        part = full[tuple(slice(a, b) for a, b in got["index"])]
        want = part if spec == "replicated" else part[0]
        assert np.array_equal(got["held"], want)
        assert got["zeros"] == got["held_shape"] == list(want.shape)
        assert got["global_shape"] == list(torch_ranks.PIPE_SHAPE)
        writers[str(got["index"])] = writers.get(str(got["index"]), 0) + \
            bool(got["writes"])
    assert all(v == 1 for v in writers.values()), writers


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_seq_parallel_over_eight_ranks(world, impl):
    sp = world["sp"]
    got = np.concatenate([r["sp"]["logits"][impl] for r in world["ranks"]],
                         axis=1)
    assert np.abs(got - sp["dense"]).max() < SP_BOUND
    assert np.abs(got - sp[impl]).max() < SP_BOUND
    assert all(r["sp"]["err"][impl] < SP_BOUND for r in world["ranks"])


def test_chip_smoke_phase_21_rehearsal(tmp_path):
    """Phase 21 (``chip_smoke.phase_mesh8``) on eight CPU ranks at a tiny
    width: the dryrun's three phases, the flagship step on (2,2,2) against
    dense, its snapshot restored bitwise in the same launch; its checks
    raise on any miss, and a planted fault (one expert shard swapped
    between ranks in the pp × ep phase) must make them raise."""
    import chip_smoke  # noqa: PLC0415
    from grit_tpu_torch.models import llama as pllama  # noqa: PLC0415

    cfg = pllama.LlamaConfig.tiny(dim=128, n_layers=2, n_heads=8,
                                  n_kv_heads=4, dtype=torch.float32,
                                  vocab_size=32000)
    got = chip_smoke.phase_mesh8(torch, str(tmp_path / "ok"), "cpu", seed=0,
                                 device="cpu", cfg=cfg, shape=(4, 64))
    assert got["dryrun"]["pp"]["err"] < PP_BOUND
    assert got["flagship"]["restore_bitwise"]
    with pytest.raises(AssertionError, match="pp"):
        chip_smoke.phase_mesh8(torch, str(tmp_path / "bad"), "cpu", seed=0,
                               device="cpu", cfg=cfg, shape=(4, 64),
                               fault="swap_expert")
