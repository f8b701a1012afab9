"""Rank functions of the port's multi-rank tests.

Each ``*_cases`` function runs on every rank of one
:func:`grit_tpu_torch.parallel.launch.run_ranks` launch of four CPU ranks
over gloo, takes numpy inputs made by the test from a seed, runs every
case of its test file on the whole axis (``"world"``, four ranks) and on
a two-rank group (``"pair"``: ranks 0-1 and, at once, ranks 2-3), and
returns this rank's local outputs as numpy. The test concatenates them
in rank order and holds them against the JAX package's functions.

This module imports torch, numpy and the port only: a rank spawned from
a test process that has JAX loaded imports nothing of JAX
(:func:`foreign_modules` says so).
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import replace
from functools import partial

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from grit_tpu_torch import convert
from grit_tpu_torch.models import llama, long_context, moe_llama, pipeline_llama
from grit_tpu_torch.ops.ring_attention import ring_attention
from grit_tpu_torch.ops.ulysses import ulysses_attention
from grit_tpu_torch.parallel import axis_index, axis_size
from grit_tpu_torch.parallel.collectives import shift
from grit_tpu_torch.parallel.pipeline import microbatch, pipeline_apply, pipeline_loss
from grit_tpu_torch.tree import flatten_with_names, map_with_names, tree_map

FOREIGN = ("jax", "jaxlib", "optax", "ml_dtypes", "grit_tpu")


def foreign_modules() -> list[str]:
    """The modules of JAX and of the JAX package this rank has loaded."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


def _axes() -> dict:
    """The whole axis and this rank's two-rank group. Every rank creates
    both groups, in the same order, as ``new_group`` requires."""
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    return {"world": None, "pair": pairs[dist.get_rank() // 2]}


def _shard(x: np.ndarray, axis, dim: int = 1) -> torch.Tensor:
    """This rank's shard of ``x`` along ``dim`` (the sequence)."""
    n, r = axis_size(axis), axis_index(axis)
    s = x.shape[dim] // n
    return torch.from_numpy(np.ascontiguousarray(
        np.take(x, range(r * s, (r + 1) * s), axis=dim)))


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().numpy()


def _grads_np(tree, grads) -> dict:
    return {name: _np(g) for (name, _), g in zip(flatten_with_names(tree),
                                                 grads)}


def _params(tree_np) -> dict:
    return convert.params_from_jax(tree_np)


def raise_on_rank_one() -> int:
    if axis_index() == 1:
        raise RuntimeError("planted failure on rank 1")
    return axis_index()


def exit_on_rank_two() -> int:
    if axis_index() == 2:
        os._exit(3)
    return axis_index()


# -- ring attention and Ulysses ----------------------------------------------------


ATTN = {"ring": ring_attention, "ulysses": ulysses_attention}


def _attention_grads(impl: str, qkv, axis) -> list[np.ndarray]:
    """Local output and q/k/v gradients of sum(out ** 2) (the global sum
    is the sum of the ranks' local sums)."""
    q, k, v = (_shard(x, axis).requires_grad_(True) for x in qkv)
    out = ATTN[impl](q, k, v, axis)
    grads = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    return [_np(out), *(_np(g) for g in grads)]


def ring_cases(inp: dict) -> dict:
    res = {"foreign": foreign_modules()}
    for name, axis in _axes().items():
        shard = lambda x: _shard(x, axis)  # noqa: E731
        q, k, v, k2, v2 = inp["causal"]
        res[name] = {
            "gqa": _np(ring_attention(*map(shard, inp["gqa"]), axis)),
            "mha": _np(ring_attention(*map(shard, inp["mha"]), axis)),
            "causal": [_np(ring_attention(*map(shard, t), axis))
                       for t in ((q, k, v), (q, k2, v2))],
            "grad": _attention_grads("ring", inp["grad"], axis),
        }
    return res


def ulysses_cases(inp: dict) -> dict:
    from torch.distributed.device_mesh import init_device_mesh  # noqa: PLC0415

    axes = _axes()
    res = {"foreign": foreign_modules()}
    for name, axis in axes.items():
        res[name] = {"gqa": _np(ulysses_attention(
            *(_shard(x, axis) for x in inp["gqa"]), axis))}
    world = {}
    shards = [_shard(x, None) for x in inp["swap"]]
    world["swap"] = [_np(ulysses_attention(*shards)),
                     _np(ring_attention(*shards))]
    mesh = init_device_mesh("cpu", (axis_size(),), mesh_dim_names=("seq",))
    world["mesh"] = _np(ulysses_attention(*shards, mesh["seq"]))
    world["grad"] = _attention_grads("ulysses", inp["grad"], None)
    try:
        ulysses_attention(*(_shard(x, None) for x in inp["bad_heads"]))
        world["error"] = None
    except ValueError as exc:
        world["error"] = str(exc)
    cfg = llama.LlamaConfig.tiny(n_kv_heads=4, dtype=torch.float32)
    params = _params(inp["model_params"])
    toks = _shard(inp["model_tokens"], None)
    with torch.no_grad():
        world["model"] = {impl: _np(long_context.forward_sp(
            cfg, params, toks, attn_impl=impl)) for impl in ATTN}
    res["world"].update(world)
    return res


# -- the long-context family ------------------------------------------------------


def long_context_cases(inp: dict) -> dict:
    from grit_tpu_torch.train import optim  # noqa: PLC0415
    from grit_tpu_torch.train.trainer import Trainer, TrainerConfig  # noqa: PLC0415

    axes = _axes()
    res = {"foreign": foreign_modules()}
    cfg = replace(llama.LlamaConfig.tiny(n_kv_heads=4, max_seq_len=256),
                  dtype=torch.float32)
    params = _params(inp["params"])
    for name, axis in axes.items():
        toks = _shard(inp["tokens"], axis)
        with torch.no_grad():
            logits = {impl: _np(long_context.forward_sp(
                cfg, params, toks, axis=axis, attn_impl=impl))
                for impl in ATTN}
        grads = {}
        for impl in ATTN:
            for remat in (False, True):
                leaves = [x.requires_grad_(True)
                          for _, x in flatten_with_names(params)]
                loss = long_context.loss_fn_sp(
                    replace(cfg, remat=remat), params,
                    _shard(inp["inp"], axis), _shard(inp["tgt"], axis).long(),
                    None if inp["mask"] is None
                    else _shard(inp["mask"], axis), axis=axis,
                    attn_impl=impl)
                g = torch.autograd.grad(loss, leaves)
                grads[f"{impl}-remat={remat}"] = (
                    float(loss.detach()), _grads_np(params, g))
        res[name] = {"logits": logits, "grads": grads}
        for x in flatten_with_names(params):
            x[1].requires_grad_(False)

    # Training on all four ranks through the unchanged Trainer.
    inp_shard = _shard(inp["train_inp"], None)
    tgt_shard = _shard(inp["train_tgt"], None).long()

    def make():
        return Trainer(
            loss_fn=lambda p, b: long_context.loss_fn_sp(
                cfg, p, b[0], b[1], attn_impl="ring"),
            init_params=lambda gen, device: tree_map(
                lambda a: a.to(device), _params(inp["train_params"])),
            batch_fn=lambda gen: (inp_shard, tgt_shard),
            cfg=TrainerConfig(seed=0), device="cpu",
            optimizer=optim.sgd(0.05))

    tr = make()
    losses = tr.run(10)
    state = {name: convert.tensor_to_numpy(x)
             for name, x in flatten_with_names(tr.state)}
    if axis_index() == 0:
        tr.snapshot(inp["snap_dir"])
    # The reverse: a dense trainer's snapshot restored into this rank's
    # sequence-parallel trainer, whose forward must match dense.
    back = make()
    step = back.restore(inp["dense_dir"])
    with torch.no_grad():
        restored_logits = _np(long_context.forward_sp(
            cfg, back.state["params"], _shard(inp["tokens"], None)))
    res["train"] = {"losses": losses, "state": state, "restored_step": step,
                    "restored_logits": restored_logits}
    return res


# -- the pipeline -----------------------------------------------------------------


def mlp_stage(params, x):
    """The JAX test's stage: one MLP block, the activation shape kept."""
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + x


def _stage(stacked_np: dict, axis) -> dict:
    return {k: torch.from_numpy(v[axis_index(axis)]).clone()
            for k, v in stacked_np.items()}


def pipeline_cases(inp: dict) -> dict:
    axes = _axes()
    res = {"foreign": foreign_modules()}
    for name, axis in axes.items():
        n = axis_size(axis)
        fwd = {}
        for (n_pipe, n_mb), (stacked, x) in inp["forward"].items():
            if n_pipe == n:
                fwd[n_mb] = _np(pipeline_apply(
                    mlp_stage, _stage(stacked, axis),
                    microbatch(torch.from_numpy(x), n_mb), axis=axis))
        res[name] = {"forward": fwd}

    # Gradients on the whole axis: 4 stages, 4 microbatches.
    stacked, x, y = inp["grad"]
    local = {k: v.requires_grad_(True) for k, v in _stage(stacked, None).items()}
    mse = lambda p, t: ((p - t) ** 2).mean()  # noqa: E731
    loss = pipeline_loss(mlp_stage, mse, local,
                         microbatch(torch.from_numpy(x), 4),
                         microbatch(torch.from_numpy(y), 4))
    grads = torch.autograd.grad(loss, list(local.values()))
    res["world"]["grad"] = (float(loss.detach()),
                            {k: _np(g) for k, g in zip(local, grads)})

    # Training on the pair: SGD over the pipelined objective.
    stacked, x = inp["train"]
    axis = axes["pair"]
    local = {k: v.requires_grad_(True) for k, v in _stage(stacked, axis).items()}
    x_mb = microbatch(torch.from_numpy(x), 4)
    losses = []
    for _ in range(50):
        loss = pipeline_loss(mlp_stage, mse, local, x_mb, 0.5 * x_mb, axis=axis)
        grads = torch.autograd.grad(loss, list(local.values()))
        with torch.no_grad():
            for p, g in zip(local.values(), grads):
                p -= 0.2 * g
        losses.append(float(loss.detach()))
    res["pair"]["train"] = losses
    return res


# -- the pipelined llama ------------------------------------------------------------


def _staged_local(cfg, params: dict, axis) -> dict:
    staged = pipeline_llama.to_stage_params(cfg, params, axis_size(axis))
    return pipeline_llama.stage_slice(staged, axis_index(axis))


def pipeline_llama_cases(inp: dict) -> dict:
    from grit_tpu_torch.device.snapshot import restore_snapshot  # noqa: PLC0415

    axes = _axes()
    res = {"foreign": foreign_modules()}
    cfg = replace(llama.LlamaConfig.tiny(n_layers=4), dtype=torch.float32)
    params = _params(inp["params"])
    toks = torch.from_numpy(inp["tokens"])
    inp_t = torch.from_numpy(inp["inp"])
    tgt_t = torch.from_numpy(inp["tgt"]).long()
    for name, axis in axes.items():
        local = _staged_local(cfg, params, axis)
        out = {}
        with torch.no_grad():
            out["forward"] = {m: _np(pipeline_llama.forward_pp(
                cfg, local, toks, n_microbatches=m, axis=axis))
                for m in (1, 2, 4)}
        out["grads"] = {}
        for m in (1, 2):
            for remat in (False, True):
                leaves = [x.requires_grad_(True)
                          for _, x in flatten_with_names(local)]
                loss = pipeline_llama.loss_fn_pp(
                    replace(cfg, remat=remat), local, inp_t, tgt_t,
                    n_microbatches=m, axis=axis)
                g = torch.autograd.grad(loss, leaves)
                out["grads"][f"{m}-remat={remat}"] = (
                    float(loss.detach()), _grads_np(local, g))
        res[name] = out

    # Training on the pair.
    axis = axes["pair"]
    local = _staged_local(cfg, _params(inp["train_params"]), axis)
    leaves = [x.requires_grad_(True) for _, x in flatten_with_names(local)]
    losses = []
    for _ in range(10):
        loss = pipeline_llama.loss_fn_pp(cfg, local, inp_t, tgt_t,
                                         n_microbatches=2, axis=axis)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p -= 0.05 * g
        losses.append(float(loss.detach()))
    res["pair"]["train"] = losses

    # The pipelined MoE against dense, on the whole axis.
    mcfg = replace(moe_llama.MoeLlamaConfig.tiny(n_layers=4),
                   dtype=torch.float32, capacity_factor=4.0)
    local = _staged_local(mcfg, _params(inp["moe_params"]), None)
    leaves = [x.requires_grad_(True) for _, x in flatten_with_names(local)]
    logits = moe_llama.forward_pp(mcfg, local, toks, n_microbatches=2)
    loss = llama.token_cross_entropy(logits, torch.from_numpy(
        inp["moe_tgt"]).long())
    g = torch.autograd.grad(loss, leaves)
    res["world"]["moe"] = (_np(logits), float(loss.detach()),
                           _grads_np(local, g))

    # A dense snapshot restored onto the pipelined job.
    like = tree_map(lambda a: torch.empty_like(a, device="meta"), params)
    restored = restore_snapshot(inp["dense_dir"], like=like, device="cpu")
    with torch.no_grad():
        res["world"]["restored"] = _np(pipeline_llama.forward_pp(
            cfg, _staged_local(cfg, restored, None), toks, n_microbatches=2))
    return res


def group_any_cases(inp: dict) -> dict:
    """:func:`~grit_tpu_torch.parallel.coordination.group_any` on every
    pending pattern of ``inp["patterns"]`` (one flag a rank): over the
    whole axis, over this rank's pair, and over the gloo twin it builds
    for a group of another backend (``get_backend`` made to answer
    ``nccl`` while it is built). Returns each collective's answers."""
    from unittest import mock  # noqa: PLC0415

    from grit_tpu_torch.parallel.coordination import group_any  # noqa: PLC0415

    rank = dist.get_rank()
    axes = _axes()
    fns = {"world": group_any(), "pair": group_any(axes["pair"])}
    with mock.patch.object(dist, "get_backend", return_value="nccl"):
        fns["twin_world"] = group_any()
        fns["twin_pair"] = group_any(axes["pair"])
    return {name: [fn(bool(p[rank])) for p in inp["patterns"]]
            for name, fn in fns.items()}



def slice_barrier_fault(inp: dict) -> dict:
    """A :class:`~grit_tpu_torch.parallel.coordination.SliceQuiesceGate`
    over the group's store, its request naming ``inp["dir"]``'s flight
    log, run to its cut under the ``GRIT_FAULT_POINTS`` the test armed:
    whether the loop parked within a few steps, the gate's latched
    failure, the point's hits, ``SLICE_BARRIER_SECONDS`` and this pid."""
    from grit_tpu_torch import faults  # noqa: PLC0415
    from grit_tpu_torch.obs.metrics import SLICE_BARRIER_SECONDS  # noqa: PLC0415
    from grit_tpu_torch.parallel.coordination import (  # noqa: PLC0415
        SliceCoordinator,
        SliceQuiesceGate,
        StoreRendezvous,
    )

    rank, world = dist.get_rank(), dist.get_world_size()
    rdv = StoreRendezvous(dist.distributed_c10d._get_default_store(), rank,
                          world)
    gate = SliceQuiesceGate(SliceCoordinator(rdv, process_index=rank,
                                             process_count=world),
                            timeout_s=60.0)
    gate.request(flight_dir=inp["dir"], nonce="1", step=rank)
    parked = False
    for step in range(rank, rank + 4):  # a few more training steps
        if gate.ready_to_park(step):
            parked = True
            break
        if gate.failed is not None:
            break
    return {"parked": parked, "failed": gate.failed,
            "hits": faults.hits("slice.barrier"),
            "barrier_s": SLICE_BARRIER_SECONDS.value(), "pid": os.getpid()}

# -- the mesh, the sharding rules and sharded state -----------------------------------


def _local_np(x: torch.Tensor) -> np.ndarray:
    """This rank's shard of ``x`` (a DTensor, or a plain tensor) as numpy,
    bf16 as its int16 bits."""
    t = x.to_local() if isinstance(x, DTensor) else x
    t = t.detach().clone()  # a copy: the optimizer updates in place
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def mesh_cases(inp: dict) -> dict:
    """:func:`~grit_tpu_torch.parallel.mesh.build_mesh` of every spec in
    ``inp["specs"]`` on the world: the mesh's shape, axes and this rank's
    coordinate, its active sub-mesh, or the ``ValueError`` it raised."""
    from grit_tpu_torch.parallel.mesh import MeshSpec, active_mesh, build_mesh  # noqa: PLC0415

    out = {"foreign": foreign_modules()}
    for key, spec in inp["specs"].items():
        try:
            mesh = build_mesh(MeshSpec(*spec), "cpu")
        except ValueError as exc:
            out[key] = {"error": str(exc)}
            continue
        act = active_mesh(mesh)
        out[key] = {"shape": list(mesh.shape),
                    "names": list(mesh.mesh_dim_names),
                    "coord": list(mesh.get_coordinate()),
                    "active": list(act.mesh_dim_names),
                    "active_coord": list(act.get_coordinate())}
    return out


def placement_cases(inp: dict) -> dict:
    """On each mesh of ``inp["meshes"]``: every tree of ``inp["trees"]``
    (``{tree: (rule table, {leaf name: shape})}``, leaves valued
    ``arange``) through :func:`shard_tree` under the port's rule table;
    this rank's local shards, their :func:`dtensor_index`, and the
    ``ValueError`` of each spec in ``inp["bad"]``."""
    from grit_tpu_torch.models import lora, mnist  # noqa: PLC0415
    from grit_tpu_torch.parallel.mesh import MeshSpec, build_mesh  # noqa: PLC0415
    from grit_tpu_torch.parallel.sharding import dtensor_index, named_sharding, shard_tree  # noqa: PLC0415

    from grit_tpu_torch.models import serving  # noqa: PLC0415

    tables = {"llama": llama.LLAMA_RULES, "mnist": mnist.MNIST_RULES,
              "lora": lora.LORA_RULES, "moe": moe_llama.MOE_LLAMA_RULES,
              "kv_cache": serving.KV_CACHE_RULES}
    out: dict = {"foreign": foreign_modules()}
    for mshape in inp["meshes"]:
        mesh = build_mesh(MeshSpec(*mshape), "cpu")
        for tree, (table, shapes) in inp["trees"].items():
            full = {name: torch.arange(int(np.prod(shape)),
                                       dtype=torch.int32).reshape(shape)
                    for name, shape in shapes.items()}
            if table == "batch":
                placed = {n: named_sharding(mesh, *llama.BATCH_SPEC)
                          .distribute(x) for n, x in full.items()}
            else:
                placed = shard_tree(full, mesh, tables[table])
            out[(tuple(mshape), tree)] = {
                n: {"local": _local_np(x), "index": dtensor_index(x),
                    "placements": [str(p) for p in x.placements]}
                for n, x in placed.items()}
        for key, (shape, spec) in inp["bad"].items():
            try:
                named_sharding(mesh, *spec).distribute(
                    torch.zeros(shape, dtype=torch.int32))
                out[(tuple(mshape), key)] = "placed"
            except ValueError as exc:
                out[(tuple(mshape), key)] = f"ValueError: {exc}"
    return out


def _llama_trainer(inp: dict, dtype, mesh):
    """A Trainer of the tiny llama (the tiny MoE llama when ``inp["moe"]``,
    its loss closing over ``mesh``) on ``inp``'s numpy weights and fixed
    tokens (every step the same batch), sharded when ``mesh`` is given."""
    from grit_tpu_torch.train.trainer import Trainer, TrainerConfig  # noqa: PLC0415

    if inp.get("moe"):
        cfg = replace(moe_llama.MoeLlamaConfig.tiny(**inp["cfg"]),
                      dtype=dtype, param_dtype=dtype)
        loss = partial(moe_llama.loss_fn, cfg, mesh=mesh)
        rules = moe_llama.MOE_LLAMA_RULES
    else:
        cfg = replace(llama.LlamaConfig.tiny(**inp["cfg"]), dtype=dtype,
                      param_dtype=dtype)
        loss, rules = partial(llama.loss_fn, cfg), llama.LLAMA_RULES
    toks = torch.from_numpy(inp["tokens"])

    def init(_gen, device):
        if torch.device(device).type == "meta":
            return tree_map(lambda a: torch.empty_like(
                a, dtype=dtype, device="meta"), _params(inp["params"]))
        return tree_map(lambda a: a.to(dtype), _params(inp["params"]))

    return Trainer(
        loss_fn=lambda p, b: loss(p, b[0], b[1]),
        init_params=init, batch_fn=lambda _gen: (toks[:, :-1], toks[:, 1:]),
        cfg=TrainerConfig(learning_rate=1e-3, batch_spec=llama.BATCH_SPEC),
        device="cpu", mesh=mesh, rules=None if mesh is None else rules)


def _state_np(tr) -> dict:
    """Every tensor leaf of the Trainer's state as this rank holds it:
    ``{name: (index or None, numpy)}``."""
    from grit_tpu_torch.parallel.sharding import dtensor_index  # noqa: PLC0415

    return {name: (dtensor_index(x) if isinstance(x, DTensor) else None,
                   _local_np(x))
            for name, x in flatten_with_names(tr.state)}


def _full_np(tr) -> dict:
    """Every leaf of the Trainer's state, whole (a collective: every rank
    calls it)."""
    return {name: _local_np(x.full_tensor() if isinstance(x, DTensor) else x)
            for name, x in flatten_with_names(tr.state)}


def sharded_state_cases(inp: dict) -> dict:
    """The tiny llama (the tiny MoE llama with ``inp["moe"]``) on the
    (1,2,2) mesh against dense: first-step losses in bf16 and f32; a
    sharded snapshot, its bitwise resume, a restore onto (2,1,2) and into
    a dense Trainer (each one's whole state at the cut, and its losses); a
    delta of the same cut against it; restores of the JAX package's
    snapshots; the port-written snapshot's state for the JAX package to
    restore."""
    from grit_tpu_torch.device.snapshot import restore_snapshot  # noqa: PLC0415
    from grit_tpu_torch.parallel.mesh import MeshSpec, build_mesh  # noqa: PLC0415
    from grit_tpu_torch.parallel.sharding import dtensor_index  # noqa: PLC0415

    work = inp["work"]
    meshes = {k: build_mesh(MeshSpec(*v), "cpu") for k, v in
              {"122": (1, 2, 2), "212": (2, 1, 2)}.items()}
    out: dict = {"foreign": foreign_modules(), "rank": dist.get_rank()}
    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        out[label] = {
            "sharded": _llama_trainer(inp, dtype, meshes["122"]).run(2),
            "dense": _llama_trainer(inp, dtype, None).run(2)}

    src = _llama_trainer(inp, torch.bfloat16, meshes["122"])
    src.run(3)
    snap = os.path.join(work, "port-snap")
    src.snapshot(snap)
    out["port_full"] = _full_np(src)
    delta = os.path.join(work, "port-delta")
    src.snapshot(delta, base=snap)
    with open(os.path.join(delta, "MANIFEST.json")) as f:
        out["delta_dirty"] = json.load(f).get("dirty")
    out["source_after"] = src.run(3)
    out["source_state"] = _state_np(src)
    resumed = {}
    for key, d in (("same", snap), ("delta", delta)):
        tr = _llama_trainer(inp, torch.bfloat16, meshes["122"])
        step = tr.restore(d)
        resumed[key] = {"step": step, "losses": tr.run(3),
                        "state": _state_np(tr)}
    for key, mesh in (("212", meshes["212"]), ("dense", None)):
        tr = _llama_trainer(inp, torch.bfloat16, mesh)
        tr.restore(snap)
        cut = _full_np(tr)
        resumed[key] = {"cut": cut, "losses": tr.run(3)}
    out["resumed"] = resumed

    # The JAX package's snapshots, restored onto each mesh (rng aside:
    # JAX keeps a threefry key, the port the seed).
    out["jax_restored"] = {}
    for key, mesh in meshes.items():
        tr = _llama_trainer(inp, torch.bfloat16, mesh)
        like = tr.abstract_state()
        like.pop("rng")
        got = restore_snapshot(inp["jax_dir"], like=like, device="cpu")
        out["jax_restored"][key] = {
            name: (dtensor_index(x) if isinstance(x, DTensor) else None,
                   _local_np(x)) for name, x in flatten_with_names(got)}
    return out


def local_gloo_cases(inp: dict) -> dict:
    """Every collective :class:`~grit_tpu_torch.parallel.collectives.LocalGloo`
    implements, through ``torch.distributed`` and through the functional
    collectives DTensor calls, and the ring hop :func:`shift` makes of
    them, on the world and on this rank's pair, with rank ``r`` holding
    ``inp["x"] + 10 r``; and the backend's name."""
    import torch.distributed._functional_collectives as funcol  # noqa: PLC0415

    rank = dist.get_rank()
    out: dict = {"backend": dist.get_backend(), "foreign": foreign_modules()}
    for name, axis in _axes().items():
        group = dist.group.WORLD if axis is None else axis
        n = dist.get_world_size(group)
        x = torch.from_numpy(inp["x"]) + 10 * rank
        res = {}
        y = x.clone()
        dist.all_reduce(y, group=group)
        res["all_reduce"] = y
        res["all_gather"] = torch.empty(n * x.numel())
        dist.all_gather_into_tensor(res["all_gather"], x, group=group)
        res["reduce_scatter"] = torch.empty(x.numel() // n)
        dist.reduce_scatter_tensor(res["reduce_scatter"], x.clone(), group=group)
        res["all_to_all"] = torch.empty_like(x)
        dist.all_to_all_single(res["all_to_all"], x, group=group)
        res["broadcast"] = x.clone()
        dist.broadcast(res["broadcast"], dist.get_global_rank(group, 0),
                       group=group)
        dist.barrier(group=group)
        res["f_all_gather"] = funcol.all_gather_tensor(x, 0, group).wait()
        res["f_reduce_scatter"] = funcol.reduce_scatter_tensor(
            x, "sum", 0, group).wait()
        res["f_all_reduce"] = funcol.all_reduce(x, "sum", group).wait()
        res["f_all_to_all"] = funcol.all_to_all_single(x, None, None,
                                                       group).wait()
        res["shift"] = shift(x, axis, 1)  # the ring hop: send, then receive
        # The list forms of all-gather and reduce-scatter.
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        res["l_all_gather"] = torch.cat(parts)
        res["l_reduce_scatter"] = torch.empty(x.numel() // n)
        dist.reduce_scatter(res["l_reduce_scatter"],
                            list(x.clone().chunk(n)), group=group)
        out[name] = {k: _np(v) for k, v in res.items()}
    return out


# -- sharded serving grids --------------------------------------------------------


def _serving_cfg(inp: dict, fam: str):
    kind = moe_llama.MoeLlamaConfig if fam == "moe" else llama.LlamaConfig
    return kind.tiny(**inp["cfg"][fam], dtype=torch.float32)


def _drive(eng, prompts, rounds: int, script=None) -> list[dict]:
    """Admit ``prompts`` (the first two at once, the rest after the first
    round) and step ``rounds`` times: each round's ``{slot: token}``."""
    out = []
    for p in prompts[:2]:
        eng.submit(p)
    for r in range(rounds):
        if r == 1:
            for p in prompts[2:]:
                eng.submit(p)
        out.append(eng.step())
    return out


def _written_np(state) -> dict:
    """This rank's shard of the cache's ``k`` and ``v`` (and its index),
    every page no step has written yet zeroed: positions at or past each
    active slot's length, and inactive slots' rows."""
    from grit_tpu_torch.parallel.sharding import dtensor_index  # noqa: PLC0415

    out = {}
    for name in ("k", "v"):
        x = state["cache"][name]
        index = dtensor_index(x) if isinstance(x, DTensor) else None
        local = x.to_local() if isinstance(x, DTensor) else x
        b0, b1 = (0, local.shape[1]) if index is None else index[1]
        lengths = state["lengths"][b0:b1][None, :, None, None, None]
        active = state["active"][b0:b1][None, :, None, None, None]
        pos = torch.arange(local.shape[2])[None, None, :, None, None]
        out[name] = (index, _local_np(torch.where(
            active & (pos < lengths), local, torch.zeros((), dtype=local.dtype))))
    return out


def serving_mesh_cases(inp: dict) -> dict:
    """Both serving engines, dense and MoE llama, sharded by
    ``KV_CACHE_RULES`` on (1,2,2) against the single-device engine, greedy
    and sampled; a (1,2,2) grid snapshot restored onto (1,2,2) (tokens and
    the cache's shards bitwise), onto (1,1,4) and onto one device; the JAX
    package's grid snapshots restored onto (1,2,2); the port's grid state
    whole for the JAX package to hold its restore to; post-copy onto a
    mesh."""
    from grit_tpu_torch.models import serving  # noqa: PLC0415
    from grit_tpu_torch.parallel.mesh import MeshSpec, build_mesh  # noqa: PLC0415
    from grit_tpu_torch.parallel.sharding import dtensor_index  # noqa: PLC0415

    work = inp["work"]
    meshes = {k: build_mesh(MeshSpec(*v), "cpu") for k, v in
              {"122": (1, 2, 2), "114": (1, 1, 4)}.items()}
    rounds, cut = inp["rounds"], inp["cut"]
    out: dict = {"foreign": foreign_modules(), "rank": dist.get_rank()}
    for fam in ("dense", "moe"):
        cfg = _serving_cfg(inp, fam)
        params = _params(inp["params"][fam])
        prompts = [torch.from_numpy(p) for p in inp["prompts"]]
        res: dict = {}

        def grid(temperature: float, mesh):
            return serving.ContinuousBatchingEngine(
                cfg, params, serving.BatchingConfig(
                    n_slots=4, max_seq_len=inp["max_len"],
                    temperature=temperature, seed=7,
                    prefill_buckets=(16, 32)),
                device="cpu", mesh=mesh)

        for label, t in (("greedy", 0.0), ("sampled", 1.0)):
            res[label] = {
                "solo": _drive(grid(t, None), prompts, rounds),
                "mesh": _drive(grid(t, meshes["122"]), prompts, rounds)}
            lock = {}
            for key, mesh in (("solo", None), ("mesh", meshes["122"])):
                eng = serving.InferenceEngine(
                    cfg, params, serving.ServingConfig(
                        batch_size=4, max_seq_len=inp["max_len"],
                        temperature=t, seed=7), device="cpu", mesh=mesh)
                first = eng.prefill(torch.from_numpy(inp["batch_prompt"]))
                lock[key] = torch.cat([first, eng.generate(rounds)],
                                      1).tolist()
            res[f"lockstep_{label}"] = lock

        # A grid snapshot taken mid-flight and its restores.
        src = grid(0.0, meshes["122"])
        before = _drive(src, prompts, cut)
        snap = os.path.join(work, f"port-grid-{fam}")
        src.snapshot(snap)
        res["port_full"] = {  # as the snapshot holds it (written pages)
            name: convert.tensor_to_numpy(x)
            for name, x in flatten_with_names(src.snapshot_state())}
        res["source"] = {"before": before,
                         "after": [src.step() for _ in range(rounds - cut)],
                         "cache": _written_np(src.state)}
        for key, mesh in (("122", meshes["122"]), ("114", meshes["114"]),
                          ("dense", None)):
            dst = grid(0.0, mesh)
            dst.restore(snap)
            res[key] = {"after": [dst.step() for _ in range(rounds - cut)],
                        "cache": _written_np(dst.state)}
        dst = grid(0.0, meshes["122"])
        dst.restore_postcopy(snap)
        dst.absorb_restored()
        res["postcopy"] = {"after": [dst.step() for _ in range(rounds - cut)],
                           "cache": _written_np(dst.state)}

        # The JAX package's grid snapshot onto this rank's mesh.
        dst = grid(0.0, meshes["122"])
        dst.restore(inp["jax_dirs"][fam])
        res["jax_restored"] = {
            name: (dtensor_index(x) if isinstance(x, DTensor) else None,
                   _local_np(x))
            for name, x in flatten_with_names(dst.state)}
        res["jax_after"] = [dst.step() for _ in range(rounds - cut)]
        # The same JAX state carried over as numpy, each rank keeping its
        # shards of it.
        dst = grid(0.0, meshes["122"])
        dst.state = convert.serving_state_from_jax(
            inp["jax_states"][fam], shardings=dst._state_shardings)
        res["jax_converted_after"] = [dst.step()
                                      for _ in range(rounds - cut)]
        out[fam] = res
    return out


# -- the agentlet's sharded dump, post-copy onto a mesh, the pipe axis ----------------


def _drive_hook(agentlet, steps) -> list[str]:
    """Run ``steps`` (callables of the port's node hook) on a thread while
    this loop offers the agentlet its checkpoint points, as a training
    loop parked between steps does; returns the errors they raised."""
    import threading  # noqa: PLC0415
    import time  # noqa: PLC0415

    errors: list[str] = []

    def drive():
        try:
            for step in steps:
                step()
        except Exception as exc:  # noqa: BLE001 — the test reads it
            errors.append(f"{type(exc).__name__}: {exc}")

    t = threading.Thread(target=drive)
    t.start()
    while t.is_alive():
        agentlet.checkpoint_point()
        time.sleep(0.01)
    return errors


def _wire_cut(agentlet, hook, dest: str, endpoint: str, prefix: str,
              errors: list[str]) -> dict:
    """One cut of this rank through the hook with its leg teed to the
    wire receiver at ``endpoint`` under ``prefix``; returns the dump's
    wire outcome, also written to ``<dest>.sent`` once the dump is done
    (the agent's signal to ship the rest of the tree)."""
    got: dict = {}
    os.environ["GRIT_SNAP_SPECULATE"] = "0"
    try:
        errors += _drive_hook(agentlet, [
            lambda: got.update(hook.dump(os.getpid(), dest, wire={
                "endpoint": endpoint, "prefix": prefix, "streams": 2})),
            lambda: hook.resume(os.getpid())])
    finally:
        os.environ.pop("GRIT_SNAP_SPECULATE")
    with open(dest + ".sent.tmp", "w") as f:
        json.dump(got, f)
    os.rename(dest + ".sent.tmp", dest + ".sent")
    return got


def _wait_for_file(path: str, timeout: float = 120.0) -> None:
    """Wait for ``path``, written by the test process; raises on its
    timeout or if it holds an error."""
    import time  # noqa: PLC0415

    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.05)
    with open(path) as f:
        status = f.read()
    if status != "ok":
        raise RuntimeError(f"{path}: {status}")


def _descriptors(d: str) -> dict:
    with open(os.path.join(d, "MANIFEST.json")) as f:
        return {rec["name"]: rec["sharding"] for rec in json.load(f)["arrays"]}


def sharded_agentlet_cases(inp: dict) -> dict:
    """A (1,2,2) Trainer of the tiny llama (bf16, ``inp``'s weights) takes
    two steps and snapshots through ``Trainer.snapshot``; then, with no
    ``shardings=`` anywhere, each rank's ``Agentlet(lambda: tr.state)`` is
    cut by the port's node hook into its own leg (speculation on, so a
    ``-spec`` pass and a delta against it), reloads the JAX package's
    sharded snapshot through the hook's re-attach, and rank 0 merges the
    legs. A fresh (1,2,2) Trainer restores each rank's leg and a (2,1,2)
    one the merged view. Also: a (2,1,2) state's leg written without
    shardings, and DTensors no sharding describes."""
    import torch.distributed.tensor as dt  # noqa: PLC0415
    from torch.distributed.device_mesh import init_device_mesh  # noqa: PLC0415

    from grit_tpu_torch.device.agentlet import Agentlet  # noqa: PLC0415
    from grit_tpu_torch.device.hook import TpuDeviceCheckpointHook  # noqa: PLC0415
    from grit_tpu_torch.device.snapshot import (  # noqa: PLC0415
        merge_legs,
        restore_snapshot,
        write_snapshot,
    )
    from grit_tpu_torch.parallel.mesh import MeshSpec, active_mesh, build_mesh  # noqa: PLC0415
    from grit_tpu_torch.parallel.sharding import dtensor_index, sharding_of  # noqa: PLC0415

    work, rank = inp["work"], dist.get_rank()
    os.environ["GRIT_TPU_SOCKET_DIR"] = os.path.join(work, "s")
    os.makedirs(os.environ["GRIT_TPU_SOCKET_DIR"], exist_ok=True)
    meshes = {k: build_mesh(MeshSpec(*v), "cpu") for k, v in
              {"122": (1, 2, 2), "212": (2, 1, 2)}.items()}
    out: dict = {"foreign": foreign_modules(), "rank": rank}
    tr = _llama_trainer(inp, torch.bfloat16, meshes["122"])
    tr.run(2)
    tr.snapshot(os.path.join(work, "trainer-snap"))
    out["cut_state"] = _state_np(tr)
    out["cut_full"] = _full_np(tr)
    wq = tr.state["params"]["layers"]["attn"]["wq"]
    out["wq_descriptor"] = sharding_of(wq).descriptor()

    reloaded: dict = {}

    def reload(d: str) -> None:
        like = tr.abstract_state()
        like.pop("rng")  # JAX keeps a threefry key, the port the seed
        got = restore_snapshot(d, like=like, device="cpu")
        reloaded.update({name: (dtensor_index(x) if isinstance(x, DTensor)
                                else None, _local_np(x))
                         for name, x in flatten_with_names(got)})

    agentlet = Agentlet(lambda: tr.state, step_fn=lambda: tr.step,
                        reload_fn=reload).start()
    hook = TpuDeviceCheckpointHook(timeout=120)
    leg = os.path.join(work, "legs", f"host-{rank}")
    mirrored = os.path.join(work, "mlegs", f"host-{rank}")
    try:
        out["hook_errors"] = _drive_hook(agentlet, [
            lambda: hook.dump(os.getpid(), leg),
            lambda: hook.reattach(os.getpid(), inp["jax_parent"])])
        # A second cut, its leg teed into a mirror (the agent's upload).
        out["hook_errors"] += _drive_hook(agentlet, [
            lambda: hook.dump(os.getpid(), mirrored,
                              mirror=mirrored + "-mirror"),
            lambda: hook.resume(os.getpid())])
        # A third, its leg teed over the wire (no speculative pass, so the
        # leg's own data file holds every byte and the wire carries it).
        out["wire"] = _wire_cut(agentlet, hook, os.path.join(
            work, "wlegs", f"host-{rank}"), inp["wire_endpoint"],
            f"host-{rank}/hbm", out["hook_errors"])
    finally:
        agentlet.stop()
    out["reloaded"] = reloaded
    out["source_after"] = tr.run(2)
    dist.barrier()
    merged = os.path.join(work, "merged")
    if rank == 0:
        merge_legs(merged, [os.path.join(work, "legs", f"host-{k}", "hbm")
                            for k in range(dist.get_world_size())])
    dist.barrier()

    same = _llama_trainer(inp, torch.bfloat16, meshes["122"])
    out["leg_step"] = same.restore(os.path.join(leg, "hbm"))
    out["leg_state"] = _state_np(same)
    out["leg_after"] = same.run(2)
    # The wire's receiver holds each rank's leg once the agent commits.
    received = os.path.join(inp["wire_dst"], f"host-{rank}", "hbm")
    _wait_for_file(os.path.join(work, "wire-received"))
    wired = _llama_trainer(inp, torch.bfloat16, meshes["122"])
    out["wire_step"] = wired.restore(received)
    out["wire_state"] = _state_np(wired)
    other = _llama_trainer(inp, torch.bfloat16, meshes["212"])
    other.restore(merged)
    out["merged_full"] = _full_np(other)
    out["merged_after"] = other.run(2)

    # A (2,1,2) state's leg, described by its leaves alone: fsdp (size 1)
    # stays named in every spec, as Trainer.shardings() names it.
    t212 = _llama_trainer(inp, torch.bfloat16, meshes["212"])
    leg212 = os.path.join(work, "leg212", f"host-{rank}")
    write_snapshot(leg212, t212.state, process_index=rank,
                   process_count=dist.get_world_size(), leg=True)
    out["leg212"] = _descriptors(leg212)
    out["shardings212"] = {name: s.descriptor() for name, s in
                           flatten_with_names(t212.shardings())}

    # DTensors that no sharding describes raise, and nothing is written.
    act = active_mesh(meshes["122"])
    bad = {
        "partial": dt.DTensor.from_local(torch.ones(4, 4), act,
                                         [dt.Partial(), dt.Replicate()]),
        "foreign_mesh": dt.distribute_tensor(
            torch.ones(4, 4), init_device_mesh("cpu", (4,),
                                               mesh_dim_names=("x",)),
            [dt.Shard(0)]),
        # A copy of a placed leaf: its sharding stays with the original.
        "detached": wq.detach(),
    }
    out["undescribable"] = {}
    for key, x in bad.items():
        d = os.path.join(work, f"bad-{key}-{rank}")
        try:
            write_snapshot(d, {"x": x}, process_index=rank,
                           process_count=dist.get_world_size(), leg=True)
            out["undescribable"][key] = "written"
        except ValueError as exc:
            out["undescribable"][key] = (f"ValueError: {exc}",
                                         os.path.exists(d))
    return out


def _hold_tail():
    """Patch the post-copy tail to wait for the returned event before it
    places anything (a tail whose cold bytes have not landed)."""
    import threading  # noqa: PLC0415
    from unittest import mock  # noqa: PLC0415

    from grit_tpu_torch.device.snapshot import PostcopyRestore  # noqa: PLC0415

    gate = threading.Event()
    real = PostcopyRestore._pick_ready

    def held(self, pending):
        gate.wait(60)
        return real(self, pending)

    return gate, mock.patch.object(PostcopyRestore, "_pick_ready", held)


def postcopy_mesh_cases(inp: dict) -> dict:
    """Post-copy restores onto a (1,2,2) mesh against the blocking restore
    of the same snapshot: the raw handle with its tail held (the hot set
    placed, the cold leaves not) and released; ``Trainer.restore`` under
    ``GRIT_RESTORE_POSTCOPY``; both families' grid ``restore_postcopy``
    with the bookkeeping hot (the clone parks the source's slots) and
    with nothing hot (it blocks)."""
    from grit_tpu_torch.device.snapshot import (  # noqa: PLC0415
        restore_snapshot,
        restore_snapshot_postcopy,
    )
    from grit_tpu_torch.models import serving  # noqa: PLC0415
    from grit_tpu_torch.parallel.mesh import MeshSpec, build_mesh  # noqa: PLC0415

    work, rank = inp["work"], dist.get_rank()
    mesh = build_mesh(MeshSpec(1, 2, 2), "cpu")
    out: dict = {"foreign": foreign_modules(), "rank": rank}
    src = _llama_trainer(inp, torch.bfloat16, mesh)
    src.run(2)
    snap = os.path.join(work, "snap")
    src.snapshot(snap)

    blocking = _llama_trainer(inp, torch.bfloat16, mesh)
    like = blocking.abstract_state()
    truth = restore_snapshot(snap, like=like, device="cpu")
    os.environ["GRIT_RESTORE_POSTCOPY_HOT_MB"] = inp["hot_mb"]
    gate, patch = _hold_tail()
    with patch:
        handle = restore_snapshot_postcopy(snap, like=like, device="cpu")
        hot = handle.hot_leaves()
        out["held"] = {"placed": handle.placed, "done": handle.done,
                       "hot": sorted(hot),
                       "hot_dtensors": sorted(n for n, x in hot.items()
                                              if isinstance(x, DTensor)),
                       "total": len(flatten_with_names(like))}
        gate.set()
        lazy = handle.wait(60)
    out["lazy_equal"] = {
        name: bool(type(a) is type(b) and np.array_equal(
            _local_np(a), _local_np(b)) and (
            not isinstance(a, DTensor) or a.placements == b.placements))
        for (name, a), (_, b) in zip(flatten_with_names(lazy),
                                     flatten_with_names(truth))}

    # Plain like leaves placed by the snapshot's own descriptors on the
    # mesh (mesh=), or by the Trainer's shardings (shardings=).
    dense_like = _llama_trainer(inp, torch.bfloat16, None).abstract_state()
    out["placed_by"] = {}
    for key, kw in (("mesh", {"mesh": mesh}),
                    ("shardings", {"shardings": blocking.shardings()})):
        got = restore_snapshot_postcopy(snap, like=dense_like, device="cpu",
                                        **kw).wait(60)
        placed = {}
        for (name, a), (_, b) in zip(flatten_with_names(got),
                                     flatten_with_names(truth)):
            split = isinstance(b, DTensor) and not all(
                p.is_replicate() for p in b.placements)
            placed[name] = bool(
                np.array_equal(_local_np(a), _local_np(b))
                and isinstance(a, DTensor) == split
                and (not split or a.placements == b.placements))
        out["placed_by"][key] = placed

    blocking.restore(snap)
    out["blocking_after"] = blocking.run(2)
    out["blocking_state"] = _state_np(blocking)
    os.environ["GRIT_RESTORE_POSTCOPY"] = "1"
    try:
        lazy_tr = _llama_trainer(inp, torch.bfloat16, mesh)
        out["lazy_step"] = lazy_tr.restore(snap)
        out["lazy_pending"] = lazy_tr.postcopy is not None
        out["lazy_after"] = lazy_tr.run(2)
        out["lazy_state"] = _state_np(lazy_tr)
    finally:
        del os.environ["GRIT_RESTORE_POSTCOPY"]

    # Both grid families: a (1,2,2) snapshot mid-flight, restored onto
    # (1,2,2) blocking and by post-copy (the merge run before stepping).
    rounds, cut = inp["rounds"], inp["cut"]
    for fam in ("dense", "moe"):
        cfg = _serving_cfg({"cfg": inp["grid_cfg"]}, fam)
        params = _params(inp["grid_params"][fam])
        prompts = [torch.from_numpy(p) for p in inp["prompts"]]

        def grid():
            return serving.ContinuousBatchingEngine(
                cfg, params, serving.BatchingConfig(
                    n_slots=4, max_seq_len=inp["max_len"], temperature=1.0,
                    seed=7, prefill_buckets=(16, 32)),
                device="cpu", mesh=mesh)

        eng = grid()
        _drive(eng, prompts, cut)
        gsnap = os.path.join(work, f"grid-{fam}")
        eng.snapshot(gsnap)
        res = {"source_after": [eng.step() for _ in range(rounds - cut)]}
        dst = grid()
        dst.restore(gsnap)
        res["blocking_after"] = [dst.step() for _ in range(rounds - cut)]
        res["blocking_cache"] = _written_np(dst.state)
        for label, hot_mb in (("parked", inp["grid_hot_mb"]), ("blocked", "0")):
            os.environ["GRIT_RESTORE_POSTCOPY_HOT_MB"] = hot_mb
            dst = grid()
            dst.restore_postcopy(gsnap)
            res[label] = {"parked": not dst.resumed_all,
                          "free": dst.free_slots()}
            dst.absorb_restored()
            res[label]["after"] = [dst.step() for _ in range(rounds - cut)]
            res[label]["cache"] = _written_np(dst.state)
        out[fam] = res
    return out


def stage_sharding_cases(inp: dict) -> dict:
    """The pipe axis on four ranks, one stage a rank: the descriptors of
    ``stage_shardings`` (on the pipe mesh) and ``pp_stage_shardings`` (on
    a (pipe 2, expert 2) mesh); a pipelined Trainer of the tiny llama (f32,
    four layers) on the pipe mesh takes two steps, snapshots one manifest
    and steps on; a fresh one restores it and steps on; another restores
    the JAX package's pipelined snapshot."""
    from torch.distributed.device_mesh import init_device_mesh  # noqa: PLC0415

    from grit_tpu_torch.device.snapshot import restore_snapshot  # noqa: PLC0415
    from grit_tpu_torch.parallel.mesh import build_pipe_mesh  # noqa: PLC0415
    from grit_tpu_torch.train.trainer import Trainer, TrainerConfig  # noqa: PLC0415

    work, rank, n = inp["work"], dist.get_rank(), dist.get_world_size()
    out: dict = {"foreign": foreign_modules(), "rank": rank}
    cfg = replace(llama.LlamaConfig.tiny(**inp["cfg"]), dtype=torch.float32,
                  param_dtype=torch.float32)
    pipe = build_pipe_mesh("cpu")
    params = _params(inp["params"])
    staged = pipeline_llama.to_stage_params(cfg, params, n)
    out["stage_shardings"] = {
        name: s.descriptor() for name, s in flatten_with_names(
            pipeline_llama.stage_shardings(pipe, staged))}
    mcfg = replace(moe_llama.MoeLlamaConfig.tiny(**inp["cfg"]),
                   dtype=torch.float32, param_dtype=torch.float32)
    mstaged = pipeline_llama.to_stage_params(
        mcfg, moe_llama.init_params(mcfg, None, "meta"), 2)
    ppe = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pipe", "expert"))
    out["pp_stage_shardings"] = {
        name: s.descriptor() for name, s in flatten_with_names(
            moe_llama.pp_stage_shardings(ppe, mstaged))}
    toks = torch.from_numpy(inp["tokens"])

    def trainer():
        def init(_gen, device):
            if torch.device(device).type == "meta":
                return tree_map(lambda a: torch.empty_like(a, device="meta"),
                                staged)
            return tree_map(torch.clone, staged)

        return Trainer(
            loss_fn=lambda p, b: pipeline_llama.loss_fn_pp(
                cfg, p, b[0], b[1], n_microbatches=2),
            init_params=init,
            batch_fn=lambda _gen: (toks[:, :-1], toks[:, 1:]),
            cfg=TrainerConfig(learning_rate=1e-2), device="cpu", mesh=pipe,
            rules=pipeline_llama.STAGE_RULES)

    src = trainer()
    src.run(2)
    snap = os.path.join(work, "pipe-snap")
    src.snapshot(snap)
    out["cut_state"] = _state_np(src)
    out["source_after"] = src.run(2)
    fresh = trainer()
    out["restored_step"] = fresh.restore(snap)
    out["restored_state"] = _state_np(fresh)
    out["restored_after"] = fresh.run(2)
    # The JAX package's pipelined snapshot (rng aside), each rank its stage.
    jt = trainer()
    like = jt.abstract_state()
    like.pop("rng")
    shardings = jt.shardings()
    shardings.pop("rng")
    got = restore_snapshot(inp["jax_dir"], like=like, device="cpu",
                           shardings=shardings)
    out["jax_restored"] = {name: _local_np(x)
                           for name, x in flatten_with_names(got)}
    return out


# -- pp × ep: experts split inside each pipeline stage ----------------------------

# The three specs a pipe mesh's leaves take (a stage leaf, a staged expert
# weight, a replicated leaf) and the staged leaf shape they split:
# (stages, layers a stage, experts, width).
PIPE_SPECS = {"stage": ("pipe",), "stage_expert": ("pipe", None, "expert"),
              "replicated": ()}
PIPE_SHAPE = (2, 3, 4, 6)


def pipe_layouts(mesh) -> dict:
    """Each of :data:`PIPE_SPECS` on ``mesh`` over an ``arange`` of
    :data:`PIPE_SHAPE`: what ``distribute`` hands this rank, the shapes
    ``zeros``, ``held_shape`` and ``global_shape`` give, the shard's index
    and whether this rank writes it."""
    from grit_tpu_torch.parallel.sharding import NamedSharding  # noqa: PLC0415

    x = torch.arange(int(np.prod(PIPE_SHAPE)), dtype=torch.int32).reshape(
        PIPE_SHAPE)
    out = {}
    for key, spec in PIPE_SPECS.items():
        ns = NamedSharding(mesh, spec)
        index = ns.shard_index(PIPE_SHAPE)
        held = ns.distribute(x)
        out[key] = {"held": _np(held), "index": index,
                    "zeros": list(ns.zeros(PIPE_SHAPE, torch.int32,
                                           "cpu").shape),
                    "zeros_meta": list(ns.zeros(PIPE_SHAPE, torch.int32,
                                                "meta").shape),
                    "held_shape": ns.held_shape(index),
                    "global_shape": ns.global_shape(held.shape),
                    "writes": ns.writes()}
    return out


def _pp_ep_cfg(inp: dict):
    return replace(moe_llama.MoeLlamaConfig.tiny(**inp["cfg"]),
                   dtype=torch.float32, param_dtype=torch.float32)


def pp_ep_cases(inp: dict) -> dict:
    """pp × ep on four ranks, a (pipe 2, expert 2) mesh: each rank's
    shard of the staged tiny MoE llama by ``pp_stage_shardings``, the
    pipelined forward with each stage's experts split (``forward_pp
    (mesh=)``) and its cross-entropy gradients, the shard layouts of the
    three specs on (pipe, expert) and (data 1, pipe, expert), a snapshot
    of the staged shards written by every rank into one manifest and
    restored onto the mesh, and the JAX package's pp × ep snapshot
    restored onto it."""
    from grit_tpu_torch.device.snapshot import restore_snapshot, write_snapshot  # noqa: PLC0415
    from grit_tpu_torch.parallel.mesh import build_pipe_mesh  # noqa: PLC0415

    rank = dist.get_rank()
    out: dict = {"foreign": foreign_modules(), "rank": rank}
    cfg = _pp_ep_cfg(inp)
    mesh = build_pipe_mesh("cpu", expert=2)
    out["mesh"] = {"names": list(mesh.mesh_dim_names),
                   "shape": list(mesh.shape),
                   "coord": list(mesh.get_coordinate())}
    out["layouts"] = {"pipe_expert": pipe_layouts(mesh),
                      "data_pipe_expert": pipe_layouts(
                          build_pipe_mesh("cpu", data=1, expert=2))}
    staged = pipeline_llama.to_stage_params(cfg, _params(inp["params"]), 2)
    shardings = dict(flatten_with_names(
        moe_llama.pp_stage_shardings(mesh, staged)))
    out["descriptors"] = {n: s.descriptor() for n, s in shardings.items()}
    local = map_with_names(lambda name, x: shardings[name].distribute(x),
                           staged)
    out["held"] = {name: _np(x) for name, x in flatten_with_names(local)}
    toks = torch.from_numpy(inp["tokens"])
    micro = inp["n_microbatches"]
    with torch.no_grad():
        out["logits"] = _np(moe_llama.forward_pp(
            cfg, local, toks[:, :-1], n_microbatches=micro, mesh=mesh))
    named = flatten_with_names(local)
    leaves = [x.clone().requires_grad_(True) for _, x in named]
    it = iter(leaves)
    params = map_with_names(lambda _n, _x: next(it), local)
    loss = llama.token_cross_entropy(moe_llama.forward_pp(
        cfg, params, toks[:, :-1], n_microbatches=micro, mesh=mesh),
        toks[:, 1:])
    out["loss"] = float(loss.detach())
    out["grads"] = {name: _np(g) for (name, _), g in zip(
        named, torch.autograd.grad(loss, leaves))}
    # One manifest of the staged shards, every rank its (stage, expert)
    # chunk, each distinct one once; restored onto the mesh by every rank.
    snap = os.path.join(inp["work"], "pp-ep-snap")
    write_snapshot(snap, local, meta={"step": 1}, barrier=dist.barrier,
                   process_index=rank, process_count=dist.get_world_size(),
                   shardings=map_with_names(lambda n, _x: shardings[n],
                                            local))
    like = map_with_names(lambda n, x: shardings[n].zeros(
        [int(d) for d in x.shape], x.dtype, "meta"), staged)
    shard_tree = map_with_names(lambda n, _x: shardings[n], staged)
    got = restore_snapshot(snap, like=like, device="cpu", shardings=shard_tree)
    out["restored"] = {name: _np(x) for name, x in flatten_with_names(got)}
    jgot = restore_snapshot(inp["jax_dir"], like=like, device="cpu",
                            shardings=shard_tree)
    out["jax_restored"] = {name: _np(x) for name, x in flatten_with_names(jgot)}
    return out


# -- eight ranks: the (2,2,2) mesh, dp × pp × ep, sequence parallelism -------------


def _masked_pipeline_moe(stacked: dict, x: torch.Tensor,
                         mask: np.ndarray) -> dict:
    """The dp × pp × ep step of ``entry`` with ``mask`` (M, mb) keeping
    some rows of each microbatch: each data shard's kept rows' loss sum
    and count summed over ``data``, the microbatch's loss their ratio.
    Returns the loss and this rank's gradients."""
    from grit_tpu_torch import entry  # noqa: PLC0415
    from grit_tpu_torch.parallel.collectives import reduce_sum  # noqa: PLC0415
    from grit_tpu_torch.parallel.mesh import build_pipe_mesh  # noqa: PLC0415

    mesh = build_pipe_mesh("cpu", data=2, expert=2)
    shardings = entry.moe_stage_shardings(mesh)
    local = {k: shardings[k].distribute(v).requires_grad_(True)
             for k, v in stacked.items()}
    n_mb = entry.PP["n_mb"]
    rows_of = partial(entry.data_rows, mesh)
    out = pipeline_apply(entry._moe_stage(mesh["data", "expert"]), local,
                         rows_of(microbatch(x, n_mb)),
                         axis=mesh.get_group("pipe"))
    data = mesh.get_group("data")
    per = []
    for o, y, keep in zip(out, rows_of(microbatch(0.5 * x, n_mb)),
                          rows_of(torch.from_numpy(mask))):
        rows = entry.row_mse(o, y)
        total = torch.where(keep, rows, torch.zeros_like(rows)).sum()
        per.append(reduce_sum(total, data)
                   / reduce_sum(keep.sum().to(rows.dtype), data))
    loss = torch.stack(per).mean()
    names = list(local)
    grads = torch.autograd.grad(loss, [local[k] for k in names])
    return {"mesh": {"coord": list(mesh.get_coordinate())},
            "loss": float(loss.detach()),
            "grads": {k: _np(g) for k, g in zip(names, grads)}}


def _dense_stage_pipeline(x: torch.Tensor) -> dict:
    """A dense stage ``h + tanh(h @ w)``, ``w`` held whole by every rank
    of its stage, through ``entry.global_row_mean`` on (data 2, pipe 2,
    expert 2): the loss, this rank's gradient of its stage's ``w``, that
    gradient summed over ``data``, and the unsharded composition's loss
    and gradient of the same stage."""
    from grit_tpu_torch import entry  # noqa: PLC0415
    from grit_tpu_torch.parallel.mesh import build_pipe_mesh  # noqa: PLC0415
    from grit_tpu_torch.parallel.sharding import NamedSharding  # noqa: PLC0415

    mesh = build_pipe_mesh("cpu", data=2, expert=2)
    dim = x.shape[1]
    w = 0.1 * torch.randn(2, dim, dim, generator=torch.Generator().manual_seed(7))

    def stage(p, h):
        return h + torch.tanh(h @ p)

    n_mb = entry.PP["n_mb"]
    x_mb, y_mb = microbatch(x, n_mb), microbatch(0.5 * x, n_mb)
    local = NamedSharding(mesh, ("pipe",)).distribute(w).requires_grad_(True)
    out = pipeline_apply(stage, local, entry.data_rows(mesh, x_mb),
                         axis=mesh.get_group("pipe"))
    loss = entry.global_row_mean(out, entry.data_rows(mesh, y_mb),
                                 mesh.get_group("data"))
    (grad,) = torch.autograd.grad(loss, [local])
    summed = grad.clone()
    dist.all_reduce(summed, group=mesh.get_group("data"))
    whole = w.clone().requires_grad_(True)
    per = []
    for xm, ym in zip(x_mb, y_mb):
        h = xm
        for i in range(2):
            h = stage(whole[i], h)
        per.append(entry.row_mse(h, ym).mean())
    dense = torch.stack(per).mean()
    (dense_grad,) = torch.autograd.grad(dense, [whole])
    p = mesh.get_coordinate()[mesh.mesh_dim_names.index("pipe")]
    return {"loss": float(loss.detach()), "dense": float(dense.detach()),
            "grad": _np(grad), "summed": _np(summed),
            "dense_grad": _np(dense_grad[p])}


def mesh8_cases(inp: dict) -> dict:
    """Eight ranks: the tiny llama's first step on the (2,2,2) mesh and
    densely, in bf16 and f32; a (2,2,2) snapshot, its bitwise resume and
    the JAX package's (2,2,2) snapshot restored onto it; the dp × pp × ep
    step of the dryrun on (data 2, pipe 2, expert 2) on the JAX package's
    weights and rows, and with a mask that leaves the data shards unequal
    row counts; a dense stage's gradients through the same loss; the pipe
    layouts on that mesh; the ring and Ulysses
    sequence-parallel forwards over the eight ranks."""
    from grit_tpu_torch import entry  # noqa: PLC0415
    from grit_tpu_torch.device.snapshot import restore_snapshot  # noqa: PLC0415
    from grit_tpu_torch.parallel.mesh import MeshSpec, build_mesh, build_pipe_mesh  # noqa: PLC0415
    from grit_tpu_torch.parallel.sharding import dtensor_index  # noqa: PLC0415

    rank = dist.get_rank()
    cpu = torch.device("cpu")
    out: dict = {"foreign": foreign_modules(), "rank": rank}
    mesh = build_mesh(MeshSpec(2, 2, 2), "cpu")
    out["mesh"] = {"shape": list(mesh.shape),
                   "names": list(mesh.mesh_dim_names),
                   "coord": list(mesh.get_coordinate())}
    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        out[label] = {"sharded": _llama_trainer(inp, dtype, mesh).run(1),
                      "dense": _llama_trainer(inp, dtype, None).run(1)}
    src = _llama_trainer(inp, torch.bfloat16, mesh)
    src.run(2)
    snap = os.path.join(inp["work"], "port-222")
    src.snapshot(snap)
    full = _full_np(src)
    if rank == 0:
        out["port_full"] = full
    out["source_after"] = src.run(2)
    out["source_state"] = _state_np(src)
    fresh = _llama_trainer(inp, torch.bfloat16, mesh)
    out["resumed"] = {"step": fresh.restore(snap), "losses": fresh.run(2),
                      "state": _state_np(fresh)}
    tr = _llama_trainer(inp, torch.bfloat16, mesh)
    like = tr.abstract_state()
    like.pop("rng")
    got = restore_snapshot(inp["jax_dir"], like=like, device="cpu")
    out["jax_restored"] = {
        name: (dtensor_index(x) if isinstance(x, DTensor) else None,
               _local_np(x)) for name, x in flatten_with_names(got)}

    stacked = {k: torch.from_numpy(v) for k, v in inp["pp_stacked"].items()}
    x = torch.from_numpy(inp["pp_x"])
    got = entry.pipeline_moe_step(cpu, stacked, x)
    out["pp"] = {**{k: got[k] for k in ("mesh", "loss", "dense", "err")},
                 "grads": {k: _np(v) for k, v in got["grads"].items()},
                 "updated": {k: _np(v) for k, v in got["updated"].items()}}
    out["pp_masked"] = _masked_pipeline_moe(stacked, x, inp["pp_mask"])
    out["pp_dense_stage"] = _dense_stage_pipeline(x)
    out["layouts"] = pipe_layouts(build_pipe_mesh("cpu", data=2, expert=2))
    sp = entry.seq_parallel(cpu, params=_params(inp["sp_params"]),
                            tokens=torch.from_numpy(inp["sp_tokens"]))
    out["sp"] = {"logits": {k: _np(v) for k, v in sp["logits"].items()},
                 "err": sp["err"]}
    return out
