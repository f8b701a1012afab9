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

import os
import sys
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

from grit_tpu_torch import convert
from grit_tpu_torch.models import llama, long_context, moe_llama, pipeline_llama
from grit_tpu_torch.ops.ring_attention import ring_attention
from grit_tpu_torch.ops.ulysses import ulysses_attention
from grit_tpu_torch.parallel import axis_index, axis_size
from grit_tpu_torch.parallel.pipeline import microbatch, pipeline_apply, pipeline_loss
from grit_tpu_torch.tree import flatten_with_names, tree_map

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
