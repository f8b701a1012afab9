"""Pipeline-parallel llama: the decoder over the GPipe schedule.

Counterpart of ``grit_tpu/models/pipeline_llama.py`` (``to_stage_params``,
``from_stage_params``, ``_stage_fn``, ``forward_pp``, ``loss_fn_pp``).
The embedding and ``lm_head`` run outside the pipeline on every rank
(replicated compute, as in the reference); the layer stack, where the
parameters and the work are, splits into ``n_stages`` contiguous groups,
one per rank of the axis (:mod:`grit_tpu_torch.parallel.pipeline`). The
stage's body is llama's own layer loop (:func:`llama.layer_stack`) over
its local layers, with llama's per-layer remat when ``cfg.remat`` is set
(the reference's stage has none; remat is bitwise neutral). The stage
interface carries (mb, S, dim) activations, the whole sequence of each
microbatch.

A checkpoint interchanges with the dense layout: :func:`to_stage_params`
and :func:`from_stage_params` are pure reshapes of the same tree. Each
rank holds only its stage: :func:`stage_slice` of the staged tree, whose
layer leaves are (L / n_stages, ...); the embedding, final norm and
``lm_head`` are on every rank. On a pipe mesh a rank's stage tree is
its shard of the staged tree (:func:`stage_shardings`, the JAX package's
layout: layer leaves over ``pipe``, the rest replicated), so a pipelined
Trainer (rules :data:`STAGE_RULES`) writes one manifest of the staged
arrays, which :func:`from_stage_params` turns into the dense tree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from grit_tpu_torch.models import llama
from grit_tpu_torch.models.llama import LlamaConfig, rms_norm, token_cross_entropy
from grit_tpu_torch.parallel.pipeline import (
    PIPE_AXIS,
    microbatch,
    pipeline_apply,
)
from grit_tpu_torch.parallel.sharding import NamedSharding, ShardingRules
from grit_tpu_torch.tree import map_with_names, tree_map

# A pipelined Trainer's table (the JAX package's tests/test_pipeline_llama.py
# rules): the staged layer leaves over the stages, everything else whole.
STAGE_RULES = ShardingRules(rules=[(r"layers/", (PIPE_AXIS,))])


def to_stage_params(cfg: LlamaConfig, params: dict, n_stages: int) -> dict:
    """The stacked layer leaves (L, ...) as (n_stages, L / n_stages, ...)
    (views); :func:`from_stage_params` inverts it exactly."""
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers not divisible by "
                         f"{n_stages} stages")
    per = cfg.n_layers // n_stages
    return {**params, "layers": tree_map(
        lambda a: a.reshape(n_stages, per, *a.shape[1:]), params["layers"])}


def from_stage_params(params: dict) -> dict:
    """Undo :func:`to_stage_params`: the dense (L, ...) leaves."""
    return {**params, "layers": tree_map(
        lambda a: a.reshape(a.shape[0] * a.shape[1], *a.shape[2:]),
        params["layers"])}


def stage_slice(stage_params: dict, stage: int) -> dict:
    """What rank ``stage`` holds of a staged tree: its layer group and
    the replicated embedding, final norm and ``lm_head``."""
    return {**stage_params,
            "layers": tree_map(lambda a: a[stage], stage_params["layers"])}


def stage_shardings(mesh, params: dict, axis: str = PIPE_AXIS) -> dict:
    """Layer leaves sharded over ``axis``; embedding, final norm and
    ``lm_head`` replicated (a tree like ``params``)."""
    return map_with_names(
        lambda name, _leaf: NamedSharding(
            mesh, (axis,) if name.startswith("['layers']") else ()), params)


def _stage_fn(cfg: LlamaConfig, mlp_fn_builder=None):
    """One stage: this rank's layers through llama's layer loop.
    ``mlp_fn_builder(mb, S) -> mlp_fn`` swaps the feed-forward per
    activation shape (the MoE family pipelines through it)."""

    def fn(stage_layers, x):
        mb, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(mb, S)
        mlp_fn = mlp_fn_builder(mb, S) if mlp_fn_builder else None
        x, _aux = llama.layer_stack(cfg, stage_layers, x, positions,
                                    mlp_fn=mlp_fn)
        return x

    return fn


def forward_pp(cfg: LlamaConfig, stage_params: dict, tokens: torch.Tensor, *,
               n_microbatches: int, axis=None,
               mlp_fn_builder=None) -> torch.Tensor:
    """Tokens (B, S), the same on every rank → logits (B, S, vocab) fp32
    on every rank, through the layer pipeline over ``axis``.
    ``stage_params``: this rank's :func:`stage_slice`; B must divide by
    ``n_microbatches``."""
    B, S = tokens.shape
    x = F.embedding(tokens, stage_params["tok_emb"]).to(cfg.dtype)
    y_mb = pipeline_apply(_stage_fn(cfg, mlp_fn_builder),
                          stage_params["layers"],
                          microbatch(x, n_microbatches), axis=axis)
    y = rms_norm(y_mb.reshape(B, S, cfg.dim), stage_params["final_norm"],
                 cfg.norm_eps)
    return (y @ stage_params["lm_head"].to(cfg.dtype)).float()


def loss_fn_pp(cfg: LlamaConfig, stage_params: dict, tokens: torch.Tensor,
               targets: torch.Tensor, mask: torch.Tensor | None = None, *,
               n_microbatches: int, axis=None) -> torch.Tensor:
    """The pipelined next-token loss, the same value on every rank; its
    backward gives each rank its stage's layer gradients and the whole
    gradients of the embedding, final norm and ``lm_head``."""
    logits = forward_pp(cfg, stage_params, tokens,
                        n_microbatches=n_microbatches, axis=axis)
    return token_cross_entropy(logits, targets, mask)
