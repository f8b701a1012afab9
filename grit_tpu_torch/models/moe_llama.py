"""MoE-llama: llama attention with a top-k expert feed-forward in every
layer (Mixtral-shaped; ``top_k`` 1 is Switch routing, 2 Mixtral's).

Counterpart of ``grit_tpu/models/moe_llama.py``: ``MoeLlamaConfig``,
``init_params``, ``forward_with_aux``, ``forward`` and ``loss_fn``; the
serving steps ``decode`` and ``decode_ragged`` (llama's, through their
``mlp_fn`` hook) and ``init_kv_cache``; and ``forward_pp``, the pipelined
forward. It composes llama's trunk (:func:`llama.forward_hidden`
through its ``mlp_fn`` hook, remat included) with
:func:`grit_tpu_torch.ops.moe.moe_mlp`; the router's load-balancing aux
is averaged over the layers and added to the LM loss. The parameter tree
is llama's without the dense FFN, plus the stacked
``['layers']['moe']`` leaves (``router`` (L, dim, E), ``w_in``
(L, E, dim, hidden), ``w_out`` (L, E, hidden, dim)), under the JAX
package's names, so snapshots of the two cross-restore.

Tokens compete for expert capacity within one call, so a prefill, a
decode step and a pipeline microbatch drop differently from a whole
training batch when capacity binds (the reference's capacity note); with
``capacity_factor >= n_experts`` nothing drops and all of them agree with
:func:`forward`.

Sharded (``MOE_LLAMA_RULES``, the JAX package's table): llama's rules,
the experts over ``model`` and their hidden dims over ``fsdp``, the
router replicated. ``mesh=`` on :func:`forward_with_aux`, :func:`forward`,
:func:`loss_fn`, :func:`decode` and :func:`decode_ragged` runs the expert
layer expert-parallel over ``EXPERT_MESH_AXIS`` with the whole batch's
routing (:func:`grit_tpu_torch.ops.moe.moe_mlp`): the sharded Trainer's
loss closes over its mesh, and the serving engines pass theirs.
:func:`pp_stage_shardings` is the pipelined MoE's layout: the pipeline's,
with the experts' dim (axis 2 of a staged leaf) over the expert axis;
``forward_pp(mesh=)`` runs on it (pp × ep: each stage's experts split
over ``expert``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from grit_tpu_torch.models import llama, pipeline_llama
from grit_tpu_torch.models.llama import (  # noqa: F401  (BATCH_SPEC: re-export)
    BATCH_SPEC,
    LlamaConfig,
    token_cross_entropy,
)
from grit_tpu_torch.ops.moe import moe_mlp, moe_param_shapes
from grit_tpu_torch.parallel.mesh import DATA_AXIS, EXPERT_AXIS, PIPE_AXIS
from grit_tpu_torch.parallel.sharding import NamedSharding, ShardingRules
from grit_tpu_torch.tree import map_with_names

# Experts ride the tensor-parallel axis, as in the reference.
EXPERT_MESH_AXIS = "model"


@dataclass(frozen=True)
class MoeLlamaConfig(LlamaConfig):
    n_experts: int = 8
    capacity_factor: float = 1.25
    aux_weight: float = 0.01  # load-balancing loss weight
    # Experts per token: 1 = Switch, 2 = Mixtral (gates renormalised over
    # the chosen experts).
    top_k: int = 1

    @staticmethod
    def tiny(**overrides) -> "MoeLlamaConfig":
        """Derived from llama's tiny, as the reference's is."""
        base = {f.name: getattr(LlamaConfig.tiny(), f.name)
                for f in dataclasses.fields(LlamaConfig)}
        base.update({"n_experts": 4})
        base.update(overrides)
        return MoeLlamaConfig(**base)

    @staticmethod
    def bench(**overrides) -> "MoeLlamaConfig":
        """``bench.py``'s MoE model (``bench_moe``): about 0.82 B params,
        8 experts, top-2, bf16 params and activations."""
        cfg = MoeLlamaConfig(
            dim=1024, n_layers=12, n_heads=8, n_kv_heads=8, hidden_dim=3584,
            max_seq_len=1024, n_experts=8, top_k=2,
            param_dtype=torch.bfloat16)
        return dataclasses.replace(cfg, **overrides)


# llama's rules plus the expert weights: experts over 'model', hidden dims
# over 'fsdp', the router replicated (the JAX package's table).
MOE_LLAMA_RULES = ShardingRules(
    rules=[
        *llama.LLAMA_RULES.rules,
        (r"moe/router", (None, None, None)),            # (L, dim, E)
        (r"moe/w_in", (None, "model", "fsdp", None)),   # (L, E, dim, hid)
        (r"moe/w_out", (None, "model", None, "fsdp")),  # (L, E, hid, dim)
    ],
    default=llama.LLAMA_RULES.default,
)


def _moe_shapes(cfg: MoeLlamaConfig) -> dict:
    return {name: ((cfg.n_layers, *shape), scale) for name, (shape, scale)
            in moe_param_shapes(cfg.dim, cfg.hidden_dim, cfg.n_experts).items()}


def init_params(cfg: MoeLlamaConfig, generator: torch.Generator,
                device: torch.device | str) -> dict:
    """llama's tree without the dense FFN, then the stacked expert
    leaves, each N(0, 1) times 1/sqrt(fan_in) in fp32, cast to
    ``cfg.param_dtype``."""
    params = llama.init_params(cfg, generator, device, with_mlp=False)
    params["layers"]["moe"] = {
        name: (torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device) * scale).to(cfg.param_dtype)
        for name, (shape, scale) in _moe_shapes(cfg).items()}
    return params


def _moe_ffn(cfg: MoeLlamaConfig, mesh=None,
             token_mask: torch.Tensor | None = None,
             expert_axis: str = EXPERT_MESH_AXIS):
    """The FFN hook for llama's trunk: the expert layer over the (B, S)
    tokens it is given, which compete for capacity within the batch (over
    every shard of it on a ``mesh``). ``token_mask`` (B·S,) bool keeps rows
    (bucket padding, released serving slots) out of the routing, so they
    never take a real token's capacity."""

    def ffn(layer_params, normed):
        y, aux = moe_mlp(layer_params["moe"], normed.reshape(-1, cfg.dim),
                         capacity_factor=cfg.capacity_factor, mesh=mesh,
                         axis=expert_axis, top_k=cfg.top_k,
                         token_mask=token_mask)
        return y.reshape(normed.shape), aux

    return ffn


def forward_with_aux(cfg: MoeLlamaConfig, params: dict, tokens: torch.Tensor,
                     mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Tokens (B, S) → (logits (B, S, vocab) fp32, the mean aux over the
    layers). ``mesh``: the expert layer runs expert-parallel on it (the
    sharded Trainer's DTensors)."""
    x, aux = llama.forward_hidden(cfg, params, tokens,
                                  mlp_fn=_moe_ffn(cfg, mesh), return_aux=True)
    logits = (x @ params["lm_head"].to(cfg.dtype)).float()
    return logits, aux.mean()


def forward(cfg: MoeLlamaConfig, params: dict, tokens: torch.Tensor,
            mesh=None) -> torch.Tensor:
    return forward_with_aux(cfg, params, tokens, mesh=mesh)[0]


def _local_mask(cfg: MoeLlamaConfig, mesh, cache: dict, B: int, S: int,
                token_mask: torch.Tensor | None) -> torch.Tensor | None:
    """This rank's rows of a (B·S,) token mask on a serving mesh (its
    slots')."""
    if mesh is None or token_mask is None:
        return token_mask
    slots = llama.kv_shard(cfg, mesh, cache).slots
    return token_mask.reshape(B, S)[slots].reshape(-1)


def decode(cfg: MoeLlamaConfig, params: dict, tokens: torch.Tensor,
           cache: dict, token_mask: torch.Tensor | None = None, mesh=None
           ) -> tuple[torch.Tensor, dict]:
    """Serving step (prefill or S = 1 decode): llama's cached attention
    with the expert feed-forward; the cache layout is llama's, so the
    serving engines migrate MoE generations unchanged. ``token_mask``
    (B·S,) as :func:`_moe_ffn` takes it; the aux is dropped. ``mesh``: a
    cache sharded by the serving rules (:func:`llama.decode`), the experts
    over its ``model`` axis, the routing over every slot's tokens."""
    B, S = tokens.shape
    ffn = _moe_ffn(cfg, mesh, _local_mask(cfg, mesh, cache, B, S, token_mask))
    return llama.decode(cfg, params, tokens, cache,
                        mlp_fn=lambda lp, normed: ffn(lp, normed)[0],
                        mesh=mesh)


def decode_ragged(cfg: MoeLlamaConfig, params: dict, tokens: torch.Tensor,
                  cache: dict, lengths: torch.Tensor, active: torch.Tensor,
                  mesh=None) -> tuple[torch.Tensor, dict]:
    """The continuous-batching step for the MoE family: llama's ragged
    step with the expert feed-forward, released slots' stale tokens
    masked out of the routing (``mesh`` as :func:`decode` takes it)."""
    B, S = tokens.shape
    mask = _local_mask(cfg, mesh, cache, B, S,
                       active.to(cache["k"].device).repeat_interleave(S))
    ffn = _moe_ffn(cfg, mesh, token_mask=mask)
    return llama.decode_ragged(cfg, params, tokens, cache, lengths, active,
                               mlp_fn=lambda lp, normed: ffn(lp, normed)[0],
                               mesh=mesh)


init_kv_cache = llama.init_kv_cache  # the same cache layout


def forward_pp(cfg: MoeLlamaConfig, stage_params: dict, tokens: torch.Tensor,
               *, n_microbatches: int, axis=None, mesh=None) -> torch.Tensor:
    """The pipelined MoE forward: :func:`pipeline_llama.forward_pp` with
    the expert feed-forward per microbatch (``stage_params``: this rank's
    stage of :func:`pipeline_llama.to_stage_params` on an MoE tree). The
    aux is dropped, as the reference's stage drops it.

    ``mesh``: pp × ep (a :func:`~grit_tpu_torch.parallel.mesh.build_pipe_mesh`
    mesh with an ``expert`` axis; ``axis`` is then its ``pipe`` group).
    ``stage_params`` is this rank's shard by :func:`pp_stage_shardings`,
    its stage's experts split over ``expert``, and each stage's expert
    layer runs expert-parallel on the sub-mesh without ``pipe``
    (:func:`grit_tpu_torch.ops.moe.moe_mlp` takes every other axis of the
    mesh it is given for a token axis), the routing global over the
    microbatch's tokens, which every rank of a stage holds. A ``data``
    axis larger than 1 raises: the batch is not split here (the dryrun's
    data-parallel pipeline is :func:`grit_tpu_torch.entry.pipeline_moe_loss`).

    Capacity note: tokens compete for an expert's capacity within one
    microbatch here and within the whole batch in :func:`forward`; with
    ``capacity_factor >= n_experts`` nothing drops and the two agree."""
    sub = None
    if mesh is not None:
        names = mesh.mesh_dim_names
        if DATA_AXIS in names and mesh.size(names.index(DATA_AXIS)) > 1:
            raise ValueError("forward_pp does not split the batch over "
                             f"{DATA_AXIS!r}: {dict(zip(names, mesh.shape))}")
        axis = mesh.get_group(PIPE_AXIS)
        rest = tuple(n for n in names if n != PIPE_AXIS)
        sub = mesh[rest] if len(rest) > 1 else mesh[rest[0]]
    return pipeline_llama.forward_pp(
        cfg, stage_params, tokens, n_microbatches=n_microbatches,
        axis=axis, mlp_fn_builder=lambda _mb, _S: _moe_ffn(
            cfg, sub, expert_axis=EXPERT_AXIS))


def pp_stage_shardings(mesh, stage_params: dict, pipe_axis: str = PIPE_AXIS,
                       expert_axis: str = EXPERT_AXIS) -> dict:
    """The pipelined MoE's layout: :func:`pipeline_llama.stage_shardings`
    (layer leaves over ``pipe_axis``, the rest replicated) with the
    expert weights ``w_in``/``w_out``, staged (n_stages, per, E, ...),
    sharding their expert dim, axis 2, over ``expert_axis``."""
    base = pipeline_llama.stage_shardings(mesh, stage_params, axis=pipe_axis)
    return map_with_names(
        lambda name, sh: NamedSharding(mesh, (pipe_axis, None, expert_axis))
        if name.startswith("['layers']") and name.endswith(
            ("['w_in']", "['w_out']")) else sh, base)


def loss_fn(cfg: MoeLlamaConfig, params: dict, tokens: torch.Tensor,
            targets: torch.Tensor, mask: torch.Tensor | None = None,
            mesh=None) -> torch.Tensor:
    """Next-token cross entropy (llama's, same masking) plus the weighted
    load-balancing aux. A sharded Trainer's loss closes over its ``mesh``,
    so the expert layer runs expert-parallel with the whole batch's
    routing."""
    logits, aux = forward_with_aux(cfg, params, tokens, mesh=mesh)
    return token_cross_entropy(logits, targets, mask) + cfg.aux_weight * aux
