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
:func:`forward`. The expert sharding (``MOE_LLAMA_RULES``,
``pp_stage_shardings``) is not ported.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from grit_tpu_torch.models import llama, pipeline_llama
from grit_tpu_torch.models.llama import LlamaConfig, token_cross_entropy
from grit_tpu_torch.ops.moe import moe_mlp, moe_param_shapes


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


def _moe_ffn(cfg: MoeLlamaConfig, B: int, S: int,
             token_mask: torch.Tensor | None = None):
    """The FFN hook for llama's trunk: the expert layer over the B·S
    tokens, which compete for capacity within the batch. ``token_mask``
    (B·S,) bool keeps rows (bucket padding, released serving slots) out
    of the routing, so they never take a real token's capacity."""

    def ffn(layer_params, normed):
        y, aux = moe_mlp(layer_params["moe"], normed.reshape(B * S, cfg.dim),
                         capacity_factor=cfg.capacity_factor,
                         top_k=cfg.top_k, token_mask=token_mask)
        return y.reshape(B, S, cfg.dim), aux

    return ffn


def forward_with_aux(cfg: MoeLlamaConfig, params: dict, tokens: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Tokens (B, S) → (logits (B, S, vocab) fp32, the mean aux over the
    layers)."""
    B, S = tokens.shape
    x, aux = llama.forward_hidden(cfg, params, tokens,
                                  mlp_fn=_moe_ffn(cfg, B, S), return_aux=True)
    logits = (x @ params["lm_head"].to(cfg.dtype)).float()
    return logits, aux.mean()


def forward(cfg: MoeLlamaConfig, params: dict,
            tokens: torch.Tensor) -> torch.Tensor:
    return forward_with_aux(cfg, params, tokens)[0]


def decode(cfg: MoeLlamaConfig, params: dict, tokens: torch.Tensor,
           cache: dict, token_mask: torch.Tensor | None = None
           ) -> tuple[torch.Tensor, dict]:
    """Serving step (prefill or S = 1 decode): llama's cached attention
    with the expert feed-forward; the cache layout is llama's, so the
    serving engines migrate MoE generations unchanged. ``token_mask``
    (B·S,) as :func:`_moe_ffn` takes it; the aux is dropped."""
    B, S = tokens.shape
    ffn = _moe_ffn(cfg, B, S, token_mask=token_mask)
    return llama.decode(cfg, params, tokens, cache,
                        mlp_fn=lambda lp, normed: ffn(lp, normed)[0])


def decode_ragged(cfg: MoeLlamaConfig, params: dict, tokens: torch.Tensor,
                  cache: dict, lengths: torch.Tensor, active: torch.Tensor
                  ) -> tuple[torch.Tensor, dict]:
    """The continuous-batching step for the MoE family: llama's ragged
    step with the expert feed-forward, released slots' stale tokens
    masked out of the routing."""
    B, S = tokens.shape
    mask = active.to(cache["k"].device).repeat_interleave(S)
    ffn = _moe_ffn(cfg, B, S, token_mask=mask)
    return llama.decode_ragged(cfg, params, tokens, cache, lengths, active,
                               mlp_fn=lambda lp, normed: ffn(lp, normed)[0])


init_kv_cache = llama.init_kv_cache  # the same cache layout


def forward_pp(cfg: MoeLlamaConfig, stage_params: dict, tokens: torch.Tensor,
               *, n_microbatches: int, axis=None) -> torch.Tensor:
    """The pipelined MoE forward: :func:`pipeline_llama.forward_pp` with
    the expert feed-forward per microbatch (``stage_params``: this rank's
    stage of :func:`pipeline_llama.to_stage_params` on an MoE tree). The
    aux is dropped, as the reference's stage drops it."""
    return pipeline_llama.forward_pp(
        cfg, stage_params, tokens, n_microbatches=n_microbatches,
        axis=axis, mlp_fn_builder=lambda mb, S: _moe_ffn(cfg, mb, S))


def loss_fn(cfg: MoeLlamaConfig, params: dict, tokens: torch.Tensor,
            targets: torch.Tensor, mask: torch.Tensor | None = None
            ) -> torch.Tensor:
    """Next-token cross entropy (llama's, same masking) plus the weighted
    load-balancing aux."""
    logits, aux = forward_with_aux(cfg, params, tokens)
    return token_cross_entropy(logits, targets, mask) + cfg.aux_weight * aux
