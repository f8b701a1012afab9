"""MoE-llama: llama attention with a top-k expert feed-forward in every
layer (Mixtral-shaped; ``top_k`` 1 is Switch routing, 2 Mixtral's).

Counterpart of ``grit_tpu/models/moe_llama.py``'s training path:
``MoeLlamaConfig``, ``init_params``, ``forward_with_aux``, ``forward`` and
``loss_fn``. It composes llama's trunk (:func:`llama.forward_hidden`
through its ``mlp_fn`` hook, remat included) with
:func:`grit_tpu_torch.ops.moe.moe_mlp`; the router's load-balancing aux
is averaged over the layers and added to the LM loss. The parameter tree
is llama's without the dense FFN, plus the stacked
``['layers']['moe']`` leaves (``router`` (L, dim, E), ``w_in``
(L, E, dim, hidden), ``w_out`` (L, E, hidden, dim)), under the JAX
package's names, so snapshots of the two cross-restore.

Serving (``decode``, ``decode_ragged``), the pipelined forward and the
expert sharding are not ported.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from grit_tpu_torch.models import llama
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


def _moe_ffn(cfg: MoeLlamaConfig, B: int, S: int):
    """The FFN hook for llama's trunk: the expert layer over the B·S
    tokens, which compete for capacity within the batch."""

    def ffn(layer_params, normed):
        y, aux = moe_mlp(layer_params["moe"], normed.reshape(B * S, cfg.dim),
                         capacity_factor=cfg.capacity_factor,
                         top_k=cfg.top_k)
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


def loss_fn(cfg: MoeLlamaConfig, params: dict, tokens: torch.Tensor,
            targets: torch.Tensor, mask: torch.Tensor | None = None
            ) -> torch.Tensor:
    """Next-token cross entropy (llama's, same masking) plus the weighted
    load-balancing aux."""
    logits, aux = forward_with_aux(cfg, params, tokens)
    return token_cross_entropy(logits, targets, mask) + cfg.aux_weight * aux
