"""LoRA adapters for the llama model, in the merge formulation.

Counterpart of ``grit_tpu/models/lora.py`` (``TARGETS``, ``LoraConfig``,
``init_lora``, ``merge``, ``lora_loss_fn``; the sharding rules are not
ported). The base weights stay frozen and ``W + (alpha/rank)·A@B`` is
materialised inside the loss, so the loss is a function of the adapter
tree alone: autograd gives adapter-only gradients with no bookkeeping,
and the optimizer state is rank-sized. The frozen base is not part of
the trainer's state; a restoring process rebuilds it from its own seed.

The adapter tree is ``{"layers": {"attn": {"wq_a": (L, in, rank),
"wq_b": (L, rank, out), ...}}}``, the JAX package's names, so a LoRA
trainer's snapshot cross-restores between the packages.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from grit_tpu_torch.models.llama import LlamaConfig, loss_fn

TARGETS = ("wq", "wk", "wv", "wo")


@dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: tuple[str, ...] = ("wq", "wv")


def adapter_shapes(cfg: LlamaConfig, lcfg: LoraConfig) -> dict:
    """``{"wq_a": (L, in, rank), "wq_b": (L, rank, out), ...}``."""
    hd = cfg.head_dim
    out_dims = {"wq": cfg.n_heads * hd, "wk": cfg.n_kv_heads * hd,
                "wv": cfg.n_kv_heads * hd, "wo": cfg.dim}
    in_dims = {"wq": cfg.dim, "wk": cfg.dim, "wv": cfg.dim,
               "wo": cfg.n_heads * hd}
    L, r = cfg.n_layers, lcfg.rank
    shapes = {}
    for t in lcfg.targets:
        shapes[f"{t}_a"] = (L, in_dims[t], r)
        shapes[f"{t}_b"] = (L, r, out_dims[t])
    return shapes


def init_lora(cfg: LlamaConfig, lcfg: LoraConfig,
              generator: torch.Generator | None,
              device: torch.device | str) -> dict:
    """A ~ N(0, 1)/sqrt(rank), B = 0, in ``cfg.param_dtype``: the adapters
    start as the identity (delta 0). On the meta device (``generator``
    None) only the shapes are made: the ``like`` tree of a restore."""
    pd = cfg.param_dtype
    adapters = {}
    for name, shape in adapter_shapes(cfg, lcfg).items():
        if name.endswith("_b"):
            adapters[name] = torch.zeros(shape, dtype=pd, device=device)
        else:
            adapters[name] = (torch.randn(shape, generator=generator,
                                          dtype=pd, device=device)
                              / lcfg.rank ** 0.5)
    return {"layers": {"attn": adapters}}


def merge(params: dict, lora_params: dict, lcfg: LoraConfig) -> dict:
    """Base params plus the scaled low-rank deltas, as a new tree; the base
    is untouched. Each delta is computed in the adapters' dtype, cast to
    the base weight's dtype, scaled by alpha/rank and added."""
    scale = lcfg.alpha / lcfg.rank
    attn = dict(params["layers"]["attn"])
    adapters = lora_params["layers"]["attn"]
    for t in lcfg.targets:
        delta = torch.einsum("lir,lro->lio", adapters[f"{t}_a"],
                             adapters[f"{t}_b"])
        attn[t] = attn[t] + scale * delta.to(attn[t].dtype)
    return {**params, "layers": {**params["layers"], "attn": attn}}


def lora_loss_fn(cfg: LlamaConfig, lcfg: LoraConfig, base_params: dict,
                 lora_params: dict, tokens: torch.Tensor,
                 targets: torch.Tensor, mask: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """The loss as a function of the adapter tree only (base frozen)."""
    return loss_fn(cfg, merge(base_params, lora_params, lcfg), tokens,
                   targets, mask)
