"""Llama-family decoder transformer, training subset, in PyTorch.

Counterpart of ``grit_tpu/models/llama.py``. Parameters are the same
nested dict of **stacked** leaves with a leading ``n_layers`` axis, under
the same names, so a snapshot's leaf names are the JAX package's
(``['params']['layers']['attn']['wq']``) and weights carry across by
name (:mod:`grit_tpu_torch.convert`). The JAX ``lax.scan`` over the
stacked layers becomes a Python loop over ``torch.unbind(leaf, 0)``
views: one unbind per leaf, whose backward stacks the per-layer grads
once (indexing ``leaf[l]`` per layer would allocate a full stacked-size
zero gradient in every layer's backward).

Attention runs through :func:`grit_tpu_torch.ops.attention.causal_attention`:
the CUDA flash kernels on the card at the training shape, plain tensor
ops elsewhere. Decode, the KV cache and chunked cross-entropy come with
the serving slice.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F

from grit_tpu_torch.ops.attention import causal_attention


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    hidden_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def tiny(**overrides) -> "LlamaConfig":
        """Small config for tests (same base values as the JAX tiny)."""
        cfg = LlamaConfig(
            vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            hidden_dim=128, max_seq_len=128,
        )
        return replace(cfg, **overrides)

    @staticmethod
    def flagship(**overrides) -> "LlamaConfig":
        """The migrated flagship's widths (Sheared-LLaMA-2.7B, 13 layers,
        bf16 params and activations): the width ``chip_smoke.py`` trains."""
        cfg = LlamaConfig(
            vocab_size=32000, dim=2560, n_layers=13, n_heads=20,
            n_kv_heads=20, hidden_dim=6912, max_seq_len=4096,
            dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        )
        return replace(cfg, **overrides)


def param_shapes(cfg: LlamaConfig) -> dict:
    """The parameter tree's leaves as ``(shape, fan_in)``; ``fan_in`` None
    marks a norm scale (initialised to ones)."""
    L, d, hd = cfg.n_layers, cfg.dim, cfg.head_dim
    return {
        "tok_emb": ((cfg.vocab_size, d), d),
        "layers": {
            "attn": {
                "wq": ((L, d, cfg.n_heads * hd), d),
                "wk": ((L, d, cfg.n_kv_heads * hd), d),
                "wv": ((L, d, cfg.n_kv_heads * hd), d),
                "wo": ((L, cfg.n_heads * hd, d), d),
            },
            "attn_norm": ((L, d), None),
            "mlp_norm": ((L, d), None),
            "mlp": {
                "w_gate": ((L, d, cfg.hidden_dim), d),
                "w_up": ((L, d, cfg.hidden_dim), d),
                "w_down": ((L, cfg.hidden_dim, d), cfg.hidden_dim),
            },
        },
        "final_norm": ((d,), None),
        "lm_head": ((d, cfg.vocab_size), d),
    }


def _build(spec: dict, make) -> dict:
    return {k: _build(v, make) if isinstance(v, dict) else make(*v)
            for k, v in spec.items()}


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: torch.device | str) -> dict:
    """Initialise the parameter tree on ``device`` from ``generator``
    (which must live on the same device type): dense weights
    N(0, 1/fan_in), norm scales ones, in ``cfg.param_dtype``."""
    pd = cfg.param_dtype

    def make(shape, fan_in):
        if fan_in is None:
            return torch.ones(shape, dtype=pd, device=device)
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w / fan_in ** 0.5).to(pd)

    return _build(param_shapes(cfg), make)


def abstract_params(cfg: LlamaConfig) -> dict:
    """Shape/dtype skeleton of the parameter tree on the meta device
    (allocates nothing): the ``like`` tree of a restore."""
    return _build(param_shapes(cfg), lambda shape, _fan_in: torch.empty(
        shape, dtype=cfg.param_dtype, device="meta"))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, hd); positions: (B, S)."""
    hd = x.shape[-1]
    exps = -torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    angles = positions[..., None].float() * freqs          # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _attn_block(cfg: LlamaConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Self-attention without a cache (the training path)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"].to(cfg.dtype)).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p["wk"].to(cfg.dtype)).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p["wv"].to(cfg.dtype)).reshape(B, S, cfg.n_kv_heads, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = causal_attention(q, k, v).reshape(B, S, cfg.n_heads * hd)
    return out @ p["wo"].to(cfg.dtype)


def _mlp_block(cfg: LlamaConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(x @ p["w_gate"].to(cfg.dtype))
    up = x @ p["w_up"].to(cfg.dtype)
    return (gate * up) @ p["w_down"].to(cfg.dtype)


def layer_body(cfg: LlamaConfig, layer_params: dict, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """One transformer layer (attn_norm → attn → residual → mlp_norm →
    FFN → residual)."""
    h = x + _attn_block(cfg, layer_params["attn"],
                        rms_norm(x, layer_params["attn_norm"], cfg.norm_eps),
                        positions)
    normed = rms_norm(h, layer_params["mlp_norm"], cfg.norm_eps)
    return h + _mlp_block(cfg, layer_params["mlp"], normed).to(h.dtype)


def _unstack(tree: dict, n: int) -> list[dict]:
    """Per-layer views of the stacked layer tree, one unbind per leaf."""
    out: list[dict] = [{} for _ in range(n)]
    for key, val in tree.items():
        parts = _unstack(val, n) if isinstance(val, dict) else torch.unbind(val, 0)
        for layer, part in zip(out, parts):
            layer[key] = part
    return out


def forward_hidden(cfg: LlamaConfig, params: dict,
                   tokens: torch.Tensor) -> torch.Tensor:
    """Decoder trunk up to and including the final norm: tokens (B, S)
    → hidden (B, S, dim) in ``cfg.dtype``."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = F.embedding(tokens, params["tok_emb"]).to(cfg.dtype)
    for layer_params in _unstack(params["layers"], cfg.n_layers):
        x = layer_body(cfg, layer_params, x, positions)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward_trunk(cfg: LlamaConfig, params: dict,
                  tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, vocab) fp32."""
    x = forward_hidden(cfg, params, tokens)
    return (x @ params["lm_head"].to(cfg.dtype)).float()


def forward(cfg: LlamaConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Training forward: tokens (B, S) int → logits (B, S, vocab) fp32."""
    return forward_trunk(cfg, params, tokens)


def token_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy in fp32. ``nll_loss`` (not a gather)
    keeps the backward deterministic on the card."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = F.nll_loss(logp.reshape(-1, logp.shape[-1]), targets.reshape(-1),
                     reduction="none").reshape(targets.shape)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(cfg: LlamaConfig, params: dict, tokens: torch.Tensor,
            targets: torch.Tensor, mask: torch.Tensor | None = None
            ) -> torch.Tensor:
    return token_cross_entropy(forward(cfg, params, tokens), targets, mask)
