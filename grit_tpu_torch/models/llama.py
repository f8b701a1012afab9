"""Llama-family decoder transformer in PyTorch: training and serving.

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
ops elsewhere. Serving (:func:`decode`, :func:`decode_ragged`) always
passes ``kv_len``, so it runs the plain path, as the reference's does.

The serving functions write new K/V into the cache's tensors in place
(the JAX functions return new arrays; a copy of a multi-GB cache per
token buys nothing here) and return the cache dict with the new
``length``. ``length`` is a host-side int32 scalar, as the trainer keeps
its step: every cache write is bounds-checked on the host, with no device
sync, and an out-of-range write raises where ``lax.dynamic_update_slice``
would clamp.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from grit_tpu_torch.ops.attention import causal_attention
from grit_tpu_torch.tree import flatten_with_names


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
    # Per-layer rematerialization: the backward recomputes each layer from
    # its input instead of keeping its activations, so activation memory
    # holds one layer's input per layer (the counterpart of the reference's
    # jax.checkpoint around the scan body). The flash forward then
    # launches twice per layer and step.
    remat: bool = False

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


def param_shapes(cfg: LlamaConfig, with_mlp: bool = True) -> dict:
    """The parameter tree's leaves as ``(shape, fan_in)``; ``fan_in`` None
    marks a norm scale (initialised to ones). ``with_mlp=False`` leaves
    out the dense feed-forward, for the families that replace it."""
    L, d, hd = cfg.n_layers, cfg.dim, cfg.head_dim
    spec = {
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
    if not with_mlp:
        del spec["layers"]["mlp"]
    return spec


def _build(spec: dict, make) -> dict:
    return {k: _build(v, make) if isinstance(v, dict) else make(*v)
            for k, v in spec.items()}


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: torch.device | str, with_mlp: bool = True) -> dict:
    """Initialise the parameter tree on ``device`` from ``generator``
    (which must live on the same device type): dense weights
    N(0, 1/fan_in), norm scales ones, in ``cfg.param_dtype``.
    ``with_mlp=False`` allocates no dense feed-forward (the MoE family
    replaces it)."""
    pd = cfg.param_dtype

    def make(shape, fan_in):
        if fan_in is None:
            return torch.ones(shape, dtype=pd, device=device)
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w / fan_in ** 0.5).to(pd)

    return _build(param_shapes(cfg, with_mlp), make)


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


def _ragged_cache_write(cache: torch.Tensor, new: torch.Tensor,
                        starts: torch.Tensor, active: torch.Tensor) -> None:
    """Write row ``b``'s ``new[b]`` (S positions) into ``cache[b]`` at its
    own offset ``starts[b]``, in place; inactive rows are left
    byte-identical (their current content at positions 0..S-1 is written
    back). One B-row scatter, never a full-cache rewrite. The caller
    keeps active rows' writes in range (:func:`decode_ragged`)."""
    B, S = new.shape[:2]
    span = torch.arange(S, device=cache.device)
    rows = torch.arange(B, device=cache.device)[:, None]
    pos = torch.where(active[:, None], starts[:, None] + span, span)
    cur = cache[rows, pos]
    cache[rows, pos] = torch.where(active[:, None, None, None], new, cur)


def _attn_block(cfg: LlamaConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor,
                cache: tuple | None = None,
                active: torch.Tensor | None = None,
                attn_fn=None) -> torch.Tensor:
    """Self-attention; with ``cache=(k_cache, v_cache, cur_len)`` it runs
    the serving path: write the new K/V at ``cur_len`` into the caches
    (in place) and attend into them.

    ``cur_len`` is a Python int (lock-step batch: every row at the same
    position) or a per-row ``(B,)`` tensor on the cache's device
    (continuous batching, with ``active`` (B,): released slots' rows stay
    untouched). One implementation of projections, RoPE and output for
    training and both serving cases, so the paths cannot drift.

    ``attn_fn(q, k, v) -> out`` replaces the cache-less attention core
    (the long-context family runs ring or Ulysses attention through it,
    the same pattern as ``mlp_fn``)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"].to(cfg.dtype)).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p["wk"].to(cfg.dtype)).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p["wv"].to(cfg.dtype)).reshape(B, S, cfg.n_kv_heads, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is None:
        out = (attn_fn or causal_attention)(q, k, v)
    else:
        k_cache, v_cache, cur_len = cache
        if isinstance(cur_len, int):
            if not 0 <= cur_len <= k_cache.shape[1] - S:
                raise ValueError(
                    f"KV cache write of {S} positions at {cur_len} overruns "
                    f"max_len={k_cache.shape[1]}")
            k_cache[:, cur_len:cur_len + S] = k
            v_cache[:, cur_len:cur_len + S] = v
        else:
            _ragged_cache_write(k_cache, k, cur_len, active)
            _ragged_cache_write(v_cache, v, cur_len, active)
        out = causal_attention(q, k_cache, v_cache, q_offset=cur_len,
                               kv_len=cur_len + S)
    out = out.reshape(B, S, cfg.n_heads * hd)
    return out @ p["wo"].to(cfg.dtype)


def _mlp_block(cfg: LlamaConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(x @ p["w_gate"].to(cfg.dtype))
    up = x @ p["w_up"].to(cfg.dtype)
    return (gate * up) @ p["w_down"].to(cfg.dtype)


def layer_body(cfg: LlamaConfig, layer_params: dict, x: torch.Tensor,
               positions: torch.Tensor, cache=None, active=None,
               mlp_fn=None, attn_fn=None
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One transformer layer (attn_norm → attn → residual → mlp_norm →
    FFN → residual), the single copy of the layer math for training and
    serving (``cache``/``active`` as :func:`_attn_block` takes them).

    ``mlp_fn(layer_params, normed) -> (y, aux)`` replaces the dense
    feed-forward (the MoE family runs through this hook) and
    ``attn_fn(q, k, v) -> out`` the attention core (the long-context
    family). Returns ``(h, aux)``; the dense FFN's aux is None."""
    h = x + _attn_block(cfg, layer_params["attn"],
                        rms_norm(x, layer_params["attn_norm"], cfg.norm_eps),
                        positions, cache=cache, active=active,
                        attn_fn=attn_fn)
    normed = rms_norm(h, layer_params["mlp_norm"], cfg.norm_eps)
    if mlp_fn is None:
        y, aux = _mlp_block(cfg, layer_params["mlp"], normed), None
    else:
        y, aux = mlp_fn(layer_params, normed)
    return h + y.to(h.dtype), aux


def _unstack(tree: dict, n: int) -> list[dict]:
    """Per-layer views of the stacked layer tree, one unbind per leaf."""
    out: list[dict] = [{} for _ in range(n)]
    for key, val in tree.items():
        parts = _unstack(val, n) if isinstance(val, dict) else torch.unbind(val, 0)
        for layer, part in zip(out, parts):
            layer[key] = part
    return out


def layer_stack(cfg: LlamaConfig, layers: dict, x: torch.Tensor,
                positions: torch.Tensor, mlp_fn=None, attn_fn=None
                ) -> tuple[torch.Tensor, list]:
    """``x`` through every layer of the stacked tree ``layers`` (their
    count is the leaves' leading axis), each under non-reentrant
    activation checkpointing when ``cfg.remat`` is set, which keeps only
    the layer's input and replays the layer in the backward. Returns
    ``(x, per-layer aux list)``. The single copy of the layer loop: the
    dense trunk and each pipeline stage run it."""
    n = flatten_with_names(layers)[0][1].shape[0]
    auxes = []
    for layer_params in _unstack(layers, n):
        if cfg.remat:
            x, aux = checkpoint(layer_body, cfg, layer_params, x, positions,
                                mlp_fn=mlp_fn, attn_fn=attn_fn,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = layer_body(cfg, layer_params, x, positions,
                                mlp_fn=mlp_fn, attn_fn=attn_fn)
        auxes.append(aux)
    return x, auxes


def forward_hidden(cfg: LlamaConfig, params: dict, tokens: torch.Tensor,
                   mlp_fn=None, return_aux: bool = False, attn_fn=None,
                   positions: torch.Tensor | None = None):
    """Decoder trunk up to and including the final norm: tokens (B, S)
    → hidden (B, S, dim) in ``cfg.dtype``; the single copy of the
    positions and remat semantics (:func:`layer_stack`).

    ``mlp_fn`` and ``attn_fn`` as :func:`layer_body` takes them.
    ``positions`` (B, S) defaults to ``arange(S)``; a rank holding one
    shard of a longer sequence passes its own (the long-context family).
    ``return_aux`` (with an ``mlp_fn``) returns ``(hidden, aux)`` with
    the per-layer aux stacked to (n_layers,)."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = F.embedding(tokens, params["tok_emb"]).to(cfg.dtype)
    x, auxes = layer_stack(cfg, params["layers"], x, positions,
                           mlp_fn=mlp_fn, attn_fn=attn_fn)
    hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (hidden, torch.stack(auxes)) if return_aux else hidden


def forward_trunk(cfg: LlamaConfig, params: dict, tokens: torch.Tensor,
                  attn_fn=None,
                  positions: torch.Tensor | None = None) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, vocab) fp32; ``attn_fn`` and
    ``positions`` as :func:`forward_hidden` takes them."""
    x = forward_hidden(cfg, params, tokens, attn_fn=attn_fn,
                       positions=positions)
    return (x @ params["lm_head"].to(cfg.dtype)).float()


def forward(cfg: LlamaConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Training forward: tokens (B, S) int → logits (B, S, vocab) fp32."""
    return forward_trunk(cfg, params, tokens)


# -- serving ---------------------------------------------------------------------


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int | None = None, *,
                  device: torch.device | str) -> dict:
    """An all-layers KV cache: ``k``/``v`` (L, batch, max_len, kv_heads, hd)
    zeros in ``cfg.dtype`` on ``device`` (``"meta"`` for a restore's
    ``like`` tree), ``length`` an int32 scalar on the host."""
    max_len = max_len or cfg.max_seq_len
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "length": torch.zeros((), dtype=torch.int32)}


def _cached_trunk(cfg: LlamaConfig, params: dict, tokens: torch.Tensor,
                  cache: dict, positions: torch.Tensor, cur_len,
                  active: torch.Tensor | None = None,
                  mlp_fn=None) -> torch.Tensor:
    """Embedding, the layer stack against the cache (in place), final norm
    and ``lm_head``: fp32 logits. The single copy of the serving trunk for
    :func:`decode` and :func:`decode_ragged`; ``mlp_fn(layer_params,
    normed) -> y`` as they take it."""
    ffn = None if mlp_fn is None else (
        lambda layer_params, normed: (mlp_fn(layer_params, normed), None))
    x = F.embedding(tokens, params["tok_emb"]).to(cfg.dtype)
    layers = zip(_unstack(params["layers"], cfg.n_layers),
                 torch.unbind(cache["k"], 0), torch.unbind(cache["v"], 0))
    for layer_params, kc, vc in layers:
        x, _ = layer_body(cfg, layer_params, x, positions,
                          cache=(kc, vc, cur_len), active=active, mlp_fn=ffn)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"].to(cfg.dtype)).float()


@torch.no_grad()
def decode(cfg: LlamaConfig, params: dict, tokens: torch.Tensor,
           cache: dict, mlp_fn=None) -> tuple[torch.Tensor, dict]:
    """Serving step: append ``tokens`` (B, S) at ``cache['length']``,
    attend into the cache, return (logits (B, S, vocab) fp32, the cache
    with ``length`` advanced by S). Prefill (S = prompt length) and
    autoregressive decode (S = 1) alike. A write past the cache's end
    raises ``ValueError`` before anything is written.

    ``mlp_fn(layer_params, normed) -> y`` replaces the dense feed-forward
    (the MoE family serves through this function with its expert layer,
    so the cache and position semantics cannot drift between the
    families). Unlike :func:`layer_body`'s hook it returns ``y`` alone."""
    B, S = tokens.shape
    cur_len = int(cache["length"])
    positions = (cur_len + torch.arange(S, device=tokens.device)).expand(B, S)
    logits = _cached_trunk(cfg, params, tokens, cache, positions, cur_len,
                           mlp_fn=mlp_fn)
    return logits, {**cache, "length": torch.tensor(cur_len + S,
                                                    dtype=torch.int32)}


@torch.no_grad()
def decode_ragged(cfg: LlamaConfig, params: dict, tokens: torch.Tensor,
                  cache: dict, lengths: torch.Tensor, active: torch.Tensor,
                  mlp_fn=None) -> tuple[torch.Tensor, dict]:
    """Continuous-batching serving step: one new token per slot, each slot
    at its own position in the cache.

    ``tokens`` (B, 1): each slot's last token. ``lengths`` (B,) int: valid
    KV entries per slot (the position of the token being decoded).
    ``active`` (B,) bool: inactive slots compute (the batch is the step's
    shape) but their cache rows stay byte-identical. ``cache['length']``
    is ignored and returned as is. An active slot at the cache's end
    raises ``ValueError`` before anything is written. ``mlp_fn`` as
    :func:`decode` takes it. Returns (logits (B, 1, vocab) fp32, cache)."""
    B, S = tokens.shape
    if S != 1:
        raise ValueError("decode_ragged is the per-token step; use "
                         "decode() for prefill")
    max_len = cache["k"].shape[2]
    over = active & (lengths >= max_len)
    if bool(over.any()):
        raise ValueError(f"KV cache write at {lengths.tolist()} overruns "
                         f"max_len={max_len} in active slots "
                         f"{over.nonzero().flatten().tolist()}")
    dev = cache["k"].device
    lengths, active = lengths.to(dev), active.to(dev)
    logits = _cached_trunk(cfg, params, tokens.to(dev), cache,
                           lengths[:, None], lengths, active, mlp_fn=mlp_fn)
    return logits, cache


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
            targets: torch.Tensor, mask: torch.Tensor | None = None,
            ce_chunk: int | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy (fp32 accumulation). ``ce_chunk``
    switches to :func:`chunked_token_cross_entropy`, which bounds the fp32
    logits to (ce_chunk, vocab) at a time instead of (B, S, vocab): the
    same value up to summation order."""
    if ce_chunk is None:
        return token_cross_entropy(forward(cfg, params, tokens), targets, mask)
    return chunked_token_cross_entropy(
        forward_hidden(cfg, params, tokens), params["lm_head"].to(cfg.dtype),
        targets, mask, chunk=ce_chunk)


def _nll_sum(rows: torch.Tensor, lm_head: torch.Tensor, targets: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """The masked NLL sum of ``rows`` projected through ``lm_head`` (fp32)."""
    logp = F.log_softmax((rows @ lm_head).float(), dim=-1)
    return (F.nll_loss(logp, targets, reduction="none") * mask).sum()


def chunked_token_cross_entropy(
    hidden: torch.Tensor, lm_head: torch.Tensor, targets: torch.Tensor,
    mask: torch.Tensor | None = None, chunk: int = 4096,
) -> torch.Tensor:
    """CE over chunks of the flattened (B·S, dim) rows: each chunk is
    projected to logits and reduced to its NLL sum, accumulated in fp32 in
    chunk order; each chunk runs under activation checkpointing, so the
    backward recomputes its logits instead of holding (B·S, vocab) of
    them. When ``chunk`` does not divide B·S, the whole projection runs at
    once, as the reference falls back."""
    B, S, D = hidden.shape
    N = B * S
    rows = hidden.reshape(N, D)
    t_flat = targets.reshape(N).long()
    m_flat = (torch.ones(N, dtype=torch.float32, device=hidden.device)
              if mask is None else mask.reshape(N).float())
    if N % chunk != 0:
        return (_nll_sum(rows, lm_head, t_flat, m_flat)
                / torch.clamp(m_flat.sum(), min=1.0))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, N, chunk):
        sl = slice(start, start + chunk)
        total = total + checkpoint(_nll_sum, rows[sl], lm_head, t_flat[sl],
                                   m_flat[sl], use_reentrant=False)
        count = count + m_flat[sl].sum()
    return total / torch.clamp(count, min=1.0)
