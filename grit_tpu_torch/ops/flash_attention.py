"""Causal GQA flash attention: three hand-written CUDA kernels for Hopper,
each with its plain PyTorch version beside it.

Counterpart of ``grit_tpu/ops/flash_attention.py`` (three Pallas TPU
kernels). Public layouts are the JAX package's: q/o (B, S, H, hd), k/v
(B, S, KVH, hd), LSE (B, H, S, 1) fp32.

============  ===========================  =================================
kernel        CUDA source                  replaces (Pallas, TPU)
============  ===========================  =================================
flash_fwd     ``csrc/flash_fwd.cu``        ``_kernel`` (+ ``_online_update``)
flash_bwd_dq  ``csrc/flash_bwd_dq.cu``     ``_bwd_dq_kernel``
flash_bwd_dkv ``csrc/flash_bwd_dkv.cu``    ``_bwd_dkv_kernel``
============  ===========================  =================================

Dispatch is by the tensors' device and nothing else: a CPU tensor runs
the kernel's plain version (the CPU tests), a CUDA tensor launches the
kernel or raises. There is no fallback from a CUDA tensor to the plain
version. The CUDA kernels take bf16, head dim 128, contiguous inputs.

Each wrapper counts its launches in :data:`LAUNCHES` (plain calls do not
count), so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import torch

from grit_tpu_torch.ops import build

BLOCK = 128  # sequence granularity the public API accepts (as in JAX)
KERNEL_HEAD_DIM = 128

LAUNCHES: dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- input checks ---------------------------------------------------------------


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,S,H,hd), k/v (B,S,KVH,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if H % k.shape[2] != 0:
        raise ValueError(f"n_heads {H} is not a multiple of kv heads {k.shape[2]}")
    if S % BLOCK != 0 or hd % BLOCK != 0:
        raise ValueError(f"flash attention needs S % {BLOCK} == 0 and "
                         f"hd % {BLOCK} == 0; got S={S}, hd={hd}")


def _device_kind(*tensors: torch.Tensor) -> str:
    kinds = {t.device.type for t in tensors}
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"tensors on several devices: "
                         f"{sorted(str(t.device) for t in tensors)}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda (kernels) or cpu "
                         f"(plain version), not {kind}")
    return kind


def _check_kernel_inputs(*tensors: torch.Tensor, fp32: tuple = ()) -> None:
    """What the CUDA kernels take: bf16 (fp32 for lse/delta), head dim 128,
    contiguous."""
    for i, t in enumerate(tensors):
        want = torch.float32 if i in fp32 else torch.bfloat16
        if t.dtype != want:
            raise TypeError(f"CUDA flash kernel input {i} must be {want}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"CUDA flash kernel input {i} must be contiguous")
    if tensors[0].shape[-1] != KERNEL_HEAD_DIM:
        raise ValueError(f"CUDA flash kernels are built for head dim "
                         f"{KERNEL_HEAD_DIM}, got {tensors[0].shape[-1]}")


def _launch(name: str, args: list, device: torch.device) -> None:
    fn = build.kernel(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _shape_args(q: torch.Tensor, k: torch.Tensor) -> list:
    B, S, H, hd = q.shape
    return [B, S, H, k.shape[2], 1.0 / hd ** 0.5]


# -- kernel 1: forward ------------------------------------------------------------


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Plain version of kernel 1: the full masked fp32 score matrix.
    Returns (O in q's dtype, LSE (B, H, S, 1) fp32)."""
    B, S, H, hd = q.shape
    groups = H // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2).repeat_interleave(groups, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(groups, dim=1)
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / hd ** 0.5)
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    out = torch.exp(s - lse) @ vf
    return out.transpose(1, 2).to(q.dtype), lse


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Kernel 1 (``csrc/flash_fwd.cu``): (O, LSE)."""
    _check(q, k, v)
    if _device_kind(q, k, v) == "cpu":
        return flash_fwd_plain(q, k, v)
    _check_kernel_inputs(q, k, v)
    B, S, H, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S, 1), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), lse.data_ptr(), *_shape_args(q, k)],
            q.device)
    return out, lse


# -- backward: shared recomputation of P ---------------------------------------


def _probs_plain(q, k, lse):
    """P = exp(scale.Q.K^T - LSE), causal, per q head: (B, H, S, S) fp32
    from ``lse`` (B, H, S),
    with Q and the group-repeated K in (B, H, S, hd) fp32."""
    B, S, H, hd = q.shape
    groups = H // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2).repeat_interleave(groups, dim=1)
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / hd ** 0.5)
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.exp(s - lse.float().unsqueeze(-1)).masked_fill(~causal, 0.0)
    return p, qf, kf


def _dscores_plain(p, v, do, delta, groups):
    """dS = P * (dO.V^T - D), plus dO in (B, H, S, hd) fp32."""
    vf = v.float().transpose(1, 2).repeat_interleave(groups, dim=1)
    dof = do.float().transpose(1, 2)
    dp = dof @ vf.transpose(-1, -2)
    return p * (dp - delta.float().unsqueeze(-1)), dof


def attention_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O): (B, H, S) fp32 — a plain tensor op beside the
    kernels, as in JAX (it is O(S.hd), not a kernel of its own)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


# -- kernel 2: dQ -------------------------------------------------------------------


def flash_bwd_dq_plain(q, k, v, do, lse, delta):
    """Plain version of kernel 2: dQ = scale.dS.K, in q's dtype."""
    H, hd = q.shape[2], q.shape[3]
    groups = H // k.shape[2]
    p, _, kf = _probs_plain(q, k, lse)
    ds, _ = _dscores_plain(p, v, do, delta, groups)
    dq = (ds @ kf) * (1.0 / hd ** 0.5)
    return dq.transpose(1, 2).to(q.dtype)


def flash_bwd_dq(q, k, v, do, lse, delta):
    """Kernel 2 (``csrc/flash_bwd_dq.cu``): dQ. ``lse`` is the forward's
    logsumexp and ``delta`` :func:`attention_delta`, both (B, H, S) fp32."""
    _check(q, k, v)
    if _device_kind(q, k, v, do, lse, delta) == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta)
    _check_kernel_inputs(q, k, v, do, lse, delta, fp32=(4, 5))
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             *_shape_args(q, k)], q.device)
    return dq


# -- kernel 3: dK, dV -----------------------------------------------------------


def flash_bwd_dkv_plain(q, k, v, do, lse, delta):
    """Plain version of kernel 3: dV = P^T.dO and dK = scale.dS^T.Q per q
    head, summed over each kv head's group in fp32, in k's dtype."""
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    groups = H // KVH
    p, qf, _ = _probs_plain(q, k, lse)
    ds, dof = _dscores_plain(p, v, do, delta, groups)
    dv = (p.transpose(-1, -2) @ dof).reshape(B, KVH, groups, S, hd).sum(2)
    dk = (ds.transpose(-1, -2) @ qf).reshape(B, KVH, groups, S, hd).sum(2)
    dk = dk * (1.0 / hd ** 0.5)
    return dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def flash_bwd_dkv(q, k, v, do, lse, delta):
    """Kernel 3 (``csrc/flash_bwd_dkv.cu``): (dK, dV), group-summed."""
    _check(q, k, v)
    if _device_kind(q, k, v, do, lse, delta) == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta)
    _check_kernel_inputs(q, k, v, do, lse, delta, fp32=(4, 5))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd_dkv",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             *_shape_args(q, k)], q.device)
    return dk, dv


# -- public API (the JAX package's names) -----------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    return_lse: bool = False):
    """Causal self-attention. q: (B, S, H, hd); k/v: (B, S, KVH, hd).
    ``return_lse=True`` also returns the row logsumexp (B, H, S, 1) fp32,
    the residual :func:`flash_attention_bwd` consumes."""
    out, lse = flash_fwd(q, k, v)
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, lse, do, out):
    """Fused causal-attention backward: (dq, dk, dv) in the primal
    layouts and dtypes; GQA dk/dv are summed over each kv head's group."""
    delta = attention_delta(do, out)
    lse = lse.reshape(lse.shape[:3]).contiguous()
    dq = flash_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta)
    return dq, dk, dv
