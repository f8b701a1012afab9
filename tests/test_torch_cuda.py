"""The port on the card: its CUDA kernels against their plain versions and
a short flagship-width training and snapshot round trip. Every test is
``cuda``-marked and skips without a GPU. This file imports neither JAX nor
the JAX package, so it also runs on a GPU machine without them:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from grit_tpu_torch.models import llama
from grit_tpu_torch.ops import attention
from grit_tpu_torch.ops import flash_attention as fa
from grit_tpu_torch.workload import llama_trainer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card, decided here and not at import, so every test worker
    collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see the module "
                    "docstring)")
    return torch.device("cuda", 0)


def _inputs(B, S, H, KVH, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, do = (torch.randn(B, S, H, 128, generator=gen, device=device)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, S, KVH, 128, generator=gen, device=device)
            .to(torch.bfloat16) for _ in range(2))
    return q, k, v, do


def _close(got, want):
    """bf16 outputs agree to 2^-6 of their scale (the kernels round P and
    dS to bf16 before their second product; see chip_smoke.py)."""
    err = (got.float() - want.float()).abs().max().item()
    return err <= 2.0 ** -6 * max(1.0, want.float().abs().max().item())


@pytest.mark.parametrize("S,H,KVH", [(128, 2, 2), (256, 4, 2), (384, 4, 1)])
def test_kernels_match_plain_versions(cuda_device, S, H, KVH):
    B = 2
    q, k, v, do = _inputs(B, S, H, KVH, cuda_device)
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v)
    po, plse = fa.flash_fwd_plain(q, k, v)
    assert _close(o, po)
    assert (lse - plse).abs().max().item() < 1e-3
    lse3 = plse.reshape(B, H, S).contiguous()
    delta = fa.attention_delta(do, po)
    dq = fa.flash_bwd_dq(q, k, v, do, lse3, delta)
    assert torch.equal(dq, fa.flash_bwd_dq(q, k, v, do, lse3, delta))
    assert _close(dq, fa.flash_bwd_dq_plain(q, k, v, do, lse3, delta))
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse3, delta)
    pdk, pdv = fa.flash_bwd_dkv_plain(q, k, v, do, lse3, delta)
    assert _close(dk, pdk) and _close(dv, pdv)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 2,
                           "flash_bwd_dkv": 1}


def test_kernel_wrappers_refuse_what_the_kernels_cannot_take(cuda_device):
    q, k, v, _ = _inputs(1, 128, 2, 2, cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_fwd(q.float(), k.float(), v.float())
    strided = torch.cat([q, q], dim=2)[:, :, :2]  # head stride of 4 heads
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(strided, k, v)
    with pytest.raises(ValueError, match="several devices"):
        fa.flash_fwd(q, k.cpu(), v)


def test_fp32_at_the_flash_shape_is_refused_not_sent_to_the_plain_path(
        cuda_device):
    """The gate has no dtype clause: fp32 at an aligned training shape
    reaches the bf16 kernel's wrapper, which raises; nothing launches."""
    q, k, v, _ = _inputs(1, 128, 2, 2, cuda_device)
    fa.reset_launch_counts()
    with pytest.raises(TypeError, match="bfloat16"):
        attention.causal_attention(q.float(), k.float(), v.float())
    assert fa.LAUNCHES == {name: 0 for name in fa.LAUNCHES}


def test_flagship_width_steps_snapshot_and_resume(cuda_device, tmp_path):
    """Two layers at the flagship widths: each step launches each kernel
    once per layer, and a restored Trainer continues bit-identically."""
    cfg = llama.LlamaConfig.flagship(n_layers=2)
    a = llama_trainer(cfg, batch=1, seq=256, device=cuda_device)
    fa.reset_launch_counts()
    a.run(2)
    assert fa.LAUNCHES == {name: 2 * 2 for name in fa.LAUNCHES}
    d = str(tmp_path / "snap")
    a.snapshot(d)
    want = a.run(2)
    b = llama_trainer(cfg, batch=1, seq=256, device=cuda_device)
    assert b.restore(d) == 2
    assert b.state["params"]["lm_head"].is_cuda
    assert b.run(2) == want
