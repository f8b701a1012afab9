"""The port's flash-attention kernels, by their plain versions, against the
JAX package's Pallas kernels (interpret mode on the CPU) on the same
numpy inputs. The CUDA kernels themselves run only on the card:
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold them against
these plain versions there."""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu.ops.attention import _flash_differentiable
from grit_tpu.ops.attention import attention_reference as jax_reference
from grit_tpu.ops.flash_attention import flash_attention as jax_flash
from grit_tpu.ops.flash_attention import flash_attention_bwd as jax_flash_bwd
from grit_tpu_torch.ops import attention as port_attention
from grit_tpu_torch.ops import flash_attention as fa


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and oversubscribed spinning threads slow torch's CPU ops many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, H, KVH, seed, hd=128):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, S, KVH, hd), dtype=np.float32)
    v = rng.standard_normal((B, S, KVH, hd), dtype=np.float32)
    do = rng.standard_normal((B, S, H, hd), dtype=np.float32)
    return q, k, v, do


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# (B, S, H, gqa) — S 256 is two 128-tiles, S 512 four; gqa 2 shares each
# kv head between two q heads. Tolerances are the JAX package's own for
# its kernels against the XLA reference (tests/test_flash_attention.py).
CASES = [(2, 256, 4, 1, 2e-5), (2, 256, 4, 2, 2e-5),
         (1, 512, 2, 1, 5e-5), (1, 512, 2, 2, 5e-5)]


@pytest.mark.parametrize("B,S,H,gqa,grad_tol", CASES)
def test_plain_versions_match_pallas_kernels(B, S, H, gqa, grad_tol):
    q, k, v, do = _inputs(B, S, H, H // gqa, seed=S + gqa)
    o_j, lse_j = jax_flash(q, k, v, interpret=True, return_lse=True)
    dq_j, dk_j, dv_j = jax_flash_bwd(q, k, v, lse_j, do, o_j, interpret=True)

    qt, kt, vt, dot = _t(q, k, v, do)
    o, lse = fa.flash_fwd(qt, kt, vt)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j),
                               rtol=1e-5, atol=1e-5)
    # Kernel 2 and kernel 3 separately, on the JAX forward's residuals.
    lse3 = torch.from_numpy(np.array(lse_j)).reshape(B, H, S)
    delta = fa.attention_delta(dot, torch.from_numpy(np.array(o_j)))
    dq = fa.flash_bwd_dq(qt, kt, vt, dot, lse3, delta)
    dk, dv = fa.flash_bwd_dkv(qt, kt, vt, dot, lse3, delta)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=grad_tol, atol=grad_tol)
    assert fa.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0}, "CPU tensors launched a kernel"


def test_public_api_shapes_and_backward_composition():
    q, k, v, do = _t(*_inputs(1, 256, 4, 2, seed=3))
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    assert out.shape == q.shape and lse.shape == (1, 4, 256, 1)
    assert lse.dtype == torch.float32
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, lse, do, out)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert torch.equal(fa.flash_attention(q, k, v), out)


@pytest.mark.parametrize("gqa", [1, 2])
def test_autograd_function_grads_match_jax_custom_vjp(gqa):
    B, S, H = 1, 256, 4
    q, k, v, _ = _inputs(B, S, H, H // gqa, seed=11 + gqa)

    def loss_jax(q, k, v):
        return jnp.sum(_flash_differentiable(q, k, v, True) ** 2)

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (x.requires_grad_(True) for x in _t(q, k, v))
    (port_attention.flash_differentiable(qt, kt, vt) ** 2).sum().backward()
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("q_offset,kv_len", [
    (0, None), (64, 192), (np.array([0, 100], np.int32),
                           np.array([128, 228], np.int32))])
def test_attention_reference_matches_jax(q_offset, kv_len):
    """Scalar and per-row (ragged) offsets and kv lengths."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 128, 4, 64), dtype=np.float32)
    k = rng.standard_normal((2, 256, 2, 64), dtype=np.float32)
    v = rng.standard_normal((2, 256, 2, 64), dtype=np.float32)
    want = jax_reference(q, k, v, q_offset=q_offset, kv_len=kv_len)
    to_t = (lambda x: torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
    got = port_attention.attention_reference(
        *_t(q, k, v), q_offset=to_t(q_offset), kv_len=to_t(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_dispatch_uses_plain_path_off_cuda():
    """On CPU tensors the gate never picks the flash path, as the JAX gate
    never does off the TPU."""
    q, k, v, _ = _t(*_inputs(1, 128, 2, 2, seed=1))
    assert not port_attention._use_flash(q, k, 0, None)
    out = port_attention.causal_attention(q, k, v)
    assert torch.equal(out, port_attention.attention_reference(q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_is_the_jax_gate_with_no_dtype_clause(dtype):
    """The gate passes on CUDA with no offset or kv_len, Sq == Skv and S,
    hd multiples of 128, whatever the dtype: an fp32 model on the card
    reaches the kernel wrapper (which refuses it), never quietly the plain
    path. Stand-ins carry what the gate reads of a CUDA tensor."""
    def on_cuda(S, hd=128):
        return SimpleNamespace(shape=(1, S, 2, hd), is_cuda=True, dtype=dtype)

    q = on_cuda(256)
    assert port_attention._use_flash(q, q, 0, None)
    assert not port_attention._use_flash(q, q, 64, None)
    assert not port_attention._use_flash(q, q, 0, 256)
    assert not port_attention._use_flash(q, on_cuda(384), 0, None)
    assert not port_attention._use_flash(on_cuda(192), on_cuda(192), 0, None)
    assert not port_attention._use_flash(on_cuda(256, 64), on_cuda(256, 64),
                                         0, None)


def test_non_cpu_non_cuda_tensors_raise():
    """No hidden fallback: a tensor the kernels cannot take (here on the
    meta device, the stand-in for a device this host lacks) raises
    instead of running the plain version."""
    q = torch.empty(1, 128, 2, 128, device="meta")
    with pytest.raises(ValueError, match="runs on cuda"):
        fa.flash_fwd(q, q, q)
    with pytest.raises(ValueError, match="S % 128"):
        fa.flash_fwd(*_t(*_inputs(1, 64, 2, 2, seed=1)[:3]))



def test_a_cuda_request_without_a_kernel_raises(monkeypatch, tmp_path):
    """A request the wrapper routes to the card (forced here, as this host
    has none) builds and launches the kernel or raises — it never falls
    back to the plain version. Without nvcc the build raises."""
    from grit_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_fns", {})
    monkeypatch.setattr(fa, "_device_kind", lambda *tensors: "cuda")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    q, k, v, _ = (t.to(torch.bfloat16) for t in _t(*_inputs(1, 128, 2, 2, seed=1)))
    fa.reset_launch_counts()
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        fa.flash_fwd(q, k, v)
    assert fa.LAUNCHES["flash_fwd"] == 0
