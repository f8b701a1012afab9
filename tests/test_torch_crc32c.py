"""The port's crc32c verifier (``grit_tpu_torch/checksum.py``): the C library
on both of its paths against the RFC 3720 vectors and its plain version,
against the JAX package's native crc32c, and the snapshot reader verifying
crc32c chunks (the JAX native plane's) or refusing them loudly."""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu import native as jnative
from grit_tpu.device import snapshot as jsnap
from grit_tpu_torch import checksum
from grit_tpu_torch.device import snapshot as psnap

# RFC 3720 section B.4, and the usual check value of "123456789".
VECTORS = {
    "32 zeros": (bytes(32), 0x8A9136AA),
    "32 ones": (b"\xff" * 32, 0x62A8AB43),
    "incrementing": (bytes(range(32)), 0x46DD794E),
    "decrementing": (bytes(range(31, -1, -1)), 0x113FDB5C),
    "123456789": (b"123456789", 0xE3069283),
}


@pytest.fixture(params=["cpuid", "table"])
def lib_path(request):
    """Each test runs on the path cpuid picks and on the table path."""
    checksum.force_table(request.param == "table")
    try:
        yield request.param
    finally:
        checksum.force_table(False)


@pytest.mark.parametrize("name", sorted(VECTORS))
def test_rfc3720_vectors(name, lib_path):
    data, want = VECTORS[name]
    assert checksum.crc32c(data) == want
    assert checksum.plain_crc32c(data) == want


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 15, 63, 64, 65, 1000, 4099,
                               65537])
def test_library_against_plain_at_lengths_and_alignments(n, lib_path):
    buf = np.random.default_rng(n).integers(0, 256, n + 8, dtype=np.uint8)
    for align in range(8):
        view = buf[align:align + n]
        assert checksum.crc32c(view) == checksum.plain_crc32c(view), align


def test_running_crc_equals_the_whole_and_any_buffer_type():
    data = np.random.default_rng(1).standard_normal(10_000).astype(np.float32)
    whole = checksum.crc32c(data)
    raw = data.tobytes()
    crc = 0
    for o in range(0, len(raw), 4093):
        crc = checksum.crc32c(memoryview(raw)[o:o + 4093], crc)
    assert crc == whole == checksum.crc32c(raw) == checksum.crc32c(
        bytearray(raw))


def test_path_is_reported_and_forcing_the_table_changes_it():
    assert checksum.path() in ("sse4.2", "table")
    checksum.force_table(True)
    try:
        assert checksum.crc32c(b"123456789") == 0xE3069283
    finally:
        checksum.force_table(False)


def test_matches_the_jax_package_native_crc32c():
    if not jnative.available():
        pytest.skip("libgritio is not built (make -C native)")
    rng = np.random.default_rng(2)
    for n in (0, 3, 4096, 1 << 20):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        assert checksum.crc32c(data) == jnative.crc32c(data)


def test_a_library_that_fails_to_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "crc32c.c"
    bad.write_text("this is not C;\n")
    monkeypatch.setattr(checksum, "SOURCE", bad)
    monkeypatch.setattr(checksum, "_lib", None)
    monkeypatch.setenv("GRIT_TPU_COMPILE_CACHE", str(tmp_path / "build"))
    with pytest.raises(checksum.CRC32CUnavailable, match="failed") as err:
        checksum.crc32c(b"x")
    assert "crc32c.c" in str(err.value)  # the compiler's own message
    monkeypatch.setattr(checksum, "COMPILER", str(tmp_path / "no-such-cc"))
    with pytest.raises(checksum.CRC32CUnavailable, match="no-such-cc"):
        checksum.crc32c(b"x")


# -- snapshots with crc32c chunks -------------------------------------------------


def _state() -> dict:
    return {"w": torch.arange(600, dtype=torch.float32).reshape(20, 30),
            "b": torch.linspace(-1, 1, 40).to(torch.bfloat16),
            "n": torch.tensor(9, dtype=torch.int64)}


def _as_crc32c(d: str) -> None:
    """Rewrite the manifest of the port snapshot ``d`` as the JAX native
    plane writes it: every chunk's checksum a crc32c (the plain version's)."""
    raw = open(os.path.join(d, psnap.DATA_FILE), "rb").read()
    mpath = os.path.join(d, psnap.MANIFEST_FILE)
    manifest = json.load(open(mpath))
    for rec in manifest["arrays"]:
        for c in rec["chunks"]:
            c.update(algo="crc32c", crc=checksum.plain_crc32c(
                raw[c["offset"]:c["offset"] + c["nbytes"]]))
    json.dump(manifest, open(mpath, "w"))


def _assert_state(got: dict, want: dict) -> None:
    for k, v in want.items():
        assert torch.equal(got[f"['{k}']"], v), k


@pytest.mark.parametrize("restore", ["blocking", "serial"])
def test_crc32c_manifest_restores_verified(tmp_path, monkeypatch, restore):
    if restore == "serial":
        monkeypatch.setenv("GRIT_RESTORE_PIPELINE", "0")
    d = str(tmp_path / "snap")
    psnap.write_snapshot(d, _state())
    _as_crc32c(d)
    _assert_state(psnap.restore_snapshot(d), _state())
    # The JAX package reads the same manifest.
    got = jsnap.restore_snapshot(d)
    assert np.asarray(got["['w']"]).tobytes() == _state()["w"].numpy().tobytes()


def test_crc32c_flipped_byte_raises(tmp_path):
    d = str(tmp_path / "snap")
    psnap.write_snapshot(d, _state())
    _as_crc32c(d)
    path = os.path.join(d, psnap.DATA_FILE)
    raw = bytearray(open(path, "rb").read())
    raw[5] ^= 0x40
    open(path, "wb").write(bytes(raw))
    with pytest.raises(psnap.SnapshotIntegrityError, match="crc32c"):
        psnap.restore_snapshot(d)


def test_crc32c_unverifiable_raises_naming_why(tmp_path, monkeypatch):
    """Where the library cannot be built, a crc32c chunk is refused (the
    reference skips the check) unless the caller asks for no check."""
    d = str(tmp_path / "snap")
    psnap.write_snapshot(d, _state())
    _as_crc32c(d)
    monkeypatch.setattr(checksum, "_lib", None)
    monkeypatch.setattr(checksum, "COMPILER", str(tmp_path / "no-such-cc"))
    monkeypatch.setenv("GRIT_TPU_COMPILE_CACHE", str(tmp_path / "build"))
    with pytest.raises(psnap.SnapshotIntegrityError, match="no-such-cc"):
        psnap.restore_snapshot(d)
    _assert_state(psnap.restore_snapshot(d, verify=False), _state())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_native_plane_snapshot_restores_verified(tmp_path, dtype):
    """A snapshot the JAX package writes through libgritio (crc32c
    chunks) restores through the port bitwise, every chunk verified."""
    if not jnative.available():
        pytest.skip("libgritio is not built (make -C native)")
    rng = np.random.default_rng(3)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    state = {"w": jnp.asarray(w, dtype=dtype), "step": jnp.int32(4)}
    d = str(tmp_path / "jax")
    jsnap.write_snapshot(d, state)
    algos = {c["algo"] for rec in jsnap.SnapshotManifest.load(d).arrays
             for c in rec["chunks"]}
    assert algos == {"crc32c"}
    got = psnap.restore_snapshot(d)
    assert got["['w']"].view(torch.uint8 if dtype == "bfloat16" else
                             torch.float32).numpy().tobytes() == \
        np.asarray(jax.device_get(state["w"])).tobytes()
    assert int(got["['step']"]) == 4
    path = os.path.join(d, psnap.DATA_FILE)
    raw = bytearray(open(path, "rb").read())
    raw[100] ^= 1
    open(path, "wb").write(bytes(raw))
    with pytest.raises(psnap.SnapshotIntegrityError, match="crc mismatch"):
        psnap.restore_snapshot(d)
