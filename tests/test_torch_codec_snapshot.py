"""Codec containers across the two packages: a port mirror written under
``GRIT_SNAPSHOT_CODEC`` restores bitwise through the JAX package, and a
JAX container through the port, each through the blocking, pipelined,
streamed-stage and post-copy restore paths; plus the tee's spare buffers
under the codec and a corrupt block refused."""

from __future__ import annotations

import os
import shutil
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu import codec as jcodec
from grit_tpu.agent.copy import StageJournal
from grit_tpu.device import snapshot as jsnap
from grit_tpu_torch import codec as pcodec
from grit_tpu_torch.device import snapshot as psnap

PATHS = ["blocking", "pipelined", "streamed", "postcopy"]


def _np_state() -> dict:
    """Raw-shipped blocks (random), zero blocks and compressible blocks,
    arrays over one 4 MiB block, bf16 and a scalar."""
    rng = np.random.default_rng(5)
    return {
        "w": rng.standard_normal((1536, 1024)).astype(np.float32),  # 6 MiB
        "z": np.zeros(5 << 20, np.uint8),
        "r": np.linspace(0, 1, 512 * 1024, dtype=np.float32).reshape(512, 1024),
        "h": rng.standard_normal((64, 32)).astype(np.float32),
        "s": np.asarray(11, np.int32),  # JAX keeps 32-bit ints
    }


def _torch_state(st: dict) -> dict:
    out = {k: torch.from_numpy(np.array(v)) for k, v in st.items()}
    out["h"] = out["h"].to(torch.bfloat16)
    return out


def _jax_state(st: dict) -> dict:
    out = {k: jnp.asarray(v) for k, v in st.items()}
    out["h"] = out["h"].astype(jnp.bfloat16)
    return out


def _raw(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.uint8) if x.dtype == torch.bfloat16 and x.dim() else x
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def _stage(snap: str, dst: str) -> threading.Thread:
    """A streamed stage of ``snap`` into ``dst``: COMMIT, MANIFEST and the
    codec sidecar staged whole (the agent ships sidecars as metadata), the
    container's bytes streamed on a thread in 1 MiB pieces, a waterline
    line after each."""
    os.makedirs(dst)
    journal = StageJournal(dst)
    data = os.path.join(snap, psnap.DATA_FILE)
    for name in (psnap.COMMIT_FILE, psnap.MANIFEST_FILE,
                 psnap.DATA_FILE + pcodec.SIDECAR_SUFFIX):
        shutil.copyfile(os.path.join(snap, name), os.path.join(dst, name))
        journal.note_file(name, os.path.getsize(os.path.join(dst, name)))
    size = os.path.getsize(data)
    with open(os.path.join(dst, psnap.DATA_FILE), "wb") as f:
        f.truncate(size)

    def stream():
        with open(data, "rb") as fin, \
                open(os.path.join(dst, psnap.DATA_FILE), "r+b") as fout:
            off = 0
            while off < size:
                piece = fin.read(1 << 20)
                fout.write(piece)
                fout.flush()
                journal.note_chunk(psnap.DATA_FILE, off, len(piece), size)
                off += len(piece)
        journal.complete()

    t = threading.Thread(target=stream, daemon=True)
    t.start()
    return t


def _restore(pkg: str, path: str, d: str, tmp_path, monkeypatch) -> dict:
    """``d`` restored by ``pkg`` ("port" or "jax") through ``path``; the
    result as ``{name: raw bytes}``."""
    monkeypatch.setenv("GRIT_RESTORE_PIPELINE",
                       "0" if path == "blocking" else "1")
    monkeypatch.setenv("GRIT_RESTORE_POSTCOPY_HOT_MB", "1")
    mod = psnap if pkg == "port" else jsnap
    stager = None
    if path == "streamed":
        staged = str(tmp_path / f"staged-{pkg}")
        stager = _stage(d, staged)
        d = staged
    if path == "postcopy":
        st = _np_state()
        like = (_torch_state(st) if pkg == "port" else _jax_state(st))
        got = mod.restore_snapshot_postcopy(d, like=like).wait(timeout=120)
        got = {f"['{k}']": v for k, v in got.items()}
    else:
        got = mod.restore_snapshot(d)
    if stager is not None:
        stager.join(timeout=60)
    return {k: _raw(v) for k, v in got.items()}


def _assert_bitwise(got: dict, st: dict) -> None:
    want = _torch_state(st)
    assert set(got) == {f"['{k}']" for k in want}
    for k, v in want.items():
        assert got[f"['{k}']"] == _raw(v), k


@pytest.fixture
def zlib(monkeypatch):
    monkeypatch.setenv("GRIT_SNAPSHOT_CODEC", "zlib")


@pytest.mark.parametrize("pkg", ["port", "jax"])
@pytest.mark.parametrize("path", PATHS)
def test_port_container_restores_bitwise(tmp_path, monkeypatch, zlib, path,
                                         pkg):
    st = _np_state()
    primary, mirror = str(tmp_path / "hbm"), str(tmp_path / "pvc" / "hbm")
    psnap.write_snapshot(primary, _torch_state(st), mirror=mirror)
    index = jcodec.load_container_index(os.path.join(mirror, psnap.DATA_FILE))
    assert {r.codec for r in index.records} == {"none", "zero", "zlib"}
    assert index.comp_size < index.raw_size
    assert psnap.last_write()["codec"] == "zlib"
    _assert_bitwise(_restore(pkg, path, mirror, tmp_path, monkeypatch), st)


@pytest.mark.parametrize("path", PATHS)
def test_jax_container_restores_bitwise_through_the_port(tmp_path, monkeypatch,
                                                         zlib, path):
    """The JAX writer on whatever plane it has here (crc32c chunks where
    libgritio is built, crc32 elsewhere), its mirror a container."""
    st = _np_state()
    primary, mirror = str(tmp_path / "hbm"), str(tmp_path / "pvc" / "hbm")
    jsnap.write_snapshot(primary, _jax_state(st), mirror=mirror)
    assert jcodec.load_container_index(
        os.path.join(mirror, psnap.DATA_FILE)) is not None
    _assert_bitwise(_restore("port", path, mirror, tmp_path, monkeypatch), st)


def test_zstd_container_cross_restores(tmp_path, monkeypatch):
    if not pcodec.zstd_available():
        pytest.skip("zstandard is not installed")
    monkeypatch.setenv("GRIT_SNAPSHOT_CODEC", "zstd")
    st = _np_state()
    mirror = str(tmp_path / "pvc")
    psnap.write_snapshot(str(tmp_path / "hbm"), _torch_state(st), mirror=mirror)
    index = jcodec.load_container_index(os.path.join(mirror, psnap.DATA_FILE))
    assert "zstd" in {r.codec for r in index.records}
    for pkg in ("port", "jax"):
        _assert_bitwise(_restore(pkg, "pipelined", mirror, tmp_path,
                                 monkeypatch), st)


def test_delta_mirror_chain_of_containers(tmp_path, monkeypatch, zlib):
    """A pre-copy chain mirrored as containers: the delta's referenced
    chunks decode out of the base mirror's container."""
    st = _np_state()
    host, pvc = tmp_path / "host", tmp_path / "pvc"
    psnap.write_snapshot(str(host / "base" / "hbm"), _torch_state(st),
                         hashes=True, mirror=str(pvc / "base" / "hbm"))
    st2 = dict(st, s=np.asarray(12, np.int32), r=st["r"] * 2)
    psnap.write_snapshot(str(host / "main" / "hbm"), _torch_state(st2),
                         base=str(host / "base" / "hbm"),
                         mirror=str(pvc / "main" / "hbm"))
    delta = str(pvc / "main" / "hbm")
    assert psnap.snapshot_delta_nbytes(delta) < psnap.snapshot_nbytes(delta)
    for pkg in ("port", "jax"):
        _assert_bitwise(_restore(pkg, "pipelined", delta, tmp_path,
                                 monkeypatch), st2)


def test_corrupt_container_block_is_refused(tmp_path, zlib):
    st = _np_state()
    mirror = str(tmp_path / "pvc")
    psnap.write_snapshot(str(tmp_path / "hbm"), _torch_state(st), mirror=mirror)
    data = os.path.join(mirror, psnap.DATA_FILE)
    rec = next(r for r in jcodec.load_container_index(data).records
               if r.codec == "zlib")
    with open(data, "r+b") as f:
        f.seek(rec.comp_off + rec.comp_n // 2)
        b = f.read(1)
        f.seek(rec.comp_off + rec.comp_n // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(psnap.SnapshotIntegrityError, match="decode"):
        psnap.restore_snapshot(mirror)


class _SlowWire:
    """A wire sink that holds on to what it is given and lets go later,
    as the sender's queues do."""

    def __init__(self) -> None:
        self.held: list = []
        self.ok = True
        self.finished = None

    def put(self, view, done=None):
        self.held.append((bytes(view), done))

    def put_record(self, codec, payload, raw_off, raw_n, crc, done=None):
        self.held.append((bytes(payload), done))

    def mark_failed(self, msg):
        self.ok = False

    def finish(self, ok=True):
        self.finished = ok
        return self.ok

    def release(self) -> None:
        for _, done in self.held:
            if done is not None:
                done()


@pytest.mark.parametrize("codec", ["none", "zlib"])
def test_borrowed_pieces_keep_their_bytes_until_the_wire_lets_go(
        tmp_path, monkeypatch, codec):
    """A borrowed piece (a ring slot the dump reuses) is copied into a
    spare, and the spare is not reused while the wire still holds it."""
    monkeypatch.setenv("GRIT_SNAPSHOT_CODEC", codec)
    wire = _SlowWire()
    path = str(tmp_path / "data.bin")
    tee = psnap._MirrorWriter(path, wire=wire)
    slot = np.empty(3 << 20, np.uint8)
    pieces = []
    for k in range(3):
        slot[:] = np.random.default_rng(k).integers(0, 8, slot.size,
                                                    dtype=np.uint8)
        pieces.append(slot.tobytes())
        tee.put(slot, borrowed=True)
    assert tee.finish() and wire.finished is True
    assert tee._spare.empty()  # every spare still lent to the wire
    wire.release()
    assert tee._spare.qsize() == 3
    whole = b"".join(pieces)
    if codec == "none":
        assert open(path, "rb").read() == whole
        assert b"".join(b for b, _ in wire.held) == whole
    else:
        index = pcodec.load_container_index(path)
        assert pcodec.read_container_range(path, index, 0, len(whole)) == whole
