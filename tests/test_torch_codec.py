"""The port's codec stage (``grit_tpu_torch/codec.py``) against the JAX
package's (``grit_tpu/codec.py``): blocks, decisions, sidecars and
containers cross-decode both ways, byte for byte."""

from __future__ import annotations

import logging
import os

import numpy as np
import pytest

from grit_tpu import codec as jcodec
from grit_tpu_torch import codec as pcodec


def _data(kind: str, n: int = 3 * 100_000 + 17) -> np.ndarray:
    rng = np.random.default_rng(len(kind))
    if kind == "zeros":
        return np.zeros(n, np.uint8)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8)
    if kind == "ramp":  # compressible: a slow float ramp's bytes
        return np.linspace(0, 1, n // 4, dtype=np.float32).view(np.uint8)
    if kind == "islands":  # a delta page: zeros with a random head
        out = np.zeros(n, np.uint8)
        out[:n // 3] = rng.integers(0, 256, n // 3, dtype=np.uint8)
        return out
    raise ValueError(kind)


KINDS = ["zeros", "random", "ramp", "islands"]
CODECS = ["zlib", "zstd", "none"]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("kind", KINDS)
def test_blocks_cross_decode_both_ways(kind, codec):
    if codec == "zstd" and not pcodec.zstd_available():
        pytest.skip("zstandard is not installed")
    view = _data(kind)
    got = pcodec.compress_block(view, codec, elide_zeros=True)
    want = jcodec.compress_block(view, codec, elide_zeros=True)
    assert got[0] == want[0] and got[2:] == want[2:]
    assert bytes(got[1]) == bytes(want[1])
    used, payload, raw_n, crc = got
    assert bytes(jcodec.decompress_block(used, payload, raw_n, crc)) == \
        view.tobytes()
    used, payload, raw_n, crc = want
    assert bytes(pcodec.decompress_block(used, payload, raw_n, crc)) == \
        view.tobytes()


@pytest.mark.parametrize("sample_kb", [1, 64])
@pytest.mark.parametrize("codec", ["zlib", "none"])
@pytest.mark.parametrize("kind", KINDS)
def test_decide_codec_decides_as_the_reference(kind, codec, sample_kb):
    view = _data(kind)
    assert pcodec.decide_codec(view, codec, sample_kb=sample_kb) == \
        jcodec.decide_codec(view, codec, sample_kb=sample_kb)


@pytest.mark.parametrize("ratio", ["0.05", "0.9"])
def test_min_ratio_knob_is_read_as_the_reference(ratio, monkeypatch):
    monkeypatch.setenv("GRIT_CODEC_MIN_RATIO", ratio)
    for kind in KINDS:
        view = _data(kind)
        assert pcodec.compress_block(view, "zlib")[0] == \
            jcodec.compress_block(view, "zlib")[0], kind


def test_workers_as_the_reference(monkeypatch):
    for value in (None, "3", "0", "abc"):
        if value is None:
            monkeypatch.delenv("GRIT_CODEC_WORKERS", raising=False)
        else:
            monkeypatch.setenv("GRIT_CODEC_WORKERS", value)
        assert pcodec.workers() == jcodec.workers(), value
        assert pcodec.shared_pool()._max_workers == pcodec.workers()


def test_zstd_degrades_loudly_without_the_module(monkeypatch, caplog):
    monkeypatch.setattr(pcodec, "zstd_available", lambda: False)
    monkeypatch.setattr(pcodec, "_warned", set())
    with caplog.at_level(logging.WARNING, logger=pcodec.__name__):
        assert pcodec.resolve_codec("zstd") == "zlib"
        assert pcodec.resolve_codec("zstd") == "zlib"
    assert [r.getMessage() for r in caplog.records].count(
        "GRIT_SNAPSHOT_CODEC=zstd but the zstandard module is not "
        "installed; degrading to zlib") == 1
    with pytest.raises(pcodec.CodecError, match="zstandard"):
        pcodec.decompress_block("zstd", b"\x28\xb5\x2f\xfd", 10)


def test_unknown_codec_degrades_to_none(monkeypatch, caplog):
    monkeypatch.setenv("GRIT_SNAPSHOT_CODEC", "lz4")
    with caplog.at_level(logging.WARNING, logger=pcodec.__name__):
        assert pcodec.resolve_codec() == jcodec.resolve_codec() == "none"
    with pytest.raises(pcodec.CodecError, match="unknown codec"):
        pcodec.decompress_block("lz4", b"x", 1)


@pytest.mark.parametrize("fault", ["payload", "crc", "size"])
def test_corrupt_block_raises(fault):
    view = _data("ramp")
    used, payload, raw_n, crc = pcodec.compress_block(view, "zlib")
    assert used == "zlib"
    if fault == "payload":
        payload = payload[:-9] + bytes(9)
    elif fault == "crc":
        crc ^= 1
    else:
        raw_n += 1
    with pytest.raises(pcodec.CodecError):
        pcodec.decompress_block(used, payload, raw_n, crc)


def _container(mod, path: str, blocks: list[np.ndarray], codec: str) -> None:
    """A container of ``blocks`` as the mirror tee writes one."""
    side = mod.SidecarWriter(path)
    raw_off = comp_off = 0
    with open(path, "wb") as f:
        for view in blocks:
            used, payload, raw_n, crc = mod.compress_block(
                view, codec, elide_zeros=True)
            f.write(payload)
            side.record(used, raw_off, raw_n, comp_off, len(payload), crc)
            raw_off += raw_n
            comp_off += len(payload)
    side.close(raw_off, comp_off)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_containers_and_sidecars_cross_read(tmp_path, writer):
    blocks = [_data(k) for k in KINDS]
    raw = b"".join(b.tobytes() for b in blocks)
    os.makedirs(tmp_path / "p")
    os.makedirs(tmp_path / "j")
    p, j = str(tmp_path / "p" / "c.bin"), str(tmp_path / "j" / "c.bin")
    _container(pcodec, p, blocks, "zlib")
    _container(jcodec, j, blocks, "zlib")
    for suffix in ("", pcodec.SIDECAR_SUFFIX):  # byte-identical files
        assert open(p + suffix, "rb").read() == open(j + suffix, "rb").read()
    path = p if writer == "port" else j
    for mod in (pcodec, jcodec):
        index = mod.load_container_index(path)
        assert index.raw_size == len(raw)
        assert [r.codec for r in index.records] == \
            ["zero", "none", "zlib", "none"]
        assert mod.container_raw_size(path) == len(raw)
    pidx = pcodec.load_container_index(path)
    jidx = jcodec.load_container_index(path)
    f = open(path, "rb")

    def pread(co, cn):
        f.seek(co)
        return f.read(cn)

    for off, n in ((0, len(raw)), (5, 300_000), (299_990, 400_000)):
        assert pcodec.read_container_range(path, pidx, off, n) == \
            raw[off:off + n]
        assert jcodec.read_container_range(path, jidx, off, n,
                                           pread=pread) == raw[off:off + n]
    f.close()
    with pytest.raises(pcodec.CodecError, match="cover"):
        pidx.covering(len(raw) - 1, 2)


@pytest.mark.parametrize("tear", ["no terminal line", "not json",
                                  "wrong format"])
def test_torn_sidecar_raises(tmp_path, tear):
    path = str(tmp_path / "c.bin")
    _container(pcodec, path, [_data("ramp")], "zlib")
    sidecar = path + pcodec.SIDECAR_SUFFIX
    lines = open(sidecar).read().splitlines()
    if tear == "no terminal line":
        lines = lines[:-1]
    elif tear == "not json":
        lines[1] = lines[1][:10]
    else:
        lines[0] = '{"format": "grit-codec-0"}'
    open(sidecar, "w").write("\n".join(lines) + "\n")
    for mod in (pcodec, jcodec):
        with pytest.raises(mod.CodecError):
            mod.load_container_index(path)
    assert pcodec.container_raw_size(path) is None
    os.unlink(sidecar)
    assert pcodec.load_container_index(path) is None
