"""The port's mirror tee (``write_snapshot(mirror=)``): twins of
``tests/test_snapshot.py::TestMirrorSnapshots``, the reference agent's
upload-skip check (``_mirrored_skip``) over port mirrors, and the codec
container in both directions."""

from __future__ import annotations

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu import codec as jcodec
from grit_tpu.agent.checkpoint import CheckpointOptions, _mirrored_skip
from grit_tpu.device import snapshot as jsnap
from grit_tpu.metadata import manifest_data_file_signature
from grit_tpu_torch import metadata
from grit_tpu_torch.device import snapshot as psnap


@pytest.fixture
def python_chunks(monkeypatch):
    """The JAX writer on its Python plane, whose chunks carry crc32 (its
    native plane writes crc32c, which only the tests of the crc32c
    verifier need)."""
    monkeypatch.setattr(jsnap, "_chunk_writer",
                        lambda path, durable: jsnap._PyChunkWriter(path, durable))


def _state(key: float = 1.0) -> dict:
    return {"w": torch.arange(256, dtype=torch.float32).reshape(16, 16) * key,
            "b": torch.ones(16, dtype=torch.bfloat16) * key,
            "n": torch.tensor(7, dtype=torch.int32)}


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _commit_files(d: str) -> dict:
    """The ``{"files": ...}`` map of a mirror COMMIT's second line."""
    with open(os.path.join(d, psnap.COMMIT_FILE)) as f:
        assert f.readline().strip() == metadata.SNAPSHOT_FORMAT
        return json.loads(f.readline())["files"]


class TestMirrorSnapshots:
    def test_mirror_is_byte_identical_committed_snapshot(self, tmp_path):
        primary = str(tmp_path / "hbm")
        mirror = str(tmp_path / "pvc" / "hbm")
        os.makedirs(os.path.dirname(mirror))
        psnap.write_snapshot(primary, _state(), mirror=mirror)

        assert psnap.snapshot_exists(primary) and psnap.snapshot_exists(mirror)
        assert sorted(os.listdir(mirror)) == sorted(os.listdir(primary))
        for name in (psnap.DATA_FILE, psnap.INDEX_FILE, psnap.MANIFEST_FILE):
            assert _read(os.path.join(mirror, name)) == \
                _read(os.path.join(primary, name)), name
        assert not os.path.exists(mirror + psnap.WORK_SUFFIX)
        got = psnap.restore_snapshot(mirror)
        jgot = jsnap.restore_snapshot(mirror)
        for k, v in _state().items():
            assert torch.equal(got[f"['{k}']"], v)
            assert np.asarray(jgot[f"['{k}']"]).tobytes() == \
                v.reshape(-1).view(torch.uint8).numpy().tobytes(), k
        files = _commit_files(mirror)
        manifest = json.load(open(os.path.join(primary, psnap.MANIFEST_FILE)))
        assert files[psnap.DATA_FILE] == {
            "size": os.path.getsize(os.path.join(primary, psnap.DATA_FILE)),
            "sig": manifest_data_file_signature(manifest, psnap.DATA_FILE)}
        assert metadata.manifest_data_file_signature(
            manifest, psnap.DATA_FILE) == files[psnap.DATA_FILE]["sig"]
        for name in (psnap.INDEX_FILE, psnap.MANIFEST_FILE):
            path = os.path.join(primary, name)
            assert files[name] == {"size": os.path.getsize(path),
                                   "crc": metadata.crc32_file(path)}
        assert psnap.last_write()["mirror"] is True

    def test_mirror_failure_never_fails_the_dump(self, tmp_path):
        primary = str(tmp_path / "hbm")
        # The mirror's parent is a regular file: every mkdir/open fails.
        blocked = tmp_path / "blocked"
        blocked.write_text("not a directory")
        psnap.write_snapshot(primary, _state(), mirror=str(blocked / "sub" / "hbm"))
        assert psnap.snapshot_exists(primary)
        assert not psnap.snapshot_exists(str(blocked / "sub" / "hbm"))
        assert torch.equal(psnap.restore_snapshot(primary)["['w']"], _state()["w"])
        assert psnap.last_write()["mirror"] is False

    def test_tee_thread_death_never_fails_the_dump(self, tmp_path, monkeypatch):
        """The tee dies on its own thread (its file cannot be opened) and
        the queue is bounded at 1 MiB, below the dump's bytes: the dump
        neither fails nor blocks, and the mirror is abandoned."""

        class DyingWriter(psnap._MirrorWriter):
            def _run(self):
                self._path = str(tmp_path / "no-such-dir" / "data")
                super()._run()

        monkeypatch.setattr(psnap, "_MirrorWriter", DyingWriter)
        monkeypatch.setenv("GRIT_MIRROR_MAX_INFLIGHT_MB", "1")
        primary, mirror = str(tmp_path / "hbm"), str(tmp_path / "pvc")
        big = {"x": torch.arange(3 << 20, dtype=torch.uint8)}  # 3 MiB
        psnap.write_snapshot(primary, big, mirror=mirror)
        assert psnap.snapshot_exists(primary)
        assert not os.path.exists(mirror)
        assert not os.path.exists(mirror + psnap.WORK_SUFFIX)

    def test_byte_bounded_queue_keeps_the_write_order(self, tmp_path,
                                                      monkeypatch):
        """Pieces of 64 KiB behind a 1 MiB bound: the producer blocks on
        the tee many times, and the mirror is still byte-identical."""
        monkeypatch.setattr(psnap, "_PIECE_BYTES", 64 << 10)
        monkeypatch.setenv("GRIT_MIRROR_MAX_INFLIGHT_MB", "1")
        gen = torch.Generator().manual_seed(5)
        state = {f"x{i}": torch.randn(1 << 18, generator=gen) for i in range(6)}
        primary, mirror = str(tmp_path / "hbm"), str(tmp_path / "pvc")
        psnap.write_snapshot(primary, state, mirror=mirror)
        assert psnap.snapshot_exists(mirror)
        assert _read(os.path.join(mirror, psnap.DATA_FILE)) == \
            _read(os.path.join(primary, psnap.DATA_FILE))

    def test_delta_dump_mirrors_only_changed_bytes(self, tmp_path):
        base_d = str(tmp_path / "base")
        psnap.write_snapshot(base_d, _state(1.0), hashes=True)
        delta_d, mirror = str(tmp_path / "delta"), str(tmp_path / "pvc-delta")
        changed = dict(_state(1.0), w=_state(2.0)["w"])
        psnap.write_snapshot(delta_d, changed, base=base_d, mirror=mirror)
        assert psnap.snapshot_exists(mirror)
        pdata = _read(os.path.join(delta_d, psnap.DATA_FILE))
        assert _read(os.path.join(mirror, psnap.DATA_FILE)) == pdata
        assert len(pdata) == 16 * 16 * 4  # just "w"
        assert _commit_files(mirror)[psnap.DATA_FILE]["size"] == len(pdata)


class TestReferenceUploadSkip:
    """The reference agent's ``_mirrored_skip`` over a port mirror: it
    skips exactly the files whose identity the mirror COMMIT records and
    ships a same-size tree whose bytes differ."""

    @staticmethod
    def _opts(tmp_path) -> CheckpointOptions:
        return CheckpointOptions(pod_name="p", pod_namespace="ns",
                                 pod_uid="u", work_dir=str(tmp_path / "work"),
                                 dst_dir=str(tmp_path / "pvc"))

    def test_skips_the_port_mirrored_files(self, tmp_path):
        opts = self._opts(tmp_path)
        psnap.write_snapshot(os.path.join(opts.work_dir, "main", "hbm"),
                             _state(), mirror=os.path.join(opts.dst_dir, "main", "hbm"))
        skip = _mirrored_skip(opts, {})
        assert sorted(skip) == sorted(os.path.join("main", "hbm", n) for n in (
            psnap.DATA_FILE, psnap.INDEX_FILE, psnap.MANIFEST_FILE))

    def test_ships_a_same_size_tree_with_different_bytes(self, tmp_path):
        opts = self._opts(tmp_path)
        src = os.path.join(opts.work_dir, "main", "hbm")
        psnap.write_snapshot(src, _state(1.0),
                             mirror=os.path.join(opts.dst_dir, "main", "hbm"))
        psnap.write_snapshot(src, _state(3.0))  # same sizes, other bytes
        assert os.path.getsize(os.path.join(src, psnap.DATA_FILE)) == \
            _commit_files(os.path.join(opts.dst_dir, "main", "hbm"))[
                psnap.DATA_FILE]["size"]
        assert _mirrored_skip(opts, {}) == {}


class TestCodecAnswers:
    def test_codec_knob_abandons_the_mirror_loudly(self, tmp_path, monkeypatch,
                                                   caplog):
        """Under ``GRIT_SNAPSHOT_CODEC`` the mirror is no longer abandoned:
        it commits as a codec container with its ``.gritc`` sidecar, whose
        identity its COMMIT records beside the data file's raw one, and the
        JAX package restores it bitwise."""
        monkeypatch.setenv("GRIT_SNAPSHOT_CODEC", "zlib")
        primary, mirror = str(tmp_path / "hbm"), str(tmp_path / "pvc")
        with caplog.at_level(logging.WARNING, logger=psnap.__name__):
            psnap.write_snapshot(primary, _state(), mirror=mirror)
        assert psnap.snapshot_exists(primary) and psnap.snapshot_exists(mirror)
        assert not os.path.exists(mirror + psnap.WORK_SUFFIX)
        assert not caplog.records
        data = os.path.join(mirror, psnap.DATA_FILE)
        index = jcodec.load_container_index(data)
        assert index is not None
        assert index.raw_size == os.path.getsize(
            os.path.join(primary, psnap.DATA_FILE))
        files = _commit_files(mirror)
        sidecar = psnap.DATA_FILE + jcodec.SIDECAR_SUFFIX
        assert files[sidecar] == {"size": os.path.getsize(data + jcodec.SIDECAR_SUFFIX),
                                  "crc": metadata.crc32_file(
                                      data + jcodec.SIDECAR_SUFFIX)}
        assert files[psnap.DATA_FILE]["size"] == index.raw_size
        got = jsnap.restore_snapshot(mirror)
        for k, v in _state().items():
            assert np.asarray(got[f"['{k}']"]).tobytes() == \
                v.view(torch.uint8 if v.dtype == torch.bfloat16 else v.dtype
                       ).numpy().tobytes(), k

    def test_port_refuses_a_jax_codec_container(self, tmp_path, monkeypatch,
                                                python_chunks):
        """The port restores the JAX package's codec container bitwise (it
        used to refuse it); a torn sidecar is refused."""
        monkeypatch.setenv("GRIT_SNAPSHOT_CODEC", "zlib")
        state = {k: np.asarray(v.float()) for k, v in _state().items()}
        primary, mirror = str(tmp_path / "hbm"), str(tmp_path / "pvc")
        jsnap.write_snapshot(primary, jax.tree.map(jnp.asarray, state),
                             mirror=mirror)
        data = os.path.join(mirror, psnap.DATA_FILE)
        assert jcodec.load_container_index(data) is not None
        for d in (mirror, primary):
            got = psnap.restore_snapshot(d)
            for k, v in state.items():
                assert got[f"['{k}']"].numpy().tobytes() == v.tobytes(), (d, k)
        sidecar = data + jcodec.SIDECAR_SUFFIX
        lines = open(sidecar).read().splitlines()
        open(sidecar, "w").write("\n".join(lines[:-1]) + "\n")
        with pytest.raises(psnap.SnapshotIntegrityError, match="torn"):
            psnap.restore_snapshot(mirror)
