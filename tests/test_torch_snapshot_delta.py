"""The port's delta dumps (``write_snapshot(base=, hashes=)``) against the
JAX package's: twins of ``tests/test_snapshot.py::TestDeltaSnapshots``
(its single-process cases) and ``::TestDeltaChainFlatten`` (the reference
``grit_tpu.deltachain`` over port chains), and deltas across the packages
both ways, each restored by both with byte-identical leaves."""

from __future__ import annotations

import glob
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu import deltachain
from grit_tpu.device import snapshot as jsnap
from grit_tpu_torch.device import snapshot as psnap


@pytest.fixture
def python_chunks(monkeypatch):
    """The JAX writer on its Python plane, whose chunks carry crc32 (its
    native plane writes crc32c, which the port refuses)."""
    monkeypatch.setattr(jsnap, "_chunk_writer",
                        lambda path, durable: jsnap._PyChunkWriter(path, durable))


def _state(key: int = 0, frozen_scale: float = 1.0) -> dict:
    """The reference's delta state: a frozen leaf, a leaf that changes with
    ``key`` and a step scalar."""
    return {
        "frozen": torch.arange(64, dtype=torch.float32).reshape(8, 8) * frozen_scale,
        "lora": torch.full((8, 4), float(key)),
        "step": torch.tensor(key, dtype=torch.int32),
    }


def _np(state: dict) -> dict:
    return {k: v.numpy() for k, v in state.items()}


def _by_name(d: str) -> dict:
    return {r["name"]: r for r in psnap.SnapshotManifest.load(d).arrays}


def _assert_restores(d: str, want: dict) -> None:
    """``d`` restores to ``want`` through the port and through the JAX
    package, byte for byte."""
    got = psnap.restore_snapshot(d)
    jgot = jsnap.restore_snapshot(d)
    for k, v in want.items():
        raw = np.asarray(v).tobytes()
        assert got[f"['{k}']"].numpy().tobytes() == raw, k
        assert np.asarray(jgot[f"['{k}']"]).tobytes() == raw, k


class TestDeltaSnapshots:
    def test_delta_references_unchanged_chunks(self, tmp_path):
        base_d, delta_d = str(tmp_path / "hbm-base"), str(tmp_path / "hbm")
        psnap.write_snapshot(base_d, _state(1))
        state2 = _state(2)
        psnap.write_snapshot(delta_d, state2, base=base_d)

        assert psnap.snapshot_nbytes(delta_d) == psnap.snapshot_nbytes(base_d)
        assert psnap.snapshot_delta_nbytes(delta_d) == 8 * 4 * 4 + 4
        by_name = _by_name(delta_d)
        assert by_name["['frozen']"]["chunks"][0]["ref_dir"] == "../hbm-base"
        assert not by_name["['lora']"]["chunks"][0].get("ref_dir")
        manifest = json.load(open(os.path.join(delta_d, psnap.MANIFEST_FILE)))
        assert manifest["base"] == "../hbm-base"
        assert manifest["dirty"] == {"bytes": 8 * 4 * 4 + 4,
                                     "totalBytes": 64 * 4 + 8 * 4 * 4 + 4,
                                     "chunks": 2, "totalChunks": 3}
        # The delta's data file holds only the dirty bytes.
        assert os.path.getsize(os.path.join(delta_d, psnap.DATA_FILE)) == 132
        _assert_restores(delta_d, state2)
        like = {k: torch.empty_like(v, device="meta") for k, v in state2.items()}
        got = psnap.restore_snapshot(delta_d, like=like, device="cpu")
        assert all(torch.equal(got[k], state2[k]) for k in state2)

    def test_chained_delta_resolves_transitively(self, tmp_path):
        d1, d2, d3 = (str(tmp_path / f"snap{i}") for i in (1, 2, 3))
        psnap.write_snapshot(d1, _state(1))
        psnap.write_snapshot(d2, _state(2), base=d1)
        psnap.write_snapshot(d3, _state(3), base=d2)
        # The chain collapses: d3's frozen chunk points at d1 directly.
        assert _by_name(d3)["['frozen']"]["chunks"][0]["ref_dir"] == "../snap1"
        _assert_restores(d3, _state(3))

    def test_relocated_tree_restores(self, tmp_path):
        """Base and delta shipped to another node keep their sibling
        layout; no absolute source path leaks into the manifest."""
        src = tmp_path / "work"
        src.mkdir()
        psnap.write_snapshot(str(src / "hbm-base"), _state(1))
        psnap.write_snapshot(str(src / "hbm"), _state(2),
                             base=str(src / "hbm-base"))
        staged = tmp_path / "staged-on-dest-node"
        shutil.copytree(src, staged)
        shutil.rmtree(src)
        _assert_restores(str(staged / "hbm"), _state(2))

    def test_missing_base_fails_loudly(self, tmp_path):
        psnap.write_snapshot(str(tmp_path / "base"), _state(1))
        psnap.write_snapshot(str(tmp_path / "delta"), _state(2),
                             base=str(tmp_path / "base"))
        shutil.rmtree(tmp_path / "base")
        with pytest.raises(psnap.SnapshotIntegrityError,
                           match="references base .*base"):
            psnap.restore_snapshot(str(tmp_path / "delta"))

    def test_uncommitted_base_degrades_to_full_dump(self, tmp_path):
        d = str(tmp_path / "snap")
        psnap.write_snapshot(d, _state(1), base=str(tmp_path / "never-written"))
        assert psnap.snapshot_delta_nbytes(d) == psnap.snapshot_nbytes(d)
        assert "base" not in json.load(open(os.path.join(d, psnap.MANIFEST_FILE)))
        _assert_restores(d, _state(1))

    def test_self_base_rejected(self, tmp_path):
        d = str(tmp_path / "snap")
        psnap.write_snapshot(d, _state(1))
        with pytest.raises(ValueError, match="itself"):
            psnap.write_snapshot(d, _state(2), base=d)

    def test_hashed_base_matches_without_reading_base_bytes(self, tmp_path):
        """Against a hashes=True base the delta decides by sha256: with the
        base's data scribbled over after commit it still references (no
        read), and the restore then catches the corruption."""
        base_d, delta_d = str(tmp_path / "base"), str(tmp_path / "delta")
        psnap.write_snapshot(base_d, _state(1), hashes=True)
        chunks = [c for r in psnap.SnapshotManifest.load(base_d).arrays
                  for c in r["chunks"]]
        assert all(len(c["sha256"]) == 64 for c in chunks)
        for f in glob.glob(os.path.join(base_d, "data-*.bin")):
            with open(f, "r+b") as fh:
                fh.write(b"\xff" * 16)
        psnap.write_snapshot(delta_d, _state(2), base=base_d, hashes=True)
        frozen = _by_name(delta_d)["['frozen']"]["chunks"][0]
        assert frozen.get("ref_dir")
        # The reused chunk carries the base's hash for the next round.
        assert frozen["sha256"] == chunks[0]["sha256"]
        with pytest.raises(psnap.SnapshotIntegrityError, match="crc mismatch"):
            psnap.restore_snapshot(delta_d)

    def test_hash_mismatch_writes_fresh(self, tmp_path):
        base_d, delta_d = str(tmp_path / "b"), str(tmp_path / "d")
        psnap.write_snapshot(base_d, _state(1), hashes=True)
        # frozen_scale changes the frozen leaf too: it is written fresh.
        psnap.write_snapshot(delta_d, _state(1, frozen_scale=2.0), base=base_d)
        assert not _by_name(delta_d)["['frozen']"]["chunks"][0].get("ref_dir")
        assert _by_name(delta_d)["['lora']"]["chunks"][0].get("ref_dir")
        _assert_restores(delta_d, _state(1, frozen_scale=2.0))

    def test_crc_match_is_confirmed_by_a_byte_compare(self, tmp_path):
        """A base chunk whose crc matches but whose bytes differ (here: a
        forged manifest crc) is written fresh, never referenced."""
        base_d, delta_d = str(tmp_path / "b"), str(tmp_path / "d")
        psnap.write_snapshot(base_d, _state(1))
        psnap.write_snapshot(str(tmp_path / "probe"), _state(2))
        want_crc = _by_name(str(tmp_path / "probe"))["['lora']"]["chunks"][0]["crc"]
        mpath = os.path.join(base_d, psnap.MANIFEST_FILE)
        manifest = json.load(open(mpath))
        lora = next(r for r in manifest["arrays"] if r["name"] == "['lora']")
        lora["chunks"][0]["crc"] = want_crc  # the crc of state 2's bytes
        json.dump(manifest, open(mpath, "w"))
        psnap.write_snapshot(delta_d, _state(2), base=base_d)
        assert not _by_name(delta_d)["['lora']"]["chunks"][0].get("ref_dir")
        _assert_restores(delta_d, _state(2))

    def test_crc32c_base_chunks_go_straight_to_the_byte_compare(self, tmp_path):
        """A base chunk whose algo the port cannot compute (crc32c, the JAX
        native plane's) is matched by the byte compare alone: equal bytes
        are referenced, changed bytes written fresh."""
        base_d, delta_d = str(tmp_path / "b"), str(tmp_path / "d")
        psnap.write_snapshot(base_d, _state(1))
        mpath = os.path.join(base_d, psnap.MANIFEST_FILE)
        manifest = json.load(open(mpath))
        for rec in manifest["arrays"]:
            rec["chunks"][0].update(algo="crc32c", crc=0)
        json.dump(manifest, open(mpath, "w"))
        psnap.write_snapshot(delta_d, _state(2), base=base_d)
        by_name = _by_name(delta_d)
        assert by_name["['frozen']"]["chunks"][0]["algo"] == "crc32c"
        assert by_name["['frozen']"]["chunks"][0].get("ref_dir")
        assert not by_name["['lora']"]["chunks"][0].get("ref_dir")
        # The JAX package reads it (it skips crc32c it cannot compute);
        # the port refuses the crc32c chunk unless told not to verify.
        with pytest.raises(psnap.SnapshotIntegrityError, match="crc32c"):
            psnap.restore_snapshot(delta_d)
        got = psnap.restore_snapshot(delta_d, verify=False)
        assert torch.equal(got["['frozen']"], _state(2)["frozen"])

    def test_committed_tree_has_the_reference_file_set(self, tmp_path,
                                                       python_chunks):
        """A port snapshot holds the reference's files, the per-process
        index included, and its index matches the reference's layout."""
        pd, jd = str(tmp_path / "port"), str(tmp_path / "jax")
        psnap.write_snapshot(pd, _state(1))
        jsnap.write_snapshot(jd, jax.tree.map(jnp.asarray, _np(_state(1))))
        assert sorted(os.listdir(pd)) == sorted(os.listdir(jd))
        index = json.load(open(os.path.join(pd, psnap.INDEX_FILE)))
        assert index == psnap.SnapshotManifest.load(pd).arrays
        jindex = json.load(open(os.path.join(jd, psnap.INDEX_FILE)))
        assert [sorted(r) for r in index] == [sorted(r) for r in jindex]


class TestDeltaChainFlatten:
    """The reference's flatten (``grit_tpu.deltachain``) over port
    chains: the rolling base stays self-contained and the blackout delta
    resolves in at most two directories."""

    @staticmethod
    def _state(r: int) -> dict:
        w = torch.arange(4096.0)
        w[: 256 * (r + 1)] += float(r)
        return {"w": w, "frozen": torch.ones(64),
                "step": torch.tensor(r, dtype=torch.int32)}

    def test_five_round_chain_restores_bit_identical_bounded_hops(
            self, tmp_path):
        base = str(tmp_path / "precopy" / "hbm")
        psnap.write_snapshot(base, self._state(0), hashes=True)
        for r in range(1, 6):
            round_d = str(tmp_path / f"round{r}" / "hbm")
            psnap.write_snapshot(round_d, self._state(r), base=base,
                                 hashes=True)
            assert deltachain.flatten_delta_into_base(base, round_d) > 0
            assert deltachain.chain_depth(base) == 0
            assert psnap.snapshot_exists(base)

        state = self._state(9)
        delta = str(tmp_path / "blackout" / "hbm")
        psnap.write_snapshot(delta, state, base=base)
        assert deltachain.chain_depth(delta) <= 1
        assert deltachain.referenced_dirs(delta) == {os.path.abspath(base)}
        assert psnap.snapshot_delta_nbytes(delta) < psnap.snapshot_nbytes(delta)
        assert _by_name(delta)["['frozen']"]["chunks"][0].get("ref_dir")
        _assert_restores(delta, state)

    def test_flatten_preserves_hash_identity_for_next_round(self, tmp_path):
        base = str(tmp_path / "base" / "hbm")
        psnap.write_snapshot(base, self._state(0), hashes=True)
        round_d = str(tmp_path / "r1" / "hbm")
        psnap.write_snapshot(round_d, self._state(1), base=base, hashes=True)
        deltachain.flatten_delta_into_base(base, round_d)
        for rec in psnap.SnapshotManifest.load(base).arrays:
            for c in rec["chunks"]:
                assert "sha256" in c and not c.get("ref_dir"), rec["name"]
        # The next round matches the flattened base by hash.
        nxt = str(tmp_path / "r2" / "hbm")
        psnap.write_snapshot(nxt, self._state(1), base=base)
        assert psnap.snapshot_delta_nbytes(nxt) == 0

    def test_physical_nbytes_matches_the_reference_accounting(self, tmp_path):
        base = str(tmp_path / "base" / "hbm")
        psnap.write_snapshot(base, self._state(0), hashes=True)
        delta = str(tmp_path / "delta" / "hbm")
        psnap.write_snapshot(delta, self._state(1), base=base)
        for d in (base, delta):
            assert deltachain.manifest_physical_nbytes(d) == \
                psnap.snapshot_delta_nbytes(d) == jsnap.snapshot_delta_nbytes(d)

    def test_flatten_rejects_uncommitted_and_self(self, tmp_path):
        base = str(tmp_path / "base" / "hbm")
        psnap.write_snapshot(base, self._state(0), hashes=True)
        with pytest.raises(ValueError, match="itself"):
            deltachain.flatten_delta_into_base(base, base)
        with pytest.raises(ValueError, match="committed"):
            deltachain.flatten_delta_into_base(base, str(tmp_path / "missing"))


class TestCrossPackageDeltas:
    @pytest.mark.parametrize("hashed", [False, True])
    def test_jax_delta_over_a_port_base(self, tmp_path, python_chunks, hashed):
        base_d, delta_d = str(tmp_path / "base"), str(tmp_path / "delta")
        psnap.write_snapshot(base_d, _state(1), hashes=hashed)
        state2 = _np(_state(2))
        jsnap.write_snapshot(delta_d, jax.tree.map(jnp.asarray, state2),
                             base=base_d)
        by_name = _by_name(delta_d)
        assert by_name["['frozen']"]["chunks"][0]["ref_dir"] == "../base"
        assert not by_name["['lora']"]["chunks"][0].get("ref_dir")
        assert psnap.snapshot_delta_nbytes(delta_d) == 8 * 4 * 4 + 4
        _assert_restores(delta_d, state2)

    @pytest.mark.parametrize("hashed", [False, True])
    def test_port_delta_over_a_jax_base(self, tmp_path, python_chunks, hashed):
        base_d, delta_d = str(tmp_path / "base"), str(tmp_path / "delta")
        jsnap.write_snapshot(base_d, jax.tree.map(jnp.asarray, _np(_state(1))),
                             hashes=hashed)
        psnap.write_snapshot(delta_d, _state(2), base=base_d)
        by_name = _by_name(delta_d)
        assert by_name["['frozen']"]["chunks"][0]["ref_dir"] == "../base"
        assert not by_name["['lora']"]["chunks"][0].get("ref_dir")
        assert ("sha256" in by_name["['frozen']"]["chunks"][0]) == hashed
        _assert_restores(delta_d, _np(_state(2)))
