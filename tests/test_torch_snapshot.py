"""The port's snapshot writer/reader against the JAX package's: one on-disk
format, read and written by both, byte-identical leaves, keystr names."""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from grit_tpu.device import snapshot as jsnap
from grit_tpu_torch import convert, metadata
from grit_tpu_torch.device import snapshot as psnap
from grit_tpu_torch.train.optim import EmptyState, ScaleByAdamState
from grit_tpu_torch.tree import flatten_with_names


def _numpy_tree(seed=0):
    """Leaves of every dtype the slice stores, 0-d scalars included."""
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "w": rng.standard_normal((3, 5), dtype=np.float32),
            "emb": rng.standard_normal((4, 8)).astype(ml_dtypes.bfloat16),
        },
        "opt_state": (
            {"count": np.asarray(7, np.int32),
             "mask": rng.integers(0, 255, (6,), dtype=np.uint8)},
            {"scale": np.asarray(0.5, np.float32)},
        ),
        "step": np.asarray(42, np.int32),
        "ids": rng.integers(-5, 5, (2, 3), dtype=np.int32),
    }


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.asarray(x).tobytes()


@pytest.fixture
def python_chunks(monkeypatch):
    """The JAX writer on its Python plane, whose chunks carry crc32 (its
    native plane writes crc32c, which only the tests of the crc32c
    verifier need)."""
    monkeypatch.setattr(jsnap, "_chunk_writer",
                        lambda path, durable: jsnap._PyChunkWriter(path, durable))


def test_port_written_snapshot_restores_through_jax(tmp_path):
    tree = _numpy_tree()
    port_tree = convert.params_from_jax(tree)
    d = str(tmp_path / "snap")
    psnap.write_snapshot(d, port_tree, meta={"step": 42})
    assert psnap.snapshot_exists(d)
    assert jsnap.SnapshotManifest.load(d).meta == {"step": 42}

    got = jsnap.restore_snapshot(d, like=jax.tree.map(jnp.asarray, tree))
    want_names = [jax.tree_util.keystr(p) for p, _ in
                  jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [n for n, _ in flatten_with_names(port_tree)] == want_names
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                            jax.tree_util.tree_leaves(got)):
        assert np.asarray(b).dtype == a.dtype, path
        assert np.asarray(b).shape == a.shape, path
        assert _bytes(b) == _bytes(a), path
    assert psnap.snapshot_nbytes(d) == jsnap.snapshot_nbytes(d)


def test_jax_written_snapshot_restores_through_port(tmp_path, python_chunks):
    tree = _numpy_tree(seed=1)
    d = str(tmp_path / "snap")
    jsnap.write_snapshot(d, jax.tree.map(jnp.asarray, tree), meta={"step": 3})

    flat = psnap.restore_snapshot(d)  # no like: {keystr: CPU tensor}
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        assert _bytes(flat[jax.tree_util.keystr(path)]) == _bytes(a), path

    like = convert.params_from_jax(tree)
    like["params"]["w"] = torch.empty(3, 5, device="meta")
    got = psnap.restore_snapshot(d, like=like, device="cpu")
    assert got["params"]["w"].device.type == "cpu"
    for (_, a), (name, b) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                 flatten_with_names(got)):
        assert _bytes(b) == _bytes(a), name


def test_meta_leaves_restore_onto_the_gpu_unless_told_otherwise(
        tmp_path, monkeypatch):
    """A meta ``like`` leaf with no device lands on the current CUDA
    device, as the reference restores onto the accelerator: with no GPU
    that raises instead of landing on the CPU. Leaves with a device of
    their own, and the flat form, still come back without a GPU."""
    d = str(tmp_path / "snap")
    psnap.write_snapshot(d, {"w": torch.arange(6.0).reshape(2, 3)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        psnap.restore_snapshot(d, like={"w": torch.empty(2, 3, device="meta")})
    got = psnap.restore_snapshot(d, like={"w": torch.empty(2, 3)})
    assert torch.equal(got["w"], torch.arange(6.0).reshape(2, 3))
    assert psnap.restore_snapshot(d)["['w']"].device.type == "cpu"


def test_sharded_and_delta_jax_snapshots_restore_through_port(
        tmp_path, python_chunks):
    """A JAX array sharded over the test mesh's devices is dumped as one
    chunk per shard, and a JAX delta snapshot references its base's
    chunks (``ref_dir``): the port reassembles both byte-identically."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    devices = np.array(jax.devices()[:4])
    mesh = Mesh(devices, ("x",))
    rng = np.random.default_rng(2)
    full = rng.standard_normal((8, 6), dtype=np.float32)
    frozen = rng.standard_normal((5,), dtype=np.float32)
    sharded = jax.device_put(full, NamedSharding(mesh, PartitionSpec("x")))
    base = str(tmp_path / "base")
    jsnap.write_snapshot(base, {"w": sharded, "f": jnp.asarray(frozen)})
    assert len(jsnap.SnapshotManifest.load(base).arrays[1]["chunks"]) == 4
    delta = str(tmp_path / "delta")
    jsnap.write_snapshot(delta, {"w": sharded + 1, "f": jnp.asarray(frozen)},
                         base=base)
    refs = [c.get("ref_dir") for rec in
            jsnap.SnapshotManifest.load(delta).arrays for c in rec["chunks"]]
    assert any(refs) and not all(refs)

    got = psnap.restore_snapshot(delta)
    assert _bytes(got["['w']"]) == _bytes(full + 1)
    assert _bytes(got["['f']"]) == _bytes(frozen)


def test_crc32c_chunks_are_refused_loudly(tmp_path):
    d = str(tmp_path / "snap")
    psnap.write_snapshot(d, {"a": torch.arange(4, dtype=torch.int32)})
    mpath = os.path.join(d, psnap.MANIFEST_FILE)
    manifest = json.load(open(mpath))
    manifest["arrays"][0]["chunks"][0]["algo"] = "crc32c"
    json.dump(manifest, open(mpath, "w"))
    with pytest.raises(psnap.SnapshotIntegrityError, match="crc32c"):
        psnap.restore_snapshot(d)


def test_corrupt_byte_is_detected(tmp_path):
    d = str(tmp_path / "snap")
    psnap.write_snapshot(d, {"a": torch.arange(64, dtype=torch.float32)})
    path = os.path.join(d, psnap.DATA_FILE)
    raw = bytearray(open(path, "rb").read())
    raw[17] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(psnap.SnapshotIntegrityError, match="crc mismatch"):
        psnap.restore_snapshot(d)


def test_overwrite_is_atomic_and_uncommitted_dirs_are_refused(tmp_path):
    d = str(tmp_path / "snap")
    psnap.write_snapshot(d, {"a": torch.zeros(3)})
    psnap.write_snapshot(d, {"a": torch.ones(3)})
    assert torch.equal(psnap.restore_snapshot(d)["['a']"], torch.ones(3))
    assert not os.path.exists(d + psnap.WORK_SUFFIX)
    assert not os.path.exists(d + ".old")
    os.unlink(os.path.join(d, psnap.COMMIT_FILE))
    with pytest.raises(FileNotFoundError):
        psnap.restore_snapshot(d)


def test_like_tree_mismatch_raises(tmp_path):
    d = str(tmp_path / "snap")
    psnap.write_snapshot(d, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="want"):
        psnap.restore_snapshot(d, like={"a": torch.zeros(4)})
    with pytest.raises(KeyError):
        psnap.restore_snapshot(d, like={"b": torch.zeros(3)})


def test_trainer_state_names_match_the_jax_trainer():
    """The port Trainer's state tree flattens to the JAX Trainer's keystr
    names (optax's ScaleByAdamState fields included)."""
    import optax

    params = {"b": np.zeros(2, np.float32), "a": {"w": np.zeros(3, np.float32)}}
    jstate = {"params": params, "opt_state": optax.adam(1e-3).init(params),
              "step": jnp.zeros((), jnp.int32), "rng": jax.random.PRNGKey(0)}
    pparams = convert.params_from_jax(params)
    pstate = {"params": pparams,
              "opt_state": (ScaleByAdamState(
                  count=torch.zeros((), dtype=torch.int32),
                  mu=convert.params_from_jax(params),
                  nu=convert.params_from_jax(params)), EmptyState()),
              "step": torch.zeros((), dtype=torch.int32),
              "rng": torch.tensor(0)}
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(jstate)[0]]
    assert [n for n, _ in flatten_with_names(pstate)] == want


def test_metadata_helpers_match_the_reference(tmp_path):
    from grit_tpu import metadata as jmeta

    assert metadata.SNAPSHOT_FORMAT == jmeta.SNAPSHOT_FORMAT
    p = str(tmp_path / "f.json")
    metadata.atomic_write_json(p, {"x": [1, 2]})
    assert json.load(open(p)) == {"x": [1, 2]}
    assert metadata.crc32_file(p) == jmeta.crc32_file(p)
