"""Post-copy restore onto a mesh (``restore_snapshot_postcopy``,
``Trainer.restore`` under ``GRIT_RESTORE_POSTCOPY`` and both families'
``ContinuousBatchingEngine.restore_postcopy``), held bitwise to the
blocking restore of the same snapshot: the twins, on four gloo CPU ranks
of a (1,2,2) mesh, of the reference's ``TestPostcopyRestore``
(``tests/test_restore_pipeline.py:316-413``).

One launch runs every case (``torch_ranks.postcopy_mesh_cases``):

- with the tail held, the hot set (every array of at most 1 KB: the
  norms, the scalars) is placed, each rank's shard of each norm as a
  DTensor, and no cold array is; released, the handle hands back every
  leaf with the blocking restore's bytes and placements; plain ``like``
  leaves come back placed by ``mesh=`` (the recorded descriptors) or
  ``shardings=``;
- a (1,2,2) ``Trainer.restore`` under ``GRIT_RESTORE_POSTCOPY`` returns
  the cut step with the tail pending and continues bitwise;
- a grid snapshot of the tiny llama and the tiny MoE llama (temperature
  1.0) restored by post-copy onto (1,2,2) decodes the blocking restore's
  tokens and writes its cache; with the bookkeeping hot the clone parks
  the source's slots, with nothing hot it blocks, on every rank alike.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_ranks
from grit_tpu.models import llama as jllama
from grit_tpu.models import moe_llama as jmoe
from grit_tpu_torch.parallel.launch import run_ranks

CFG = dict(dim=128, n_layers=4, n_heads=8, n_kv_heads=4)
GRID_CFG = {"dense": CFG, "moe": dict(CFG, capacity_factor=1.0, top_k=2)}
ROUNDS, CUT = 6, 3
HOT_MB = "0.001"        # 1 KB: the norms and the scalars
GRID_HOT_MB = "0.001"   # the grid's bookkeeping, not its cache


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("postcopy-mesh"))
    params = jax.tree.map(np.asarray, jllama.init_params(
        jllama.LlamaConfig.tiny(**CFG, dtype=jnp.float32),
        jax.random.PRNGKey(0)))
    tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (4, 17), 0, 256), np.int64)
    grid_params = {
        "dense": params,
        "moe": jax.tree.map(np.asarray, jmoe.init_params(
            jmoe.MoeLlamaConfig.tiny(**GRID_CFG["moe"], dtype=jnp.float32),
            jax.random.PRNGKey(2)))}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 9, 3, 12)]
    ranks = run_ranks(torch_ranks.postcopy_mesh_cases, 4,
                      {"work": work, "cfg": CFG, "params": params,
                       "tokens": tokens, "hot_mb": HOT_MB,
                       "grid_cfg": GRID_CFG, "grid_params": grid_params,
                       "grid_hot_mb": GRID_HOT_MB, "prompts": prompts,
                       "max_len": 64, "rounds": ROUNDS, "cut": CUT},
                      backend="gloo", timeout=600)
    return {"ranks": ranks}


def test_hot_set_places_before_the_cold_bytes_land(world):
    for r in world["ranks"]:
        assert r["foreign"] == []
        held = r["held"]
        assert not held["done"]
        assert 0 < held["placed"] == len(held["hot"]) < held["total"]
        norms = [n for n in held["hot"] if "norm" in n]
        assert norms and set(norms) <= set(held["hot_dtensors"])
        assert "['params']['layers']['attn']['wq']" not in held["hot"]


def test_postcopy_bit_identical_on_a_mesh(world):
    for r in world["ranks"]:
        assert all(r["lazy_equal"].values()), [
            n for n, ok in r["lazy_equal"].items() if not ok]


@pytest.mark.parametrize("by", ["mesh", "shardings"])
def test_postcopy_places_plain_like_leaves(world, by):
    """``restore_snapshot_postcopy(mesh=)`` re-realises the recorded
    descriptors on the mesh, ``shardings=`` takes the given ones: each
    split leaf comes back a DTensor of the blocking restore's placements
    and bytes, each leaf no spec splits whole."""
    for r in world["ranks"]:
        got = r["placed_by"][by]
        assert got and all(got.values()), [n for n, ok in got.items()
                                           if not ok]


def test_trainer_postcopy_resume_bit_identical_on_a_mesh(world):
    for r in world["ranks"]:
        assert r["lazy_step"] == 2 and r["lazy_pending"]
        assert r["lazy_after"] == r["blocking_after"]
        for name, (index, a) in r["lazy_state"].items():
            want_index, b = r["blocking_state"][name]
            assert index == want_index and np.array_equal(a, b), name


@pytest.mark.parametrize("fam", ["dense", "moe"])
@pytest.mark.parametrize("label", ["parked", "blocked"])
def test_grid_postcopy_matches_the_blocking_restore(world, fam, label):
    for r in world["ranks"]:
        res = r[fam]
        assert res["blocking_after"] == res["source_after"]
        got = res[label]
        assert got["after"] == res["blocking_after"]
        for name, (index, a) in got["cache"].items():
            want_index, b = res["blocking_cache"][name]
            assert index == want_index and np.array_equal(a, b), name


@pytest.mark.parametrize("fam", ["dense", "moe"])
def test_park_or_block_is_decided_on_the_hot_set_alike(world, fam):
    ranks = world["ranks"]
    assert all(r[fam]["parked"]["parked"] for r in ranks)
    assert not any(r[fam]["blocked"]["parked"] for r in ranks)
    # The source's in-flight slots are reserved on every rank alike.
    assert len({tuple(r[fam]["parked"]["free"]) for r in ranks}) == 1
