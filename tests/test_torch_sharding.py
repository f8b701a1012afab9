"""The port's sharding rules (``grit_tpu_torch.parallel.sharding`` and the
models' rule tables) against the JAX package's.

Each rule table's ``spec_for`` equals the JAX table's for every leaf path
of the JAX model's own tree: llama, MNIST, LoRA, the MoE llama
(``MOE_LLAMA_RULES``) and a serving grid's state (``KV_CACHE_RULES``);
``tree_shardings`` and ``expert_shardings`` give the JAX package's specs.
On four gloo CPU ranks (one launch), every leaf of those trees is placed
by ``shard_tree`` on a (1,2,2) and a (2,1,2) mesh: each rank's local
shard (its values and its global index) is the slice
``NamedSharding.devices_indices_map`` gives the JAX device at the same
mesh coordinate, among the test process's eight virtual CPU devices. A
dim that does not divide raises in both packages; a tuple of axes out of
mesh order raises in the port.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_ranks
from grit_tpu.models import llama as jllama
from grit_tpu.models import lora as jlora
from grit_tpu.models import mnist as jmnist
from grit_tpu.models import moe_llama as jmoe
from grit_tpu.models import serving as jserving
from grit_tpu.ops import moe as jmoe_ops
from grit_tpu.parallel.mesh import MeshSpec, build_mesh
from grit_tpu.parallel.sharding import _path_str
from grit_tpu_torch.models import llama as pllama
from grit_tpu_torch.models import lora as plora
from grit_tpu_torch.models import mnist as pmnist
from grit_tpu_torch.models import moe_llama as pmoe
from grit_tpu_torch.models import serving as pserving
from grit_tpu_torch.ops import moe as pmoe_ops
from grit_tpu_torch.parallel.launch import run_ranks
from grit_tpu_torch.parallel.sharding import ShardingRules, path_str

LLAMA_CFG = jllama.LlamaConfig.tiny(dim=128, n_layers=4, n_heads=8,
                                    n_kv_heads=4, dtype=jnp.float32)
MOE_CFG = jmoe.MoeLlamaConfig.tiny(dim=128, n_layers=4, n_heads=8,
                                   n_kv_heads=4, dtype=jnp.float32)
MNIST_CFG = jmnist.MnistConfig()
LORA_CFG = jlora.LoraConfig(rank=4, targets=jlora.TARGETS)


def _grid_state():
    """A continuous-batching grid's fresh state (4 slots), as the JAX
    engine builds it."""
    params = jmoe.init_params(MOE_CFG, jax.random.PRNGKey(0))
    eng = jserving.ContinuousBatchingEngine(
        MOE_CFG, params, jserving.BatchingConfig(n_slots=4, max_seq_len=32))
    return jax.eval_shape(eng._fresh_state)


def _jax_trees() -> dict:
    """``{tree: (JAX rule table, port table's name, the JAX tree)}``."""
    key = jax.random.PRNGKey(0)
    return {
        "llama": (jllama.LLAMA_RULES, "llama",
                  jax.eval_shape(partial(jllama.init_params, LLAMA_CFG), key)),
        "mnist": (jmnist.MNIST_RULES, "mnist",
                  jax.eval_shape(partial(jmnist.init_params, MNIST_CFG), key)),
        "lora": (jlora.LORA_RULES, "lora",
                 jax.eval_shape(partial(jlora.init_lora, LLAMA_CFG, LORA_CFG),
                                key)),
        "moe": (jmoe.MOE_LLAMA_RULES, "moe",
                jax.eval_shape(partial(jmoe.init_params, MOE_CFG), key)),
        "kv_cache": (jserving.KV_CACHE_RULES, "kv_cache", _grid_state()),
    }


PORT_TABLES = {"llama": pllama.LLAMA_RULES, "mnist": pmnist.MNIST_RULES,
               "lora": plora.LORA_RULES, "moe": pmoe.MOE_LLAMA_RULES,
               "kv_cache": pserving.KV_CACHE_RULES}
TREES = ["llama", "mnist", "lora", "moe", "kv_cache"]


@pytest.mark.parametrize("tree", TREES)
def test_rule_table_matches_jax(tree):
    jrules, name, jtree = _jax_trees()[tree]
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert len(flat) >= 4
    for path, _ in flat:
        p = _path_str(path)
        assert path_str(jax.tree_util.keystr(path)) == p
        assert PORT_TABLES[name].spec_for(p) == tuple(jrules.spec_for(p)), p
    assert pllama.BATCH_SPEC == tuple(jllama.BATCH_SPEC)


def test_rules_first_match_and_default():
    rules = ShardingRules(rules=[(r"a", ("model",)), (r"ab", ("fsdp",))],
                          default=("data",))
    assert rules.spec_for("xab") == ("model",)
    assert rules.spec_for("zz") == ("data",)
    assert rules.tree_specs({"a": 1, "b": {"c": 2}}) == {
        "a": ("model",), "b": {"c": ("data",)}}


MESHES = [(1, 2, 2), (2, 1, 2)]
# (shape, spec): a dim that does not divide; the batch spec's tuple in the
# wrong order; one axis used twice.
BAD = {"odd_dim": ((6, 5), (None, "model")),
       "odd_tuple": ((6,), (("data", "fsdp", "model"),)),
       "order": ((8,), (("fsdp", "data"),)),
       "twice": ((4, 4), ("model", "model"))}


@pytest.fixture(scope="module")
def placed():
    trees = {name: (table, {jax.tree_util.keystr(p): tuple(leaf.shape)
                            for p, leaf in
                            jax.tree_util.tree_flatten_with_path(jtree)[0]})
             for name, (_, table, jtree) in _jax_trees().items()}
    trees["batch"] = ("batch", {"['tokens']": (4, 16)})
    return run_ranks(torch_ranks.placement_cases, 4,
                     {"meshes": MESHES, "trees": trees, "bad": BAD},
                     backend="gloo", timeout=300)


def _jax_mesh(shape):
    return build_mesh(MeshSpec(*shape), jax.devices()[:4])


@pytest.mark.parametrize("mshape", MESHES, ids=["122", "212"])
@pytest.mark.parametrize("tree", TREES + ["batch"])
def test_local_shards_match_devices_indices_map(placed, mshape, tree):
    jm = _jax_mesh(mshape)
    if tree == "batch":
        flat = [("['tokens']", (4, 16), jllama.BATCH_SPEC)]
    else:
        jrules, _, jtree = _jax_trees()[tree]
        flat = [(jax.tree_util.keystr(p), tuple(leaf.shape),
                 jrules.spec_for(_path_str(p)))
                for p, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    devices = jm.devices.reshape(-1)  # rank r holds the r-th, row-major
    for name, shape, spec in flat:
        full = np.arange(int(np.prod(shape)), dtype=np.int32).reshape(shape)
        index_map = NamedSharding(jm, spec).devices_indices_map(shape)
        for rank, got in enumerate(placed):
            slices = index_map[devices[rank]]
            want = [list(s.indices(n)[:2]) for s, n in zip(slices, shape)]
            leaf = got[(tuple(mshape), tree)][name]
            assert leaf["index"] == want, (name, rank)
            assert np.array_equal(leaf["local"], full[slices]), (name, rank)
    assert all(r["foreign"] == [] for r in placed)


@pytest.mark.parametrize("mshape", MESHES, ids=["122", "212"])
@pytest.mark.parametrize("key", sorted(BAD))
def test_unplaceable_specs_raise(placed, mshape, key):
    """A dim that does not divide by its axes raises in both packages; so
    does an axis used twice. An axes tuple out of mesh order is the
    port's own refusal: DTensor would split the dim in mesh order, and
    the JAX package (which takes any order) would disagree."""
    shape, spec = BAD[key]
    got = placed[0][(tuple(mshape), key)]
    assert all(r[(tuple(mshape), key)] == got for r in placed)
    assert got.startswith("ValueError"), got
    if key == "order":
        assert "mesh order" in got
        return
    with pytest.raises(Exception) as err:
        jax.device_put(np.zeros(shape, np.int32),
                       NamedSharding(_jax_mesh(mshape), P(*spec)))
    assert type(err.value).__name__ in ("ValueError", "DuplicateSpecError")


def test_placements_of_a_spec():
    """Shard(d) on the mesh dim of an axis named at tensor dim d, a tuple
    over several mesh dims, Replicate elsewhere; axes of size 1 are left
    out of the active mesh's placements."""
    from torch.distributed.tensor import Replicate, Shard  # noqa: PLC0415

    from grit_tpu_torch.parallel.sharding import placements  # noqa: PLC0415

    class FakeMesh:  # the two attributes ``placements`` reads
        def __init__(self, names):
            self.mesh_dim_names = names
            self.ndim = len(names)

    full = FakeMesh(("data", "fsdp", "model"))
    assert placements((None, "fsdp", "model"), full, 3) == (
        Replicate(), Shard(1), Shard(2))
    assert placements((("data", "fsdp"),), full, 2) == (
        Shard(0), Shard(0), Replicate())
    assert placements((), full, 2) == (Replicate(),) * 3
    active = FakeMesh(("fsdp", "model"))
    assert placements((("data", "fsdp"), "model"), active, 2) == (
        Shard(0), Shard(1))


class _FakeMesh:
    """The attributes a port ``NamedSharding`` reads of its mesh."""

    mesh_dim_names = ("data", "fsdp", "model")
    ndim = 3
    shape = (1, 2, 2)


@pytest.mark.parametrize("tree", ["moe", "kv_cache"])
def test_tree_shardings_match_jax(tree):
    """``ShardingRules.tree_shardings``: one ``NamedSharding`` a leaf, on
    the mesh given, with the JAX package's spec for that leaf."""
    jrules, name, jtree = _jax_trees()[tree]
    jmesh = build_mesh(MeshSpec(1, 2, 2), jax.devices()[:4])
    want = {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(
                jrules.tree_shardings(jtree, jmesh),
                is_leaf=lambda x: isinstance(x, NamedSharding))[0]}
    from grit_tpu_torch.tree import flatten_with_names  # noqa: PLC0415

    skeleton = {jax.tree_util.keystr(p): leaf for p, leaf in
                jax.tree_util.tree_flatten_with_path(jtree)[0]}
    got = PORT_TABLES[name].tree_shardings(jtree, _FakeMesh())
    flat = dict(flatten_with_names(got))
    assert flat.keys() == want.keys() == skeleton.keys()
    for leaf, sh in flat.items():
        assert sh.mesh is not None and sh.spec == want[leaf], leaf
        assert sh.descriptor()["spec"] == [
            list(e) if isinstance(e, tuple) else e for e in want[leaf]]


def test_expert_shardings_match_jax():
    jmesh = build_mesh(MeshSpec(1, 2, 2), jax.devices()[:4])
    want = jmoe_ops.expert_shardings(jmesh, "model")
    got = pmoe_ops.expert_shardings(_FakeMesh(), "model")
    assert got.keys() == want.keys()
    for leaf, sh in got.items():
        assert sh.spec == tuple(want[leaf].spec), leaf
    assert pmoe_ops.EXPERT_AXIS == jmoe_ops.EXPERT_AXIS
    assert pmoe.EXPERT_MESH_AXIS == jmoe.EXPERT_MESH_AXIS
    assert pmoe.BATCH_SPEC == tuple(jmoe.BATCH_SPEC)


def test_a_dense_workload_loads_no_dtensor_module():
    """The port's workload, dense, never imports DTensor's module (its
    import lengthens every process start, inside every migration's
    blackout): the sharded code paths import it when they run."""
    import subprocess  # noqa: PLC0415
    import sys  # noqa: PLC0415

    code = ("import sys; import grit_tpu_torch.workload, grit_tpu_torch."
            "parallel; print('torch.distributed.tensor' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=__file__.rsplit("/tests/", 1)[0])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
