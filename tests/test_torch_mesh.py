"""The port's device mesh (``grit_tpu_torch.parallel.mesh``) against the
JAX package's (``grit_tpu.parallel.mesh``): ``MeshSpec.resolve``'s
results and errors, and ``build_mesh`` on four CPU ranks against a JAX
mesh of four of the test process's eight virtual CPU devices. The ranks
run over ``LOCAL_GLOO``, the port's process group for ranks of one host
(``grit_tpu_torch.parallel.collectives.LocalGloo``), whose every
collective (the CPU tensors' host path) is held to its definition
here, with the ring hop it carries."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_ranks
from grit_tpu.parallel import mesh as jmesh
from grit_tpu.parallel.sharding import _path_str
from grit_tpu.models import llama as jllama
from grit_tpu.train import Trainer as JaxTrainer
from grit_tpu_torch.parallel import mesh as pmesh
from grit_tpu_torch.parallel.collectives import LOCAL_GLOO, _reduce_in_order
from grit_tpu_torch.parallel.launch import run_ranks
from grit_tpu_torch.parallel.sharding import path_str

RESOLVE_CASES = [
    ((-1, 1, 1), 8), ((-1, 2, 2), 8), ((-1, 2, 1), 4), ((2, 2, 2), 8),
    ((1, 2, 2), 4), ((2, 1, 2), 4), ((4, 1, 1), 4), ((-1, 3, 1), 8),
    ((-1, 2, 2), 6), ((2, 2, 2), 4), ((3, 1, 1), 4), ((-1, 1, 4), 2),
    ((1, 1, 1), 1),
]


def _resolve(spec_cls, spec, n):
    try:
        return spec_cls(*spec).resolve(n)
    except ValueError as exc:
        return f"ValueError: {exc}"


@pytest.mark.parametrize("spec,n", RESOLVE_CASES,
                         ids=[f"{s}-{n}" for s, n in RESOLVE_CASES])
def test_resolve_matches_jax(spec, n):
    assert _resolve(pmesh.MeshSpec, spec, n) == _resolve(jmesh.MeshSpec,
                                                         spec, n)


def test_axes_match_jax():
    assert pmesh.AXES == jmesh.AXES
    assert pmesh.MeshSpec() == pmesh.MeshSpec(data=-1, fsdp=1, model=1)


MESHES = {"122": (1, 2, 2), "212": (2, 1, 2), "411": (4, 1, 1),
          "fill": (-1, 2, 1), "bad": (-1, 3, 1), "big": (2, 2, 2)}


@pytest.fixture(scope="module")
def built():
    return run_ranks(torch_ranks.mesh_cases, 4, {"specs": MESHES},
                     backend=LOCAL_GLOO, timeout=300)


@pytest.mark.parametrize("key", sorted(MESHES))
def test_build_mesh_matches_jax(built, key):
    """Shape and axes equal the JAX mesh's; rank r sits where the JAX
    mesh puts the r-th device (row-major), or both raise alike."""
    spec = MESHES[key]
    try:
        jm = jmesh.build_mesh(jmesh.MeshSpec(*spec), jax.devices()[:4])
    except ValueError as exc:
        assert all(r[key] == {"error": str(exc)} for r in built)
        return
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    first = jax.devices()[0].id
    for rank, got in enumerate(built):
        assert got[key]["shape"] == list(jm.devices.shape)
        assert got[key]["names"] == list(jm.axis_names)
        coord = [int(c[0]) for c in np.nonzero(ids == first + rank)]
        assert got[key]["coord"] == coord
        # The active sub-mesh: the axes larger than 1, in mesh order.
        active = [a for a, k in zip(jm.axis_names, jm.devices.shape) if k > 1]
        assert got[key]["active"] == active
        assert got[key]["active_coord"] == [
            c for c, k in zip(coord, jm.devices.shape) if k > 1]
    assert all(r["foreign"] == [] for r in built)


def test_path_str_matches_jax_for_the_trainer_state():
    """The rule path of every leaf of the JAX Trainer's state (params,
    Adam's moments and count, step, rng) spelled from its keystr name."""
    import jax.numpy as jnp  # noqa: PLC0415
    from functools import partial  # noqa: PLC0415

    cfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    jt = JaxTrainer(loss_fn=lambda p, b: 0.0,
                    init_params=partial(jllama.init_params, cfg),
                    batch_fn=lambda rng: None)
    flat = jax.tree_util.tree_flatten_with_path(jt._abstract)[0]
    assert len(flat) > 20
    for path, _ in flat:
        assert path_str(jax.tree_util.keystr(path)) == _path_str(path)


X = np.arange(8, dtype=np.float32)


@pytest.fixture(scope="module")
def local():
    return run_ranks(torch_ranks.local_gloo_cases, 4, {"x": X},
                     backend=LOCAL_GLOO, timeout=300)


@pytest.mark.parametrize("axis", ["world", "pair"])
def test_local_gloo_collectives(local, axis):
    """Each collective of the local gloo group, through
    ``torch.distributed`` (tensor and list forms) and through the
    functional collectives, and the ring hop, equals its definition over
    the ranks' inputs ``X + 10 r``."""
    for rank, got in enumerate(local):
        members = list(range(4)) if axis == "world" else (
            [0, 1] if rank < 2 else [2, 3])
        n, i = len(members), members.index(rank)
        xs = [X + 10 * r for r in members]
        total = sum(xs)
        chunk = X.size // n
        want = {
            "all_reduce": total, "all_gather": np.concatenate(xs),
            "reduce_scatter": total[i * chunk:(i + 1) * chunk],
            "all_to_all": np.concatenate([x[i * chunk:(i + 1) * chunk]
                                          for x in xs]),
            "broadcast": xs[0], "shift": xs[(i - 1) % n]}
        for key, value in want.items():
            assert np.array_equal(got[axis][key], value), (rank, key)
            if key not in ("broadcast", "shift"):
                assert np.array_equal(got[axis]["f_" + key], value), (rank, key)
            if key in ("all_gather", "reduce_scatter"):
                assert np.array_equal(got[axis]["l_" + key], value), (rank, key)
        assert got["backend"] == LOCAL_GLOO and got["foreign"] == []


# The reduction LocalGloo runs on a CUDA tensor's parts (the device path
# itself needs the card): held here on CPU tensors to the exact result.
_N = 4
_TRI = _N * (_N - 1) // 2
REDUCE_CASES = {
    # An int64 past 2^24 stays exact (an fp32 accumulator rounds it).
    "int64-sum": ([[2 ** 40 + r, -(2 ** 33) * r] for r in range(_N)],
                  torch.int64, "SUM", [_N * 2 ** 40 + _TRI, -(2 ** 33) * _TRI]),
    # An fp64 part below fp32's precision survives.
    "float64-sum": ([[1 + r * 2.0 ** -40] for r in range(_N)], torch.float64,
                    "SUM", [_N + _TRI * 2.0 ** -40]),
    "bfloat16-sum": ([[r + 1.0, 0.5] for r in range(_N)], torch.bfloat16,
                     "SUM", [_N * (_N + 1) / 2, _N * 0.5]),
    "float32-avg": ([[2.0 * r] for r in range(_N)], torch.float32, "AVG",
                    [_N - 1.0]),
    "int64-max": ([[2 ** 40 + r, -r] for r in range(_N)], torch.int64, "MAX",
                  [2 ** 40 + _N - 1, 0]),
    "float32-min": ([[float(r), -float(r)] for r in range(_N)], torch.float32,
                    "MIN", [0.0, 1.0 - _N]),
    "int32-product": ([[r + 1] for r in range(_N)], torch.int32, "PRODUCT",
                      [24]),
}


@pytest.mark.parametrize("case", sorted(REDUCE_CASES))
def test_local_gloo_reduction_is_exact_in_its_dtype(case):
    """``_reduce_in_order`` accumulates a floating type at least fp32's
    width and an integer in its own dtype, so the cast back gives the
    exact result."""
    parts, dtype, op, want = REDUCE_CASES[case]
    tensors = [torch.tensor(p, dtype=dtype) for p in parts]
    got = _reduce_in_order(tensors, getattr(dist.ReduceOp, op)).to(dtype)
    assert torch.equal(got, torch.tensor(want, dtype=dtype)), got


@pytest.mark.parametrize("op,match", [
    ("BAND", "LocalGloo reduces"), ("BOR", "LocalGloo reduces"),
    ("BXOR", "LocalGloo reduces"), ("AVG", "averages floating")])
def test_local_gloo_reduction_refuses_what_it_cannot_do_exactly(op, match):
    """A bitwise reduction and an integer average raise: a CUDA tensor's
    collective has no other route."""
    with pytest.raises(ValueError, match=match):
        _reduce_in_order([torch.ones(2, dtype=torch.int64)] * 2,
                         getattr(dist.ReduceOp, op))
