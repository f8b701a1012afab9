"""The port's GPipe schedule (``grit_tpu_torch/parallel/pipeline.py``)
against the JAX package's ``pipeline_apply``/``pipeline_loss``: the same
numpy stage weights and inputs, the port on four gloo CPU ranks (and on
two-rank groups), each rank holding its own stage. Forward at 2, 4
stages and several microbatch counts at 1e-5, the loss at 1e-6 relative
and every stage's gradients at 1e-4/1e-5 (as ``tests/test_pipeline.py``),
an SGD loop over the pipelined objective, the microbatch guard, and the
rank launcher's refusal to run fewer ranks than asked."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from grit_tpu.parallel import pipeline as jpipe
from grit_tpu_torch.parallel.launch import RankError, run_ranks
from grit_tpu_torch.parallel.pipeline import microbatch, stack_stage_params
from tests import torch_ranks

FWD_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def stage_fn(params, x):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + x


def stage_params(n_stages, dim, hidden, seed):
    rng = np.random.default_rng(seed)
    return {"w1": rng.standard_normal((n_stages, dim, hidden), np.float32) * 0.1,
            "b1": np.zeros((n_stages, hidden), np.float32),
            "w2": rng.standard_normal((n_stages, hidden, dim), np.float32) * 0.1}


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


FORWARD = {(n_pipe, n_mb): (stage_params(n_pipe, 8, 16, n_pipe * 10 + n_mb),
                            normal((n_mb * 2, 8), n_mb))
           for n_pipe, n_mb in [(2, 4), (4, 8), (4, 4)]}
INPUTS = {"forward": FORWARD,
          "grad": (stage_params(4, 6, 12, 2), normal((8, 6), 3),
                   normal((8, 6), 4)),
          "train": (stage_params(2, 4, 8, 5), normal((8, 4), 6))}


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(torch_ranks.pipeline_cases, 4, INPUTS, backend="gloo")


def pipe_mesh(n: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:n]), (jpipe.PIPE_AXIS,))


def test_ranks_import_nothing_of_jax(ranks):
    assert all(r["foreign"] == [] for r in ranks)


@pytest.mark.parametrize("n_pipe,n_mb", sorted(FORWARD))
def test_forward_matches_jax(ranks, n_pipe, n_mb):
    stacked, x = FORWARD[(n_pipe, n_mb)]
    want = np.asarray(jpipe.pipeline_apply(
        stage_fn, stacked, jpipe.microbatch(x, n_mb), mesh=pipe_mesh(n_pipe)))
    axis = "world" if n_pipe == 4 else "pair"
    # Every rank of the group returns the last stage's outputs.
    for r in range(4):
        np.testing.assert_allclose(ranks[r][axis]["forward"][n_mb], want,
                                   rtol=FWD_TOL, atol=FWD_TOL)


def test_gradients_match_jax(ranks):
    stacked, x, y = INPUTS["grad"]

    def mse(pred, target):
        return jnp.mean((pred - target) ** 2)

    loss, grads = jax.jit(jax.value_and_grad(lambda p: jpipe.pipeline_loss(
        stage_fn, mse, p, jpipe.microbatch(x, 4), jpipe.microbatch(y, 4),
        mesh=pipe_mesh(4))))(stacked)
    for r in range(4):
        got_loss, got = ranks[r]["world"]["grad"]
        assert abs(got_loss - float(loss)) <= 1e-6 * abs(float(loss))
        for name, g in got.items():
            np.testing.assert_allclose(g, np.asarray(grads[name])[r],
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"stage {r} {name}")


def test_training_reduces_loss(ranks):
    losses = ranks[0]["pair"]["train"]
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    assert all(r["pair"]["train"] == losses for r in ranks[1:])


def test_microbatch_shape_guard():
    with pytest.raises(ValueError):
        microbatch(torch.zeros(5, 3), 2)
    assert microbatch(torch.zeros(6, 3), 2).shape == (2, 3, 3)


def test_stack_stage_params_matches_jax():
    per = [{k: v[i] for k, v in stage_params(3, 4, 8, 0).items()}
           for i in range(3)]
    want = jpipe.stack_stage_params(per)
    got = stack_stage_params([{k: torch.from_numpy(v) for k, v in p.items()}
                              for p in per])
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("fn,message", [
    (torch_ranks.raise_on_rank_one, "planted failure"),
    (torch_ranks.exit_on_rank_two, "rank 2 exited")])
def test_launcher_raises_when_a_rank_fails(fn, message):
    """A rank that raises or dies ends the launch with its traceback; the
    launcher never returns fewer results than ranks."""
    with pytest.raises(RankError, match=message):
        run_ranks(fn, 3, backend="gloo", timeout=120)


def test_launcher_refuses_no_ranks():
    with pytest.raises(ValueError):
        run_ranks(torch_ranks.raise_on_rank_one, 0, backend="gloo")
