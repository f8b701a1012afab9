"""The port's entry points (``grit_tpu_torch.entry``) against the
JAX package's ``__graft_entry__.py``.

- ``entry(device="cpu")``'s forward on the JAX ``entry()``'s weights
  (through ``convert``) and tokens gives the JAX forward's logits within
  the bf16 bound (2^-6 relative L2: the two frameworks' bf16 roundings);
- ``entry()`` and ``dryrun_multichip(n)`` raise with no GPU and no
  device: no entry point of the port falls back to the CPU on its own;
- the mesh factorings are the reference's (``:135-138``, ``:228-234``);
- ``dryrun_multichip(n, device="cpu")`` runs the three phases on ``n``
  gloo CPU processes, holds them to the reference's bounds and prints
  the reference's one-line summary.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from grit_tpu_torch import convert, entry

BF16_BOUND = 2.0 ** -6  # relative L2 of bf16 logits across frameworks


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points would run on it")


def test_entry_matches_the_jax_entry():
    import __graft_entry__ as graft  # noqa: PLC0415

    jfn, (jparams, jtokens) = graft.entry()
    want = np.asarray(jfn(jparams, jtokens))
    fn, (params, tokens) = entry.entry(device="cpu")
    assert tuple(tokens.shape) == tuple(jtokens.shape) == entry.ENTRY_TOKENS
    assert {k: tuple(v.shape) for k, v in params["layers"]["attn"].items()} \
        == {k: tuple(v.shape) for k, v in jparams["layers"]["attn"].items()}
    mine = fn(params, tokens)
    assert mine.shape == want.shape and torch.isfinite(mine).all()
    got = fn(convert.params_from_jax(jax.tree.map(np.asarray, jparams)),
             torch.from_numpy(np.asarray(jtokens, np.int64))).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < BF16_BOUND, rel


def test_entry_without_a_gpu_raises(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_without_a_gpu_raises(no_gpu, n):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(n)


@pytest.mark.parametrize("n,mesh,pipe", [
    (1, (1, 1, 1), (1, 1, 1)), (2, (1, 1, 2), (1, 2, 1)),
    (4, (1, 2, 2), (1, 2, 2)), (6, (3, 1, 2), (3, 2, 1)),
    (8, (2, 2, 2), (2, 2, 2)), (16, (4, 2, 2), (4, 2, 2))])
def test_mesh_factorings_are_the_references(n, mesh, pipe):
    assert entry.mesh_factors(n) == mesh
    assert entry.pipe_factors(n) == pipe


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_on_cpu_processes(n, capsys):
    res = entry.dryrun_multichip(n, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    data, fsdp, model = entry.mesh_factors(n)
    assert line.startswith(
        f"dryrun_multichip OK: mesh={{'data': {data}, 'fsdp': {fsdp}, "
        f"'model': {model}}} devices={n} device=cpu step_loss=")
    assert line.endswith("axes=dp,fsdp,tp,pp,ep,sp")
    assert entry.dryrun_misses(res) == []
    assert res["pp"]["mesh"]["shape"] == list(entry.pipe_factors(n))
    assert set(res["sp"]) == {"ring", "ulysses"}
