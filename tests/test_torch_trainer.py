"""The port's Trainer: Adam against optax, snapshot/restore, loading a JAX
Trainer's state, the frozen-trunk fine-tune (cross-restore both ways, the
delta's dirty set, continuation from the delta), the no-hidden-CPU rule
and import hygiene."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from grit_tpu.device import snapshot as jsnap
from grit_tpu.models import llama as jllama
from grit_tpu.train import Trainer as JaxTrainer
from grit_tpu_torch import convert
from grit_tpu_torch.device import snapshot as psnap
from grit_tpu_torch.models import llama
from grit_tpu_torch.parallel.launch import run_ranks
from grit_tpu_torch.train import optim
from grit_tpu_torch.train import trainer as ptrainer
from grit_tpu_torch.tree import flatten_with_names
from grit_tpu_torch.workload import llama_trainer
from tests import torch_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and oversubscribed spinning threads slow torch's CPU ops many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(**kw):
    return llama.LlamaConfig.tiny(**{
        "dim": 256, "n_heads": 2, "n_kv_heads": 2,
        "param_dtype": torch.float32, "dtype": torch.float32, **kw})


def test_adam_update_matches_optax():
    """Two updates from the same numpy grads: params, moments and count
    agree with optax.adam to f32 rounding."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((4, 6), dtype=np.float32),
              "b": {"v": rng.standard_normal((5,), dtype=np.float32)}}
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape,
                                                        dtype=np.float32),
                          params) for _ in range(2)]
    lr = 1e-2
    opt = optax.adam(lr)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = opt.init(jparams)
    pparams = convert.params_from_jax(params)
    popt = optim.adam(lr)
    pstate = popt.init(pparams)
    for g in grads:
        upd, jstate = opt.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        pstate = popt.apply_(pparams, convert.params_from_jax(g), pstate)
    for want, got in ((jparams, pparams), (jstate[0].mu, pstate[0].mu),
                      (jstate[0].nu, pstate[0].nu)):
        for (path, a), (name, b) in zip(
                jax.tree_util.tree_flatten_with_path(want)[0],
                flatten_with_names(got)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
    assert int(pstate[0].count) == int(jstate[0].count) == 2


def test_snapshot_restore_continues_bit_identically(tmp_path):
    """Cut at step 3, restore into a fresh Trainer: the next losses are
    the uninterrupted run's, bit for bit, and the restore never pays the
    parameter init."""
    cfg = _tiny()
    a = llama_trainer(cfg, batch=2, seq=128, device="cpu")
    a.run(3)
    d = str(tmp_path / "snap")
    a.snapshot(d)
    want = a.run(3)
    assert psnap.SnapshotManifest.load(d).meta == {"step": 3}

    b = llama_trainer(cfg, batch=2, seq=128, device="cpu")
    calls = []
    init = b._init_params
    b._init_params = lambda gen, dev: calls.append(dev) or init(gen, dev)
    assert b.restore(d) == 3
    assert all(torch.device(dev).type == "meta" for dev in calls), calls
    assert b.run(3) == want


def test_jax_trainer_state_loads_into_port_trainer(tmp_path, monkeypatch):
    """A JAX Trainer's snapshot (llama tiny at head dim 128) restores its
    params and Adam state into the port Trainer's tree byte for byte."""
    monkeypatch.setattr(jsnap, "_chunk_writer",
                        lambda path, durable: jsnap._PyChunkWriter(path, durable))
    jcfg = jllama.LlamaConfig.tiny(dim=256, n_heads=2, n_kv_heads=2,
                                   dtype=jnp.float32)

    def batch_fn(rng):
        toks = jax.random.randint(rng, (2, 129), 0, jcfg.vocab_size)
        return toks[:, :-1], toks[:, 1:]

    jt = JaxTrainer(
        loss_fn=lambda p, b: jllama.loss_fn(jcfg, p, *b),
        init_params=partial(jllama.init_params, jcfg),
        batch_fn=batch_fn)
    jt.run(2)
    d = str(tmp_path / "jax-snap")
    jt.snapshot(d)
    jstate = jax.tree.map(np.asarray, jt.state)

    pt = llama_trainer(_tiny(), batch=2, seq=128, device="cpu")
    like = pt.abstract_state()
    like.pop("rng")  # the stated divergence: JAX keeps a threefry key
    got = psnap.restore_snapshot(d, like=like, device="cpu")
    assert int(got["step"]) == 2 and int(got["opt_state"][0].count) == 2
    want = convert.state_from_jax(jstate, seed=0)
    for (name, a), (_, b) in zip(flatten_with_names(got),
                                 flatten_with_names({k: want[k] for k in got})):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    pt._state = {**got, "rng": want["rng"]}
    losses = pt.run(2)
    assert all(np.isfinite(losses)) and pt.step == 4


def test_no_gpu_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama_trainer(_tiny(), batch=2, seq=128)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptrainer.resolve_device()
    assert ptrainer.resolve_device("cpu") == torch.device("cpu")


def test_state_to_numpy_roundtrip():
    cfg = _tiny(param_dtype=torch.bfloat16)
    tr = llama_trainer(cfg, batch=2, seq=128, device="cpu")
    arrays = convert.state_to_numpy(tr.state)
    wq = arrays["params"]["layers"]["attn"]["wq"]
    assert wq.dtype == np.float32  # bf16 comes back as exact float32
    assert torch.equal(torch.from_numpy(wq).to(torch.bfloat16),
                       tr.state["params"]["layers"]["attn"]["wq"])


def test_port_imports_nothing_of_jax():
    """Every module of the port and chip_smoke's imports leave jax, optax,
    ml_dtypes and the JAX package out of sys.modules; so does a rank that
    the port's launcher spawns from this process, which has them all."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {REPO!r})
        import grit_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            grit_tpu_torch.__path__, "grit_tpu_torch.")]
        for want in ("grit_tpu_torch.workload", "grit_tpu_torch.train.optim",
                     "grit_tpu_torch.device.hook",
                     "grit_tpu_torch.models.mnist",
                     "grit_tpu_torch.serving.fanout", "grit_tpu_torch.wire",
                     "grit_tpu_torch.codec", "grit_tpu_torch.checksum",
                     "grit_tpu_torch.models.lora",
                     "grit_tpu_torch.models.moe_llama",
                     "grit_tpu_torch.ops.moe",
                     "grit_tpu_torch.parallel.collectives",
                     "grit_tpu_torch.parallel.launch",
                     "grit_tpu_torch.parallel.pipeline",
                     "grit_tpu_torch.ops.ring_attention",
                     "grit_tpu_torch.ops.ulysses",
                     "grit_tpu_torch.models.long_context",
                     "grit_tpu_torch.models.pipeline_llama",
                     "grit_tpu_torch.parallel.mesh",
                     "grit_tpu_torch.parallel.sharding",
                     "grit_tpu_torch.entry",
                     "grit_tpu_torch.models.serving",
                     "grit_tpu_torch.faults", "grit_tpu_torch.obs.flight",
                     "grit_tpu_torch.obs.trace", "grit_tpu_torch.obs.metrics",
                     "grit_tpu_torch.obs.server",
                     "grit_tpu_torch.obs.logctx"):
            assert want in names, names
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "optax",
                                            "ml_dtypes", "grit_tpu"))
        assert not bad, bad
        print("clean", len(names))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")
    assert "jax" in sys.modules
    assert run_ranks(torch_ranks.foreign_modules, 2,
                     backend="gloo") == [[], []]


# -- the frozen-trunk fine-tune (bench.py's migrated flagship) ---------------------------


def _jax_frozen_trunk_trainer(jcfg):
    def labels(params):
        return jax.tree_util.tree_map_with_path(
            lambda path, _: "train" if jax.tree_util.keystr(path).startswith(
                ("['final_norm']", "['lm_head']")) else "freeze", params)

    def batch_fn(rng):
        toks = jax.random.randint(rng, (2, 129), 0, jcfg.vocab_size)
        return toks[:, :-1], toks[:, 1:]

    return JaxTrainer(
        loss_fn=lambda p, b: jllama.loss_fn(jcfg, p, *b),
        init_params=partial(jllama.init_params, jcfg), batch_fn=batch_fn,
        optimizer=optax.multi_transform(
            {"train": optax.sgd(0.5), "freeze": optax.set_to_zero()}, labels))


def _frozen_port(seq=128):
    return llama_trainer(_tiny(), batch=2, seq=seq, device="cpu",
                         optimizer=optim.frozen_trunk(0.5))


def test_frozen_trunk_snapshot_from_jax_restores_byte_identical(
        tmp_path, monkeypatch):
    """A JAX frozen-trunk Trainer's snapshot (params, step; an opt_state
    without leaves) restores into the port's frozen-trunk Trainer byte for
    byte, and the port trains on from it."""
    monkeypatch.setattr(jsnap, "_chunk_writer",
                        lambda path, durable: jsnap._PyChunkWriter(path, durable))
    jt = _jax_frozen_trunk_trainer(jllama.LlamaConfig.tiny(
        dim=256, n_heads=2, n_kv_heads=2, dtype=jnp.float32))
    jt.run(2)
    d = str(tmp_path / "jax-frozen")
    jt.snapshot(d)
    jstate = jax.tree.map(np.asarray, jt.state)
    assert jax.tree_util.tree_leaves(jstate["opt_state"]) == []

    pt = _frozen_port()
    like = pt.abstract_state()
    like.pop("rng")  # the stated divergence: JAX keeps a threefry key
    got = psnap.restore_snapshot(d, like=like, device="cpu")
    assert flatten_with_names(got["opt_state"]) == []
    want = convert.params_from_jax(jstate["params"])
    for (name, a), (_, b) in zip(flatten_with_names(got["params"]),
                                 flatten_with_names(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert int(got["step"]) == 2
    pt._state = {**got, "rng": torch.tensor(0, dtype=torch.int64)}
    assert all(np.isfinite(pt.run(2))) and pt.step == 4


def test_frozen_trunk_snapshot_from_port_restores_into_jax(tmp_path):
    """The other way: the port's frozen-trunk snapshot restores into the
    JAX Trainer's abstract state (rng aside) byte for byte, and the JAX
    Trainer steps on from it."""
    pt = _frozen_port()
    pt.run(2)
    d = str(tmp_path / "port-frozen")
    pt.snapshot(d)
    jt = _jax_frozen_trunk_trainer(jllama.LlamaConfig.tiny(
        dim=256, n_heads=2, n_kv_heads=2, dtype=jnp.float32))
    like = {k: v for k, v in jt._abstract.items() if k != "rng"}
    got = jsnap.restore_snapshot(d, like=like)
    assert int(got["step"]) == 2
    for (path, a), (name, b) in zip(
            jax.tree_util.tree_flatten_with_path(got["params"])[0],
            flatten_with_names(pt.state["params"])):
        assert "['params']" + name == "['params']" + jax.tree_util.keystr(path)
        assert np.array_equal(np.asarray(a), b.detach().numpy()), name
    jt.state = {**got, "rng": jax.random.PRNGKey(0)}
    assert all(np.isfinite(jt.run(1)))


@pytest.mark.parametrize("hashes", [True, False], ids=["sha256", "crc-compare"])
def test_frozen_trunk_delta_dirties_only_the_trainable_slice(tmp_path, hashes):
    """``snapshot(base=, hashes=)``: the live pass at step 2, the blackout
    delta at step 3. Its dirty chunks are ``final_norm``, ``lm_head`` and
    the step counter; every trunk chunk is a reference into the base.
    A fresh Trainer restored from the delta continues bit-identically."""
    a = _frozen_port()
    a.run(2)
    base = str(tmp_path / "main-precopy")
    a.snapshot(base, hashes=hashes)
    a.run(1)
    delta = str(tmp_path / "main")
    a.snapshot(delta, base=base)
    want = a.run(2)

    manifest = json.load(open(os.path.join(delta, "MANIFEST.json")))
    dirty = {rec["name"] for rec in manifest["arrays"]
             for c in rec["chunks"] if not c.get("ref_dir")}
    assert dirty == {"['params']['final_norm']", "['params']['lm_head']",
                     "['step']"}
    nbytes = {rec["name"]: sum(c["nbytes"] for c in rec["chunks"])
              for rec in manifest["arrays"]}
    assert manifest["dirty"]["bytes"] == sum(nbytes[n] for n in dirty)
    assert manifest["dirty"]["totalBytes"] == sum(nbytes.values())
    assert psnap.snapshot_delta_nbytes(delta) == manifest["dirty"]["bytes"]

    b = _frozen_port()
    assert b.restore(delta) == 3
    assert b.run(2) == want
