"""The port's MoE serving (``moe_llama.decode``/``decode_ragged`` and the
engines' family dispatch in ``grit_tpu_torch/models/serving.py``) against
the JAX package's, on converted weights, f32, on the CPU: prefill and
per-token decode logits against JAX's decode and the port's own forward
at 2e-4 with non-binding capacity (as ``tests/test_moe_llama.py``), the
ragged step against JAX's (released slots out of the routing, at tight
capacity too), both engines dispatching on ``MoeLlamaConfig``, a
mid-generation migration that continues bitwise, continuous batching
against solo runs and JAX's engine, the masked bucket prefill (as
``tests/test_continuous_batching.py``), and MoE serving snapshots that
cross-restore with the JAX engine in both directions."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu.device import snapshot as jsnap
from grit_tpu.models import moe_llama as jmoe
from grit_tpu.models import serving as jserving
from grit_tpu_torch import convert
from grit_tpu_torch.models import llama, moe_llama, serving

TOL = 2e-4
PROMPT_A = [3, 17, 42, 7]
PROMPT_B = [9, 1, 13]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**kw):
    """The JAX MoE tiny config in f32 and its port twin."""
    jcfg = jmoe.MoeLlamaConfig.tiny(dtype=jnp.float32, **kw)
    pcfg = moe_llama.MoeLlamaConfig.tiny(dtype=torch.float32, **kw)
    return jcfg, pcfg


# Non-binding capacity (capacity_factor = n_experts): nothing drops, so
# decode agrees with the forward (the reference's capacity note).
LOOSE = dict(capacity_factor=4.0)


def carried(jcfg):
    jparams = jmoe.init_params(jcfg, jax.random.PRNGKey(0))
    return jparams, convert.params_from_jax(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def params():
    return carried(configs()[0])


def tokens(B=2, S=12, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, S), dtype=np.int32)


# -- decode and decode_ragged ------------------------------------------------------


@pytest.mark.parametrize("top_k", [1, 2])
def test_decode_matches_jax_and_the_forward(top_k):
    jcfg, pcfg = configs(top_k=top_k, **LOOSE)
    jparams, params = carried(jcfg)
    toks = tokens()
    full = moe_llama.forward(pcfg, params, torch.from_numpy(toks)).numpy()
    jcache = jmoe.init_kv_cache(jcfg, batch=2)
    cache = moe_llama.init_kv_cache(pcfg, 2, device="cpu")
    want, jcache = jmoe.decode(jcfg, jparams, toks[:, :8], jcache)
    got, cache = moe_llama.decode(pcfg, params, torch.from_numpy(toks[:, :8]),
                                  cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), full[:, :8], rtol=TOL, atol=TOL)
    for s in range(8, 12):
        want, jcache = jmoe.decode(jcfg, jparams, toks[:, s:s + 1], jcache)
        got, cache = moe_llama.decode(pcfg, params,
                                      torch.from_numpy(toks[:, s:s + 1]), cache)
        np.testing.assert_allclose(got.numpy()[:, 0], np.asarray(want)[:, 0],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got.numpy()[:, 0], full[:, s], rtol=TOL,
                                   atol=TOL)
    assert int(cache["length"]) == int(jcache["length"]) == 12


@pytest.mark.parametrize("capacity_factor", [4.0, 1.25], ids=["loose", "tight"])
def test_decode_ragged_matches_jax(capacity_factor):
    """Per-slot positions with slot 1 released: its stale token routes
    nowhere (at tight capacity it would take an expert's only place), its
    cache rows stay byte-identical, and the active slot's logits are
    JAX's."""
    jcfg, pcfg = configs(top_k=2, capacity_factor=capacity_factor)
    jparams, params = carried(jcfg)
    toks = tokens(S=9)
    jcache = jmoe.init_kv_cache(jcfg, batch=2, max_len=32)
    cache = moe_llama.init_kv_cache(pcfg, 2, 32, device="cpu")
    _, jcache = jmoe.decode(jcfg, jparams, toks[:, :8], jcache)
    moe_llama.decode(pcfg, params, torch.from_numpy(toks[:, :8]), cache)
    before = cache["v"].clone()
    lengths, active = np.array([8, 8], np.int32), np.array([True, False])
    want, _ = jmoe.decode_ragged(jcfg, jparams, toks[:, 8:9], jcache,
                                 jnp.asarray(lengths), jnp.asarray(active))
    got, cache = moe_llama.decode_ragged(
        pcfg, params, torch.from_numpy(toks[:, 8:9]), cache,
        torch.from_numpy(lengths), torch.from_numpy(active))
    np.testing.assert_allclose(got.numpy()[0], np.asarray(want)[0], rtol=TOL,
                               atol=TOL)
    assert torch.equal(cache["v"][:, 1], before[:, 1])


@pytest.mark.parametrize("top_k", [1, 2])
def test_masked_prefill_matches_the_unpadded_prompt(top_k):
    """A bucket-padded prompt decoded with its pads masked out of the
    routing gives the unpadded prompt's logits and K/V. At non-binding
    capacity: a capacity is a share of the call's rows, pads included,
    so at a tight one the two calls may drop differently."""
    jcfg, pcfg = configs(top_k=top_k, **LOOSE)
    _, params = carried(jcfg)
    prompt = torch.from_numpy(tokens(B=1, S=11))
    padded = torch.zeros((1, 64), dtype=torch.int32)
    padded[0, :11] = prompt[0]
    runs = {}
    for label, toks, token_mask in (("plain", prompt, None),
                                    ("masked", padded, torch.arange(64) < 11)):
        cache = moe_llama.init_kv_cache(pcfg, 1, 64, device="cpu")
        logits, cache = moe_llama.decode(pcfg, params, toks, cache,
                                         token_mask=token_mask)
        runs[label] = (logits[:, :11], cache["k"][:, :, :11])
    np.testing.assert_allclose(runs["masked"][0], runs["plain"][0], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(runs["masked"][1], runs["plain"][1], rtol=1e-5,
                               atol=1e-5)


# -- the engines ------------------------------------------------------------------


def _lockstep(pcfg, params, **kw):
    return serving.InferenceEngine(
        pcfg, params, serving.ServingConfig(**{"batch_size": 2,
                                               "max_seq_len": 64, **kw}),
        device="cpu")


def _cb(cfg, params, framework="port", **kw):
    bcfg = {"n_slots": 2, "max_seq_len": 128, **kw}
    if framework == "jax":
        return jserving.ContinuousBatchingEngine(
            cfg, params, jserving.BatchingConfig(**bcfg))
    return serving.ContinuousBatchingEngine(
        cfg, params, serving.BatchingConfig(**bcfg), device="cpu")


def test_engines_dispatch_on_the_family(params):
    _, pcfg = configs()
    lock = _lockstep(pcfg, params[1])
    assert lock._decode_fn is moe_llama.decode
    cb = _cb(pcfg, params[1])
    assert cb._decode_fn is moe_llama.decode
    assert cb._ragged_fn is moe_llama.decode_ragged and cb._masked
    dense = serving.ContinuousBatchingEngine(
        llama.LlamaConfig.tiny(dtype=torch.float32), {}, device="cpu")
    assert dense._ragged_fn is llama.decode_ragged and not dense._masked


def test_mid_generation_migration_is_bit_identical(params, tmp_path):
    """The twin of the JAX package's MoE serving migration: snapshot the
    lock-step engine mid-generation at temperature 0.7, restore into a
    fresh engine, the same tokens."""
    _, pcfg = configs()
    eng = _lockstep(pcfg, params[1], temperature=0.7)
    eng.prefill(tokens(S=8))
    eng.generate(3)
    eng.snapshot(str(tmp_path / "kv"))
    cont = eng.generate(5)
    eng2 = _lockstep(pcfg, params[1], temperature=0.7)
    assert eng2.restore(str(tmp_path / "kv")) == 4
    assert torch.equal(eng2.generate(5), cont)


def _cb_mid_generation(eng):
    sa = eng.submit(PROMPT_A)
    [eng.step() for _ in range(2)]
    sb = eng.submit(PROMPT_B)
    return sa, sb


def test_cb_migration_is_bit_identical(params, tmp_path):
    _, pcfg = configs()
    src = _cb(pcfg, params[1], temperature=1.0, seed=3)
    _cb_mid_generation(src)
    src.step()
    src.snapshot(str(tmp_path / "grid"))
    want = [src.step() for _ in range(6)]
    dst = _cb(pcfg, params[1], temperature=1.0, seed=3)
    dst.restore(str(tmp_path / "grid"))
    assert [dst.step() for _ in range(6)] == want


def solo(pcfg, params, prompt, n):
    eng = _lockstep(pcfg, params, batch_size=1, max_seq_len=128)
    toks = eng.prefill([prompt]).reshape(-1).tolist()
    return (toks + eng.generate(n - 1).reshape(-1).tolist())[:n]


def test_continuous_batching_matches_solo_runs_and_jax(params):
    """Staggered joins decode as each prompt does alone, and as JAX's
    engine does (greedy, non-binding capacity)."""
    jcfg, pcfg = configs(**LOOSE)
    jparams, pparams = carried(jcfg)
    streams = []
    for framework, p, cfg in (("port", pparams, pcfg), ("jax", jparams, jcfg)):
        eng = _cb(cfg, p, framework)
        sa, sb = _cb_mid_generation(eng)
        toks_a, toks_b = [], []
        for _ in range(4):
            emitted = eng.step()
            toks_a.append(int(emitted[sa]))
            toks_b.append(int(emitted[sb]))
        streams.append((toks_a, toks_b))
    assert streams[0] == streams[1]
    assert streams[0][1] == solo(pcfg, pparams, PROMPT_B, 4)


def test_prefill_masks_bucket_padding(params):
    """The same prompt through a 16 and a 64 bucket at the default
    (tight) capacity, top-2: the prompt's K/V and the greedy tokens
    agree (the JAX package's test of the same name)."""
    jcfg, pcfg = configs(top_k=2)
    _, pparams = carried(jcfg)
    n = len(PROMPT_A)
    outs = []
    for bucket in (16, 64):
        eng = _cb(pcfg, pparams, n_slots=1, prefill_buckets=(bucket,))
        slot = eng.submit(PROMPT_A)
        k = eng.state["cache"]["k"][:, slot, :n].clone()
        v = eng.state["cache"]["v"][:, slot, :n].clone()
        outs.append((k, v, [eng.step()[slot] for _ in range(3)]))
    (k16, v16, t16), (k64, v64, t64) = outs
    np.testing.assert_allclose(k16, k64, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(v16, v64, rtol=1e-4, atol=1e-5)
    assert t16 == t64


def test_prefill_token_mask_wiring():
    """The MoE prefill passes ``positions < prompt length`` as the
    routing mask (a spy decode function, as the JAX package's test)."""
    jcfg, pcfg = configs(top_k=2)
    _, pparams = carried(jcfg)
    seen = {}

    def spy(cfg, p, toks, cache, token_mask=None):
        seen["mask"] = token_mask
        return moe_llama.decode(cfg, p, toks, cache, token_mask=token_mask)

    cache = moe_llama.init_kv_cache(pcfg, 1, 32, device="cpu")
    padded = torch.zeros((1, 16), dtype=torch.int32)
    padded[0, :3] = torch.tensor(PROMPT_A[:3])
    serving._cb_prefill(pcfg, spy, True, pparams, padded, 3, 0, cache)
    assert torch.equal(seen["mask"], torch.arange(16) < 3)


@pytest.fixture
def python_chunks(monkeypatch):
    monkeypatch.setattr(jsnap, "_chunk_writer",
                        lambda path, durable: jsnap._PyChunkWriter(path, durable))


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_moe_serving_snapshot_cross_restores(params, tmp_path, python_chunks,
                                             direction):
    """A continuous-batching MoE engine's snapshot, mid-generation, restores
    into the other package's engine, which continues with the greedy
    tokens the source emits."""
    jcfg, pcfg = configs(**LOOSE)
    jparams, pparams = carried(jcfg)
    src_fw, dst_fw = direction.split("->")
    make = {"jax": lambda: _cb(jcfg, jparams, "jax"),
            "port": lambda: _cb(pcfg, pparams)}
    src = make[src_fw]()
    _cb_mid_generation(src)
    d = str(tmp_path / "moe-grid")
    src.snapshot(d)
    want = [{k: int(v) for k, v in src.step().items()} for _ in range(5)]
    dst = make[dst_fw]()
    dst.restore(d)
    assert dst._submissions == 2
    assert [{k: int(v) for k, v in dst.step().items()} for _ in range(5)] == want


def test_moe_cache_layout_is_llamas():
    _, pcfg = configs()
    a = moe_llama.init_kv_cache(pcfg, 2, 16, device="meta")
    b = llama.init_kv_cache(dataclasses.replace(pcfg), 2, 16, device="meta")
    assert {k: (tuple(v.shape), v.dtype) for k, v in a.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in b.items()}
