"""The port's serving engines against the JAX package's: greedy tokens of
both engines over the same admission schedules (staggered joins, slot
reuse, EOS, the cache limit, submit guards, capacity overflow),
bit-identical mid-flight migration within the port at temperature 1.0,
the RNG stream position across a restore, and serving snapshots that
cross-restore in both directions. Weights go across by
``params_from_jax``; everything runs on the CPU in f32."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu.device import snapshot as jsnap
from grit_tpu.models import llama as jllama
from grit_tpu.models import serving as jserving
from grit_tpu_torch import convert
from grit_tpu_torch.device import snapshot as psnap
from grit_tpu_torch.models import llama
from grit_tpu_torch.models import serving
from grit_tpu_torch.tree import flatten_with_names

# f32 activations: the exactness assertions compare tokens across
# different batch shapes and frameworks, where bf16 rounding would flip
# an argmax sooner or later (as tests/test_continuous_batching.py says).
JCFG = jllama.LlamaConfig.tiny(dtype=jnp.float32)
PCFG = llama.LlamaConfig.tiny(dtype=torch.float32)

PROMPT_A = [3, 17, 42, 7]
PROMPT_B = [9, 1, 13]
PROMPT_C = [5, 6, 7]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and oversubscribed spinning threads slow torch's CPU ops many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """(JAX params, the port's copy of them)."""
    jparams = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    return jparams, convert.params_from_jax(jax.tree.map(np.asarray, jparams))


@pytest.fixture
def python_chunks(monkeypatch):
    """The JAX writer on its Python plane, whose chunks carry crc32 (its
    native plane writes crc32c, which only the tests of the crc32c
    verifier need)."""
    monkeypatch.setattr(jsnap, "_chunk_writer",
                        lambda path, durable: jsnap._PyChunkWriter(path, durable))


def _cb(params, framework="port", **kw):
    bcfg = dict(n_slots=2, max_seq_len=128)
    bcfg.update(kw)
    if framework == "jax":
        return jserving.ContinuousBatchingEngine(
            JCFG, params[0], jserving.BatchingConfig(**bcfg))
    return serving.ContinuousBatchingEngine(
        PCFG, params[1], serving.BatchingConfig(**bcfg), device="cpu")


def _lockstep(params, framework="port", **kw):
    scfg = dict(batch_size=2, max_seq_len=64)
    scfg.update(kw)
    if framework == "jax":
        return jserving.InferenceEngine(JCFG, params[0],
                                        jserving.ServingConfig(**scfg))
    return serving.InferenceEngine(PCFG, params[1],
                                   serving.ServingConfig(**scfg), device="cpu")


def _prompt(B=2, S=8, seed=5):
    return np.random.default_rng(seed).integers(0, 256, (B, S), dtype=np.int32)


def _tokens(x) -> list:
    return np.asarray(x).reshape(-1).tolist()


def solo_greedy(params, prompt, n_tokens):
    """The port's lock-step engine decoding one prompt alone (its prefill
    emits the first generated token)."""
    eng = _lockstep(params, batch_size=1, max_seq_len=128)
    toks = _tokens(eng.prefill([prompt]))
    if n_tokens > 1:
        toks += _tokens(eng.generate(n_tokens - 1))
    return toks[:n_tokens]


def _schedule(eng) -> tuple[list[int], list[dict]]:
    """Staggered joins, a full grid refusing an admission, a release and
    the slot's reuse; returns the admitted slots and every round's
    ``{slot: token}``."""
    rounds = []
    sa = eng.submit(PROMPT_A)
    rounds += [eng.step() for _ in range(2)]
    sb = eng.submit(PROMPT_B)
    assert not eng.free_slots()
    with pytest.raises(RuntimeError, match="free slot"):
        eng.submit([1, 2])
    rounds += [eng.step() for _ in range(3)]
    eng.release(sa)
    assert eng.free_slots() == [sa]
    sc = eng.submit(PROMPT_C)
    rounds += [eng.step() for _ in range(4)]
    return [sa, sb, sc], rounds


# -- greedy parity with the JAX engines ----------------------------------------


def test_continuous_batching_greedy_tokens_match_jax(params):
    want = _schedule(_cb(params, "jax"))
    got = _schedule(_cb(params))
    assert got == want
    assert got[0][2] == got[0][0]  # the released slot was reused


def test_cache_limit_and_eos_deactivate_as_in_jax(params):
    """A 16-position cache: the slot runs to the limit and deactivates;
    with its first greedy token declared EOS it stops after one round."""
    runs = {}
    for fw in ("jax", "port"):
        eng = _cb(params, fw, max_seq_len=16)
        slot = eng.submit(PROMPT_A)
        rounds = []
        while True:
            emitted = eng.step()
            if not emitted:
                break
            rounds.append(emitted)
        assert slot in eng.free_slots()
        runs[fw] = rounds
    assert runs["port"] == runs["jax"]
    assert len(runs["port"]) == 16 - len(PROMPT_A) + 1
    eos = runs["jax"][0][0]
    for fw in ("jax", "port"):
        eng = _cb(params, fw, eos_id=eos)
        slot = eng.submit(PROMPT_A)
        assert eng.step() == {slot: eos}
        assert slot in eng.free_slots()
        assert eng.step() == {}


@pytest.mark.parametrize("framework", ["jax", "port"])
def test_submit_guards(params, framework):
    eng = _cb(params, framework, n_slots=1)
    with pytest.raises(ValueError, match="empty"):
        eng.submit([])
    # 70 tokens: the next bucket (256) exceeds the 128-position cache.
    with pytest.raises(ValueError, match="bucket"):
        eng.submit(list(range(1, 71)))


def test_staggered_joins_match_solo_runs(params):
    """B joins while A is mid-generation; both emit exactly their solo
    lock-step tokens (the batching is invisible to each sequence)."""
    eng = _cb(params, n_slots=3)
    sa = eng.submit(PROMPT_A)
    toks_a = [eng.step()[sa] for _ in range(2)]
    sb = eng.submit(PROMPT_B)
    toks_b = []
    while len(toks_a) < 6 or len(toks_b) < 5:
        emitted = eng.step()
        if len(toks_a) < 6:
            toks_a.append(emitted[sa])
        if len(toks_b) < 5:
            toks_b.append(emitted[sb])
    assert toks_a == solo_greedy(params, PROMPT_A, 6)
    assert toks_b == solo_greedy(params, PROMPT_B, 5)


def test_lockstep_greedy_tokens_match_jax(params):
    runs = {}
    for fw in ("jax", "port"):
        eng = _lockstep(params, fw)
        first = eng.prefill(_prompt())
        runs[fw] = (_tokens(first), _tokens(eng.generate(4)))
        assert int(eng.state["cache"]["length"]) == 12
    assert runs["port"] == runs["jax"]


def test_lockstep_capacity_overflow_raises_and_restore_resyncs(params,
                                                               tmp_path):
    eng = _lockstep(params, max_seq_len=4)
    with pytest.raises(ValueError, match="KV cache overflow"):
        eng.prefill(_prompt())  # 8 > 4
    eng = _lockstep(params, max_seq_len=12)
    eng.prefill(_prompt())
    eng.generate(4)  # fills the 12 positions
    with pytest.raises(ValueError, match="KV cache overflow"):
        eng.generate_step()
    eng = _lockstep(params, max_seq_len=16)
    eng.prefill(_prompt())
    eng.generate(2)
    eng.snapshot(str(tmp_path / "snap"))
    fresh = _lockstep(params, max_seq_len=16)
    assert fresh.restore(str(tmp_path / "snap")) == 3
    assert fresh._cache_len == 10
    fresh.generate(6)
    with pytest.raises(ValueError, match="KV cache overflow"):
        fresh.generate_step()


# -- migration within the port --------------------------------------------------


def test_continuous_batching_midflight_migration_is_bit_identical(params,
                                                                  tmp_path):
    """Temperature 1.0 (the RNG leaves matter): a heterogeneous grid
    snapshotted mid-decode continues in a fresh engine token for token,
    with the tagged cache; a changed RNG word changes that slot's
    stream."""
    eng = _cb(params, temperature=1.0)
    sa = eng.submit(PROMPT_A)
    [eng.step() for _ in range(2)]
    sb = eng.submit(PROMPT_B)
    d = str(tmp_path / "grid")
    eng.snapshot(d)
    want = [eng.step() for _ in range(6)]
    assert all(set(r) == {sa, sb} for r in want)

    dst = _cb(params, temperature=1.0)
    dst.restore(d)
    assert dst._submissions == 2
    assert [dst.step() for _ in range(6)] == want

    other = _cb(params, temperature=1.0)
    other.restore(d)
    other.state["rngs"][sb] = torch.tensor(serving.stream_key(1, 99),
                                           dtype=torch.uint32)
    got = [other.step() for _ in range(6)]
    assert [r[sa] for r in got] == [r[sa] for r in want]
    assert [r[sb] for r in got] != [r[sb] for r in want]


def test_lockstep_midflight_migration_is_bit_identical(params, tmp_path):
    eng = _lockstep(params, temperature=0.7)
    eng.prefill(_prompt())
    eng.generate(3)
    eng.snapshot(str(tmp_path / "kv"))
    cont = eng.generate(5)
    eng2 = _lockstep(params, temperature=0.7)
    assert eng2.restore(str(tmp_path / "kv")) == 4  # prefill sample + 3
    assert torch.equal(eng2.generate(5), cont)
    assert torch.equal(eng2.state["cache"]["k"], eng.state["cache"]["k"])


def test_restored_engine_keeps_rng_stream_position(params, tmp_path):
    """Admissions after a restore take RNG streams no slot had before."""
    eng = _cb(params)
    eng.submit(PROMPT_A)
    d = str(tmp_path / "grid")
    eng.snapshot(d)
    dst = _cb(params)
    dst.restore(d)
    before = dst.state["rngs"].tolist()
    slot = dst.submit(PROMPT_B)
    assert dst.state["rngs"][slot].tolist() not in before


def test_serving_state_names_dtypes_and_shapes_match_jax(params):
    for make in (_cb, _lockstep):
        want = jax.tree_util.tree_flatten_with_path(make(params, "jax").state)[0]
        got = flatten_with_names(make(params).state)
        assert [n for n, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
        for (name, t), (_, a) in zip(got, want):
            assert str(t.dtype).removeprefix("torch.") == str(a.dtype), name
            assert tuple(t.shape) == a.shape, name


# -- cross-restore -------------------------------------------------------------


def _midflight(eng):
    sa = eng.submit(PROMPT_A)
    [eng.step() for _ in range(2)]
    eng.submit(PROMPT_B)
    return sa


def test_jax_serving_snapshot_restores_into_the_port(params, tmp_path,
                                                     python_chunks):
    """A JAX continuous-batching snapshot, mid-flight: the port restores
    it and continues with the greedy tokens the JAX engine emits."""
    src = _cb(params, "jax")
    _midflight(src)
    d = str(tmp_path / "jax-grid")
    src.snapshot(d)
    want = [src.step() for _ in range(5)]
    dst = _cb(params)
    dst.restore(d)
    assert dst._submissions == 2
    assert [dst.step() for _ in range(5)] == want
    # The carried numpy state is the same state.
    carried = convert.serving_state_from_jax(jax.tree.map(np.asarray,
                                                          src.state))
    assert set(carried) == set(dst.state)


def test_port_serving_snapshot_restores_into_jax(params, tmp_path):
    src = _cb(params)
    _midflight(src)
    d = str(tmp_path / "port-grid")
    src.snapshot(d)
    want = [src.step() for _ in range(5)]
    dst = _cb(params, "jax")
    dst.restore(d)
    assert dst._submissions == 2
    assert [dst.step() for _ in range(5)] == want


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_lockstep_snapshot_cross_restores(params, tmp_path, python_chunks,
                                          direction):
    src_fw, dst_fw = direction.split("->")
    src = _lockstep(params, src_fw)
    src.prefill(_prompt())
    src.generate(2)
    d = str(tmp_path / "kv")
    src.snapshot(d)
    want = _tokens(src.generate(4))
    dst = _lockstep(params, dst_fw)
    assert dst.restore(d) == 3
    assert _tokens(dst.generate(4)) == want


def test_port_snapshot_keeps_uint32_rng_words(params, tmp_path):
    eng = _cb(params, seed=7)
    eng.submit(PROMPT_A)
    d = str(tmp_path / "grid")
    eng.snapshot(d)
    rec = {r["name"]: r for r in psnap.SnapshotManifest.load(d).arrays}
    assert rec["['rngs']"]["dtype"] == "uint32"
    assert rec["['rngs']"]["shape"] == [2, 2]
    flat = psnap.restore_snapshot(d)
    assert flat["['rngs']"].tolist() == [[7, 2], [7, 1]]  # slot 0 readmitted


def test_engines_given_no_device_raise_without_a_gpu(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.ContinuousBatchingEngine(PCFG, params[1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.InferenceEngine(PCFG, params[1])


def test_stream_keys_and_sample_seeds():
    assert serving.stream_key(3, 9) == [3, 9]
    with pytest.raises(ValueError, match="32 bits"):
        serving.stream_key(1 << 32, 0)
    seeds = {serving.sample_seed([0, s], n) for s in range(4) for n in range(4)}
    assert len(seeds) == 16 and all(0 <= x < 1 << 63 for x in seeds)
