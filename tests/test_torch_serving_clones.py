"""Post-copy serving clones in the port: twins of
``tests/test_serving_restore.py::TestPostcopyClone`` and the fan-out's
sibling isolation. A clone engine restores a continuous-batching snapshot
by post-copy (``restore_postcopy``, through ``fan_out_clones``), serves new
requests on the slots the source had free while its KV cache lands, and
after ``absorb_restored`` the migrated streams continue bit-identically,
greedy against the JAX engine's tokens and sampled (temperature 1.0)
against the port's own uninterrupted source. Weights go across by
``params_from_jax``; everything runs on the CPU in f32."""

from __future__ import annotations

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu.device import snapshot as jsnap
from grit_tpu.device.agentlet import ToggleClient
from grit_tpu.models import llama as jllama
from grit_tpu.models import serving as jserving
from grit_tpu_torch import convert
from grit_tpu_torch.device import snapshot as psnap
from grit_tpu_torch.models import llama
from grit_tpu_torch.models import serving
from grit_tpu_torch.serving import CloneLeg, ServingAgentlet, fan_out_clones

JCFG = jllama.LlamaConfig.tiny(dtype=jnp.float32)
CFG = llama.LlamaConfig.tiny(dtype=torch.float32)
PROMPT_A = [3, 17, 42, 7]
PROMPT_B = [9, 1, 13]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _hot_cut(monkeypatch):
    # The KV cache stays cold at this size, so the tail is real.
    monkeypatch.setenv("GRIT_RESTORE_POSTCOPY_HOT_MB", "0.001")


@pytest.fixture(scope="module")
def params():
    """(JAX params, the port's copy of them)."""
    jparams = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    return jparams, convert.params_from_jax(jax.tree.map(np.asarray, jparams))


def _engine(params, **kw) -> serving.ContinuousBatchingEngine:
    bcfg = dict(n_slots=4, max_seq_len=128)
    bcfg.update(kw)
    return serving.ContinuousBatchingEngine(
        CFG, params[1], serving.BatchingConfig(**bcfg), device="cpu")


def _drain(engine, slot: int, n: int) -> list[int]:
    toks: list[int] = []
    while len(toks) < n:
        emitted = engine.step()
        assert emitted, "the engine went idle early"
        if slot in emitted:
            toks.append(emitted[slot])
    return toks


def _snapshot(params, tmp_path, **kw):
    """A source with one stream in flight (slot ``sa``) snapshotted; the
    source's next three rounds are the uninterrupted continuation."""
    src = _engine(params, **kw)
    sa = src.submit(PROMPT_A)
    _drain(src, sa, 2)
    d = str(tmp_path / "snap")
    src.snapshot(d)
    return d, sa, [src.step() for _ in range(3)]


def _solo_greedy(params, prompt) -> int:
    eng = serving.InferenceEngine(CFG, params[1], serving.ServingConfig(
        batch_size=1, max_seq_len=128), device="cpu")
    return int(eng.prefill([prompt]).reshape(-1)[0])


class _HeldTail:
    """Hold every post-copy tail at its first pick until ``release`` is
    set: the clone then serves with its cold arrays outstanding by
    construction (measured, not raced against a clock)."""

    def __init__(self, monkeypatch) -> None:
        self.release = threading.Event()
        real = psnap.PostcopyRestore._pick_ready

        def held(handle, pending):
            assert self.release.wait(timeout=60.0)
            return real(handle, pending)

        monkeypatch.setattr(psnap.PostcopyRestore, "_pick_ready", held)

    def __enter__(self) -> "_HeldTail":
        return self

    def __exit__(self, *exc) -> None:
        self.release.set()  # a failed assertion must not strand the tail


class TestPostcopyClone:
    def test_clone_serves_new_request_before_cold_tail_lands(
            self, params, tmp_path, monkeypatch):
        d, sa, src_cont = _snapshot(params, tmp_path)
        clone = _engine(params)
        with _HeldTail(monkeypatch) as tail:
            (leg,) = fan_out_clones(d, [clone])
            assert leg.error is None and leg.hot_placed_s > 0
            # The source's in-flight slot is parked, not admissible.
            assert sa not in clone.free_slots()
            assert len(clone.free_slots()) == 3
            tok = leg.serve_first(PROMPT_B)
            assert leg.served_before_tail
            assert tok == _solo_greedy(params, PROMPT_B)
            clone.submit([5, 6])
            clone.submit([7, 8])
            with pytest.raises(RuntimeError, match="free slot"):
                clone.submit([2, 3])  # only the parked slot is left
            tail.release.set()
        leg.finish()
        assert clone.resumed_all and leg.handle.tail_s > 0
        got = []
        while len(got) < len(src_cont):
            emitted = clone.step()
            if sa in emitted:
                got.append({sa: emitted[sa]})
        assert got == [{sa: e[sa]} for e in src_cont]

    def test_absorb_runs_automatically_at_batch_boundary(self, params,
                                                         tmp_path):
        d, sa, src_cont = _snapshot(params, tmp_path)
        clone = _engine(params)
        handle = clone.restore_postcopy(d)
        handle.wait()
        deadline = time.monotonic() + 10
        while not handle.done:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        emitted = clone.step()
        assert clone.resumed_all
        assert emitted == src_cont[0]

    def test_snapshot_of_mid_restore_clone_absorbs_first(self, params,
                                                         tmp_path):
        d, sa, _ = _snapshot(params, tmp_path)
        clone = _engine(params)
        clone.restore_postcopy(d)
        st = clone.snapshot_state()  # what a ServingAgentlet's dump reads
        assert clone.resumed_all and bool(st["active"][sa])
        d2 = str(tmp_path / "resnap")
        clone.snapshot(d2)  # iterative migration: must not tear
        dst = _engine(params)
        dst.restore(d2)
        assert bool(dst.state["active"][sa])

    def test_drain_mode_on_mid_restore_clone_drains_migrated_streams(
            self, params, tmp_path):
        """Re-migrating a clone whose tail is still landing, under drain
        mode: the merge settles first, then the migrated stream drains
        too, and the snapshot holds an empty grid."""
        d, sa, _ = _snapshot(params, tmp_path, max_seq_len=16)
        clone = _engine(params, max_seq_len=16)
        clone.restore_postcopy(d)
        adapter = ServingAgentlet(clone, drain_mode="drain",
                                  path=str(tmp_path / "clone.sock"))
        d2 = str(tmp_path / "resnap")
        with adapter, ToggleClient(0, path=adapter.agentlet.path) as client:
            box: dict = {}

            def quiesce():
                try:
                    box["step"] = client.quiesce()
                except RuntimeError as exc:
                    box["err"] = exc

            t = threading.Thread(target=quiesce, daemon=True)
            t.start()
            deadline = time.monotonic() + 10
            while not adapter.draining:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            boundary = threading.Thread(target=adapter.batch_boundary,
                                        daemon=True)
            boundary.start()
            t.join(timeout=60)
            assert "step" in box, box.get("err")
            assert clone.resumed_all
            assert not clone.state["active"].any()
            assert adapter.last_drain["drained_tokens"] > 0
            assert client.dump(d2)["ok"]
            client.resume()
            boundary.join(timeout=10)
            assert not boundary.is_alive()
        dst = _engine(params, max_seq_len=16)
        dst.restore(d2)
        assert not dst.state["active"].any()

    def test_zero_hot_cut_degrades_to_blocking_restore(self, params,
                                                       tmp_path, monkeypatch):
        d, sa, src_cont = _snapshot(params, tmp_path)
        monkeypatch.setenv("GRIT_RESTORE_POSTCOPY_HOT_MB", "0")
        clone = _engine(params)
        clone.restore_postcopy(d)
        assert clone.resumed_all  # nothing parked
        assert clone.step() == src_cont[0]

    @pytest.mark.parametrize("hot_mb,parks", [("0", False), ("0.001", True)],
                             ids=["bookkeeping-cold", "bookkeeping-hot"])
    @pytest.mark.parametrize("tail", ["held", "landed"])
    def test_park_or_block_does_not_race_the_tail(self, params, tmp_path,
                                                  monkeypatch, hot_mb, parks,
                                                  tail):
        """Whether a clone parks depends on the hot cut alone: the same
        decision when the tail is held before the engine reads the handle
        as when the tail has placed every array first."""
        d, sa, src_cont = _snapshot(params, tmp_path)
        monkeypatch.setenv("GRIT_RESTORE_POSTCOPY_HOT_MB", hot_mb)
        real = serving.restore_snapshot_postcopy

        def tail_first(*a, **kw):
            handle = real(*a, **kw)
            handle._thread.join(timeout=60.0)
            assert handle.done
            return handle

        clone = _engine(params)
        if tail == "held":
            with _HeldTail(monkeypatch) as held:
                # The tail waits at its first pick until the engine has
                # read the handle.
                read = psnap.PostcopyRestore.hot_leaves

                def read_then_release(handle):
                    out = read(handle)
                    assert handle.placed == len(out)  # the tail placed none
                    held.release.set()
                    return out

                monkeypatch.setattr(psnap.PostcopyRestore, "hot_leaves",
                                    read_then_release)
                handle = clone.restore_postcopy(d)
                monkeypatch.setattr(psnap.PostcopyRestore, "hot_leaves", read)
        else:
            monkeypatch.setattr(serving, "restore_snapshot_postcopy",
                                tail_first)
            handle = clone.restore_postcopy(d)
        assert (not clone.resumed_all) == parks
        hot = set(handle.hot_leaves())
        assert ("['active']" in hot) == parks
        assert "['cache']['k']" not in hot
        clone.absorb_restored()
        assert clone.step() == src_cont[0]

    def test_hot_leaves_are_the_hot_set_while_placed_leaves_grow(
            self, params, tmp_path, monkeypatch):
        d, _sa, _cont = _snapshot(params, tmp_path)
        eng = _engine(params)
        with _HeldTail(monkeypatch) as held:
            handle = psnap.restore_snapshot_postcopy(
                d, like=eng._fresh_state("meta"), device="cpu")
            hot = set(handle.hot_leaves())
            assert hot and set(handle.placed_leaves()) == hot
            held.release.set()
            handle.wait()
        assert set(handle.hot_leaves()) == hot
        assert set(handle.placed_leaves()) > hot

    def test_restore_clears_a_pending_clone(self, params, tmp_path):
        d, sa, src_cont = _snapshot(params, tmp_path)
        clone = _engine(params)
        handle = clone.restore_postcopy(d)
        clone.restore(d)
        assert clone.resumed_all and clone.free_slots() == [
            i for i in range(4) if i != sa]
        assert clone.step() == src_cont[0]
        handle.wait()


# -- the fan-out ---------------------------------------------------------------------


@pytest.mark.parametrize("parallel", [True, False], ids=["parallel", "serial"])
def test_fan_out_isolates_a_failing_clone(params, tmp_path, parallel):
    """A clone whose restore raises (its grid does not match the snapshot)
    carries the error on its own leg; its sibling serves and continues."""
    d, sa, src_cont = _snapshot(params, tmp_path)
    good, bad = _engine(params), _engine(params, n_slots=3)
    legs = fan_out_clones(d, [good, bad], parallel=parallel)
    assert [leg.ordinal for leg in legs] == [0, 1]
    assert legs[0].error is None and isinstance(legs[0], CloneLeg)
    assert isinstance(legs[1].error, ValueError) and legs[1].handle is None
    legs[0].finish()
    assert good.step() == src_cont[0]


def test_sampled_clones_continue_the_source_and_agree(params, tmp_path,
                                                     monkeypatch):
    """Temperature 1.0: two clones each serve a new request on the slot the
    source freed before its snapshot; after the absorb, every migrated
    stream continues with the source's tokens, and the new request's
    tokens are the ones the source gives the same request in that slot."""
    src = _engine(params, temperature=1.0)
    slots = [src.submit(p) for p in (PROMPT_A, PROMPT_B, [5, 6, 7])]
    _drain(src, slots[0], 3)
    src.release(slots[1])  # a request completes; its slot is free
    d = str(tmp_path / "snap")
    src.snapshot(d)
    new = src.submit([11, 12, 13, 14])
    assert new == slots[1]
    want: dict = {s: [] for s in (slots[0], slots[2], new)}
    for _ in range(4):
        for s, tok in src.step().items():
            want[s].append(tok)
    clones = [_engine(params, temperature=1.0) for _ in range(2)]
    got = [{s: [] for s in want} for _ in clones]
    with _HeldTail(monkeypatch) as tail:
        legs = fan_out_clones(d, clones)
        for leg, toks in zip(legs, got):
            assert leg.error is None
            assert leg.engine.free_slots() == [new, 3]
            toks[new].append(leg.serve_first([11, 12, 13, 14]))
            assert leg.served_before_tail
        tail.release.set()
    for leg, toks in zip(legs, got):
        leg.finish()
        while min(len(v) for v in toks.values()) < 4:
            for s, tok in leg.engine.step().items():
                toks[s].append(tok)
        assert {s: v[:4] for s, v in toks.items()} == want


def test_jax_snapshot_fans_out_into_port_clones(params, tmp_path, monkeypatch):
    """A JAX engine's mid-flight snapshot (the JAX writer on its crc32
    plane) fanned out into port clones: greedy, the migrated stream goes on
    with the JAX source's tokens."""
    monkeypatch.setattr(jsnap, "_chunk_writer",
                        lambda path, durable: jsnap._PyChunkWriter(path, durable))
    src = jserving.ContinuousBatchingEngine(
        JCFG, params[0], jserving.BatchingConfig(n_slots=4, max_seq_len=128))
    sa = src.submit(PROMPT_A)
    _drain(src, sa, 2)
    d = str(tmp_path / "jax-snap")
    src.snapshot(d)
    want = [src.step() for _ in range(3)]
    clones = [_engine(params), _engine(params)]
    for leg in fan_out_clones(d, clones):
        assert leg.error is None
        leg.finish()
        assert [leg.engine.step() for _ in range(3)] == want
