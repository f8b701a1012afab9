"""The port's serving agentlet driven by the reference's ``ToggleClient``
(the request-drain matrix of ``tests/test_serving_restore.py``: serialize,
drain, drain timeout, admission while draining, an unknown mode), and the
agentlet hooks the serving adapter stands on: ``pre_park_fn``,
``meta_fn``, ``quiesce_state_fn``, ``path`` and ``quiesce_pending``."""

from __future__ import annotations

import threading
import time
from collections import defaultdict

import jax
import numpy as np
import pytest
import torch

from grit_tpu.device.agentlet import ToggleClient
from grit_tpu.models import llama as jllama
from grit_tpu_torch import convert
from grit_tpu_torch.device.agentlet import Agentlet
from grit_tpu_torch.device.snapshot import SnapshotManifest
from grit_tpu_torch.models import llama
from grit_tpu_torch.models.serving import (
    BatchingConfig,
    ContinuousBatchingEngine,
    InferenceEngine,
    ServingConfig,
)
from grit_tpu_torch.serving import (
    ServingAgentlet,
    ServingDrainTimeout,
    ServingDraining,
)

pytestmark = pytest.mark.race  # concurrency suite, as its reference is

CFG = llama.LlamaConfig.tiny(dtype=torch.float32)
PROMPT_A = [3, 17, 42, 7]
PROMPT_B = [9, 1, 13]


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
    """The JAX tiny llama's weights, carried into the port."""
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    return convert.params_from_jax(jax.tree.map(np.asarray, jparams))


def _engine(params, bcfg=None):
    return ContinuousBatchingEngine(
        CFG, params, bcfg or BatchingConfig(n_slots=3, max_seq_len=128),
        device="cpu")


def solo_greedy(params, prompt, n_tokens, max_seq_len=128):
    eng = InferenceEngine(CFG, params, ServingConfig(
        batch_size=1, max_seq_len=max_seq_len), device="cpu")
    toks = eng.prefill([prompt]).reshape(-1).tolist()
    if n_tokens > 1:
        toks += eng.generate(n_tokens - 1).reshape(-1).tolist()
    return toks[:n_tokens]


def drain_slot(engine, slot, n_tokens):
    toks = []
    while len(toks) < n_tokens:
        emitted = engine.step()
        if slot in emitted:
            toks.append(emitted[slot])
        if not emitted:
            raise AssertionError("engine went idle early")
    return toks


class ServeLoop:
    """A serving loop thread: step → collect tokens → batch_boundary,
    paced so a tiny model does not run its streams to the cache limit
    before a test can snapshot a live one."""

    def __init__(self, adapter: ServingAgentlet, pace_s: float = 0.01) -> None:
        self.adapter = adapter
        self.pace_s = pace_s
        self.tokens: dict[int, list[int]] = defaultdict(list)
        self.error: BaseException | None = None
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                for slot, tok in self.adapter.step().items():
                    self.tokens[slot].append(tok)
                self.adapter.batch_boundary()
                time.sleep(self.pace_s)
        except BaseException as exc:  # noqa: BLE001 — surfaced by tests
            self.error = exc

    def start(self) -> "ServeLoop":
        self.thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


def _wait(pred, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting: {msg}"
        time.sleep(0.01)


# -- request drain matrix ------------------------------------------------------


def _adapter(params, tmp_path, bcfg=None, **kw):
    return ServingAgentlet(_engine(params, bcfg),
                           path=str(tmp_path / "serve.sock"), **kw)


def test_serialize_parks_with_inflight_slots_and_restores_bit_identically(
        params, tmp_path):
    adapter = _adapter(params, tmp_path, drain_mode="serialize")
    d = str(tmp_path / "snap")
    with adapter:
        sa = adapter.submit(PROMPT_A)
        pre = drain_slot(adapter.engine, sa, 2)
        loop = ServeLoop(adapter).start()
        with ToggleClient(0, path=adapter.agentlet.path) as client:
            rounds = client.quiesce()
            assert adapter.agentlet.paused
            n = len(pre) + len(loop.tokens[sa])
            assert rounds == len(loop.tokens[sa])  # one boundary a round
            # The in-flight slot rode into the park serialized.
            assert bool(adapter.engine.state["active"][sa])
            assert adapter.last_drain["mode"] == "serialize"
            assert adapter.last_drain["slots"] == 1
            assert client.dump(d)["ok"]
            client.resume()
        loop.stop()
        assert loop.error is None
    meta = SnapshotManifest.load(d).meta
    assert meta["step"] == rounds and meta["serving"] is True
    assert meta["submissions"] == 1 and meta["active_slots"] == 1
    dst = _engine(params)
    dst.restore(d)
    assert dst._submissions == 1
    assert drain_slot(dst, sa, 4) == solo_greedy(params, PROMPT_A, n + 4)[n:]


def test_drain_mode_completes_inflight_before_park(params, tmp_path):
    """max_seq_len 48 bounds the stream: the drain's run to completion
    ends at the cache limit, and every drained token reaches emit_fn."""
    drained: list[tuple[int, int]] = []
    adapter = _adapter(params, tmp_path, drain_mode="drain",
                       emit_fn=lambda s, t: drained.append((s, t)),
                       bcfg=BatchingConfig(n_slots=2, max_seq_len=48))
    with adapter:
        sa = adapter.submit(PROMPT_A)
        pre = drain_slot(adapter.engine, sa, 2)
        loop = ServeLoop(adapter).start()
        with ToggleClient(0, path=adapter.agentlet.path) as client:
            client.quiesce()
            assert adapter.agentlet.paused
            assert not adapter.engine.state["active"].any()
            assert adapter.last_drain["mode"] == "drain"
            assert adapter.last_drain["drained_tokens"] > 0
            client.resume()
        loop.stop()
        assert loop.error is None
    all_toks = pre + loop.tokens[sa] + [t for s, t in drained if s == sa]
    assert len(all_toks) == 48 - len(PROMPT_A) + 1
    assert all_toks == solo_greedy(params, PROMPT_A, len(all_toks),
                                   max_seq_len=48)


def test_drain_timeout_fails_loudly(params, tmp_path):
    # Zero budget: the first deadline check after a step raises; the
    # drain never silently degrades to serialization.
    adapter = _adapter(params, tmp_path, drain_mode="drain",
                       drain_timeout_s=0.0)
    with adapter:
        adapter.submit(PROMPT_A)
        loop = ServeLoop(adapter).start()
        with ToggleClient(0, path=adapter.agentlet.path) as client:
            with pytest.raises(RuntimeError, match="quiesce timeout"):
                client.request("quiesce", timeout=1.0)
        _wait(lambda: loop.error is not None, msg="loop error")
        assert isinstance(loop.error, ServingDrainTimeout)
        assert not adapter.agentlet.paused
        assert adapter.last_drain["ok"] is False
        loop.stop()


def test_submit_refused_while_draining(params, tmp_path):
    adapter = _adapter(params, tmp_path, drain_mode="serialize")
    with adapter:
        adapter.submit(PROMPT_A)
        with ToggleClient(0, path=adapter.agentlet.path) as client:
            box: dict = {}

            def quiesce():
                try:
                    box["step"] = client.quiesce()
                except RuntimeError as exc:
                    box["err"] = exc

            t = threading.Thread(target=quiesce, daemon=True)
            t.start()
            _wait(lambda: adapter.draining, msg="quiesce pending")
            with pytest.raises(ServingDraining, match="draining"):
                adapter.submit(PROMPT_B)
            # Reach the boundary on a serving thread (the park holds it
            # until resume): quiesce returns; admission stays closed while
            # parked and reopens after resume.
            boundary = threading.Thread(target=adapter.batch_boundary,
                                        daemon=True)
            boundary.start()
            t.join(timeout=10)
            assert not t.is_alive() and "step" in box
            assert adapter.agentlet.paused
            with pytest.raises(ServingDraining, match="draining"):
                adapter.submit(PROMPT_B)
            client.resume()
            boundary.join(timeout=10)
            assert not boundary.is_alive()
        _wait(lambda: not adapter.draining, msg="resume")
        assert adapter.submit(PROMPT_B) >= 0


def test_unknown_drain_mode_degrades_to_serialize(params, tmp_path,
                                                  monkeypatch):
    assert _adapter(params, tmp_path, drain_mode="yolo").drain_mode == \
        "serialize"
    monkeypatch.setenv("GRIT_SERVE_DRAIN_MODE", "drain")
    monkeypatch.setenv("GRIT_SERVE_DRAIN_TIMEOUT_S", "2.5")
    adapter = _adapter(params, tmp_path)
    assert (adapter.drain_mode, adapter.drain_timeout_s) == ("drain", 2.5)


# -- the agentlet hooks --------------------------------------------------------


class _HookLoop:
    """A stand-in loop offering a checkpoint point every few ms, with
    recording hooks on its agentlet."""

    def __init__(self, tmp_path, pre_park=None) -> None:
        self.state = {"w": torch.zeros(3)}
        self.calls: dict[str, int] = defaultdict(int)
        self.parked_at_pre_park: list[bool] = []
        self.step = 0

        def state_fn():
            self.calls["state_fn"] += 1
            return self.state

        def quiesce_state_fn():
            self.calls["quiesce_state_fn"] += 1
            return self.state

        def pre_park_fn():
            self.calls["pre_park_fn"] += 1
            self.parked_at_pre_park.append(self.agentlet.paused)
            if pre_park is not None:
                pre_park()

        self.agentlet = Agentlet(
            state_fn, step_fn=lambda: self.step,
            meta_fn=lambda: {"engine": "stand-in", "rounds": self.step},
            path=str(tmp_path / "hooks.sock"),
            quiesce_state_fn=quiesce_state_fn, pre_park_fn=pre_park_fn).start()
        self.error: BaseException | None = None
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.step += 1
            try:
                self.agentlet.checkpoint_point()
            except RuntimeError as exc:
                self.error = exc
            time.sleep(0.002)

    def close(self) -> None:
        self._stop.set()
        self.agentlet.stop()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


def test_pre_park_runs_once_per_quiesce_before_the_park_and_meta_rides(
        tmp_path):
    lp = _HookLoop(tmp_path)
    try:
        assert lp.agentlet.path == str(tmp_path / "hooks.sock")
        assert not lp.agentlet.quiesce_pending
        with ToggleClient(0, path=lp.agentlet.path) as c:
            step = c.quiesce()
            assert lp.calls["pre_park_fn"] == 1
            assert lp.parked_at_pre_park == [False]
            # The park drained the raw state, not the dump view.
            assert lp.calls["quiesce_state_fn"] == 1
            assert lp.calls["state_fn"] == 0
            d = str(tmp_path / "snap")
            c.dump(d)
            assert lp.calls["state_fn"] == 1
            assert SnapshotManifest.load(d).meta == {
                "step": step, "engine": "stand-in", "rounds": step}
            time.sleep(0.05)  # parked: no boundary reruns the hook
            assert lp.calls["pre_park_fn"] == 1
            c.resume()
            _wait(lambda: lp.step > step + 3, msg="loop resumed")
            assert lp.calls["pre_park_fn"] == 1
            c.quiesce()
            assert lp.calls["pre_park_fn"] == 2
            c.resume()
    finally:
        lp.close()


def test_quiesce_pending_reads_the_request_and_a_failing_pre_park_aborts(
        tmp_path):
    fail = threading.Event()

    def pre_park():
        if fail.is_set():
            raise RuntimeError("drain refused")

    lp = _HookLoop(tmp_path, pre_park=pre_park)
    try:
        fail.set()
        with ToggleClient(0, path=lp.agentlet.path) as c:
            with pytest.raises(RuntimeError, match="quiesce timeout"):
                c.request("quiesce", timeout=0.3)
            # Every boundary retried the park and aborted it: the request
            # is still pending, the loop not parked.
            _wait(lambda: lp.calls["pre_park_fn"] >= 2, msg="retries")
            assert lp.agentlet.quiesce_pending and not lp.agentlet.paused
            assert isinstance(lp.error, RuntimeError)
            assert lp.calls["quiesce_state_fn"] == 0
            fail.clear()
            _wait(lambda: lp.agentlet.paused, msg="park")
            assert not lp.agentlet.quiesce_pending
            c.resume()
            _wait(lambda: not lp.agentlet.paused, msg="resume")
            assert not lp.agentlet.quiesce_pending
    finally:
        lp.close()
