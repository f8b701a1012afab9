"""The gang's quiesce barrier in the port: the twins of
``tests/test_slice.py``'s ``TestRendezvous``, ``TestSliceQuiesceGate`` and
``TestAgentletSliceGate`` on ``grit_tpu_torch``, driven by the port's and
the JAX package's ``ToggleClient``; the latched barrier error answering
within the barrier timeout; and the gate's ``lockstep`` collective parking
ranks that share collectives at one step however their requests are
staggered."""

from __future__ import annotations

import threading
import time

import pytest
import torch

from grit_tpu.device.agentlet import ToggleClient as RefClient
from grit_tpu_torch.device.agentlet import Agentlet, ToggleClient
from grit_tpu_torch.parallel.coordination import (
    BarrierTimeout,
    FileRendezvous,
    LocalRendezvous,
    SliceCoordinator,
    SliceQuiesceGate,
)

CLIENTS = {"port": ToggleClient, "jax": RefClient}


# -- rendezvous transports ----------------------------------------------------


class TestRendezvous:
    def test_local_barrier_timeout_is_loud(self):
        with pytest.raises(BarrierTimeout):
            LocalRendezvous(2).barrier("solo", timeout=0.2)

    def test_file_allgather_roundtrip(self, tmp_path):
        world = 3
        rdvs = [FileRendezvous(str(tmp_path), k, world) for k in range(world)]
        out: list = [None] * world

        def go(k):
            out[k] = rdvs[k].allgather("cut", 10 + k, k, timeout=10)

        threads = [threading.Thread(target=go, args=(k,)) for k in range(world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(v == [10, 11, 12] for v in out)

    def test_file_barrier_timeout_counts_arrivals(self, tmp_path):
        r = FileRendezvous(str(tmp_path), 0, 2)
        with pytest.raises(BarrierTimeout, match="1/2"):
            r.barrier("partial", timeout=0.3)

    def test_file_barrier_ignores_tmp_twins(self, tmp_path):
        # A writer mid-rename must not count as an arrival.
        r = FileRendezvous(str(tmp_path), 0, 2)
        d = tmp_path / "b"
        d.mkdir()
        (d / "arrive-0001.tmp-99").write_text("torn")
        with pytest.raises(BarrierTimeout):
            r.barrier("b", timeout=0.3)


# -- the quiesce gate ---------------------------------------------------------


def _run_hosts_to_park(gates, start_steps, timeout=10.0):
    """Each host's loop steps until its gate admits the park; the step each
    host parked at (None: never)."""
    parked = [None] * len(gates)

    def loop(k):
        step = start_steps[k]
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if gates[k].ready_to_park(step):
                parked[k] = step
                return
            if gates[k].failed is not None:
                return
            step += 1

    threads = [threading.Thread(target=loop, args=(k,))
               for k in range(len(gates))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return parked


class TestSliceQuiesceGate:
    def _gates(self, world, timeout_s=5.0):
        rdv = LocalRendezvous(world)
        return [SliceQuiesceGate(
            SliceCoordinator(rdv, process_index=k, process_count=world),
            timeout_s=timeout_s) for k in range(world)]

    def test_all_hosts_park_at_max_cut(self):
        gates = self._gates(3)
        assert _run_hosts_to_park(gates, [3, 7, 5]) == [7, 7, 7]
        assert all(g.cut == 7 for g in gates)
        assert all(g.wait_s is not None and g.wait_s >= 0 for g in gates)

    def test_straggler_timeout_latches_failed_never_parks(self):
        gates = self._gates(2, timeout_s=0.3)
        assert _run_hosts_to_park(gates[:1], [4], timeout=3.0) == [None]
        assert gates[0].failed is not None
        assert gates[0].ready_to_park(100) is False  # latched

    def test_barrier_fault_latches_failed(self, monkeypatch):
        """The port has no fault registry yet: a rendezvous whose barrier
        raises takes the reference's ``slice.barrier`` fault path: the
        gates latch, no loop parks."""
        gates = self._gates(2)
        hits = []

        def boom(name, timeout=None):
            hits.append(name)
            raise RuntimeError("injected fault at slice.barrier")

        monkeypatch.setattr(gates[0].coordinator.rendezvous, "barrier", boom)
        assert _run_hosts_to_park(gates, [1, 1], timeout=3.0) == [None, None]
        assert all("injected fault" in g.failed for g in gates)
        assert len(hits) >= 2

    def test_nonce_rescopes_and_clears_latched_failure(self):
        gates = self._gates(2, timeout_s=0.2)
        parked = _run_hosts_to_park(gates[:1], [2], timeout=2.0)
        assert parked == [None] and gates[0].failed is not None
        for g in gates:
            g.request(nonce="1")
        assert gates[0].failed is None
        assert _run_hosts_to_park(gates, [2, 6]) == [6, 6]

    def test_reset_clears_cut(self):
        gates = self._gates(2)
        assert _run_hosts_to_park(gates, [1, 2]) == [2, 2]
        gates[0].reset()
        assert gates[0].cut is None and gates[0].failed is None

    def test_second_round_same_nonce_never_reads_stale_arrivals(
            self, tmp_path):
        world = 2
        rdvs = [FileRendezvous(str(tmp_path), k, world) for k in range(world)]
        gates = [SliceQuiesceGate(
            SliceCoordinator(rdvs[k], process_index=k, process_count=world),
            timeout_s=5.0) for k in range(world)]
        assert _run_hosts_to_park(gates, [1, 3]) == [3, 3]
        for g in gates:
            g.reset()
        assert _run_hosts_to_park(gates, [10, 14]) == [14, 14]
        assert all(g.cut == 14 for g in gates)


# -- the agentlet -------------------------------------------------------------


class TestAgentletSliceGate:
    @pytest.mark.parametrize("client", sorted(CLIENTS))
    def test_two_agentlets_park_at_same_agreed_step(self, tmp_path, client):
        """Two loops whose agentlets carry gates over one rendezvous; two
        ``quiesce(slice_cut=True)`` requests, from the port's client or the
        JAX package's, park both at the same max cut."""
        Client = CLIENTS[client]
        world = 2
        rdv = LocalRendezvous(world)
        steps = [5, 9]
        running = [True, True]
        agentlets = []
        for k in range(world):
            gate = SliceQuiesceGate(
                SliceCoordinator(rdv, process_index=k, process_count=world),
                timeout_s=10.0)
            agentlets.append(Agentlet(
                lambda k=k: {"s": torch.tensor(steps[k])},
                step_fn=lambda k=k: steps[k],
                path=str(tmp_path / f"a{k}.sock"), slice_gate=gate).start())

        def loop(k):
            while running[k]:
                steps[k] += 1
                agentlets[k].checkpoint_point()
                time.sleep(0.002 * (k + 1))

        loops = [threading.Thread(target=loop, args=(k,), daemon=True)
                 for k in range(world)]
        for t in loops:
            t.start()
        try:
            cuts = [None, None]

            def quiesce(k):
                with Client(0, path=str(tmp_path / f"a{k}.sock"),
                            timeout=30) as c:
                    cuts[k] = c.quiesce(slice_cut=True, slice_nonce="0")

            qs = [threading.Thread(target=quiesce, args=(k,))
                  for k in range(world)]
            for t in qs:
                t.start()
            for t in qs:
                t.join(timeout=30)
            assert cuts[0] is not None and cuts[0] == cuts[1]
            assert all(a.paused for a in agentlets)
            assert steps[0] == steps[1] == cuts[0]
            for k in range(world):
                with Client(0, path=str(tmp_path / f"a{k}.sock"),
                            timeout=10) as c:
                    assert c.status()["slice"]["cut"] == cuts[0]
                    c.resume()
                    assert c.status()["slice"] == {"cut": None,
                                                   "failed": None}
            time.sleep(0.05)
            assert not any(a.paused for a in agentlets)
        finally:
            running[0] = running[1] = False
            for a in agentlets:
                a.stop()

    @pytest.mark.parametrize("client", sorted(CLIENTS))
    def test_plain_quiesce_ignores_gate(self, tmp_path, client):
        """A quiesce without ``slice_cut`` parks at the next boundary and
        never consults the gate."""
        rdv = LocalRendezvous(2)  # nobody else will ever arrive
        gate = SliceQuiesceGate(
            SliceCoordinator(rdv, process_index=0, process_count=2),
            timeout_s=30.0)
        steps = [0]
        a = Agentlet(lambda: {"s": torch.tensor(steps[0])},
                     step_fn=lambda: steps[0],
                     path=str(tmp_path / "a.sock"), slice_gate=gate).start()
        running = [True]

        def loop():
            while running[0]:
                steps[0] += 1
                a.checkpoint_point()
                time.sleep(0.001)

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        try:
            with CLIENTS[client](0, path=str(tmp_path / "a.sock"),
                                 timeout=10) as c:
                c.quiesce()
                assert a.paused
                assert gate.cut is None
                c.resume()
        finally:
            running[0] = False
            a.stop()

    @pytest.mark.parametrize("client", sorted(CLIENTS))
    def test_failed_barrier_answers_within_its_timeout(self, tmp_path,
                                                        client):
        """A slice quiesce whose peer never arrives: the gate latches, the
        quiesce answers the barrier error within the barrier timeout plus
        2 s (not the 300 s quiesce timeout), the request is cleared and
        the loop never parks; resume clears the latch."""
        timeout = 1.0
        gate = SliceQuiesceGate(
            SliceCoordinator(LocalRendezvous(2), process_index=0,
                             process_count=2), timeout_s=timeout)
        steps = [0]
        a = Agentlet(lambda: {"s": torch.tensor(steps[0])},
                     step_fn=lambda: steps[0],
                     path=str(tmp_path / "a.sock"), slice_gate=gate).start()
        running = [True]

        def loop():
            while running[0]:
                steps[0] += 1
                a.checkpoint_point()
                time.sleep(0.002)

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        try:
            with CLIENTS[client](0, path=str(tmp_path / "a.sock"),
                                 timeout=30) as c:
                t0 = time.monotonic()
                with pytest.raises(RuntimeError,
                                   match="slice quiesce barrier failed: "
                                         "BarrierTimeout"):
                    c.quiesce(slice_cut=True, slice_nonce="0")
                assert time.monotonic() - t0 < timeout + 2.0
                assert not a.paused and not a.quiesce_pending
                before = steps[0]
                time.sleep(0.1)
                assert steps[0] > before  # still training
                assert c.status()["slice"]["failed"].startswith(
                    "BarrierTimeout")
                c.resume()
                assert c.status()["slice"]["failed"] is None
        finally:
            running[0] = False
            a.stop()

    def test_request_records_the_step_it_arrived_at(self, tmp_path):
        gate = SliceQuiesceGate(
            SliceCoordinator(LocalRendezvous(1), process_index=0,
                             process_count=1), timeout_s=5.0)
        steps = [0]
        a = Agentlet(lambda: {"s": torch.tensor(steps[0])},
                     step_fn=lambda: steps[0],
                     path=str(tmp_path / "a.sock"), slice_gate=gate).start()
        running = [True]

        def loop():
            while running[0]:
                steps[0] += 1
                a.checkpoint_point()
                time.sleep(0.002)

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        try:
            with ToggleClient(0, path=a.path, timeout=10) as c:
                cut = c.quiesce(slice_cut=True, slice_nonce="0")
                assert gate.request_step is not None
                assert gate.request_step <= cut == gate.cut == steps[0]
                c.resume()
        finally:
            running[0] = False
            a.stop()


# -- ranks that share collectives ------------------------------------------------


class _ThreadCollectives:
    """Collectives of N threads: ``step()`` is a step's collective (every
    rank waits for every other) and ``any_fn(k)`` is rank k's ``lockstep``
    collective. Bounded, so a wedged test fails instead of hanging."""

    def __init__(self, n: int, timeout: float = 30.0) -> None:
        self._step = threading.Barrier(n, timeout=timeout)
        self._any = threading.Barrier(n, timeout=timeout)
        self._flags = [False] * n

    def step(self) -> None:
        self._step.wait()

    def any_fn(self, k: int):
        def any_pending(pending: bool) -> bool:
            self._flags[k] = pending
            self._any.wait()
            out = any(self._flags)
            self._any.wait()
            return out
        return any_pending


class _LockstepRanks:
    """N training loops (threads) whose every step is a collective, each
    with an agentlet whose gate has the ``lockstep`` collective."""

    def __init__(self, tmp_path, n: int, timeout_s: float) -> None:
        self.n = n
        self.coll = _ThreadCollectives(n)
        rdv = LocalRendezvous(n)
        self.steps = [0] * n
        self.gates = [SliceQuiesceGate(
            SliceCoordinator(rdv, process_index=k, process_count=n),
            timeout_s=timeout_s, lockstep=self.coll.any_fn(k))
            for k in range(n)]
        self.agentlets = [Agentlet(
            lambda k=k: {"s": torch.tensor(self.steps[k])},
            step_fn=lambda k=k: self.steps[k],
            path=str(tmp_path / f"r{k}.sock"), slice_gate=self.gates[k]
        ).start() for k in range(n)]
        self.running = True
        self.errors: list = []
        self.threads = [threading.Thread(target=self._loop, args=(k,),
                                         daemon=True) for k in range(n)]
        for t in self.threads:
            t.start()

    def _loop(self, k: int) -> None:
        try:
            while self.running:
                self.coll.step()
                self.steps[k] += 1
                time.sleep(0.002)
                self.agentlets[k].checkpoint_point()
        except threading.BrokenBarrierError as exc:
            if self.running:
                self.errors.append((k, exc))

    def close(self) -> None:
        self.running = False
        for a in self.agentlets:
            a.stop()
        self.coll._step.abort()
        self.coll._any.abort()
        for t in self.threads:
            t.join(timeout=10)


@pytest.mark.parametrize("stagger_s", [0.0, 0.05, 0.3])
def test_lockstep_ranks_park_at_one_step_with_staggered_requests(
        tmp_path, stagger_s):
    """Ranks whose every step is a collective: slice quiesces landing one
    after another (a rank's request up to many steps after its peer's)
    park every rank at one step, the cut."""
    ranks = _LockstepRanks(tmp_path, 3, timeout_s=20.0)
    try:
        while min(ranks.steps) < 5:
            time.sleep(0.01)
        cuts: list = [None] * 3

        def quiesce(k):
            time.sleep(stagger_s * k)
            with ToggleClient(0, path=ranks.agentlets[k].path,
                              timeout=60) as c:
                cuts[k] = c.quiesce(slice_cut=True, slice_nonce="0")

        qs = [threading.Thread(target=quiesce, args=(k,)) for k in range(3)]
        for t in qs:
            t.start()
        for t in qs:
            t.join(timeout=60)
        assert not ranks.errors
        assert cuts[0] is not None and len(set(cuts)) == 1
        assert all(a.paused for a in ranks.agentlets)
        assert ranks.steps == [cuts[0]] * 3
        assert [g.cut for g in ranks.gates] == [cuts[0]] * 3
        for a in ranks.agentlets:
            with ToggleClient(0, path=a.path, timeout=10) as c:
                c.resume()
        deadline = time.monotonic() + 10
        while min(ranks.steps) < cuts[0] + 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert min(ranks.steps) >= cuts[0] + 3 and not ranks.errors
    finally:
        ranks.close()


def test_lockstep_rank_without_its_request_never_parks(tmp_path):
    """One rank's request never arrives: the peers' quiesces answer the
    barrier error within the timeout plus 2 s, the rank holding for its
    request latches too, no rank parks and every rank trains on."""
    timeout = 1.5
    ranks = _LockstepRanks(tmp_path, 3, timeout_s=timeout)
    try:
        while min(ranks.steps) < 3:
            time.sleep(0.01)
        answers: list = [None] * 2

        def quiesce(k):
            t0 = time.monotonic()
            with ToggleClient(0, path=ranks.agentlets[k].path,
                              timeout=60) as c:
                try:
                    c.quiesce(slice_cut=True, slice_nonce="0")
                    answers[k] = ("parked", time.monotonic() - t0)
                except RuntimeError as exc:
                    answers[k] = (str(exc), time.monotonic() - t0)

        qs = [threading.Thread(target=quiesce, args=(k,)) for k in range(2)]
        for t in qs:
            t.start()
        for t in qs:
            t.join(timeout=60)
        for why, took in answers:
            assert "slice quiesce barrier failed" in why, why
            assert took < timeout + 2.0
        assert all(g.failed is not None for g in ranks.gates)
        assert "none reached this rank" in ranks.gates[2].failed
        assert not any(a.paused for a in ranks.agentlets)
        before = list(ranks.steps)
        deadline = time.monotonic() + 10
        while min(s - b for s, b in zip(ranks.steps, before)) < 3 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert min(s - b for s, b in zip(ranks.steps, before)) >= 3
        assert not ranks.errors
    finally:
        ranks.close()


def test_lockstep_retry_after_a_failed_round_parks_at_one_step(tmp_path):
    """A round fails (rank 2's request never arrives, so its hold latches
    the gate); the agent resumes the peers and retries the gang under a
    new nonce, rank 2's request again landing after a peer's. Rank 2's
    latch belongs to the finished round: it holds for its request, and
    every rank parks at one step."""
    timeout = 1.5
    ranks = _LockstepRanks(tmp_path, 3, timeout_s=timeout)

    def quiesce(k, nonce, answers):
        with ToggleClient(0, path=ranks.agentlets[k].path, timeout=60) as c:
            try:
                answers[k] = c.quiesce(slice_cut=True, slice_nonce=nonce)
            except RuntimeError as exc:
                answers[k] = str(exc)

    def gang(ks, nonce, stagger_s):
        answers: dict = {}
        qs = []
        for k in ks:
            qs.append(threading.Thread(target=quiesce,
                                       args=(k, nonce, answers)))
            qs[-1].start()
            time.sleep(stagger_s)
        for t in qs:
            t.join(timeout=60)
        return answers

    try:
        while min(ranks.steps) < 3:
            time.sleep(0.01)
        failed = gang([0, 1], "1", 0.0)
        assert all("slice quiesce barrier failed" in str(failed[k])
                   for k in (0, 1)), failed
        assert ranks.gates[2].failed is not None
        for k in (0, 1):  # the agent's error path
            with ToggleClient(0, path=ranks.agentlets[k].path,
                              timeout=10) as c:
                c.resume()
        before = max(ranks.steps)
        while min(ranks.steps) < before + 3:
            time.sleep(0.01)
        cuts = gang([0, 1, 2], "2", 0.05)
        assert not ranks.errors
        assert sorted(cuts) == [0, 1, 2] and len(set(cuts.values())) == 1, cuts
        cut = cuts[0]
        assert isinstance(cut, int)
        assert all(a.paused for a in ranks.agentlets)
        assert ranks.steps == [cut] * 3
        assert [g.cut for g in ranks.gates] == [cut] * 3
        assert [g.failed for g in ranks.gates] == [None] * 3
        for a in ranks.agentlets:
            with ToggleClient(0, path=a.path, timeout=10) as c:
                c.resume()
    finally:
        ranks.close()
