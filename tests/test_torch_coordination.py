"""Slice coordination of the port (``grit_tpu_torch.parallel.coordination``)
against the JAX package's: the twins of ``tests/test_coordination.py`` on
port tensors, the bounded ``StoreRendezvous``, a port and a JAX
``FileRendezvous`` meeting on one directory, three-process coordinated
snapshots restoring across the packages with byte-identical leaves, and
the multi-process mirror sealing only with every host's marker."""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import textwrap
import threading
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist

from grit_tpu.device import restore_snapshot as jax_restore
from grit_tpu.parallel import coordination as jcoord
from grit_tpu_torch.device import snapshot as psnap
from grit_tpu_torch.device.snapshot import (
    SnapshotManifest,
    restore_snapshot,
    snapshot_delta_nbytes,
    snapshot_exists,
    snapshot_nbytes,
)
from grit_tpu_torch.parallel.coordination import (
    BarrierTimeout,
    FileRendezvous,
    LocalRendezvous,
    SliceCoordinator,
    StoreRendezvous,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _threads(n: int, fn) -> list:
    with ThreadPoolExecutor(n) as ex:
        return [f.result() for f in [ex.submit(fn, r) for r in range(n)]]


# -- twins of tests/test_coordination.py ------------------------------------------


class TestLocalRendezvous:
    def test_allgather_orders_by_rank(self):
        rdv = LocalRendezvous(3)
        with ThreadPoolExecutor(3) as ex:
            futs = [ex.submit(rdv.allgather, "x", 10 * r, r) for r in (2, 0, 1)]
            results = [f.result() for f in futs]
        assert all(r == [0, 10, 20] for r in results)

    def test_barrier_blocks_until_all(self):
        rdv = LocalRendezvous(2)
        order = []

        def party(r):
            order.append(("before", r))
            rdv.barrier("b")
            order.append(("after", r))

        _threads(2, party)
        assert {o for o, _ in order[:2]} == {"before"}
        assert {o for o, _ in order[2:]} == {"after"}


class TestSliceCoordinator:
    def test_cut_agreement_is_max(self):
        rdv = LocalRendezvous(3)
        coords = [SliceCoordinator(rdv, process_index=r, process_count=3)
                  for r in range(3)]
        steps = [4, 7, 5]
        assert _threads(3, lambda r: coords[r].agree_cut_step(steps[r])) \
            == [7, 7, 7]

    def test_coordinated_snapshot_merges_all_hosts(self, tmp_path):
        """3 hosts: stragglers run forward to the cut, all dump, process 0
        commits one manifest holding every host's chunks."""
        d = str(tmp_path / "snap")
        rdv = LocalRendezvous(3)

        def host(rank):
            coord = SliceCoordinator(rdv, process_index=rank, process_count=3)
            step = {0: 3, 1: 5, 2: 4}[rank]
            state = {"w": torch.full((4,), float(rank)), "step": step}

            def step_fn():
                state["step"] += 1

            coord.snapshot(d, state, step_fn=step_fn, current_step=step,
                           meta={"step": 5} if rank == 0 else None)
            return state["step"]

        assert _threads(3, host) == [5, 5, 5]
        assert snapshot_exists(d)
        m = SnapshotManifest.load(d)
        assert m.process_count == 3 and m.meta == {"step": 5}
        files = {c["file"] for rec in m.arrays for c in rec["chunks"]}
        assert files == {f"data-h{k:04d}.bin" for k in range(3)}

    def test_coordinated_delta_snapshot(self, tmp_path):
        """Multi-host pre-copy: a coordinated base, then a coordinated
        delta; every host references its own unchanged chunks."""
        base_d, delta_d = str(tmp_path / "base"), str(tmp_path / "delta")

        def run(directory, trainable, base=None):
            rdv = LocalRendezvous(2)

            def host(rank):
                coord = SliceCoordinator(rdv, process_index=rank,
                                         process_count=2)
                state = {"frozen": torch.arange(8.0) + 7.0,
                         "lora": torch.full((4,), trainable + rank)}
                return coord.snapshot(directory, state, base=base)

            _threads(2, host)

        run(base_d, 1.0)
        run(delta_d, 2.0, base=base_d)
        assert snapshot_exists(delta_d)
        assert 0 < snapshot_delta_nbytes(delta_d) < snapshot_nbytes(delta_d)
        m = SnapshotManifest.load(delta_d)
        frozen = next(r for r in m.arrays if "frozen" in r["name"])
        assert all(c.get("ref_dir") for c in frozen["chunks"])
        # Each process matched its own chunk of the base, in its own file.
        assert [c["file"] for c in frozen["chunks"]] == \
            [psnap.data_file(0), psnap.data_file(1)]
        assert m.process_count == 2 and m.meta == {}
        raw = json.load(open(os.path.join(delta_d, psnap.MANIFEST_FILE)))
        assert raw["dirty"]["chunks"] == 2 and raw["dirty"]["totalChunks"] == 4

    def test_barriered_restore(self, tmp_path):
        d = str(tmp_path / "snap")
        solo = SliceCoordinator(LocalRendezvous(1), process_index=0,
                                process_count=1)
        solo.snapshot(d, {"x": torch.arange(4.0)})
        rdv = LocalRendezvous(2)
        coords = [SliceCoordinator(rdv, process_index=r, process_count=2)
                  for r in range(2)]
        outs = _threads(2, lambda r: coords[r].restore(
            d, like={"x": torch.zeros(4)}, device="cpu"))
        for out in outs:
            assert torch.equal(out["x"], torch.arange(4.0))


class TestTrainerCoordination:
    def test_trainer_coordinated_snapshot_runs_forward(self, tmp_path):
        """Two hosts at different steps both end at the cut, and the
        snapshot records it."""
        from grit_tpu_torch.workload import mnist_trainer  # noqa: PLC0415

        d = str(tmp_path / "snap")
        rdv = LocalRendezvous(2)

        def host(rank):
            tr = mnist_trainer(device="cpu")
            tr.run({0: 2, 1: 5}[rank])
            coord = SliceCoordinator(rdv, process_index=rank, process_count=2)
            tr.snapshot_coordinated(d, coord)
            return tr.step

        assert _threads(2, host) == [5, 5]
        assert SnapshotManifest.load(d).meta == {"step": 5}


def test_default_process_index_is_the_default_group(tmp_path):
    """Without explicit indices the coordinator reads the initialised
    default group, and (0, 1) without one."""
    coord = SliceCoordinator(LocalRendezvous(1))
    assert (coord._pidx(), coord._pcount()) == (0, 1)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        assert (coord._pidx(), coord._pcount()) == (0, 1)
        d = coord.snapshot(str(tmp_path / "s"), {"x": torch.ones(2)})
        assert SnapshotManifest.load(d).process_count == 1
    finally:
        dist.destroy_process_group()


# -- the store transport ------------------------------------------------------------


def _stores(kind: str, tmp_path, world: int) -> list:
    if kind == "file":
        path = str(tmp_path / "filestore")
        return [dist.FileStore(path, -1) for _ in range(world)]
    master = dist.TCPStore("127.0.0.1", 0, world, True,
                           timeout=datetime.timedelta(seconds=30),
                           wait_for_workers=False)
    return [master] + [dist.TCPStore("127.0.0.1", master.port, world, False,
                                     timeout=datetime.timedelta(seconds=30))
                       for _ in range(world - 1)]


@pytest.mark.parametrize("kind", ["file", "tcp"])
class TestStoreRendezvous:
    def test_allgather_and_barrier_roundtrip(self, tmp_path, kind):
        world = 3
        stores = _stores(kind, tmp_path, world)
        rdvs = [StoreRendezvous(stores[k], k, world) for k in range(world)]

        def go(k):
            got = rdvs[k].allgather("cut", {"step": 10 + k}, k, timeout=10)
            rdvs[k].barrier("after", timeout=10)
            return got

        want = [{"step": 10 + k} for k in range(world)]
        assert _threads(world, go) == [want] * world

    def test_barrier_is_bounded_and_counts_arrivals(self, tmp_path, kind):
        rdv = StoreRendezvous(_stores(kind, tmp_path, 2)[0], 0, 2)
        with pytest.raises(BarrierTimeout, match="1/2"):
            rdv.barrier("partial", timeout=0.3)

    def test_allgather_is_bounded(self, tmp_path, kind):
        rdv = StoreRendezvous(_stores(kind, tmp_path, 2)[0], 0, 2)
        with pytest.raises(BarrierTimeout, match="1/2"):
            rdv.allgather("cut", 4, 0, timeout=0.3)

    def test_default_timeout_is_the_knob(self, tmp_path, kind, monkeypatch):
        monkeypatch.setenv("GRIT_SLICE_BARRIER_TIMEOUT_S", "0.2")
        rdv = StoreRendezvous(_stores(kind, tmp_path, 2)[0], 0, 2)
        with pytest.raises(BarrierTimeout):
            rdv.barrier("knob")


# -- the two packages on one directory ----------------------------------------------


@pytest.mark.parametrize("port_ranks", [[0], [1, 2], [0, 2]])
def test_port_and_jax_file_rendezvous_meet(tmp_path, port_ranks):
    """Ranks of both packages' ``FileRendezvous`` on one directory complete
    an allgather and a barrier: the layout is one."""
    world = 3
    rdvs = [(FileRendezvous if k in port_ranks else jcoord.FileRendezvous)(
        str(tmp_path), k, world) for k in range(world)]

    def go(k):
        got = rdvs[k].allgather("grit/q0.g0/cut", 3 * k, k, timeout=10)
        rdvs[k].barrier("grit/q0.g0/barrier-6", timeout=10)
        return got

    assert _threads(world, go) == [[0, 3, 6]] * world
    names = sorted(os.listdir(tmp_path))
    assert names == ["grit_q0.g0_barrier-6", "grit_q0.g0_cut"]
    assert sorted(os.listdir(tmp_path / "grit_q0.g0_cut")) == \
        [f"value-{k:04d}.json" for k in range(world)]


def test_file_rendezvous_writes_the_reference_bytes(tmp_path):
    """The port's arrival and value files are the reference's byte for
    byte, under the same mangled names."""
    for pkg, sub in ((FileRendezvous, "port"), (jcoord.FileRendezvous, "jax")):
        rdv = pkg(str(tmp_path / sub), 1, 1)
        rdv.barrier("a/b/../c")
        rdv.allgather("v", {"step": 7, "x": [1, 2]}, 1)
    for rel in ("a_b___c/arrive-0001", "v/value-0001.json"):
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes()


# -- coordinated snapshots across the packages --------------------------------------


def _host_state(rank: int) -> dict:
    """Host ``rank``'s leaves as numpy: its own (disjoint) leaves and one
    replicated leaf, every host the same bytes; f32, bf16 and int32."""
    rng = np.random.default_rng(100 + rank)
    return {
        f"own{rank}": rng.standard_normal((3, 5)).astype(np.float32),
        f"bf{rank}": rng.standard_normal(7).astype(ml_dtypes.bfloat16),
        "shared": (np.arange(6, dtype=np.int32) * 11).reshape(2, 3),
    }


def _torch_leaf(x: np.ndarray) -> torch.Tensor:
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


def _expected() -> dict:
    want = {}
    for k in range(3):
        for name, x in _host_state(k).items():
            want[f"['{name}']"] = x
    return want


def test_port_three_process_snapshot_restores_in_jax(tmp_path):
    d = str(tmp_path / "snap")
    rdv = LocalRendezvous(3)

    def host(rank):
        coord = SliceCoordinator(rdv, process_index=rank, process_count=3)
        state = {n: _torch_leaf(x) for n, x in _host_state(rank).items()}
        return coord.snapshot(d, state, meta={"step": 9})

    _threads(3, host)
    m = SnapshotManifest.load(d)
    assert m.process_count == 3 and m.meta == {"step": 9}
    shared = next(r for r in m.arrays if r["name"] == "['shared']")
    assert [c["file"] for c in shared["chunks"]] == \
        [psnap.data_file(k) for k in range(3)]
    got = jax_restore(d)
    want = _expected()
    assert sorted(got) == sorted(want)
    for name, x in want.items():
        assert np.asarray(got[name]).dtype == x.dtype, name
        assert _bytes(got[name]) == x.tobytes(), name


def test_jax_three_process_snapshot_restores_in_the_port(tmp_path):
    d = str(tmp_path / "snap")
    rdv = jcoord.LocalRendezvous(3)

    def host(rank):
        coord = jcoord.SliceCoordinator(rdv, process_index=rank,
                                        process_count=3)
        state = {n: jnp.asarray(x) for n, x in _host_state(rank).items()}
        return coord.snapshot(d, state, meta={"step": 9})

    _threads(3, host)
    m = SnapshotManifest.load(d)
    assert m.process_count == 3
    got = restore_snapshot(d, device="cpu")
    want = _expected()
    assert sorted(got) == sorted(want)
    for name, x in want.items():
        assert _bytes(got[name]) == x.tobytes(), name


# -- the multi-process mirror -------------------------------------------------------


@pytest.mark.parametrize("missing", [None, 0, 1])
def test_mirror_seals_only_with_every_marker(tmp_path, monkeypatch, missing):
    """Each process tees its own data file into the mirror; process 0
    seals it (COMMIT listing both processes' files) only when both
    markers are there, and abandons it otherwise, the primary committed
    either way."""
    d, mirror = str(tmp_path / "snap"), str(tmp_path / "mirror")
    orig = psnap._mark_mirror

    def mark(*args, pidx=0, **kw):
        if pidx != missing:
            orig(*args, pidx=pidx, **kw)

    monkeypatch.setattr(psnap, "_mark_mirror", mark)
    rdv = LocalRendezvous(2)

    def host(rank):
        coord = SliceCoordinator(rdv, process_index=rank, process_count=2)
        return coord.snapshot(d, {f"w{rank}": torch.arange(5.0) + rank},
                              mirror=mirror)

    _threads(2, host)
    assert snapshot_exists(d)
    if missing is not None:
        assert not os.path.exists(mirror)
        assert not os.path.exists(mirror + psnap.WORK_SUFFIX)
        return
    assert snapshot_exists(mirror)
    commit = open(os.path.join(mirror, psnap.COMMIT_FILE)).read().splitlines()
    files = json.loads(commit[1])["files"]
    assert sorted(files) == sorted(
        [psnap.data_file(0), psnap.data_file(1), psnap.index_file(0),
         psnap.index_file(1), psnap.MANIFEST_FILE])
    for k in range(2):
        assert open(os.path.join(mirror, psnap.data_file(k)), "rb").read() \
            == open(os.path.join(d, psnap.data_file(k)), "rb").read()
    got = restore_snapshot(mirror, device="cpu")
    assert torch.equal(got["['w1']"], torch.arange(5.0) + 1)


def test_single_process_defaults_write_what_they_always_wrote(tmp_path):
    """With the defaults the dump is process 0 of 1: no barrier, one data
    file, ``process_count`` 1, the same bytes as an explicit 0 of 1."""
    state = {"a": torch.arange(4.0), "b": torch.ones(2, dtype=torch.bfloat16)}
    calls = []
    d1 = psnap.write_snapshot(str(tmp_path / "one"), state, meta={"step": 1})
    d2 = psnap.write_snapshot(str(tmp_path / "two"), state, meta={"step": 1},
                              barrier=lambda: calls.append(1),
                              process_index=0, process_count=1)
    assert calls == [1, 1]
    for name in (psnap.DATA_FILE, psnap.INDEX_FILE, psnap.MANIFEST_FILE):
        assert open(os.path.join(d1, name), "rb").read() == \
            open(os.path.join(d2, name), "rb").read()
    assert sorted(os.listdir(d1)) == sorted(
        [psnap.DATA_FILE, psnap.INDEX_FILE, psnap.MANIFEST_FILE,
         psnap.COMMIT_FILE])


def test_a_host_that_never_arrives_commits_nothing(tmp_path):
    """Process 0 commits only after the barrier: a peer that never
    writes its files times the barrier out, and no snapshot commits."""
    d = str(tmp_path / "snap")
    rdv = FileRendezvous(str(tmp_path / "rdv"), 0, 2)
    coord = SliceCoordinator(rdv, process_index=0, process_count=2)
    with pytest.raises(BarrierTimeout):
        psnap.write_snapshot(d, {"x": torch.ones(2)},
                             barrier=lambda: rdv.barrier("b", timeout=0.3),
                             process_index=coord._pidx(),
                             process_count=coord._pcount())
    assert not snapshot_exists(d)


def test_new_port_modules_import_nothing_of_jax():
    """The slice's modules load no jax, optax, ml_dtypes or JAX-package
    module."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import grit_tpu_torch.parallel.coordination
        import grit_tpu_torch.device.agentlet, grit_tpu_torch.device.hook
        import grit_tpu_torch.train.trainer
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "optax",
                                            "ml_dtypes", "grit_tpu"))
        print(bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_file_rendezvous_ignores_tmp_twins_of_the_jax_writer(tmp_path):
    """A JAX host's half-written value (its ``.tmp-`` twin) is not an
    arrival for a port host."""
    d = tmp_path / "cut"
    d.mkdir()
    (d / "value-0001.json.tmp-99").write_text("4")
    r = FileRendezvous(str(tmp_path), 0, 2)
    with pytest.raises(BarrierTimeout, match="1/2"):
        r.allgather("cut", 3, 0, timeout=0.3)
    done = threading.Event()
    jax_side = jcoord.FileRendezvous(str(tmp_path), 1, 2)

    def late():
        jax_side.allgather("cut", 4, 1, timeout=10)
        done.set()

    t = threading.Thread(target=late)
    t.start()
    assert r.allgather("cut", 3, 0, timeout=10) == [3, 4]
    t.join(timeout=10)
    assert done.is_set()


def test_group_any_answers_whether_any_rank_is_pending():
    """The ``lockstep`` collective on four gloo ranks: each pattern of
    pending flags reads the same answer on every rank of the group (the
    axis, and each rank's pair), and so does the host-side gloo twin that
    a group of another backend gets."""
    from grit_tpu_torch.parallel.launch import run_ranks  # noqa: PLC0415
    from tests import torch_ranks  # noqa: PLC0415

    patterns = [[0, 0, 0, 0], [1, 0, 0, 0], [0, 0, 0, 1], [0, 1, 1, 0],
                [1, 1, 1, 1], [0, 0, 1, 0]]
    got = run_ranks(torch_ranks.group_any_cases, 4, {"patterns": patterns},
                    backend="gloo", timeout=300)
    for rank, res in enumerate(got):
        pair = [2 * (rank // 2), 2 * (rank // 2) + 1]
        want_world = [any(p) for p in patterns]
        want_pair = [any(p[r] for r in pair) for p in patterns]
        assert res["world"] == res["twin_world"] == want_world, rank
        assert res["pair"] == res["twin_pair"] == want_pair, rank
