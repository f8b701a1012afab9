"""The reference agent's pre-copy migration of a PyTorch workload: the
unchanged ``MigrationHarness`` drives the port's tiny llama workload
through the live pre-copy phase (``h.precopy``), the blackout delta
against the pre-copy base with the streaming mirror
(``h.checkpoint(pre_copy=True)``) and the streamed stage
(``h.stage_streamed``); a fresh port process restores through the stage
journal and continues bit-identically."""

from __future__ import annotations

import json
import os

from grit_tpu.agent import checkpoint as ckpt
from grit_tpu.device.hook import HBM_SUBDIR
from grit_tpu.harness import MigrationHarness, read_losses
from tests.test_torch_agentlet import TORCH_LLAMA_WORKLOAD


def test_precopy_blackout_delta_streamed_stage(tmp_path, monkeypatch):
    uploads: list[dict] = []
    transfer = ckpt.transfer_data

    def spy(src, dst, *args, **kwargs):
        if kwargs.get("direction") == "upload":
            uploads.append(dict(kwargs.get("skip_unchanged") or {}))
        return transfer(src, dst, *args, **kwargs)

    monkeypatch.setattr(ckpt, "transfer_data", spy)
    h = MigrationHarness(str(tmp_path), workload_src=TORCH_LLAMA_WORKLOAD)
    ref = h.spawn(n_steps=8)
    ref_losses = read_losses(ref.stdout.read().splitlines())
    assert ref.wait() == 0 and len(ref_losses) == 8

    src = h.spawn(n_steps=1000)
    try:
        h.wait_ready(src)
        h.wait_until_step(src, 2)
        runtime = h.make_source_runtime(src.pid)
        shipped = h.precopy(runtime)
        base = os.path.join(h.pvc, "main-precopy", HBM_SUBDIR)
        assert os.path.isfile(os.path.join(base, "COMMIT"))
        h.wait_until_step(src, 3)
        h.checkpoint(runtime, pre_copy=True, preshipped=shipped)
    finally:
        src.kill()
        src.wait()

    manifest = json.load(open(os.path.join(h.pvc, "main", HBM_SUBDIR,
                                           "MANIFEST.json")))
    cut = manifest["meta"]["step"]
    assert cut >= 3
    # Speculation on (the default): the blackout quiesce started a pass
    # into <hbm>-spec, a delta against the pre-copy base, and the parked
    # dump re-shipped against that pass what the steps since changed.
    spec = json.load(open(os.path.join(h.pvc, "main", HBM_SUBDIR + "-spec",
                                       "MANIFEST.json")))
    assert manifest["base"] == os.path.join("..", HBM_SUBDIR + "-spec")
    assert spec["base"] == os.path.join("..", "..", "main-precopy",
                                        HBM_SUBDIR)
    for m in (manifest, spec):
        assert m["dirty"]["totalChunks"] == sum(len(r["chunks"])
                                                for r in m["arrays"])
    # Adam moves every weight each step: the pass is nearly all dirty,
    # and the leaves the steps never touch (the seed) are reused; the
    # re-ship writes at most what the pass wrote.
    dirty = spec["dirty"]
    assert 0 < dirty["chunks"] < dirty["totalChunks"]
    assert manifest["dirty"]["chunks"] <= dirty["chunks"]
    rng = next(r for r in manifest["arrays"] if r["name"] == "['rng']")
    assert rng["chunks"][0].get("ref_dir")
    # The blackout upload skipped what the streaming mirror committed.
    mirrored = {os.path.join("main", HBM_SUBDIR, n)
                for n in ("data-h0000.bin", "index-h0000.json")}
    assert any(mirrored <= set(skip) for skip in uploads), uploads

    handle = h.stage_streamed()
    spec = h.shim_restore_spec()
    dst = h.spawn(extra_env=h.restore_env(spec), n_steps=8, cache="dst")
    out = dst.stdout.read().splitlines()
    assert dst.wait() == 0
    handle.wait(timeout=120.0)
    assert "RESTORE_BEGIN" in out and f"RESTORED {cut}" in out
    legs = json.loads(next(line for line in out
                           if line.startswith("RESTORE_PIPELINE "))
                      .split(" ", 1)[1])
    assert legs["streamed"] is True and 0.0 <= legs["overlap_fraction"] <= 1.0
    got = read_losses(out)
    assert got == {s: x for s, x in ref_losses.items() if s > cut}
