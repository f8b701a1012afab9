"""Phases 18 and 19 of ``chip_smoke.py`` for comparisons on one card.

    python3 tools/mesh_phase_ab.py CHECKOUT LABEL OUT_DIR

imports ``chip_smoke`` and ``grit_tpu_torch`` from ``CHECKOUT`` (the root
of a checkout of this repo), builds that checkout's kernels, and runs its
``phase_mesh`` with phase 19 (the expert-parallel bench MoE and the
sharded serving grids) and without phase 20's gang. The phases print
their ``[mesh]`` and ``[ep]`` lines; the record goes to
``OUT_DIR/mesh-ab-LABEL.json``. Run the
parent and the change alternately in one call (parent, change, change,
parent): two runs on one card compare, two on two cards do not.

    python3 tools/mesh_phase_ab.py --reduced ROUNDS STEPS OUT_DIR

runs, in this checkout, phase 18's sharded flagship step and phase 19's
sharded bench MoE step on four ranks sharing the card over
``LOCAL_GLOO``, each with ``models.llama.reduced`` (the all-reduce after
``wo`` and ``w_down``) and with it left out (the ``Partial`` outputs left
to DTensor), the two arms alternated ROUNDS times in the same ranks,
STEPS timed steps an arm a round after two warm-up steps of each. It
prints each arm's step seconds and collectives a step on rank 0 and
writes them to ``OUT_DIR/reduced-ab.json``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def checkout_run(checkout: str, label: str, out_dir: str) -> int:
    out_dir = os.path.abspath(out_dir)
    sys.path.insert(0, checkout)
    os.chdir(checkout)
    import torch  # noqa: PLC0415

    import chip_smoke  # noqa: PLC0415
    from grit_tpu_torch.ops import build  # noqa: PLC0415

    if not torch.cuda.is_available():
        print("mesh_phase_ab: no CUDA device", file=sys.stderr)
        return 2
    card = card_name()
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    work = tempfile.mkdtemp(prefix="mesh-ab-")
    t0 = time.perf_counter()
    try:
        rec = chip_smoke.phase_mesh(torch, work, card, seed=0,
                                    ep=chip_smoke.ep_config(torch))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t0
    rec["card"] = card
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"mesh-ab-{label}.json"), "w") as f:
        json.dump(rec, f, default=str, indent=1)
    print(f"mesh_phase_ab {label}: {rec['phase_s']:.1f} s [{card}]")
    return 0


def reduced_rank(spec: dict) -> dict:
    """One rank of the ``--reduced`` comparison: for the flagship, then
    the bench MoE, a Trainer on phase 18's mesh, two warm-up steps of
    each arm, then the arms alternated; each arm's step seconds and its
    collectives a step (this rank's group counts)."""
    import torch  # noqa: PLC0415

    import chip_smoke  # noqa: PLC0415
    from grit_tpu_torch.models import llama  # noqa: PLC0415
    from grit_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    arms = {"reduced": llama.reduced, "left": lambda y: y}
    out: dict = {}
    for model in ("flagship", "moe"):
        tr = chip_smoke.mesh_trainer(torch, spec, chip_smoke.MESH_SOURCE,
                                     moe=model == "moe")
        rec = {arm: {"step_s": [], "collectives": {}} for arm in arms}
        for rnd in range(-1, spec["rounds"]):
            for arm, fn in arms.items():
                llama.reduced = fn
                n = 2 if rnd < 0 else spec["steps"]
                before = chip_smoke.mesh_collectives(tr)
                got = chip_smoke._run_steps(torch, fa, tr, dev, n)
                if rnd < 0:
                    continue  # warm-up: DTensor's plans, the allocator
                rec[arm]["step_s"] += got["step_s"]
                rec[arm]["collectives"] = {
                    k: [(c - before.get(k, [0, 0])[0]) / n,
                        (b - before.get(k, [0, 0])[1]) / n]
                    for k, (c, b) in chip_smoke.mesh_collectives(tr).items()}
        llama.reduced = arms["reduced"]
        out[model] = rec
        del tr
        torch.cuda.empty_cache()
    return out


def reduced_run(rounds: int, steps: int, out_dir: str) -> int:
    import torch  # noqa: PLC0415

    sys.path.insert(0, REPO)
    import chip_smoke  # noqa: PLC0415
    from grit_tpu_torch.models import llama  # noqa: PLC0415
    from grit_tpu_torch.ops import build  # noqa: PLC0415
    from grit_tpu_torch.parallel.collectives import LOCAL_GLOO  # noqa: PLC0415
    from grit_tpu_torch.parallel.launch import run_ranks  # noqa: PLC0415
    from tools import mesh_phase_ab  # noqa: PLC0415

    if not torch.cuda.is_available():
        print("mesh_phase_ab: no CUDA device", file=sys.stderr)
        return 2
    card = card_name()
    build.build_all()
    spec = {"device": "cuda", "seed": 0, "rounds": rounds, "steps": steps,
            "cfg": llama.LlamaConfig.flagship(n_layers=chip_smoke.MESH_LAYERS),
            "shape": (chip_smoke.BATCH, chip_smoke.SEQ),
            "ep": chip_smoke.ep_config(torch)}
    ranks = run_ranks(mesh_phase_ab.reduced_rank, chip_smoke.N_RANKS, spec,
                      backend=LOCAL_GLOO, timeout=1200)
    rec = {"card": card, "rounds": rounds, "steps": steps, "ranks": ranks}
    for model in ("flagship", "moe"):
        for arm in ("reduced", "left"):
            times = sorted(s for r in ranks for s in r[model][arm]["step_s"])
            print(f"reduced-ab {model} {arm}: step s median "
                  f"{times[len(times) // 2]:.4f}, min {times[0]:.4f}, max "
                  f"{times[-1]:.4f} over {len(times)} rank-steps; "
                  f"collectives a step on rank 0 "
                  f"{ranks[0][model][arm]['collectives']} [{card}]")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "reduced-ab.json"), "w") as f:
        json.dump(rec, f, default=str, indent=1)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[0] == "--reduced":
        sys.exit(reduced_run(int(args[1]), int(args[2]), args[3]))
    sys.exit(checkout_run(args[0], args[1], args[2]))
