"""Start N ranks of one function, each in a process of its own.

``run_ranks(fn, n, *args, backend=...)`` spawns ``n`` fresh interpreters (the
``spawn`` start method: nothing of the caller's state is forked, a rank
imports what ``fn``'s module imports), joins them into one
``torch.distributed`` group over a ``FileStore`` in a temporary
directory (a fixed TCP port would collide between test workers on one
host), calls ``fn(*args)`` on every rank and returns the ranks' results
in rank order. ``fn`` must be importable by name (a module-level
function), and its arguments and result picklable.

The launcher never runs fewer ranks than asked: a rank that raises,
dies, or outlives ``timeout`` ends every rank and raises here, with the
rank's traceback. On the card each rank should find the kernel libraries
built: build them before starting the ranks (``ops.build.build_all``),
so that the ranks load them and never race to compile them.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from grit_tpu_torch.train.trainer import enable_determinism


class RankError(RuntimeError):
    """A rank failed, died or timed out; every rank has been ended."""


def _rank_main(fn: Callable, rank: int, n: int, backend: str,
               work: str) -> None:
    torch.set_num_threads(1)  # ranks share the host's cores
    # Deterministic algorithms and a fixed cuBLAS workspace, as the
    # workloads run: a rank's step is then bit-reproducible on the card.
    enable_determinism()
    try:
        args = torch.load(os.path.join(work, "args.pt"), weights_only=False)
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(work, "store"), n),
            rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=600))
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(work, f"result-{rank}.pt"))
    except BaseException:
        with open(os.path.join(work, f"error-{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn: Callable, n: int, *args, backend: str,
              timeout: float = 600.0) -> list[Any]:
    """Run ``fn(*args)`` on ``n`` ranks of a ``backend`` group (``gloo``
    or ``nccl``: the caller names it, nothing picks one for it); returns
    the results in rank order."""
    if n < 1:
        raise ValueError(f"cannot run {n} ranks")
    ctx = mp.get_context("spawn")
    work = tempfile.mkdtemp(prefix="grit-ranks-")
    # The arguments go through a file: spawn writes a process's own
    # arguments into a pipe that the new interpreter reads only after its
    # imports, so large ones would start the ranks one after another.
    torch.save(args, os.path.join(work, "args.pt"))
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, n, backend, work))
             for rank in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            if bad:
                raise RankError(_failure(work, bad, procs))
            if time.monotonic() > deadline:
                raise RankError(f"ranks still running after {timeout} s")
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RankError(_failure(work, bad, procs))
        return [torch.load(os.path.join(work, f"result-{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
        shutil.rmtree(work, ignore_errors=True)


def _failure(work: str, bad: list[int], procs) -> str:
    parts = []
    for r in bad:
        path = os.path.join(work, f"error-{r}.txt")
        detail = open(path).read() if os.path.exists(path) else "no traceback"
        parts.append(f"rank {r} exited with {procs[r].exitcode}:\n{detail}")
    return "\n".join(parts)
