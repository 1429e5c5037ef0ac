"""A world of processes on one host: one subprocess a rank.

:func:`run_world` starts ``world`` processes, each of which joins a
``torch.distributed`` process group through a file store in ``workdir``
(no fixed port), calls ``target(rank, world, **kwargs)`` and writes what it
returns; the parent waits for all of them with one deadline. A rank that
exits non-zero, or the deadline passing, kills every rank still running
and raises with the failing rank's log: no process outlives the call.

    PYTHONPATH=src python -m repro_torch.distributed.world \\
        MODULE:FUNCTION RANK WORLD WORKDIR BACKEND TIMEOUT

is the command each rank runs (``run_world`` builds it).
"""
from __future__ import annotations

import datetime
import importlib
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, List, Optional, Sequence

SRC = Path(__file__).resolve().parents[2]


def _paths(workdir: Path, rank: int):
    return (workdir / "kwargs.pt", workdir / f"result{rank}.pt",
            workdir / f"rank{rank}.log")


def run_world(target: str, world: int, *, backend: str, workdir,
              kwargs: Optional[dict] = None, timeout: float = 300.0,
              python_path: Sequence[str] = ()) -> List[Any]:
    """Run ``target`` (``"module:function"``) on ``world`` ranks over
    ``backend``; returns each rank's return value, by rank. ``workdir``
    must be empty or new (it holds the store, the arguments, the results
    and one log a rank). ``python_path`` is put before ``src`` on the
    ranks' ``PYTHONPATH``."""
    import torch
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(kwargs or {}, _paths(workdir, 0)[0])
    run_env = dict(os.environ)
    run_env["PYTHONPATH"] = os.pathsep.join(
        [*map(str, python_path), str(SRC)]
        + ([run_env["PYTHONPATH"]] if run_env.get("PYTHONPATH") else []))
    procs = []
    for rank in range(world):
        log = open(_paths(workdir, rank)[2], "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "repro_torch.distributed.world", target,
             str(rank), str(world), str(workdir), backend, str(timeout)],
            stdout=log, stderr=subprocess.STDOUT, env=run_env), log))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while failed is None and any(p.poll() is None for p, _ in procs):
            if time.monotonic() > deadline:
                failed = ("timed out", None)
                break
            for rank, (p, _) in enumerate(procs):
                if p.poll() not in (None, 0):
                    failed = (f"exited with {p.returncode}", rank)
                    break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = (f"exited with {procs[bad[0]][0].returncode}",
                          bad[0])
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    if failed is not None:
        what, rank = failed
        logs = range(world) if rank is None else [rank]
        tails = "\n".join(
            f"--- rank {r} ---\n"
            + _paths(workdir, r)[2].read_text(errors="replace")[-4000:]
            for r in logs)
        raise RuntimeError(f"world {target} x {world}: "
                           f"{'a rank' if rank is None else f'rank {rank}'}"
                           f" {what}\n{tails}")
    return [torch.load(_paths(workdir, r)[1], weights_only=False)
            for r in range(world)]


def _main(argv: Sequence[str]) -> int:
    target, rank, world, workdir, backend, timeout = argv
    import torch
    import torch.distributed as dist
    rank, world, workdir = int(rank), int(world), Path(workdir)
    module, fn = target.split(":")
    kwargs = torch.load(_paths(workdir, rank)[0], weights_only=False)
    dist.init_process_group(
        backend, init_method=f"file://{workdir / 'store'}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=float(timeout)))
    try:
        out = getattr(importlib.import_module(module), fn)(rank, world,
                                                           **kwargs)
    finally:
        dist.destroy_process_group()
    torch.save(out, _paths(workdir, rank)[1])
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
