#!/usr/bin/env python3
"""Which collectives gloo runs on a device's tensors, and how long 256 MB take.

Run from the root of a checkout:

    PYTHONPATH=src python3 tools/gloo_collectives_probe.py [--device cuda:0]

For each of ``all_reduce`` (sum), ``all_reduce`` (max),
``reduce_scatter_tensor`` and the list form ``reduce_scatter``, in fp32 and
bf16, it starts a world of two ranks on the one device over gloo
(``repro_torch.distributed.world.run_world``, a deadline of 45 s each, so a
collective that hangs names its case), runs the collective on eight
elements and prints what each rank got, or the world's error. For
``all_reduce`` and ``reduce_scatter_tensor`` it also times three calls on
64 Mi fp32 elements (256 MB) a rank with the host clock around a device
synchronise: on one card gloo copies through host memory, so these are
loopback times, no measure of NCCL or NVLink. The last line is the card's
name and power limit from ``nvidia-smi`` (on a CUDA device).

The sharded train step (``train/step.py``) reduce-scatters gradients with
``reduce_scatter_tensor``; this probe is how that was found to run under
gloo on CUDA tensors (NVIDIA H100 80GB HBM3, torch 2.11).
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
CASES = ("all_reduce", "all_reduce_max", "reduce_scatter_tensor",
         "reduce_scatter")
TIMED = ("all_reduce", "reduce_scatter_tensor")


def _sync(torch, dev: str) -> None:
    if dev.startswith("cuda"):
        torch.cuda.synchronize()


def rank_fn(rank, world, *, name: str, dtype: str, dev: str) -> dict:
    """One rank of a probe world: ``name`` on eight elements of ``dtype``
    (rank r holds (r + 1) * arange(8)), then the timings."""
    import torch
    import torch.distributed as dist
    if dev.startswith("cuda"):
        torch.cuda.set_device(dev)
    dt = getattr(torch, dtype)
    x = torch.arange(8, dtype=torch.float32, device=dev).to(dt) * (rank + 1)
    if name == "reduce_scatter_tensor":
        out = torch.empty(4, dtype=dt, device=dev)
        dist.reduce_scatter_tensor(out, x)
    elif name == "reduce_scatter":
        out = torch.empty(4, dtype=dt, device=dev)
        dist.reduce_scatter(out, list(x.chunk(2)))
    else:
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX if name.endswith("max")
                        else dist.ReduceOp.SUM)
    _sync(torch, dev)
    result = {"value": out.float().cpu().tolist()}
    if name in TIMED and dtype == "float32":
        n = 64 * 2**20
        big = torch.ones(n, device=dev)
        half = torch.empty(n // 2, device=dev)
        secs = []
        for _ in range(3):
            _sync(torch, dev)
            dist.barrier()
            t0 = time.perf_counter()
            if name == "all_reduce":
                dist.all_reduce(big)
            else:
                dist.reduce_scatter_tensor(half, big)
            _sync(torch, dev)
            secs.append(time.perf_counter() - t0)
        result["seconds_256MB"] = secs
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--workdir", default="build/gloo_probe")
    args = ap.parse_args(argv)
    from repro_torch.distributed.world import run_world
    base = Path(args.workdir).resolve()
    for name in CASES:
        for dtype in ("float32", "bfloat16"):
            wd = base / f"{name}_{dtype}"
            shutil.rmtree(wd, ignore_errors=True)
            t0 = time.perf_counter()
            try:
                got = run_world("gloo_collectives_probe:rank_fn", 2,
                                backend="gloo", workdir=wd, timeout=45,
                                python_path=[str(HERE)],
                                kwargs={"name": name, "dtype": dtype,
                                        "dev": args.device})
            except RuntimeError as e:   # the probe's result is the error
                got = str(e)[-1500:]
            print(json.dumps({"case": f"{name}/{dtype}", "ranks": got,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    shutil.rmtree(base, ignore_errors=True)
    if args.device.startswith("cuda"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
