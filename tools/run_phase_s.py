#!/usr/bin/env python3
"""Phase (s) of ``chip_smoke.py`` alone: the collective path on the card.

Run from the root of a checkout (or name one with ``--root``), on a
machine with a CUDA GPU and ``nvcc``:

    python3 tools/run_phase_s.py [--root CHECKOUT] [--seed 0]

It builds the checkout's kernels (``repro_torch.kernels.build``), turns
TF32 off as the smoke does, and calls that checkout's
``chip_smoke.collective_path``: its worlds of ranks on the one card over
gloo, each held against one process, every line the smoke prints for
(s), then a last line with the phase's seconds and its launches. With
``--root`` pointing at an unpacked ``git archive`` of another commit, it
runs that commit's (s), so two trees can be compared in one call.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    os.chdir(root)
    sys.path[:0] = [str(root / "src"), str(root)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("run_phase_s: no CUDA GPU available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all()
    cs.log({"build_seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    launches = cs.collective_path(torch, np, smi, args.seed)
    cs.log({"phase_s_seconds": time.perf_counter() - t0,
            "launches": launches, "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
